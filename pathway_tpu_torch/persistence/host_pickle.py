"""Pickles that hold no device memory.

``dumps`` pickles an object with every ``torch.Tensor`` in it replaced by
a numpy array of the same values, on the host (a bf16 tensor as f32:
numpy has no bf16): an input event, an
operator's state or a cached object that carries a CUDA tensor is
written as host data, so a snapshot taken on the card restores in a
process on the CPU (and in the reference package, which reads numpy).
"""

from __future__ import annotations

import io
import pickle

import torch

__all__ = ["dumps"]


class _HostPickler(pickle.Pickler):
    def reducer_override(self, obj):
        if isinstance(obj, torch.Tensor):
            host = obj.detach().cpu()
            if host.dtype == torch.bfloat16:
                host = host.float()
            return host.numpy().__reduce__()
        return NotImplemented


def dumps(obj) -> bytes:
    buf = io.BytesIO()
    _HostPickler(buf, protocol=pickle.DEFAULT_PROTOCOL).dump(obj)
    return buf.getvalue()
