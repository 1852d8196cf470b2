"""Device and dtype policy of the port.

- Device: every entry point takes ``device``; ``None`` means the CUDA
  device, and asking for CUDA where there is none raises.  The CPU is
  used only when a caller passes ``device="cpu"`` (the parity tests).
- Dtype: activations are bf16 on the card, as ``TransformerConfig.dtype``
  is in the reference; callers pass ``dtype`` explicitly to get f32.
- TF32 is switched off for matmuls and cuDNN, so an f32 product on the
  card is a full-f32 product and an f32 check means f32.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

__all__ = ["DEFAULT_DTYPE", "resolve_device", "to_host", "upload"]

DEFAULT_DTYPE = torch.bfloat16

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` -> ``cuda``; raises ``RuntimeError`` for a CUDA device
    when CUDA is not available (never falls back to the CPU)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' explicitly to run "
            "the port on the CPU"
        )
    return dev


def upload(array: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host array -> tensor on ``device``.  On CUDA the source is pinned
    and the copy is asynchronous: a pageable upload would wait for the
    work already queued on the stream, serializing pipelined submits."""
    t = torch.from_numpy(np.ascontiguousarray(array))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def to_host(packed: torch.Tensor):
    """Start the device -> pinned host copy of one packed result; returns
    a zero-arg callable that waits for it and returns the numpy array."""
    if packed.device.type != "cuda":
        arr = packed.numpy()
        return lambda: arr
    host = torch.empty(packed.shape, dtype=packed.dtype, pin_memory=True)
    host.copy_(packed, non_blocking=True)
    done = torch.cuda.Event()
    done.record()

    def wait():
        done.synchronize()
        return host.numpy()

    return wait
