"""Device and dtype policy of the port.

- Device: every entry point takes ``device``; ``None`` means the process
  default, which is the CUDA device unless ``set_default_device`` changed
  it (``cli run --device cpu`` does, before it builds a template's
  objects).  Asking for CUDA where there is none raises.  The CPU is used
  only when a caller asks for it (the parity tests, ``--device cpu``).
- Dtype: activations are bf16 on the card, as ``TransformerConfig.dtype``
  is in the reference; callers pass ``dtype`` explicitly to get f32.
- TF32 is switched off for matmuls and cuDNN, so an f32 product on the
  card is a full-f32 product and an f32 check means f32.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

__all__ = ["DEFAULT_DTYPE", "default_device", "resolve_device", "set_default_device", "to_host", "upload"]

DEFAULT_DTYPE = torch.bfloat16

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


_default_device = "cuda"


def set_default_device(device: Union[str, torch.device]) -> None:
    """Set what ``resolve_device(None)`` returns in this process
    (``cuda`` or ``cpu``); checked like any explicit device."""
    global _default_device
    _default_device = str(resolve_device(device))


def default_device() -> str:
    return _default_device


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` -> the process default (``cuda`` unless
    ``set_default_device`` changed it); raises ``RuntimeError`` for a
    CUDA device when CUDA is not available (never falls back to the
    CPU)."""
    dev = torch.device(_default_device if device is None else device)
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
    done.record(torch.cuda.current_stream(packed.device))  # the copy's stream, whichever card

    def wait():
        done.synchronize()
        return host.numpy()

    return wait
