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

import torch

__all__ = ["DEFAULT_DTYPE", "resolve_device"]

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
