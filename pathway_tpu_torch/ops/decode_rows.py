"""Row-invariant LayerNorm and tied readout of the generator decode path
(port-side kernels: in the JAX package these are XLA ops of
``pathway_tpu/models/transformer.py`` and ``models/generator.py``).

The decode invariants (pool == solo, spec-on == spec-off, warm == cold)
need each row's result to be the same bits whatever the number of rows
computed with it.  On the H100 torch's f32 matmul and its row
reductions change algorithm with the row count, so the decode path
takes these functions, whose CUDA kernels (``csrc/decode_rows.cu``)
compute every output element as one fixed chain over its own row:

- ``layer_norm_rows(x, weight, bias, out_dtype)``: Flax's LayerNorm
  (f32 statistics, fast variance, epsilon 1e-6, cast to ``out_dtype``)
  over the last axis;
- ``add_layer_norm_rows(x, delta, weight, bias, out_dtype)``: the
  residual add and the LayerNorm after it in one launch, ``(s, y)`` with
  ``s = x + delta`` (rounded to ``x.dtype`` as torch rounds it) and
  ``y = layer_norm_rows(s)`` bit for bit;
- ``tied_readout(h, table)``: ``h.float() @ table.float().T``, the
  weight-tied logits ``[..., V]`` f32, each logit one FMA chain over
  ``k = 0 .. d - 1`` in order.  The kernel reads each tile of the table
  from device memory once per call whatever the row count; ``d`` is
  capped at 1536, the widest row for which a 32-row tile of the table
  and a chunk of staged rows of ``h`` fit a block's 227 KB of shared
  memory with room to spare.

CUDA tensors launch the kernel (or raise); CPU tensors take the plain
torch versions ``layer_norm_reference`` / ``add_layer_norm_reference`` /
``tied_readout_reference``, chosen by where the tensors lie, never as a
fallback.  The wrappers raise on a tensor that is not contiguous rather
than copy it, set the library up once, and read the current stream once
per call.  Each wrapper's ``launches`` counts the calls that launched its
kernel.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

__all__ = [
    "add_layer_norm_reference",
    "add_layer_norm_rows",
    "layer_norm_reference",
    "layer_norm_rows",
    "tied_readout",
    "tied_readout_reference",
]

_LN_EPS = 1e-6
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_READOUT_D = 1536
_LIB = None


def layer_norm_reference(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, out_dtype: torch.dtype
) -> torch.Tensor:
    """Plain torch version: the trunk's ``LayerNorm`` arithmetic."""
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = torch.clamp((x32 * x32).mean(-1, keepdim=True) - mean * mean, min=0.0)
    mul = torch.rsqrt(var + _LN_EPS) * weight
    return ((x32 - mean) * mul + bias).to(out_dtype)


def add_layer_norm_reference(
    x: torch.Tensor, delta: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, out_dtype: torch.dtype
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version: ``s = x + delta``, then the trunk's LayerNorm
    of ``s``."""
    s = x + delta
    return s, layer_norm_reference(s, weight, bias, out_dtype)


def tied_readout_reference(h: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Plain torch version: ``h.float() @ table.float().T``."""
    return h.float() @ table.float().t()


def _lib():
    global _LIB
    if _LIB is None:
        from ..kernels.build import load

        lib = load("decode_rows")
        lib.pw_layer_norm_rows.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [ctypes.c_float] + [ctypes.c_int] * 2 + [ctypes.c_void_p]
        )
        lib.pw_layer_norm_rows.restype = ctypes.c_int
        lib.pw_add_layer_norm_rows.argtypes = (
            [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2 + [ctypes.c_float] + [ctypes.c_int] * 2 + [ctypes.c_void_p]
        )
        lib.pw_add_layer_norm_rows.restype = ctypes.c_int
        lib.pw_tied_readout.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        lib.pw_tied_readout.restype = ctypes.c_int
        lib.pw_decode_rows_error_string.argtypes = [ctypes.c_int]
        lib.pw_decode_rows_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _launch(fn, name: str, device: torch.device, *args) -> None:
    """Call the C entry point on the current stream of ``device`` (made
    the current device only when it is not already) and raise on a
    refused launch."""
    if device.index != torch.cuda.current_device():
        with torch.cuda.device(device):
            err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    else:
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: {_LIB.pw_decode_rows_error_string(err).decode()}")


def _check(name: str, *tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"no {name} kernel for device {dev}")
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} takes contiguous tensors, got strides {t.stride()}")


def _check_ln(name: str, x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, out_dtype: torch.dtype) -> int:
    if x.dtype not in _DTYPES or out_dtype not in _DTYPES:
        raise TypeError(f"{name} takes f32 / bf16, got {x.dtype} -> {out_dtype}")
    if weight.dtype != torch.float32 or bias.dtype != torch.float32:
        raise TypeError(f"{name} needs f32 weight and bias")
    d = x.shape[-1]
    if weight.shape != (d,) or bias.shape != (d,):
        raise ValueError(f"weight / bias must be [{d}]")
    return d


def layer_norm_rows(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, out_dtype: torch.dtype
) -> torch.Tensor:
    """LayerNorm over the last axis of ``x`` (f32 or bf16) with f32
    ``weight`` / ``bias``, cast to ``out_dtype`` (f32 or bf16)."""
    if x.device.type == "cpu":
        return layer_norm_reference(x, weight, bias, out_dtype)
    _check("layer_norm_rows", x, weight, bias)
    d = _check_ln("layer_norm_rows", x, weight, bias, out_dtype)
    y = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    lib = _lib()
    _launch(
        lib.pw_layer_norm_rows, "layer_norm_rows", x.device,
        x.data_ptr(), weight.data_ptr(), bias.data_ptr(), y.data_ptr(),
        x.numel() // max(d, 1), d, _LN_EPS, _DTYPES[x.dtype], _DTYPES[out_dtype],
    )
    layer_norm_rows.launches += 1
    return y


layer_norm_rows.launches = 0


def add_layer_norm_rows(
    x: torch.Tensor, delta: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, out_dtype: torch.dtype
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(s, y)``: the residual sum ``s = x + delta`` in ``x``'s type (f32
    or bf16; ``delta`` of the same type and shape) and the LayerNorm of
    ``s`` over its last axis, cast to ``out_dtype``, in one launch."""
    if x.device.type == "cpu":
        return add_layer_norm_reference(x, delta, weight, bias, out_dtype)
    _check("add_layer_norm_rows", x, delta, weight, bias)
    d = _check_ln("add_layer_norm_rows", x, weight, bias, out_dtype)
    if delta.dtype != x.dtype or delta.shape != x.shape:
        raise ValueError(f"add_layer_norm_rows: delta {delta.dtype} {tuple(delta.shape)} vs x {x.dtype} {tuple(x.shape)}")
    s = torch.empty_like(x)
    y = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    lib = _lib()
    _launch(
        lib.pw_add_layer_norm_rows, "add_layer_norm_rows", x.device,
        x.data_ptr(), delta.data_ptr(), weight.data_ptr(), bias.data_ptr(), s.data_ptr(), y.data_ptr(),
        x.numel() // max(d, 1), d, _LN_EPS, _DTYPES[x.dtype], _DTYPES[out_dtype],
    )
    add_layer_norm_rows.launches += 1
    return s, y


add_layer_norm_rows.launches = 0


def tied_readout(h: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Logits ``[..., V]`` f32 of hidden states ``h [..., d]`` (f32 or
    bf16) against the f32 embedding table ``[V, d]``."""
    if h.device.type == "cpu":
        return tied_readout_reference(h, table)
    _check("tied_readout", h, table)
    if h.dtype not in _DTYPES or table.dtype != torch.float32:
        raise TypeError(f"tied_readout takes f32 / bf16 h and an f32 table, got {h.dtype}, {table.dtype}")
    V, d = table.shape
    if h.shape[-1] != d or d > _MAX_READOUT_D:
        raise ValueError(f"tied_readout: h width {h.shape[-1]}, table {tuple(table.shape)} (d <= {_MAX_READOUT_D})")
    out = torch.empty((*h.shape[:-1], V), dtype=torch.float32, device=h.device)
    lib = _lib()
    _launch(
        lib.pw_tied_readout, "tied_readout", h.device,
        h.data_ptr(), table.data_ptr(), out.data_ptr(), h.numel() // d, V, d, _DTYPES[h.dtype],
    )
    tied_readout.launches += 1
    return out


tied_readout.launches = 0
