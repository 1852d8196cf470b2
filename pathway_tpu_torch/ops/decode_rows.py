"""Row-invariant LayerNorm and tied readout of the generator decode path
(port-side kernels: in the JAX package both are XLA ops of
``pathway_tpu/models/transformer.py`` and ``models/generator.py``).

The decode invariants (pool == solo, spec-on == spec-off, warm == cold)
need each row's result to be the same bits whatever the number of rows
computed with it.  On the H100 torch's f32 matmul and its row
reductions change algorithm with the row count, so the decode path
takes these two functions, whose CUDA kernels (``csrc/decode_rows.cu``)
compute every output element as one fixed chain over its own row:

- ``layer_norm_rows(x, weight, bias, out_dtype)``: Flax's LayerNorm
  (f32 statistics, fast variance, epsilon 1e-6, cast to ``out_dtype``)
  over the last axis;
- ``tied_readout(h, table)``: ``h.float() @ table.float().T``, the
  weight-tied logits ``[..., V]`` f32.

CUDA tensors launch the kernel (or raise); CPU tensors take the plain
torch versions ``layer_norm_reference`` / ``tied_readout_reference``,
chosen by where the tensors lie, never as a fallback.  Each wrapper's
``launches`` counts the calls that launched its kernel.
"""

from __future__ import annotations

import ctypes

import torch

__all__ = ["layer_norm_reference", "layer_norm_rows", "tied_readout", "tied_readout_reference"]

_LN_EPS = 1e-6
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_READOUT_D = 1536  # 8 staged rows of h fit the 48 KB of static shared memory


def layer_norm_reference(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, out_dtype: torch.dtype
) -> torch.Tensor:
    """Plain torch version: the trunk's ``LayerNorm`` arithmetic."""
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = torch.clamp((x32 * x32).mean(-1, keepdim=True) - mean * mean, min=0.0)
    mul = torch.rsqrt(var + _LN_EPS) * weight
    return ((x32 - mean) * mul + bias).to(out_dtype)


def tied_readout_reference(h: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Plain torch version: ``h.float() @ table.float().T``."""
    return h.float() @ table.float().t()


def _lib():
    from ..kernels.build import load

    lib = load("decode_rows")
    if lib.pw_layer_norm_rows.argtypes is None:
        lib.pw_layer_norm_rows.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [ctypes.c_float] + [ctypes.c_int] * 2 + [ctypes.c_void_p]
        )
        lib.pw_layer_norm_rows.restype = ctypes.c_int
        lib.pw_tied_readout.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        lib.pw_tied_readout.restype = ctypes.c_int
        lib.pw_decode_rows_error_string.argtypes = [ctypes.c_int]
        lib.pw_decode_rows_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(lib, err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: {lib.pw_decode_rows_error_string(err).decode()}")


def _cuda_only(name: str, *tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"no {name} kernel for device {dev}")
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")


def layer_norm_rows(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, out_dtype: torch.dtype
) -> torch.Tensor:
    """LayerNorm over the last axis of ``x`` (f32 or bf16) with f32
    ``weight`` / ``bias``, cast to ``out_dtype`` (f32 or bf16)."""
    if x.device.type == "cpu":
        return layer_norm_reference(x, weight, bias, out_dtype)
    _cuda_only("layer_norm_rows", x, weight, bias)
    if x.dtype not in _DTYPES or out_dtype not in _DTYPES:
        raise TypeError(f"layer_norm_rows takes f32 / bf16, got {x.dtype} -> {out_dtype}")
    if weight.dtype != torch.float32 or bias.dtype != torch.float32:
        raise TypeError("layer_norm_rows needs f32 weight and bias")
    d = x.shape[-1]
    if weight.shape != (d,) or bias.shape != (d,):
        raise ValueError(f"weight / bias must be [{d}]")
    xc = x.contiguous()
    y = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        err = lib.pw_layer_norm_rows(
            xc.data_ptr(), weight.contiguous().data_ptr(), bias.contiguous().data_ptr(), y.data_ptr(),
            xc.numel() // max(d, 1), d, _LN_EPS, _DTYPES[x.dtype], _DTYPES[out_dtype],
            torch.cuda.current_stream().cuda_stream,
        )
    _raise_on(lib, err, "layer_norm_rows")
    layer_norm_rows.launches += 1
    return y


layer_norm_rows.launches = 0


def tied_readout(h: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Logits ``[..., V]`` f32 of hidden states ``h [..., d]`` (f32 or
    bf16) against the f32 embedding table ``[V, d]``."""
    if h.device.type == "cpu":
        return tied_readout_reference(h, table)
    _cuda_only("tied_readout", h, table)
    if h.dtype not in _DTYPES or table.dtype != torch.float32:
        raise TypeError(f"tied_readout takes f32 / bf16 h and an f32 table, got {h.dtype}, {table.dtype}")
    V, d = table.shape
    if h.shape[-1] != d or d > _MAX_READOUT_D:
        raise ValueError(f"tied_readout: h width {h.shape[-1]}, table {tuple(table.shape)} (d <= {_MAX_READOUT_D})")
    hc = h.contiguous()
    M = hc.numel() // d
    out = torch.empty((*h.shape[:-1], V), dtype=torch.float32, device=h.device)
    lib = _lib()
    with torch.cuda.device(h.device):
        err = lib.pw_tied_readout(
            hc.data_ptr(), table.contiguous().data_ptr(), out.data_ptr(), M, V, d, _DTYPES[h.dtype],
            torch.cuda.current_stream().cuda_stream,
        )
    _raise_on(lib, err, "tied_readout")
    tied_readout.launches += 1
    return out


tied_readout.launches = 0
