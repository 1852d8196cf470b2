"""IVF shortlist rescore (counterpart of ``pathway_tpu/ops/ivf_pallas.py``).

``scores[b, j, :] = q[b] . slabs[probe[b, j]].T + bias[probe[b, j]]``,
accumulated in f32, for probe ``[B, p]`` int32, q ``[B, d]`` f32, slabs
``[C, M, d]`` f32 or bf16 and bias ``[C, M]`` f32 (0 live, -inf
pad/removed) -> ``[B, p, M]`` f32.

``rescore_shortlist`` launches the hand-written CUDA kernels
(``csrc/ivf_rescore.cu``: a probe-table inversion, then one pass that
reads each probed slab once for all the queries that probe it) for CUDA
tensors, and runs the plain torch version ``ivf_rescore_reference`` for
CPU tensors — chosen by where the tensors lie, never as a fallback.  The
kernels take any B, p, C, M and d up to ~1,300 (no multiples of 8 or
128), need no host sync, and allocate their scratch here with
``torch.empty``.  ``rescore_shortlist.launches`` counts the calls that
launched them.
"""

from __future__ import annotations

import ctypes

import torch

__all__ = ["ivf_rescore_reference", "rescore_shortlist"]

_SLAB_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def ivf_rescore_reference(
    probe: torch.Tensor, q: torch.Tensor, slabs: torch.Tensor, bias: torch.Tensor
) -> torch.Tensor:
    """Plain torch version: slab gather + f32 einsum + ``bias[probe]``."""
    probe = probe.long()
    rows = slabs[probe].float()  # [B, p, M, d]
    return torch.einsum("bpmd,bd->bpm", rows, q.float()) + bias[probe]


def _lib():
    from ..kernels.build import load

    lib = load("ivf_rescore")
    fn = lib.pw_ivf_rescore
    if fn.argtypes is None:
        # pointers and the stream as c_void_p: ctypes would pass a bare
        # int as a 32-bit c_int and cut the pointer
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.pw_ivf_rescore_scratch_ints.argtypes = [ctypes.c_int] * 3
        lib.pw_ivf_rescore_scratch_ints.restype = ctypes.c_longlong
        lib.pw_cuda_error_string.argtypes = [ctypes.c_int]
        lib.pw_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check(probe, q, slabs, bias) -> None:
    dev = probe.device
    for name, t in (("q", q), ("slabs", slabs), ("bias", bias)):
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, probe on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not probe.is_contiguous():
        raise ValueError("probe must be contiguous")
    if probe.dtype != torch.int32 or q.dtype != torch.float32 or bias.dtype != torch.float32:
        raise TypeError(
            f"need probe int32, q f32, bias f32; got {probe.dtype}, {q.dtype}, {bias.dtype}"
        )
    if slabs.dtype not in _SLAB_DTYPES:
        raise TypeError(f"slabs must be f32 or bf16, got {slabs.dtype}")
    B, p = probe.shape
    C, M, d = slabs.shape
    if q.shape != (B, d) or bias.shape != (C, M):
        raise ValueError(
            f"shape mismatch: probe {tuple(probe.shape)}, q {tuple(q.shape)}, "
            f"slabs {tuple(slabs.shape)}, bias {tuple(bias.shape)}"
        )
    if C == 0:
        raise ValueError("empty slabs")


def rescore_shortlist(
    probe: torch.Tensor, q: torch.Tensor, slabs: torch.Tensor, bias: torch.Tensor
) -> torch.Tensor:
    """Rescore the probed slabs: ``[B, p, M]`` f32.  CUDA tensors launch
    the kernel (or raise); CPU tensors take ``ivf_rescore_reference``."""
    if probe.device.type == "cpu":
        return ivf_rescore_reference(probe, q, slabs, bias)
    if probe.device.type != "cuda":
        raise ValueError(f"no rescore kernel for device {probe.device}")
    _check(probe, q, slabs, bias)
    B, p = probe.shape
    C, M, d = slabs.shape
    out = torch.empty((B, p, M), dtype=torch.float32, device=probe.device)
    lib = _lib()
    scratch = torch.empty(
        lib.pw_ivf_rescore_scratch_ints(B, p, C), dtype=torch.int32, device=probe.device
    )
    sms = torch.cuda.get_device_properties(probe.device).multi_processor_count
    with torch.cuda.device(probe.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.pw_ivf_rescore(
            probe.data_ptr(), q.data_ptr(), slabs.data_ptr(), bias.data_ptr(),
            out.data_ptr(), scratch.data_ptr(), B, p, C, M, d,
            _SLAB_DTYPES[slabs.dtype], sms, stream,
        )
    if err != 0:
        raise RuntimeError(
            f"ivf_rescore launch failed: {lib.pw_cuda_error_string(err).decode()}"
        )
    rescore_shortlist.launches += 1
    return out


rescore_shortlist.launches = 0
