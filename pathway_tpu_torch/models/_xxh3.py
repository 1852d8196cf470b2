"""Pure-Python XXH3-64 (seed 0, default secret).

The reference tokenizer hashes words with the ``xxhash`` package or the
C++ scanner that includes ``xxhash.h``; neither is guaranteed where the
port runs, so it carries this copy of the algorithm (XXH3 v0.8, the
64-bit variant).  It covers every length class of the spec: 0, 1-3, 4-8,
9-16, 17-128, 129-240 and >240 bytes.  Hashing is per word and memoised
by the tokenizer, so its speed is not on the serve path.
"""

from __future__ import annotations

import struct

__all__ = ["xxh3_64"]

_M64 = (1 << 64) - 1

_P32_1 = 0x9E3779B1
_P32_2 = 0x85EBCA77
_P32_3 = 0xC2B2AE3D
_P64_1 = 0x9E3779B185EBCA87
_P64_2 = 0xC2B2AE3D27D4EB4F
_P64_3 = 0x165667B19E3779F9
_P64_4 = 0x85EBCA77C2B2AE63
_P64_5 = 0x27D4EB2F165667C5
_PMX1 = 0x165667919E3779F9
_PMX2 = 0x9FB21C651E98DF25

_SECRET = bytes.fromhex(
    "b8fe6c3923a44bbe7c01812cf721ad1cded46de9839097db7240a4a4b7b3671f"
    "cb79e64eccc0e578825ad07dccff7221b8084674f743248ee03590e6813a264c"
    "3c2852bb91c300cb88d0658b1b532ea371644897a20df94e3819ef46a9deacd8"
    "a8fa763fe39c343ff9dcbbc7c70b4f1d8a51e04bcdb45931c89f7ec9d9787364"
    "eac5ac8334d3ebc3c581a0fffa1363eb170ddd51b7f0da49d316552629d4689e"
    "2b16be587d47a1fc8ff8b8d17ad031ce45cb3a8f95160428afd7fbcabb4b407e"
)
_SECRET_SIZE = len(_SECRET)  # 192
_STRIPE = 64
_STRIPES_PER_BLOCK = (_SECRET_SIZE - _STRIPE) // 8  # 16
_BLOCK = _STRIPE * _STRIPES_PER_BLOCK  # 1024


def _r64(b: bytes, i: int) -> int:
    return int.from_bytes(b[i : i + 8], "little")


def _r32(b: bytes, i: int) -> int:
    return int.from_bytes(b[i : i + 4], "little")


def _mul128_fold64(a: int, b: int) -> int:
    p = a * b
    return (p & _M64) ^ (p >> 64)


def _xxh64_avalanche(h: int) -> int:
    h ^= h >> 33
    h = (h * _P64_2) & _M64
    h ^= h >> 29
    h = (h * _P64_3) & _M64
    return h ^ (h >> 32)


def _avalanche(h: int) -> int:
    h ^= h >> 37
    h = (h * _PMX1) & _M64
    return h ^ (h >> 32)


def _rotl64(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _M64


def _rrmxmx(h: int, n: int) -> int:
    h ^= _rotl64(h, 49) ^ _rotl64(h, 24)
    h = (h * _PMX2) & _M64
    h ^= (h >> 35) + n
    h = (h * _PMX2) & _M64
    return h ^ (h >> 28)


def _mix16(data: bytes, i: int, s: int) -> int:
    return _mul128_fold64(
        _r64(data, i) ^ _r64(_SECRET, s),
        _r64(data, i + 8) ^ _r64(_SECRET, s + 8),
    )


def _accumulate_512(acc: list, data: bytes, i: int, s: int) -> None:
    words = struct.unpack_from("<8Q", data, i)
    for lane in range(8):
        v = words[lane]
        k = v ^ _r64(_SECRET, s + 8 * lane)
        acc[lane ^ 1] = (acc[lane ^ 1] + v) & _M64
        acc[lane] = (acc[lane] + (k & 0xFFFFFFFF) * (k >> 32)) & _M64


def _scramble(acc: list) -> None:
    s = _SECRET_SIZE - _STRIPE
    for lane in range(8):
        a = acc[lane]
        a ^= a >> 47
        a ^= _r64(_SECRET, s + 8 * lane)
        acc[lane] = (a * _P32_1) & _M64


def _hash_long(data: bytes) -> int:
    n = len(data)
    acc = [_P32_3, _P64_1, _P64_2, _P64_3, _P64_4, _P32_2, _P64_5, _P32_1]
    nb_blocks = (n - 1) // _BLOCK
    for blk in range(nb_blocks):
        base = blk * _BLOCK
        for st in range(_STRIPES_PER_BLOCK):
            _accumulate_512(acc, data, base + st * _STRIPE, st * 8)
        _scramble(acc)
    base = nb_blocks * _BLOCK
    nb_stripes = ((n - 1) - base) // _STRIPE
    for st in range(nb_stripes):
        _accumulate_512(acc, data, base + st * _STRIPE, st * 8)
    # last stripe, at XXH_SECRET_LASTACC_START = 7 from the secret's end
    _accumulate_512(acc, data, n - _STRIPE, _SECRET_SIZE - _STRIPE - 7)
    # merge, at XXH_SECRET_MERGEACCS_START = 11
    result = (n * _P64_1) & _M64
    for i in range(4):
        result += _mul128_fold64(
            acc[2 * i] ^ _r64(_SECRET, 11 + 16 * i),
            acc[2 * i + 1] ^ _r64(_SECRET, 11 + 16 * i + 8),
        )
    return _avalanche(result & _M64)


def xxh3_64(data: bytes) -> int:
    """XXH3-64 of ``data`` with seed 0 — equal to
    ``xxhash.xxh3_64_intdigest(data)``."""
    n = len(data)
    if n == 0:
        return _xxh64_avalanche(_r64(_SECRET, 56) ^ _r64(_SECRET, 64))
    if n <= 3:
        c1, c2, c3 = data[0], data[n >> 1], data[n - 1]
        combined = (c1 << 16) | (c2 << 24) | c3 | (n << 8)
        bitflip = _r32(_SECRET, 0) ^ _r32(_SECRET, 4)
        return _xxh64_avalanche(combined ^ bitflip)
    if n <= 8:
        in1 = _r32(data, 0)
        in2 = _r32(data, n - 4)
        bitflip = _r64(_SECRET, 8) ^ _r64(_SECRET, 16)
        keyed = ((in2 + (in1 << 32)) & _M64) ^ bitflip
        return _rrmxmx(keyed, n)
    if n <= 16:
        bf1 = _r64(_SECRET, 24) ^ _r64(_SECRET, 32)
        bf2 = _r64(_SECRET, 40) ^ _r64(_SECRET, 48)
        lo = _r64(data, 0) ^ bf1
        hi = _r64(data, n - 8) ^ bf2
        swapped = int.from_bytes(lo.to_bytes(8, "little"), "big")
        acc = (n + swapped + hi + _mul128_fold64(lo, hi)) & _M64
        return _avalanche(acc)
    if n <= 128:
        acc = (n * _P64_1) & _M64
        if n > 32:
            if n > 64:
                if n > 96:
                    acc += _mix16(data, 48, 96) + _mix16(data, n - 64, 112)
                acc += _mix16(data, 32, 64) + _mix16(data, n - 48, 80)
            acc += _mix16(data, 16, 32) + _mix16(data, n - 32, 48)
        acc += _mix16(data, 0, 0) + _mix16(data, n - 16, 16)
        return _avalanche(acc & _M64)
    if n <= 240:
        acc = (n * _P64_1) & _M64
        for i in range(8):
            acc += _mix16(data, 16 * i, 16 * i)
        acc = _avalanche(acc & _M64)
        for i in range(8, n // 16):
            # XXH3_MIDSIZE_STARTOFFSET = 3
            acc += _mix16(data, 16 * i, 16 * (i - 8) + 3)
        # XXH3_SECRET_SIZE_MIN (136) - XXH3_MIDSIZE_LASTOFFSET (17)
        acc += _mix16(data, n - 16, 136 - 17)
        return _avalanche(acc & _M64)
    return _hash_long(data)
