"""32-bit avalanche hashing (port of ``zipkin_tpu/ops/hashing.py``).

u32 values are int64 in [0, 2**32) (see :mod:`zipkin_tpu_torch.u32`);
every function here is bit-exact with the JAX one.
"""

from __future__ import annotations

import torch

from zipkin_tpu_torch import u32

_C1 = 0x85EBCA6B
_C2 = 0xC2B2AE35
_GOLDEN = 0x9E3779B9


def fmix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3 finalizer: full-avalanche 32-bit mix."""
    x = u32.wrap(x.to(u32.DTYPE))
    x = x ^ (x >> 16)
    x = u32.mul(x, _C1)
    x = x ^ (x >> 13)
    x = u32.mul(x, _C2)
    x = x ^ (x >> 16)
    return x


def hash2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Mix two u32 lanes (one 64-bit id) into one well-distributed u32."""
    a = u32.wrap(a.to(u32.DTYPE))
    return fmix32(a ^ fmix32(u32.add(b.to(u32.DTYPE), _GOLDEN)))


def hash4(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Mix four u32 lanes (one 128-bit id) into one u32."""
    return hash2(hash2(a, b), hash2(c, d))


def floor_log2(x: torch.Tensor) -> torch.Tensor:
    """``floor(log2(x))`` for u32 ``x >= 1``, integer-only; 0 maps to 0.
    Returns int64 (the reference returns int32 of the same value)."""
    x = u32.wrap(x.to(u32.DTYPE))
    e = torch.zeros_like(x)
    for k in (16, 8, 4, 2, 1):
        big = (x >> k) != 0
        e = e + big.to(x.dtype) * k
        x = torch.where(big, x >> k, x)
    return e
