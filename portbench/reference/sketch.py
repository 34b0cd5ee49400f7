"""The sketches' defined bit rules in plain numpy: the 32-bit hash, the
HyperLogLog register rule and estimator and the latency histogram's bucket
rule. They are the semantics the
configuration states, written out again from their definitions; nothing
here imports the program."""

from __future__ import annotations

import numpy as np

U32 = np.uint32

# latency histogram: 32 sub-buckets an octave over u32 microseconds
SUB_BITS = 5
SUB = 1 << SUB_BITS
HIST_BUCKETS = (32 - SUB_BITS + 1) * SUB


def fmix32(x: np.ndarray) -> np.ndarray:
    """murmur3's 32-bit finalizer."""
    x = np.asarray(x).astype(np.uint64) & np.uint64(0xFFFFFFFF)
    x ^= x >> np.uint64(16)
    x = (x * np.uint64(0x85EBCA6B)) & np.uint64(0xFFFFFFFF)
    x ^= x >> np.uint64(13)
    x = (x * np.uint64(0xC2B2AE35)) & np.uint64(0xFFFFFFFF)
    x ^= x >> np.uint64(16)
    return x.astype(U32)


def floor_log2(x: np.ndarray) -> np.ndarray:
    """floor(log2(x)) of u32 x >= 1 (0 maps to 0), exact in integers."""
    x = np.asarray(x).astype(np.uint64)
    e = np.zeros(x.shape, np.int64)
    for k in (16, 8, 4, 2, 1):
        big = (x >> np.uint64(k)) != 0
        e += big * k
        x = np.where(big, x >> np.uint64(k), x)
    return e


def hll_bucket_rho(trace_h: np.ndarray, p: int):
    """(register index, rank) of each trace: the register is the top ``p``
    bits of fmix32(trace_h), the rank is the position of the first set
    bit in the rest (all zero: 32 - p + 1)."""
    h = fmix32(trace_h).astype(np.int64)
    bucket = h >> (32 - p)
    rest = h & ((1 << (32 - p)) - 1)
    rho = np.where(rest == 0, 32 - p + 1, (32 - p) - floor_log2(np.maximum(rest, 1)))
    return bucket, rho.astype(np.uint8)


def hll_alpha(m: int) -> float:
    return {16: 0.673, 32: 0.697, 64: 0.709}.get(m, 0.7213 / (1.0 + 1.079 / m))


def hll_estimate(regs: np.ndarray) -> np.ndarray:
    """[rows] estimates of u8 registers [rows, m]: the bias-corrected
    harmonic mean, linear counting below 2.5 m where a register is empty."""
    m = regs.shape[-1]
    harm = np.sum(np.exp2(-regs.astype(np.float64)), axis=-1)
    raw = hll_alpha(m) * m * m / harm
    zeros = np.sum(regs == 0, axis=-1).astype(np.float64)
    linear = m * np.log(m / np.maximum(zeros, 1.0))
    return np.where((raw <= 2.5 * m) & (zeros > 0), linear, raw)


def hist_bucket(dur: np.ndarray) -> np.ndarray:
    """Histogram bucket of u32 microsecond durations: values below 64 are
    their own bucket, above that 32 sub-buckets an octave."""
    v = np.asarray(dur).astype(np.int64)
    e = floor_log2(np.maximum(v, 1))
    shift = np.maximum(e - SUB_BITS, 0)
    idx = (e - SUB_BITS + 1) * SUB + ((v >> shift) - SUB)
    return np.where(v < (1 << (SUB_BITS + 1)), v, idx)


def hist_bucket_bounds(dur: np.ndarray):
    """(lowest value, width) of each duration's histogram bucket, int64."""
    b = hist_bucket(dur)
    small = b < 2 * SUB
    e = b // SUB + SUB_BITS - 1
    shift = np.maximum(e - SUB_BITS, 0)
    lo = np.where(small, b, (SUB + b % SUB) << shift)
    return lo.astype(np.int64), np.where(small, 1, 1 << shift).astype(np.int64)

