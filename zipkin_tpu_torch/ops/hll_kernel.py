"""HLL register update: the hand-written Hopper kernel and its plain twin.

Counterpart of ``zipkin_tpu/ops/pallas_hll.py:update`` (the repo's one
Pallas TPU kernel). The CUDA source is ``csrc/hll_update.cu``; its note
says what bounds it on the card and how the design answers that.

:func:`update` launches the kernel for a CUDA tensor and runs
:func:`update_plain` for a CPU tensor — the CPU is the only reason it
takes the plain path; there is no switch and no fallback. Both update
``registers`` in place and return it. ``update.launches`` counts kernel
launches.
"""

from __future__ import annotations

import ctypes

import torch

from zipkin_tpu_torch import u32
from zipkin_tpu_torch.ops.hashing import floor_log2


def rho_of(hashes: torch.Tensor, p: int):
    """(bucket, rho) of each u32 hash (int64 value or int32 bits) for
    precision ``p`` — the bit rules of ``zipkin_tpu/ops/hll.py:update``."""
    h = u32.wrap(hashes.to(u32.DTYPE))
    bucket = h >> (32 - p)
    rest = h & ((1 << (32 - p)) - 1)
    rho = torch.where(
        rest == 0,
        torch.full_like(rest, 32 - p + 1),
        (32 - p) - floor_log2(torch.clamp(rest, min=1)),
    )
    return bucket, rho


def update_plain(registers, row_ids, hashes, valid) -> torch.Tensor:
    """Plain PyTorch scatter-max; rows outside ``[0, rows)`` are dropped
    as the reference's scatter drops out-of-bound updates."""
    rows_n, m = registers.shape
    p = int(m).bit_length() - 1
    bucket, rho = rho_of(hashes, p)
    rows = row_ids.to(torch.int64)
    ok = valid.to(torch.bool) & (rows >= 0) & (rows < rows_n)
    rho = torch.where(ok, rho, 0).to(torch.uint8)
    flat = torch.where(ok, rows, 0) * m + bucket
    registers.view(-1).scatter_reduce_(0, flat, rho, "amax", include_self=True)
    return registers


_fn = []  # the bound C entry point, loaded at the first launch


def _entry():
    if not _fn:
        from zipkin_tpu_torch import kernels

        fn = kernels.load("hll_update").hll_update
        fn.argtypes = [ctypes.c_void_p] * 4 + [
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p
        ]
        fn.restype = ctypes.c_int
        _fn.append(fn)
    return _fn[0]


def _launch(registers, rows, hashes, valid) -> None:
    fn = _entry()
    rows_n, m = registers.shape
    err = fn(
        registers.data_ptr(), rows.data_ptr(), hashes.data_ptr(),
        valid.data_ptr(), rows.shape[0], rows_n, int(m).bit_length() - 1,
        torch.cuda.current_stream(registers.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"hll_update kernel launch failed: CUDA error {err}")


def update(registers, row_ids, hashes, valid) -> torch.Tensor:
    """Raise ``registers[row, bucket]`` to ``rho`` of each valid lane.

    ``registers``: u8 ``[rows, 2**p]``, contiguous. ``row_ids``: int32
    ``[n]``. ``hashes``: int32 ``[n]`` holding the bits of the u32 hashes
    (:func:`zipkin_tpu_torch.u32.bits32`). ``valid``: bool ``[n]``. On a
    CUDA tensor all four must be on the same card, so the kernel reads
    9 B a lane; the plain path also takes int64 rows and u32 values.
    """
    if registers.device.type == "cpu":
        return update_plain(registers, row_ids, hashes, valid)
    if registers.device.type != "cuda":
        raise ValueError(f"hll update: unsupported device {registers.device}")
    dev = registers.device
    if registers.dtype != torch.uint8 or registers.dim() != 2:
        raise ValueError("hll update: registers must be a 2-D uint8 tensor")
    m = registers.shape[1]
    p = int(m).bit_length() - 1
    if m != 1 << p or not 2 <= p <= 30:
        raise ValueError(f"hll update: register width {m} is not 2**p, 2 <= p <= 30")
    if not registers.is_contiguous() or registers.data_ptr() % 4:
        raise ValueError("hll update: registers must be contiguous and 4-byte aligned")
    n = row_ids.shape[0]
    for name, t, dt in (("row_ids", row_ids, torch.int32),
                        ("hashes", hashes, torch.int32),
                        ("valid", valid, torch.bool)):
        if t.device != dev:
            raise ValueError(f"hll update: {name} on {t.device}, registers on {dev}")
        if t.dtype != dt:
            raise ValueError(f"hll update: {name} must be {dt}, got {t.dtype}")
        if t.dim() != 1 or t.shape[0] != n or not t.is_contiguous():
            raise ValueError(f"hll update: {name} must be a contiguous [{n}] vector")
    if n == 0:
        return registers
    _launch(registers, row_ids, hashes, valid)
    update.launches += 1
    return registers


update.launches = 0
