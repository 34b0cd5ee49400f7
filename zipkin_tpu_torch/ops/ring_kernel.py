"""Retention-ring append: the hand-written Hopper kernel and its plain twin.

Counterpart of the reference's ring append in
``zipkin_tpu/tpu/ingest.py:138-151,187-206``: the stable compaction of a
batch's valid lanes into the ring at ``(ring_pos + rank) % R``, where a
lane's rank is its count of valid lanes before it, with every pad lane
dropped (the reference's ``argsort(~valid)`` and ``.at[pos].set(...,
mode="drop")``). The CUDA source is ``csrc/ring_append.cu``; its note says
what bounds it on the card and how the design answers that.

:func:`append` launches the kernel for CUDA tensors and runs
:func:`append_plain` for CPU tensors: the CPU is the only reason it takes
the plain path; there is no switch and no fallback. Both write the ring
columns in place and read ``ring_pos`` on the device (the caller advances
it). ``append.launches`` counts kernel launches
(:func:`zipkin_tpu_torch.kernels.count_launch`).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from zipkin_tpu_torch import kernels

MAX_COLUMNS = 16  # kMaxCols in csrc/ring_append.cu
TILE_LANES = 256  # kTileLanes: lanes (and threads) of a block
MAX_TILES = 4096  # kMaxTiles: the status words (batches up to 2^20 lanes)
HEADER_WORDS = 2  # kHeaderWords: the u32 words (epoch, blocks past their look-back) before them


def append_plain(ring: Sequence[torch.Tensor], lanes: Sequence[Optional[torch.Tensor]],
                 valid: torch.Tensor, ring_pos: torch.Tensor) -> None:
    """Plain PyTorch: lane ``i`` of rank ``k`` (valid lanes before it) is
    written to ``(ring_pos + k) % R`` in every column, a None lane column
    writes zero; pad lanes are dropped. Each pad lane takes the slot past
    the valid ones that its own rank would give and writes back what the
    slot holds, so no slot is written twice (``n <= R``)."""
    n = valid.shape[0]
    cap = ring[0].shape[0]
    if n > cap:
        raise ValueError(f"ring append: {n} lanes into a ring of {cap}")
    dev = valid.device
    order = torch.sort((~valid).to(torch.uint8), stable=True).indices
    lane = torch.arange(n, dtype=torch.int64, device=dev)
    live = lane < valid.sum()
    pos = (ring_pos + lane) % cap
    for dst, src in zip(ring, lanes):
        new = torch.zeros(n, dtype=dst.dtype, device=dev) if src is None else src[order].to(dst.dtype)
        dst.index_copy_(0, pos, torch.where(live, new, dst[pos]))


_fn = []  # the bound C entry point, loaded at the first launch


def _entry():
    if not _fn:
        fn = kernels.load("ring_append").ring_append
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                       ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn.append(fn)
    return _fn[0]


def _check(ring, lanes, valid, ring_pos) -> int:
    """What :func:`append` requires before it launches; returns ``R``."""
    what = "ring append"
    if not ring or len(ring) != len(lanes) or len(ring) > MAX_COLUMNS:
        raise ValueError(f"{what}: 1..{MAX_COLUMNS} ring columns, one lane column each")
    dev, n, cap = valid.device, valid.shape[0], ring[0].shape[0]
    if valid.dtype != torch.bool or valid.dim() != 1 or not valid.is_contiguous():
        raise ValueError(f"{what}: valid must be a contiguous bool vector")
    if ring_pos.device != dev or ring_pos.dtype != torch.int64 or ring_pos.numel() != 1:
        raise ValueError(f"{what}: ring_pos must be one int64 on {dev}")
    if n > cap:
        raise ValueError(f"{what}: {n} lanes into a ring of {cap}")
    if n > TILE_LANES * MAX_TILES:
        raise ValueError(f"{what}: {n} lanes, the kernel takes <= {TILE_LANES * MAX_TILES}")
    for i, (dst, src) in enumerate(zip(ring, lanes)):
        if dst.device != dev or dst.dim() != 1 or dst.shape[0] != cap or not dst.is_contiguous():
            raise ValueError(f"{what}: ring column {i} must be a contiguous [{cap}] vector on {dev}")
        if dst.element_size() not in (1, 8):
            raise ValueError(f"{what}: ring column {i} has {dst.element_size()}-byte elements")
        if src is not None and (src.device != dev or src.dtype != dst.dtype or src.dim() != 1
                                or src.shape[0] != n or not src.is_contiguous()):
            raise ValueError(f"{what}: lane column {i} must be a contiguous [{n}] {dst.dtype} "
                             f"vector on {dev}")
    return cap


def append(ring: Sequence[torch.Tensor], lanes: Sequence[Optional[torch.Tensor]],
           valid: torch.Tensor, ring_pos: torch.Tensor) -> None:  # zt-in-place: ring — the ring columns are written in place
    """Write the valid lanes of ``lanes`` (each ``[n]``, or None to clear)
    into ``ring`` (each ``[R]``) at ``(ring_pos + rank) % R``; pad lanes
    are dropped. On a CUDA tensor each lane column must have its ring
    column's dtype (1- or 8-byte elements), everything contiguous on one
    card; ``ring_pos`` is the 0-d int64 cursor, read on the card."""
    if valid.device.type == "cpu":
        return append_plain(ring, lanes, valid, ring_pos)
    if valid.device.type != "cuda":
        raise ValueError(f"ring append: unsupported device {valid.device}")
    cap = _check(ring, lanes, valid, ring_pos)
    n = valid.shape[0]
    if n == 0:
        return None
    fn = _entry()
    # the epoch and finish words, then the tiles' u64 status words
    words = kernels.device_words("ring_append", valid.device, HEADER_WORDS + 2 * MAX_TILES)
    k = len(ring)
    srcs = (ctypes.c_void_p * k)(*[0 if t is None else t.data_ptr() for t in lanes])
    dsts = (ctypes.c_void_p * k)(*[t.data_ptr() for t in ring])
    sizes = (ctypes.c_int * k)(*[t.element_size() for t in ring])
    with torch.cuda.device(valid.device):
        err = fn(valid.data_ptr(), ring_pos.data_ptr(), n, cap, k, srcs, dsts, sizes,
                 words.data_ptr(), torch.cuda.current_stream(valid.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ring_append kernel launch failed: CUDA error {err}")
    kernels.count_launch(append)
    return None


append.launches = 0
