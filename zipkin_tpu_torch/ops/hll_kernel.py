"""HLL register update: the hand-written Hopper kernel and its plain twins.

Counterpart of ``zipkin_tpu/ops/pallas_hll.py:update`` (the repo's one
Pallas TPU kernel). The CUDA source is ``csrc/hll_update.cu``; its note
says what bounds it on the card and how the design answers that. One
source, two entry points:

- :func:`update` raises one register file for one row per lane (the
  counterpart of ``pallas_hll.update``);
- :func:`update_step` raises all of an ingest step's HLL registers in
  one launch: per-service and global rows of ``hll`` and, with the time
  tier on, of the flat ``tb_hll`` view (the four updates of
  ``zipkin_tpu/tpu/ingest.py:77-82,116-122``).

Each launches the kernel for a CUDA tensor and runs its plain twin
(:func:`update_plain`, :func:`update_step_plain`) for a CPU tensor — the
CPU is the only reason it takes the plain path; there is no switch and no
fallback. All update the registers in place. ``update.launches`` and
``update_step.launches`` count kernel launches. Each launch runs inside
the device observatory's wrapper (:mod:`zipkin_tpu_torch.obs.device`) under
``hll_update`` or ``hll_update_step``, which counts the same launches and
times each on the card with a pair of CUDA events.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from zipkin_tpu_torch import kernels, u32
from zipkin_tpu_torch.obs.device import OBSERVATORY
from zipkin_tpu_torch.ops.hashing import floor_log2

# update_step's scratch, as csrc/hll_update.cu lays it out: kScratchHeader
# u32 words (the barrier counters), then one u32 per register; each launch
# tags what it writes with 1 .. TAG_LIMIT - 1 (27 bits above rho's 5)
SCRATCH_HEADER = 32
TAG_LIMIT = 1 << 27


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


def update_step_plain(hll, tb_flat, hashes, svc, valid, tb_keep, slot, *,
                      max_services: int, hll_rows: int, global_row: int):
    """The step's four :func:`update_plain` calls, with the rows and masks
    of ``zipkin_tpu/tpu/ingest.py:77-82,116-122``; ``tb_flat`` (with
    ``tb_keep`` and ``slot``) is None when the time tier is off."""
    svc = svc.to(torch.int64)
    svc_rows = torch.clamp(svc, 0, max_services - 1)
    named = svc > 0
    update_plain(hll, svc_rows, hashes, valid & named)
    update_plain(hll, torch.full_like(svc_rows, global_row), hashes, valid)
    if tb_flat is not None:
        tt_rows = slot.to(torch.int64) * hll_rows
        update_plain(tb_flat, tt_rows + svc_rows, hashes, tb_keep & named)
        update_plain(tb_flat, tt_rows + global_row, hashes, tb_keep)
    return hll, tb_flat


_fn = {}  # the bound C entry points, loaded at the first launch
# (device, stream, file shapes) -> [u32 scratch, last tag]: launches that
# share a scratch run in order on one stream, and take their tags in that
# order (under _launch_lock: a launch zeroes the next tag's barrier counter)
_scratch = {}
_launch_lock = threading.Lock()


def _entry(name: str):
    if name not in _fn:
        lib = kernels.load("hll_update")
        fn = getattr(lib, name)
        if name == "hll_update":
            fn.argtypes = [ctypes.c_void_p] * 4 + [
                ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p
            ]
        else:
            fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_uint, ctypes.c_longlong] + [
                ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn[name] = fn
    return _fn[name]


def _precision(registers, what: str) -> int:
    """``p`` of a 2-D u8 register file the kernel can take; raises otherwise."""
    if registers.dtype != torch.uint8 or registers.dim() != 2:
        raise ValueError(f"{what}: registers must be a 2-D uint8 tensor")
    m = registers.shape[1]
    p = int(m).bit_length() - 1
    if m != 1 << p or not 2 <= p <= 30:
        raise ValueError(f"{what}: register width {m} is not 2**p, 2 <= p <= 30")
    if not registers.is_contiguous() or registers.data_ptr() % 4:
        raise ValueError(f"{what}: registers must be contiguous and 4-byte aligned")
    return p


def _check_lanes(what: str, dev, n: int, lanes) -> None:
    for name, t, dt in lanes:
        if t.device != dev:
            raise ValueError(f"{what}: {name} on {t.device}, registers on {dev}")
        if t.dtype != dt:
            raise ValueError(f"{what}: {name} must be {dt}, got {t.dtype}")
        if t.dim() != 1 or t.shape[0] != n or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be a contiguous [{n}] vector")


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
    p = _precision(registers, "hll update")
    n = row_ids.shape[0]
    _check_lanes("hll update", registers.device, n, (
        ("row_ids", row_ids, torch.int32), ("hashes", hashes, torch.int32),
        ("valid", valid, torch.bool)))
    if n == 0:
        return registers
    _launch_update_observed(registers, row_ids, hashes, valid, n, p)
    update.launches += 1
    return registers


update.launches = 0


def _builds() -> int:
    return kernels.BUILDS.get("hll_update", 0)


def _launch_update(registers, row_ids, hashes, valid, n: int, p: int) -> None:
    # the launch goes to the current device: make it the registers' (a
    # shard of a mesh over several cards may live on another)
    with torch.cuda.device(registers.device):
        err = _entry("hll_update")(
            registers.data_ptr(), row_ids.data_ptr(), hashes.data_ptr(), valid.data_ptr(),
            n, registers.shape[0], p, torch.cuda.current_stream(registers.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"hll_update kernel launch failed: CUDA error {err}")


_launch_update_observed = OBSERVATORY.wrap("hll_update", _launch_update, compile_probe=_builds)


def _scratch_and_tag(hll, tb_flat, stream: int):
    """The u32 scratch of these file shapes on this stream (zeroed when
    made) and the tag of the launch about to use it."""
    key = (hll.device, stream, tuple(hll.shape), None if tb_flat is None else tb_flat.shape[0])
    entry = _scratch.get(key)
    if entry is None:
        words = SCRATCH_HEADER + hll.numel() + (0 if tb_flat is None else tb_flat.numel())
        entry = _scratch[key] = [torch.zeros(words, dtype=torch.int32, device=hll.device), 0]
    entry[1] += 1
    if entry[1] >= TAG_LIMIT:  # a tag is about to repeat: start the scratch over
        entry[0].zero_()
        entry[1] = 1
    return key, entry[0], entry[1]


def check_step(hll, tb_flat, hashes, svc, valid, tb_keep, slot, *,
               max_services: int, hll_rows: int, global_row: int) -> int:
    """Everything :func:`update_step` requires of its inputs before it
    launches, checked in Python before any build; returns the number of
    time-tier slots (0 with the tier off). Raises ValueError."""
    what = "hll update_step"
    p = _precision(hll, what)
    dev = hll.device
    if not 1 <= max_services <= hll_rows or not 0 <= global_row < hll_rows:
        raise ValueError(f"{what}: need 1 <= max_services <= hll_rows and 0 <= global_row < hll_rows")
    if hll.shape[0] != hll_rows:
        raise ValueError(f"{what}: hll has {hll.shape[0]} rows, want hll_rows={hll_rows}")
    n = hashes.shape[0]
    lanes = [("hashes", hashes, torch.int32), ("svc", svc, torch.int32), ("valid", valid, torch.bool)]
    slots = 0
    if tb_flat is not None:
        if tb_flat.device != dev:
            raise ValueError(f"{what}: tb_flat on {tb_flat.device}, hll on {dev}")
        if _precision(tb_flat, what) != p:
            raise ValueError(f"{what}: tb_flat and hll have different register widths")
        if tb_flat.shape[0] % hll_rows:
            raise ValueError(f"{what}: tb_flat rows {tb_flat.shape[0]} are not slots x {hll_rows}")
        slots = tb_flat.shape[0] // hll_rows
        if slots > 256:
            raise ValueError(f"{what}: {slots} time-tier slots; the kernel reads u8 slots (<= 256)")
        lanes += [("tb_keep", tb_keep, torch.bool), ("slot", slot, torch.uint8)]
    elif tb_keep is not None or slot is not None:
        raise ValueError(f"{what}: tb_keep and slot need tb_flat")
    _check_lanes(what, dev, n, lanes)
    return slots


def update_step(hll, tb_flat, hashes, svc, valid, tb_keep, slot, *,
                max_services: int, hll_rows: int, global_row: int):
    """One launch that raises every HLL register of an ingest step.

    ``hll``: u8 ``[hll_rows, 2**p]``. ``tb_flat``: u8 ``[slots * hll_rows,
    2**p]`` (the time tier's flat view, already wiped), or None with the
    tier off. Lanes, each ``[n]``: ``hashes`` int32 (the u32 hash bits),
    ``svc`` int32, ``valid`` bool, ``tb_keep`` bool and ``slot`` u8 (None
    with the tier off). On a CUDA tensor everything must be on the same
    card in exactly these types (11 B a lane); the plain path also takes
    int64 ids. The kernel keeps a u32 scratch of one word per register
    (cached per device, stream and file shapes: 42 MB at the default
    config). Returns ``(hll, tb_flat)``.
    """
    kw = dict(max_services=max_services, hll_rows=hll_rows, global_row=global_row)
    if hll.device.type == "cpu":
        return update_step_plain(hll, tb_flat, hashes, svc, valid, tb_keep, slot, **kw)
    if hll.device.type != "cuda":
        raise ValueError(f"hll update_step: unsupported device {hll.device}")
    slots = check_step(hll, tb_flat, hashes, svc, valid, tb_keep, slot, **kw)
    n = hashes.shape[0]
    if n == 0:
        return hll, tb_flat
    _launch_step_observed(hll, tb_flat, hashes, svc, valid, tb_keep, slot, n, slots, **kw)
    update_step.launches += 1
    return hll, tb_flat


update_step.launches = 0


def _launch_step(hll, tb_flat, hashes, svc, valid, tb_keep, slot, n: int, slots: int, *,
                 max_services: int, hll_rows: int, global_row: int) -> None:
    fn = _entry("hll_update_step")
    stream = torch.cuda.current_stream(hll.device).cuda_stream
    ptr = lambda t: 0 if t is None else t.data_ptr()
    # the launch goes to the current device: make it the registers'
    with _launch_lock, torch.cuda.device(hll.device):
        key, scratch, tag = _scratch_and_tag(hll, tb_flat, stream)
        err = fn(
            hll.data_ptr(), ptr(tb_flat), hashes.data_ptr(), svc.data_ptr(), valid.data_ptr(),
            ptr(tb_keep), ptr(slot), scratch.data_ptr(), tag, n, max_services, hll_rows,
            global_row, slots, int(hll.shape[1]).bit_length() - 1, stream,
        )
        if err != 0:  # a launch that did not run leaves its barrier counter unset
            del _scratch[key]
    if err != 0:
        raise RuntimeError(f"hll_update_step kernel launch failed: CUDA error {err}")


_launch_step_observed = OBSERVATORY.wrap("hll_update_step", _launch_step, compile_probe=_builds)
