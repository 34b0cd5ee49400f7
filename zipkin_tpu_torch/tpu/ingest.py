"""The ingest step, maintenance and reads over :class:`AggState`
(port of ``zipkin_tpu/tpu/ingest.py``).

The reference's pure functions become functions that update the state
IN PLACE and return it: every leaf a step, a flush or a rollup changes is
written into the tensor the state already holds (``copy_``, ``add_``,
scatters), never swapped for a new one. The sketch planes, ring columns
and pending buffer are hundreds of MB at the default config, and a copy
per step would double the traffic; and a CUDA graph that captured a step
(:mod:`zipkin_tpu_torch.tpu.graphs`) replays the addresses it captured, so
a leaf swapped for a new tensor would leave the next replay reading a
stale one. Reads never mutate.

The step is static-shape as the reference's is: the live count stays on
the device (``valid.sum()``) and the ring append takes every lane of the
batch, pad lanes dropped (:func:`zipkin_tpu_torch.ops.ring_kernel.append`),
so one captured graph serves every batch of a lane count.

The HLL registers of a step (per service and global, in ``hll`` and in
the time tier's ``tb_hll``) are raised by one launch,
:func:`zipkin_tpu_torch.ops.hll.update_step`, over the lane columns
:func:`hll_lanes` builds.

With ``config.sampling`` the step also scores every lane with
:func:`zipkin_tpu_torch.sampling.device.device_verdict`, records the
verdict in ``r_keep`` in the ring append's own order and counts kept and
dropped spans in counter slots 5/6; with it off those stay untouched.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from zipkin_tpu_torch import u32
from zipkin_tpu_torch.ops import delta_linker, hashing, histogram, hll, linker, ring_kernel, tdigest
from zipkin_tpu_torch.sampling.device import device_verdict
from zipkin_tpu_torch.tpu.columnar import SpanColumns
from zipkin_tpu_torch.tpu.state import (
    CTR_BATCHES,
    CTR_ERRORS,
    CTR_SAMPLED_DROPPED,
    CTR_SAMPLED_KEPT,
    CTR_SPANS,
    CTR_WITH_DURATION,
    NUM_COUNTERS,
    AggConfig,
    AggState,
)

RING_COLUMNS = (
    "trace_h", "tl0", "tl1", "s0", "s1", "p0", "p1", "shared", "kind",
    "svc", "rsvc", "err", "ts_min", "valid",
)


def lane_bucket(lanes: int, pad_to_multiple: int, cap: int) -> int:  # zt-dispatch-critical: shape-bucket pick on the coalesced dispatch path
    """Static-shape bucket for a coalesced multi-chunk lane count: the
    doubling ladder ``pad * 2^k`` capped at the aggregator's lane cap."""
    b = max(1, int(pad_to_multiple))
    while b < lanes:  # zt-lint: disable=ZT09 — doubling ladder: ≤ log2(cap/pad)+1 trips, independent of span count
        b *= 2
    return min(b, cap) if cap >= lanes else b


def ingest_step(config: AggConfig, state: AggState, batch: SpanColumns) -> AggState:  # zt-device: batch — the unpacked wire image, tensors on the card  # zt-in-place: state — every leaf the step changes is written in place
    """Fold one unpacked batch (torch columns) into the state in place and
    return it. The digest append needs ``pend_pos + n <= digest_buffer``
    (n the batch's lanes) — the aggregator keeps that invariant and an
    index past the buffer raises on the CPU (the reference's
    dynamic_update_slice would clamp the start instead)."""
    valid = batch.valid
    dev = valid.device
    live = valid.sum()

    # --- latency sketches per (service, spanName) key -------------------
    has_dur = valid & batch.has_dur
    histogram.update(state.hist, batch.key, batch.dur, has_dur)
    state.hist_t_epoch.copy_(_hist_slice_update(config, state, batch, has_dur))
    _digest_append(config, state, batch.key, batch.dur.to(torch.float32), has_dur, batch.ts_min)

    # --- time-disaggregated current-bucket leaves ------------------------
    lanes, tb_epoch, tb_wipe = hll_lanes(config, state.tb_epoch, batch)
    tb_flat = None
    if config.timetier_enabled:
        state.tb_hll.masked_fill_(tb_wipe[:, None, None], 0)
        tb_flat = state.tb_hll.view(config.time_buckets * config.hll_rows, -1)
        state.tb_digest.masked_fill_(tb_wipe[:, None, None, None], 0.0)
        state.tb_calls.masked_fill_(tb_wipe[:, None, None], 0)
        state.tb_errs.masked_fill_(tb_wipe[:, None, None], 0)
        state.tb_epoch.copy_(tb_epoch)

    # --- HLL: distinct traces per service + globally, and per time bucket:
    # one launch for all four register targets
    hll.update_step(state.hll, tb_flat, **lanes, max_services=config.max_services,
                    hll_rows=config.hll_rows, global_row=config.global_hll_row)

    # --- tail-sampling verdicts: the ring's lanes in the append's order
    keep = None
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    kept = dropped = zero
    if config.sampling:
        keep = device_verdict(
            batch.trace_h, batch.svc, batch.rsvc, batch.key,
            batch.dur, batch.has_dur, batch.err, valid,
            state.s_rate, state.s_tail, state.s_link, config.sample_rare_min,
        )
        kept = keep.sum()
        dropped = live - kept

    # --- ring append: the valid lanes in order from the cursor, pads
    # dropped; the cursor advances by the live count
    ring = [getattr(state, f"r_{name}") for name in RING_COLUMNS]
    new = [getattr(batch, name) for name in RING_COLUMNS]
    if keep is not None:
        ring.append(state.r_keep)
        new.append(keep)
    ring.append(state.r_rolled)
    new.append(None)  # appended lanes are not rolled up yet
    ring_kernel.append(ring, new, valid, state.ring_pos)
    state.ring_pos.add_(live).remainder_(config.ring_capacity)
    state.ctx_delta.add_(live)

    add = [zero] * NUM_COUNTERS
    add[CTR_SPANS] = live
    add[CTR_WITH_DURATION] = has_dur.sum()
    add[CTR_ERRORS] = (valid & batch.err).sum()
    add[CTR_BATCHES] = torch.ones((), dtype=torch.int64, device=dev)
    if config.sampling:
        add[CTR_SAMPLED_KEPT] = kept
        add[CTR_SAMPLED_DROPPED] = dropped
    state.counters.add_(torch.stack(add)).bitwise_and_(u32.MASK)
    return state


def hll_lanes(config: AggConfig, tb_epoch, batch: SpanColumns):  # zt-device: batch — the step's columns on the card
    """The lane columns of the step's one HLL update in the form the kernel
    reads (``hashes`` the u32 hash bits as int32, ``svc`` int32, ``valid``,
    and with the time tier ``tb_keep`` and the u8 ``slot``), then the time
    tier's recycled epochs and wipe mask (the caller wipes): ``(lanes,
    tb_epoch, tb_wipe)``, the last two None with the tier off."""
    valid = batch.valid
    lanes = dict(hashes=u32.bits32(hashing.fmix32(batch.trace_h)),
                 svc=batch.svc.to(torch.int32), valid=valid, tb_keep=None, slot=None)
    if not config.timetier_enabled:
        return lanes, None, None
    w_tt = config.time_buckets
    ep_tt = batch.ts_min // config.time_bucket_minutes
    sl_tt = ep_tt % w_tt
    tb_epoch, tb_wipe, lanes["tb_keep"] = _recycle_slots(w_tt, tb_epoch, sl_tt, ep_tt, valid)
    # the kernel reads u8 slots; more than 256 slots stay int64 (CPU only)
    lanes["slot"] = sl_tt.to(torch.uint8) if w_tt <= 256 else sl_tt
    return lanes, tb_epoch, tb_wipe


def _recycle_slots(num_slots: int, stored_epoch, slot, ep, active):
    """Epoch-ring slot management: (new_epoch [D], wipe [D], keep [n])."""
    slot_ep = torch.full((num_slots,), -1, dtype=torch.int64, device=slot.device)
    slot_ep.scatter_reduce_(0, slot, torch.where(active, ep, -1), "amax")
    new_epoch = torch.maximum(stored_epoch, slot_ep)
    wipe = slot_ep > stored_epoch
    keep = active & (ep == new_epoch[slot])
    return new_epoch, wipe, keep


def _slots_in_window(epoch, lo_unit, hi_unit):
    return (epoch >= 0) & (epoch >= lo_unit) & (epoch <= hi_unit)


def _masked_slot_sum(sel, arr):
    """u32 sum of ``arr`` [D, ...] over the slots selected by ``sel``."""
    view = (-1,) + (1,) * (arr.dim() - 1)
    return u32.wrap(torch.where(sel.view(view), arr, 0).sum(0))


def _hist_slice_update(config: AggConfig, state: AggState, batch, has_dur):
    """Fold durations into the time-sliced histograms in place; returns
    the new slice epochs."""
    t = config.hist_slices
    ep = batch.ts_min // config.hist_slice_minutes
    sl = ep % t
    new_epoch, wipe, ok = _recycle_slots(t, state.hist_t_epoch, sl, ep, has_dur)
    state.hist_t.masked_fill_(wipe[:, None, None], 0)
    b = histogram.bucket_of(batch.dur)
    k = torch.clamp(batch.key, 0, config.max_keys - 1)
    flat = (sl * config.max_keys + k) * histogram.BUCKETS + b
    u32.index_add_(state.hist_t.view(-1), flat, ok.to(torch.int64))
    return new_epoch


def _flush_pending_digest(config: AggConfig, digest, pend_key, pend_val):
    w = (pend_key >= 0).to(torch.float32)
    keys = torch.clamp(pend_key, 0, config.max_keys - 1)
    partial = tdigest.compact_points(keys, pend_val, w, config.max_keys, config.digest_centroids)
    return tdigest.row_merge(digest, partial)


def _digest_append(config: AggConfig, state: AggState, key, val, has_dur, ts_min=None) -> None:
    """Write the batch's (key, value) points at ``pend_pos`` and advance it,
    in place. Needs pend_pos + n <= digest_buffer (the reference's
    dynamic_update_slice would clamp the start and overwrite the buffer
    tail; here an index past the end raises on the CPU, and on the card
    would write past the buffer: the aggregator flushes first)."""
    n = key.shape[0]
    idx = state.pend_pos + torch.arange(n, dtype=torch.int64, device=key.device)
    batch_key = torch.where(has_dur, torch.clamp(key, 0, config.max_keys - 1), -1)
    state.pend_key.index_copy_(0, idx, batch_key)
    state.pend_val.index_copy_(0, idx, val)
    if config.timetier_enabled and ts_min is not None:
        ep = ts_min // config.time_bucket_minutes
        state.pend_ep.index_copy_(0, idx, torch.where(has_dur, ep, -1))
    state.pend_pos.add_(n)


def _flush_pending_tt(config: AggConfig, tb_epoch, tb_digest, pend_key, pend_val, pend_ep):
    """Fold the pending points into their bucket slots' compact digests."""
    w_tt = config.time_buckets
    k = config.max_keys
    cw = config.time_digest_centroids
    sl = torch.where(pend_ep >= 0, pend_ep % w_tt, 0)
    live = (pend_ep >= 0) & (pend_key >= 0) & (tb_epoch[sl] == pend_ep)
    w = live.to(torch.float32)
    keys = torch.clamp(pend_key, 0, k - 1)
    partial = tdigest.compact_points(sl * k + keys, pend_val, w, w_tt * k, cw)
    merged = tdigest.row_merge(tb_digest.reshape(w_tt * k, cw, 2), partial)
    return merged.reshape(w_tt, k, cw, 2)


def flush_digest(config: AggConfig, state: AggState) -> AggState:  # zt-in-place: state — the digests and the emptied pending buffer are written in place
    """Fold every pending value into the digests and empty the buffer, in
    place; returns the state."""
    d = _flush_pending_digest(config, state.digest, state.pend_key, state.pend_val)
    if config.timetier_enabled:
        state.tb_digest.copy_(_flush_pending_tt(
            config, state.tb_epoch, state.tb_digest,
            state.pend_key, state.pend_val, state.pend_ep,
        ))
        state.pend_ep.fill_(-1)
    state.digest.copy_(d)
    state.pend_key.fill_(-1)
    state.pend_val.zero_()
    state.pend_pos.zero_()
    return state


def ring_link_input(state: AggState) -> linker.LinkInput:
    """The retention ring as a link window; ``seq`` is the age since the
    cursor (the cursor's own lane is the oldest live span)."""
    r = state.r_valid.shape[0]
    lane = torch.arange(r, dtype=torch.int64, device=state.r_valid.device)
    return linker.LinkInput(
        trace_h=state.r_trace_h, tl0=state.r_tl0, tl1=state.r_tl1,
        s0=state.r_s0, s1=state.r_s1, p0=state.r_p0, p1=state.r_p1,
        shared=state.r_shared, kind=state.r_kind,
        svc=state.r_svc, rsvc=state.r_rsvc, err=state.r_err,
        valid=state.r_valid,
        seq=(lane - state.ring_pos) % r,
    )


def ctx_struct(state: AggState) -> delta_linker.CtxStruct:
    return delta_linker.CtxStruct(
        order=state.ctx_order, keys=state.ctx_keys,
        rid_c=state.ctx_rid_c, rid_f=state.ctx_rid_f, inv=state.ctx_inv,
        safe_sh=state.ctx_safe_sh, safe_ns=state.ctx_safe_ns,
        safe_fsh=state.ctx_safe_fsh,
        pos=state.ctx_pos, delta=state.ctx_delta,
    )


def fresh_link_context(config: AggConfig, state: AggState) -> linker.LinkContext:
    """The fresh-read link context: persistent ctx + since-advance delta."""
    return delta_linker.delta_link_context(
        ring_link_input(state), ctx_struct(state), config.rollup_segment
    )


def rollup_step(config: AggConfig, state: AggState) -> AggState:  # zt-in-place: state — the rollup matrices, the rolled flags and the ctx leaves are written in place
    """Link the half-ring the cursor overwrites next, fold its edges into
    the per-time-bucket rollup matrices, mark those lanes rolled, and
    advance the incremental link ctx (one resolve serves both), in place;
    returns the state."""
    x = ring_link_input(state)
    to_roll = state.r_valid & ~state.r_rolled & (x.seq < config.rollup_segment)

    bucket_abs = state.r_ts_min // config.bucket_minutes
    d = config.link_buckets
    slot = bucket_abs % d
    new_epoch, wipe, emit = _recycle_slots(d, state.rollup_epoch, slot, bucket_abs, to_roll)

    cs, parent, anc, root_ok, ctx = delta_linker.advance(x, ctx_struct(state), config.rollup_segment)
    calls_d, errs_d = linker.emit_links_bucketed(ctx, slot, d, emit, config.max_services)
    state.rollup_calls.masked_fill_(wipe[:, None, None], 0)
    state.rollup_errs.masked_fill_(wipe[:, None, None], 0)
    state.rollup_calls.add_(calls_d).bitwise_and_(u32.MASK)
    state.rollup_errs.add_(errs_d).bitwise_and_(u32.MASK)
    if config.timetier_enabled:
        w_tt = config.time_buckets
        ep_tt = state.r_ts_min // config.time_bucket_minutes
        sl_tt = ep_tt % w_tt
        emit_tt = to_roll & (state.tb_epoch[sl_tt] == ep_tt)
        calls_tt, errs_tt = linker.emit_links_bucketed(ctx, sl_tt, w_tt, emit_tt, config.max_services)
        state.tb_calls.add_(calls_tt).bitwise_and_(u32.MASK)
        state.tb_errs.add_(errs_tt).bitwise_and_(u32.MASK)
    state.r_rolled.logical_or_(to_roll)
    state.rollup_epoch.copy_(new_epoch)
    for leaf, value in ((state.ctx_order, cs.order), (state.ctx_keys, cs.keys),
                        (state.ctx_rid_c, cs.rid_c), (state.ctx_rid_f, cs.rid_f),
                        (state.ctx_inv, cs.inv), (state.ctx_safe_sh, cs.safe_sh),
                        (state.ctx_safe_ns, cs.safe_ns), (state.ctx_safe_fsh, cs.safe_fsh),
                        (state.ctx_parent, parent), (state.ctx_anc, anc),
                        (state.ctx_root, root_ok), (state.ctx_pos, cs.pos),
                        (state.ctx_delta, cs.delta)):
        leaf.copy_(value)
    return state


def rolled_links(config: AggConfig, state: AggState, ts_lo: int, ts_hi: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(calls, errors) [S, S] u32 from the rollup buckets in the window."""
    lo_b = ts_lo // config.bucket_minutes
    hi_b = ts_hi // config.bucket_minutes
    sel = _slots_in_window(state.rollup_epoch, lo_b, hi_b)
    return _masked_slot_sum(sel, state.rollup_calls), _masked_slot_sum(sel, state.rollup_errs)


def dependency_links(config: AggConfig, state: AggState, ts_lo: int, ts_hi: int,
                     ctx: Optional[linker.LinkContext] = None):
    """(calls, errors) [S, S] u32 over [ts_lo, ts_hi] epoch minutes:
    live-ring links merged with the rolled-up buckets in the window.
    Without ``ctx`` the from-scratch link context is built."""
    if ctx is None:
        # zt-lint: disable=ZT07 — dead branch on the fresh path: spmd_edges_fresh always passes the delta ctx (fresh_link_context); this fallback serves warm-read/test callers where the full rebuild is the point
        ctx = linker.link_context(ring_link_input(state))
    in_window = (state.r_ts_min >= ts_lo) & (state.r_ts_min <= ts_hi)
    calls, errors = linker.emit_links(ctx, state.r_valid & ~state.r_rolled & in_window,
                                      config.max_services)
    rc, re = rolled_links(config, state, ts_lo, ts_hi)
    return u32.wrap(calls + rc), u32.wrap(errors + re)


def key_quantiles(state: AggState, qs: torch.Tensor) -> torch.Tensor:
    """[keys, Q] latency quantiles from the histograms."""
    return histogram.quantile(state.hist, qs)


def key_quantiles_digest(state: AggState, qs: torch.Tensor) -> torch.Tensor:
    """[keys, Q] latency quantiles from the t-digests (tighter tails)."""
    return tdigest.quantile(state.digest, qs)


def cardinalities(state: AggState) -> torch.Tensor:
    """[services+1] estimated distinct traces (last row = global)."""
    return hll.estimate(state.hll)


def tt_sketches(config: AggConfig, state: AggState, lo_ep: int, hi_ep: int,
                ctx: Optional[linker.LinkContext] = None):
    """The time-tier slots whose bucket epoch lies in ``[lo_ep, hi_ep]``
    as one mergeable part: ``(epoch [W], regs [S+1, m] u8, digest
    [K, Cw, 2] f32, calls [S, S], errs [S, S])`` — the slot epochs, the
    register-max over the selected slots, one row-parallel recluster of
    their compact digests, and the edges split as in
    :func:`dependency_links`: un-rolled ring lanes whose bucket epoch is
    in the range emit through ``ctx`` (built fresh without one), rolled
    lanes come from the ``tb_calls`` / ``tb_errs`` planes."""
    sel = _slots_in_window(state.tb_epoch, lo_ep, hi_ep)
    regs = torch.where(sel[:, None, None], state.tb_hll, 0).amax(0)
    d = state.tb_digest  # [W, K, Cw, 2]
    w_tt, k, cw, _ = d.shape
    dm = torch.stack([d[..., 0], torch.where(sel[:, None, None], d[..., 1], 0.0)], dim=-1)
    all_c = dm.movedim(0, 1).reshape(k, w_tt * cw, 2)
    digest = tdigest.row_merge(torch.zeros((k, cw, 2), dtype=torch.float32, device=d.device), all_c)
    if ctx is None:
        ctx = fresh_link_context(config, state)
    ep_lane = state.r_ts_min // config.time_bucket_minutes
    in_w = (ep_lane >= lo_ep) & (ep_lane <= hi_ep)
    live_c, live_e = linker.emit_links(ctx, state.r_valid & ~state.r_rolled & in_w,
                                       config.max_services)
    calls = u32.wrap(live_c + _masked_slot_sum(sel, state.tb_calls))
    errs = u32.wrap(live_e + _masked_slot_sum(sel, state.tb_errs))
    return state.tb_epoch, regs, digest, calls, errs


def windowed_hist(config: AggConfig, state: AggState, ts_lo: int, ts_hi: int) -> torch.Tensor:
    """[keys, BUCKETS] histogram over the slices intersecting the window."""
    lo_e = ts_lo // config.hist_slice_minutes
    hi_e = ts_hi // config.hist_slice_minutes
    sel = _slots_in_window(state.hist_t_epoch, lo_e, hi_e)
    return _masked_slot_sum(sel, state.hist_t)
