"""Windowed dependency linking (port of ``zipkin_tpu/ops/linker.py``).

Same algorithm as the reference over a columnar span window of ``[n]``
tensors: parent resolution by one sort of the 2n-lane join union
(table half keyed by own (trace, span-id), query half by (trace,
parent-id)), per-run first-wins candidates, has-child marks, nearest RPC
ancestor by pointer doubling, the vectorized DependencyLinker rules, and
a scatter-add of edges into ``[S, S]`` call/error matrices.

Torch idiom where the reference leans on XLA:

- the 4-key stable ``lax.sort`` becomes :func:`zipkin_tpu_torch.u32.lexsort`
  (two chained stable sorts of packed keys, the union index as the final
  tie-break — the same permutation XLA's stable sort gives);
- per-run minima broadcast by a scatter-min on the run id and a gather
  (the reference's shift-doubling ladder computes the same values);
- the convergence-bounded ``lax.while_loop`` of :func:`chase_ancestors`
  is one launch of a hand kernel (:mod:`zipkin_tpu_torch.ops.chase_kernel`)
  that tests convergence and counts passes on the card, with the same pass
  cap; no pass reads a value back to the host.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from zipkin_tpu_torch import u32
from zipkin_tpu_torch.ops import chase_kernel
from zipkin_tpu_torch.ops.segments import segment_starts


KIND_NONE, KIND_CLIENT, KIND_SERVER, KIND_PRODUCER, KIND_CONSUMER = range(5)


class LinkInput(NamedTuple):
    """Columnar span window; u32 lanes are int64 in [0, 2**32)."""

    trace_h: torch.Tensor
    tl0: torch.Tensor
    tl1: torch.Tensor
    s0: torch.Tensor
    s1: torch.Tensor
    p0: torch.Tensor
    p1: torch.Tensor
    shared: torch.Tensor  # bool
    kind: torch.Tensor  # int64 KIND_*
    svc: torch.Tensor  # int64 local service id (0 = unknown)
    rsvc: torch.Tensor  # int64 remote service id
    err: torch.Tensor  # bool
    valid: torch.Tensor  # bool
    # insertion sequence (a permutation of [0, n), lower = earlier);
    # None = lane order
    seq: Optional[torch.Tensor] = None


def _run_starts(key_lanes: Sequence[torch.Tensor]) -> torch.Tensor:
    n = key_lanes[0].shape[0]
    change = torch.zeros(n, dtype=torch.bool, device=key_lanes[0].device)
    change[:1].fill_(True)  # a stored scalar would wait for the stream
    for lane in key_lanes:
        change = change | segment_starts(lane)
    return change


def _segment_min(values: torch.Tensor, run_id: torch.Tensor, none: int) -> torch.Tensor:
    """Min of ``values`` over each run id, broadcast back to every lane."""
    size = values.shape[0] + 2  # run ids are cumsums: at most n (+1-based)
    seg = torch.full((size,), none, dtype=values.dtype, device=values.device)
    seg.scatter_reduce_(0, run_id, values, "amin", include_self=True)
    return seg[run_id]


def _run_min_ladder(channel_runs, none: int):
    """Segmented run-min broadcast of each ``(values, run_id)`` channel;
    -1 for runs without a candidate. Same values as the reference's
    shift-doubling ladder (a run's min is order-free)."""
    out = []
    for v, rid in channel_runs:
        m = _segment_min(v, rid, none)
        out.append(torch.where(m >= none, -1, m))
    return out


def union_key_lanes(x: LinkInput):
    """The four u32 sort-key lanes of the 2n-lane join union (table half
    then query half), invalid lanes keyed 0xFFFFFFFF."""
    has_parent = ((x.p0 | x.p1) != 0) & x.valid
    anyvalid = torch.cat([x.valid, has_parent])

    def lane(t, q):
        return torch.where(anyvalid, torch.cat([t.to(u32.DTYPE), q.to(u32.DTYPE)]),
                           u32.SENTINEL)

    id_lanes = [
        lane(x.trace_h, x.trace_h),
        lane(x.s0, x.p0),
        lane(x.s1, x.p1),
    ]
    svc_lane = lane(x.svc, x.svc)
    return id_lanes, svc_lane, has_parent


def _seg_min_scan(vals: torch.Tensor, flags: torch.Tensor, reverse: bool = False) -> torch.Tensor:
    """Segmented inclusive min scan over contiguous runs (reset where
    ``flags``). Each run is lifted by an offset that falls run by run, so
    one global ``cummin`` never carries a value across a reset."""
    if reverse:
        vals, flags = torch.flip(vals, [0]), torch.flip(flags, [0])
    rid = torch.cumsum(flags.to(torch.int64), 0)
    if vals.numel():
        # the value range stays on the device: no host round trip per scan
        wide = vals.to(torch.int64)
        lift = (rid[-1] - rid) * (wide.max() - wide.min() + 1)
    else:
        lift = rid
    out = torch.cummin(vals.to(torch.int64) + lift, 0).values - lift
    out = out.to(vals.dtype)
    return torch.flip(out, [0]) if reverse else out


def _run_min_bcast(vals, starts, none: int):
    """Per-run min broadcast by a forward and a backward segmented scan;
    -1 for absent runs."""
    ends = torch.cat([starts[1:], torch.ones(1, dtype=torch.bool, device=starts.device)])
    fwd = _seg_min_scan(vals, starts)
    bwd = _seg_min_scan(vals, ends, reverse=True)
    out = torch.minimum(fwd, bwd)
    return torch.where(out >= none, -1, out)


def resolve_parents(x: LinkInput) -> Tuple[torch.Tensor, torch.Tensor]:
    """Tree edges from id joins: (parent_row [n], -1 for roots; has_child
    [n] bool). One stable sort of the 2n-lane union, per-run first-wins
    candidates in insertion order, SpanNode._choose_parent's preference
    chain evaluated in sorted space, one unsort."""
    n = x.valid.shape[0]
    dev = x.valid.device
    has_parent = ((x.p0 | x.p1) != 0) & x.valid
    nonshared = x.valid & ~x.shared
    sharedv = x.valid & x.shared
    q_valid = has_parent

    id_lanes, svc_lane, _ = union_key_lanes(x)

    idx = torch.arange(n, dtype=torch.int64, device=dev)
    seq = idx if x.seq is None else x.seq.to(torch.int64)
    rank_to_idx = torch.zeros(n, dtype=torch.int64, device=dev)
    rank_to_idx[seq] = idx
    sent = 2 * n
    far = torch.full((n,), sent, dtype=torch.int64, device=dev)
    val_sh = torch.cat([torch.where(sharedv, seq, sent), far])
    val_ns = torch.cat([torch.where(nonshared, seq, sent), far])
    qsh = torch.cat([torch.zeros(n, dtype=torch.bool, device=dev), sharedv])

    # zt-lint: disable=ZT07 — fresh entrypoints reach this only through dependency_links' ctx=None fallback, which they never take (they always pass the delta ctx from fresh_link_context); the full-ring sort runs at rollup cadence / cold rebuilds only
    sord = u32.lexsort(id_lanes + [svc_lane])
    s_ids = [lane[sord] for lane in id_lanes]
    s_svc, sh_s, ns_s, s_qsh = svc_lane[sord], val_sh[sord], val_ns[sord], qsh[sord]

    coarse = _run_starts(s_ids)
    fine = coarse | segment_starts(s_svc)
    rid_c = torch.cumsum(coarse.to(torch.int64), 0)
    rid_f = torch.cumsum(fine.to(torch.int64), 0)
    r_sh_any, r_ns_any, r_sh_fine = _run_min_ladder(
        [(sh_s, rid_c), (ns_s, rid_c), (sh_s, rid_f)], sent
    )

    primary = r_ns_any
    p_idx = rank_to_idx[torch.where(primary >= 0, primary, 0)]
    primary_svc = x.svc[p_idx].to(u32.DTYPE)
    primary_matches = (primary >= 0) & (primary_svc == s_svc)
    by_parent_id = primary
    by_parent_id = torch.where(r_sh_any >= 0, r_sh_any, by_parent_id)
    by_parent_id = torch.where(primary_matches, primary, by_parent_id)
    by_parent_id = torch.where(r_sh_fine >= 0, r_sh_fine, by_parent_id)

    is_table = sord < n
    combined = torch.where(is_table | s_qsh, r_ns_any, by_parent_id)

    inv = torch.zeros(2 * n, dtype=torch.int64, device=dev)
    inv[sord] = combined
    un = torch.where(inv >= 0, rank_to_idx[torch.where(inv >= 0, inv, 0)], -1)

    j_shared = torch.where(sharedv, un[:n], -1)
    q = torch.where(q_valid, un[n:], -1)
    parent = torch.where(sharedv, torch.where(j_shared >= 0, j_shared, q), q)
    parent = torch.where(parent == idx, -1, parent)
    parent = torch.where(x.valid, parent, -1)
    return parent, _has_child(parent)


def _has_child(parent: torch.Tensor) -> torch.Tensor:
    """[n] bool: some lane names this lane as its parent."""
    kids = torch.zeros(parent.shape[0], dtype=torch.int64, device=parent.device)
    kids.index_add_(0, torch.where(parent >= 0, parent, 0), (parent >= 0).to(torch.int64))
    return kids > 0


def chase_ancestors(parent: torch.Tensor, kind: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both pointer-doubling chases in one convergence-bounded loop:
    (anc [n] — nearest strict ancestor with a kind, else -1; root_ok [n]
    bool — the parent chain terminates at a root). Capped at
    ``chase_kernel.doubling_passes(n)`` so parent cycles terminate; capped
    cyclic lanes end mid-cycle, never at the sentinel, so root_ok stays
    False. One launch of :func:`chase_kernel.chase` on the card."""
    return chase_kernel.chase(parent.to(torch.int64).contiguous(), kind.to(torch.int64).contiguous())


def reaches_root(parent: torch.Tensor) -> torch.Tensor:
    _, ok = chase_ancestors(parent, torch.zeros_like(parent))
    return ok


def nearest_rpc_ancestor(parent: torch.Tensor, kind: torch.Tensor) -> torch.Tensor:
    anc, _ = chase_ancestors(parent, kind)
    return anc


class LinkContext(NamedTuple):
    """Window-independent per-lane edge candidates of a span window."""

    par_svc: torch.Tensor  # main edge parent service (post rule 6)
    child_svc: torch.Tensor  # main edge child service
    ok: torch.Tensor  # bool — main edge passes every non-window rule
    err: torch.Tensor  # bool — ok and the span carries an error tag
    anc_svc: torch.Tensor  # nearest RPC ancestor service
    local: torch.Tensor  # local service (rule 6b child)
    back: torch.Tensor  # bool — rule 6b backfill passes non-window rules


def link_context(x: LinkInput) -> LinkContext:
    """All link rules except the time window, from scratch (the oracle
    the incremental delta path must match)."""
    parent, has_child = resolve_parents(x)
    anc, root_ok = chase_ancestors(parent, torch.where(x.valid, x.kind, 0))
    return apply_rules(x, parent, has_child, anc, root_ok)


def apply_rules(x: LinkInput, parent, has_child, anc, root_ok) -> LinkContext:
    """The elementwise DependencyLinker rules over a resolved tree."""
    anc_svc = torch.where(anc >= 0, x.svc[torch.where(anc >= 0, anc, 0)], 0)
    local, remote = x.svc, x.rsvc
    kind = x.kind

    # rule 1: client span with children defers to its server half;
    # spans in parent cycles never emit
    live = x.valid & root_ok
    live = live & ~((kind == KIND_CLIENT) & has_child)
    # rule 2: kindless spans with both sides known act like clients
    keff = torch.where((kind == KIND_NONE) & (local > 0) & (remote > 0), KIND_CLIENT, kind)
    live = live & (keff != KIND_NONE)

    is_server_like = (keff == KIND_SERVER) | (keff == KIND_CONSUMER)
    par_svc = torch.where(is_server_like, remote, local)
    child_svc = torch.where(is_server_like, local, remote)

    # rule 3: root server with unknown caller
    live = live & ~((keff == KIND_SERVER) & (parent < 0) & (remote == 0))

    is_messaging = (keff == KIND_PRODUCER) | (keff == KIND_CONSUMER)
    # rule 5: messaging needs both sides known
    live = live & ~(is_messaging & ((par_svc == 0) | (child_svc == 0)))

    # rule 6: RPC spans resolve the parent via the nearest RPC ancestor
    is_rpc = (keff == KIND_CLIENT) | (keff == KIND_SERVER)
    use_anc = is_rpc & (anc_svc > 0) & ((keff == KIND_SERVER) | (par_svc == 0))
    par_svc = torch.where(use_anc, anc_svc, par_svc)

    main_ok = live & (par_svc > 0) & (child_svc > 0)

    # rule 6b: client whose service differs from its RPC ancestor
    back_ok = live & (keff == KIND_CLIENT) & (local > 0) & (anc_svc > 0) & (anc_svc != local)
    return LinkContext(
        par_svc=par_svc, child_svc=child_svc, ok=main_ok,
        err=main_ok & x.err, anc_svc=anc_svc, local=local, back=back_ok,
    )


def link_edges(x: LinkInput, emit: Optional[torch.Tensor] = None):
    if emit is None:
        emit = x.valid
    ctx = link_context(x)
    return (
        ctx.par_svc, ctx.child_svc, ctx.ok & emit, ctx.err & emit,
        ctx.anc_svc, ctx.local, ctx.back & emit,
    )


def emit_links(ctx: LinkContext, emit: torch.Tensor, num_services: int):
    """Scatter a context's edges for the lanes in ``emit`` into
    ``[S, S]`` u32 (int64) call and error matrices."""
    calls, errors = emit_links_bucketed(
        ctx, torch.zeros_like(ctx.par_svc), 1, emit, num_services
    )
    return calls[0], errors[0]


def link_window(x: LinkInput, num_services: int, emit=None):
    if emit is None:
        emit = x.valid
    return emit_links(link_context(x), emit, num_services)


def link_window_bucketed(x: LinkInput, num_services: int, slot, num_slots: int, emit):
    return emit_links_bucketed(link_context(x), slot, num_slots, emit, num_services)


def emit_links_bucketed(ctx: LinkContext, slot, num_slots: int, emit, num_services: int):
    """Each emitting lane scatters its edges into time bucket ``slot[i]``:
    ``[D, S, S]`` call and error matrices (counts < 2**32 per call)."""
    s = num_services
    dev = ctx.par_svc.device
    d = torch.clamp(slot.to(torch.int64), 0, num_slots - 1)
    pc = torch.clamp(ctx.par_svc, 0, s - 1)
    cc = torch.clamp(ctx.child_svc, 0, s - 1)
    bc = torch.clamp(ctx.anc_svc, 0, s - 1)
    lc = torch.clamp(ctx.local, 0, s - 1)
    calls = torch.zeros(num_slots * s * s, dtype=u32.DTYPE, device=dev)
    errors = torch.zeros_like(calls)
    main = (d * s + pc) * s + cc
    calls.index_add_(0, main, (ctx.ok & emit).to(u32.DTYPE))
    errors.index_add_(0, main, (ctx.err & emit).to(u32.DTYPE))
    calls.index_add_(0, (d * s + bc) * s + lc, (ctx.back & emit).to(u32.DTYPE))
    return calls.view(num_slots, s, s), errors.view(num_slots, s, s)
