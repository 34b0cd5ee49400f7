"""Incremental link context (port of ``zipkin_tpu/ops/delta_linker.py``).

The persistent ctx over the 2n-lane join union is advanced at rollup
cadence; a fresh read sorts only the since-advance delta segment, maps
its runs onto the stored runs by binary search and resolves every
candidate by the doomed > safe > delta age-partition priority. The
reference's module docstring argues why that is exact; the port keeps
the algorithm step for step, with the stable multi-key sort as
:func:`zipkin_tpu_torch.u32.lexsort` and key comparisons on packed
int64 lanes (:func:`zipkin_tpu_torch.u32.pack_order_lanes`).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from zipkin_tpu_torch import u32
from zipkin_tpu_torch.device import resolve_device
from zipkin_tpu_torch.ops import linker
from zipkin_tpu_torch.ops.segments import segment_starts


class CtxStruct(NamedTuple):
    """Persistent ctx over the 2n-lane join union (n ring lanes)."""

    order: torch.Tensor     # [2n] union index at each sorted position
    keys: torch.Tensor      # [4, 2n] u32 sort-key snapshot per position
    rid_c: torch.Tensor     # [2n] coarse (trace, id) run id, 1-based
    rid_f: torch.Tensor     # [2n] fine (trace, id, svc) run id, 1-based
    inv: torch.Tensor       # [2n] sorted position of union entry u
    safe_sh: torch.Tensor   # [2n] run-broadcast first SAFE shared lane
    safe_ns: torch.Tensor   # [2n] ... first SAFE non-shared lane
    safe_fsh: torch.Tensor  # [2n] ... first SAFE shared lane, fine run
    pos: torch.Tensor       # [] ring cursor at the last advance
    delta: torch.Tensor     # [] lanes written since the last advance


def init_ctx(n: int, device=None) -> CtxStruct:
    """Ctx of an all-invalid ring: identity order, one run, no candidates
    (on the card unless ``device`` names another)."""
    u = 2 * n
    i64 = dict(dtype=torch.int64, device=resolve_device(device))
    return CtxStruct(
        order=torch.arange(u, **i64),
        keys=torch.full((4, u), u32.SENTINEL, **i64),
        rid_c=torch.ones(u, **i64),
        rid_f=torch.ones(u, **i64),
        inv=torch.arange(u, **i64),
        safe_sh=torch.full((u,), -1, **i64),
        safe_ns=torch.full((u,), -1, **i64),
        safe_fsh=torch.full((u,), -1, **i64),
        pos=torch.zeros((), **i64),
        delta=torch.zeros((), **i64),
    )


def _lower_bound(tbl, q, strict: bool = False) -> torch.Tensor:
    """Vectorized binary search: for each query key (parallel u32 lanes
    in ``q``) the leftmost index i in [0, len] with tbl[i] >= q (> q when
    ``strict``); ``tbl`` lanes lex-sorted. ceil(log2(len))+1 fixed passes,
    comparing packed int64 lanes (same order as the u32 lanes)."""
    tp = u32.pack_order_lanes(tbl)
    qp = u32.pack_order_lanes(q)
    size = int(tbl[0].shape[0])
    m = q[0].shape[0]
    dev = q[0].device
    lo = torch.zeros(m, dtype=torch.int64, device=dev)
    hi = torch.full((m,), size, dtype=torch.int64, device=dev)
    for _ in range(max(size.bit_length(), 1)):
        mid = (lo + hi) >> 1
        mi = torch.clamp(mid, 0, size - 1)
        t = [lane[mi] for lane in tp]
        go_right = ~u32.lex_lt(qp, t) if strict else u32.lex_lt(t, qp)
        act = lo < hi
        lo = torch.where(act & go_right, mid + 1, lo)
        hi = torch.where(act & ~go_right, mid, hi)
    return lo


def _resolve_core(x: linker.LinkInput, cs: CtxStruct, seg: int):
    """Delta machinery shared by the fresh read and the advance."""
    n = x.valid.shape[0]
    u = 2 * n
    dev = x.valid.device
    apos = cs.pos
    # host invariant: at most one rollup segment between advances
    delta = torch.clamp(cs.delta, 0, seg)
    lane_all = torch.arange(n, dtype=torch.int64, device=dev)

    # ---- the delta segment: the only sorted piece, width 2*seg --------
    j = torch.arange(seg, dtype=torch.int64, device=dev)
    dlane = (apos + j) % n
    live_j = j < delta

    def g(col):
        return col[dlane]

    sub = linker.LinkInput(
        trace_h=g(x.trace_h), tl0=g(x.tl0), tl1=g(x.tl1),
        s0=g(x.s0), s1=g(x.s1), p0=g(x.p0), p1=g(x.p1),
        shared=g(x.shared), kind=g(x.kind), svc=g(x.svc),
        rsvc=g(x.rsvc), err=g(x.err), valid=g(x.valid) & live_j,
    )
    d_id, d_svc, d_hasp = linker.union_key_lanes(sub)
    suid = u32.lexsort(d_id + [d_svc])
    dkeys = [d_id[0][suid], d_id[1][suid], d_id[2][suid], d_svc[suid]]
    sk3 = dkeys[3]
    sj = suid % seg
    s_isq = suid >= seg
    slane = dlane[sj]
    s_live = live_j[sj]
    s_sh = sub.shared[sj]
    s_tbl_valid = ~s_isq & sub.valid[sj]
    s_q_valid = s_isq & d_hasp[sj]
    s_entry_valid = s_tbl_valid | s_q_valid

    dcoarse = linker._run_starts(dkeys[:3])
    dfine = dcoarse | segment_starts(sk3)
    drid_c = torch.cumsum(dcoarse.to(torch.int64), 0)
    drid_f = torch.cumsum(dfine.to(torch.int64), 0)

    # ---- map delta runs onto stored runs (binary search) ---------------
    skeys = [cs.keys[0], cs.keys[1], cs.keys[2], cs.keys[3]]
    p3 = _lower_bound(skeys[:3], dkeys[:3])
    p4 = _lower_bound(skeys, dkeys)
    p3c = torch.clamp(p3, 0, u - 1)
    p4c = torch.clamp(p4, 0, u - 1)
    m3 = (p3 < u) & u32.lex_eq([a[p3c] for a in skeys[:3]], dkeys[:3])
    m4 = (p4 < u) & u32.lex_eq([a[p4c] for a in skeys], dkeys)
    rid_c_old = torch.where(m3, cs.rid_c[p3c], 0)
    rid_f_old = torch.where(m4, cs.rid_f[p4c], 0)

    tsz = u + 2 * seg + 1
    rid_c_ext = torch.where(m3, rid_c_old, u + drid_c)
    rid_f_ext = torch.where(m4, rid_f_old, u + drid_f)
    bigj = 2 * seg

    def dmin(guard, rid):
        t = torch.full((tsz,), bigj, dtype=torch.int64, device=dev)
        return t.scatter_reduce_(0, rid, torch.where(guard, sj, bigj), "amin")

    dl_sh = dmin(s_tbl_valid & s_sh, rid_c_ext)
    dl_ns = dmin(s_tbl_valid & ~s_sh, rid_c_ext)
    dl_fsh = dmin(s_tbl_valid & s_sh, rid_f_ext)

    # ---- doomed window: first still-alive candidate per stored run -----
    a = torch.arange(seg, dtype=torch.int64, device=dev)
    alane = (apos + a) % n
    aalive = (a >= delta) & x.valid[alane]
    apos_tbl = cs.inv[alane]
    arc = cs.rid_c[apos_tbl]
    arf = cs.rid_f[apos_tbl]
    ash = x.shared[alane]
    biga = seg

    def amin(guard, rid):
        t = torch.full((u + 1,), biga, dtype=torch.int64, device=dev)
        return t.scatter_reduce_(0, rid, torch.where(guard, a, biga), "amin")

    dm_sh = amin(aalive & ash, arc)
    dm_ns = amin(aalive & ~ash, arc)
    dm_fsh = amin(aalive & ash, arf)

    def pick(dmv, safe, dlv):
        # alive doomed (oldest) > stored safe (middle) > delta (newest)
        return torch.where(
            dmv < biga, (apos + dmv) % n,
            torch.where(safe >= 0, safe,
                        torch.where(dlv < bigj, (apos + dlv) % n, -1)),
        )

    def prefer(c_sh, c_ns, c_fsh, is_table, qshf, svc_key):
        prim_ok = c_ns >= 0
        prim_svc = x.svc[torch.where(prim_ok, c_ns, 0)]
        prim_match = prim_ok & (prim_svc == svc_key)
        byp = c_ns
        byp = torch.where(c_sh >= 0, c_sh, byp)
        byp = torch.where(prim_match, c_ns, byp)
        byp = torch.where(c_fsh >= 0, c_fsh, byp)
        return torch.where(is_table | qshf, c_ns, byp)

    # ---- surviving stored entries (full-width elementwise only) --------
    ou = cs.order
    o_lane = torch.where(ou < n, ou, ou - n)
    o_isq = ou >= n
    o_age = (o_lane - apos) % n
    o_alive = o_age >= delta
    o_csh = pick(dm_sh[cs.rid_c], cs.safe_sh, dl_sh[cs.rid_c])
    o_cns = pick(dm_ns[cs.rid_c], cs.safe_ns, dl_ns[cs.rid_c])
    o_cfsh = pick(dm_fsh[cs.rid_f], cs.safe_fsh, dl_fsh[cs.rid_f])
    o_qsh = o_isq & x.shared[o_lane] & x.valid[o_lane]
    o_comb = prefer(o_csh, o_cns, o_cfsh, ~o_isq, o_qsh, cs.keys[3])

    # ---- delta entries --------------------------------------------------
    d_csh = pick(dm_sh[rid_c_old], torch.where(m3, cs.safe_sh[p3c], -1), dl_sh[rid_c_ext])
    d_cns = pick(dm_ns[rid_c_old], torch.where(m3, cs.safe_ns[p3c], -1), dl_ns[rid_c_ext])
    d_cfsh = pick(dm_fsh[rid_f_old], torch.where(m4, cs.safe_fsh[p4c], -1), dl_fsh[rid_f_ext])
    d_qsh = s_isq & s_sh & sub.valid[sj]
    d_comb = prefer(d_csh, d_cns, d_cfsh, ~s_isq, d_qsh, sk3)

    # ---- un-scatter: stored entries first, delta overwrites its lanes --
    # one spare slot at index u takes the dropped (non-live) delta entries
    un = torch.full((u + 1,), -1, dtype=torch.int64, device=dev)
    un[ou] = torch.where(o_alive, o_comb, -1)
    d_union_idx = torch.where(s_isq, n + slane, slane)
    un[torch.where(s_live, d_union_idx, u)] = torch.where(s_entry_valid, d_comb, -1)
    un = un[:u]

    # ---- finish exactly as resolve_parents ------------------------------
    has_parent = ((x.p0 | x.p1) != 0) & x.valid
    sharedv = x.valid & x.shared
    j_shared = torch.where(sharedv, un[:n], -1)
    q = torch.where(has_parent, un[n:], -1)
    parent = torch.where(sharedv, torch.where(j_shared >= 0, j_shared, q), q)
    parent = torch.where(parent == lane_all, -1, parent)
    parent = torch.where(x.valid, parent, -1)

    return dict(
        parent=parent, has_child=linker._has_child(parent),
        dkeys=dkeys, s_isq=s_isq, s_live=s_live, slane=slane,
        o_alive=o_alive, apos=apos, delta=delta,
    )


def delta_resolve(x: linker.LinkInput, cs: CtxStruct, seg: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(parent, has_child) — identical to linker.resolve_parents over the
    same ring, paying only the since-advance delta."""
    core = _resolve_core(x, cs, seg)
    return core["parent"], core["has_child"]


def delta_link_context(x: linker.LinkInput, cs: CtxStruct, seg: int) -> linker.LinkContext:
    """The fresh-read link context via the delta formulation."""
    core = _resolve_core(x, cs, seg)
    anc, root_ok = linker.chase_ancestors(core["parent"], torch.where(x.valid, x.kind, 0))
    return linker.apply_rules(x, core["parent"], core["has_child"], anc, root_ok)


def advance(x: linker.LinkInput, cs: CtxStruct, seg: int):
    """Advance the persistent ctx over the since-last-advance delta.

    Returns (new_ctx, ctx_parent, ctx_anc, ctx_root, link_context)."""
    n = x.valid.shape[0]
    u = 2 * n
    dev = x.valid.device
    core = _resolve_core(x, cs, seg)
    parent, has_child = core["parent"], core["has_child"]
    apos, delta = core["apos"], core["delta"]
    npos = (apos + delta) % n

    # ---- stable merge of delta entries into the surviving order ---------
    alive = core["o_alive"]
    placed = core["s_live"]
    zero = torch.zeros(1, dtype=torch.int64, device=dev)
    ac = torch.cumsum(alive.to(torch.int64), 0)
    ac_pad = torch.cat([zero, ac])
    pc = torch.cumsum(placed.to(torch.int64), 0)
    pc_pad = torch.cat([zero, pc])

    skeys = [cs.keys[0], cs.keys[1], cs.keys[2], cs.keys[3]]
    dkeys = core["dkeys"]
    # equal keys tie old-before-delta on both sides of the merge
    lbd = _lower_bound(dkeys, skeys)
    pos_old = (ac - 1) + pc_pad[lbd]
    lbo = _lower_bound(skeys, dkeys, strict=True)
    pos_delta = ac_pad[lbo] + (pc - placed.to(torch.int64))

    d_union_idx = torch.where(core["s_isq"], n + core["slane"], core["slane"])
    new_order = torch.zeros(u + 1, dtype=torch.int64, device=dev)  # slot u: dropped
    new_order[torch.where(alive, pos_old, u)] = cs.order
    new_order[torch.where(placed, pos_delta, u)] = d_union_idx
    new_order = new_order[:u]

    # ---- rebuild keys / runs / inverse from the current ring ------------
    f_id, f_svc, _ = linker.union_key_lanes(x)
    nk = [f_id[0][new_order], f_id[1][new_order], f_id[2][new_order], f_svc[new_order]]
    ncoarse = linker._run_starts(nk[:3])
    nfine = ncoarse | segment_starts(nk[3])
    nrid_c = torch.cumsum(ncoarse.to(torch.int64), 0)
    nrid_f = torch.cumsum(nfine.to(torch.int64), 0)
    ninv = torch.zeros(u, dtype=torch.int64, device=dev)
    ninv[new_order] = torch.arange(u, dtype=torch.int64, device=dev)

    # ---- safe candidates for the next doom window -----------------------
    n_lane = torch.where(new_order < n, new_order, new_order - n)
    n_isq = new_order >= n
    n_age = (n_lane - npos) % n
    n_tbl_valid = ~n_isq & x.valid[n_lane]
    n_sh = x.shared[n_lane]

    def smin(guard, rid):
        t = torch.full((u + 1,), n, dtype=torch.int64, device=dev)
        t.scatter_reduce_(0, rid, torch.where(guard & (n_age >= seg), n_age, n), "amin")
        v = t[rid]
        return torch.where(v < n, (npos + v) % n, -1)

    new_cs = CtxStruct(
        order=new_order,
        keys=torch.stack(nk),
        rid_c=nrid_c, rid_f=nrid_f, inv=ninv,
        safe_sh=smin(n_tbl_valid & n_sh, nrid_c),
        safe_ns=smin(n_tbl_valid & ~n_sh, nrid_c),
        safe_fsh=smin(n_tbl_valid & n_sh, nrid_f),
        pos=npos.to(torch.int64),
        delta=torch.zeros((), dtype=torch.int64, device=dev),
    )

    anc, root_ok = linker.chase_ancestors(parent, torch.where(x.valid, x.kind, 0))
    ctx = linker.apply_rules(x, parent, has_child, anc, root_ok)
    return new_cs, parent, anc, root_ok, ctx
