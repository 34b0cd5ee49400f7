"""The port's linker (zipkin_tpu_torch/ops/linker.py, delta_linker.py)
against the JAX package's on the CPU.

Inputs are the JAX package's own linker specs: the DependencyLinkerTest
edge-case matrix and fuzz generators of tests/test_ops_linker.py (their
trace lists are captured by standing in for that module's comparison
helpers), and the ingest/rollup interleaving fuzz of
tests/test_incremental_ctx.py. Every integer output is held bit-exact:
parents, has-child marks, ancestors, the LinkContext leaves, the edge
matrices and every ctx_* state leaf after each rollup. XLA's
``lax.sort`` is stable, so even ctx_order / ctx_inv (whose order inside
a run of equal keys is a free choice of the sort) must match exactly.
"""

from __future__ import annotations

import dataclasses
import random
import jax
import numpy as np
import pytest
import torch

import tests.test_ops_linker as ref_linker_tests
from tests.fixtures import lots_of_spans
import tests.torch_cpu  # noqa: F401  (one intra-op thread a test process)
from zipkin_tpu.ops import linker as jlinker
from zipkin_tpu.tpu import ingest as jing
from zipkin_tpu.tpu.columnar import Vocab, pack_spans
from zipkin_tpu.tpu.state import AggConfig as JConfig
from zipkin_tpu.tpu.state import init_state as jinit_state
from zipkin_tpu_torch import convert, u32
from zipkin_tpu_torch.ops import linker
from zipkin_tpu_torch.parallel.aggregator import unfuse_columns
from zipkin_tpu_torch.tpu import ingest as ing
from zipkin_tpu_torch.tpu.columnar import fuse_columns
from zipkin_tpu_torch.tpu.state import AggConfig, AggState


def _inputs(cols, seq=None):
    """(JAX LinkInput, port LinkInput) of one packed batch."""
    jx = jlinker.LinkInput(
        trace_h=cols.trace_h, tl0=cols.tl0, tl1=cols.tl1, s0=cols.s0, s1=cols.s1,
        p0=cols.p0, p1=cols.p1, shared=cols.shared, kind=cols.kind,
        svc=cols.svc, rsvc=cols.rsvc, err=cols.err, valid=cols.valid, seq=seq,
    )
    b = unfuse_columns(u32.from_numpy(fuse_columns(cols), "cpu"))
    px = linker.LinkInput(
        trace_h=b.trace_h, tl0=b.tl0, tl1=b.tl1, s0=b.s0, s1=b.s1, p0=b.p0, p1=b.p1,
        shared=b.shared, kind=b.kind, svc=b.svc, rsvc=b.rsvc, err=b.err, valid=b.valid,
        seq=None if seq is None else torch.from_numpy(seq.astype(np.int64)),
    )
    return jx, px


_j_resolve = jax.jit(jlinker.resolve_parents)
_j_chase = jax.jit(jlinker.chase_ancestors)
_j_context = jax.jit(jlinker.link_context)
_j_emit = jax.jit(jlinker.emit_links, static_argnums=2)
_j_emit_bucketed = jax.jit(jlinker.emit_links_bucketed, static_argnums=(2, 4))


def _eq(got: torch.Tensor, want, what: str) -> None:
    np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=what)


def assert_port_matches(traces) -> None:
    """Every stage of the from-scratch linker, port vs JAX, bit-exact."""
    spans = [s for t in traces for s in t]
    vocab = Vocab(max_services=256, max_keys=1024)
    cols = pack_spans(spans, vocab, pad_to_multiple=256)
    n = cols.size
    # a wrapped insertion order, as the ring view hands the linker
    seq = ((np.arange(n) - n // 3) % n).astype(np.int32)
    for s in (None, seq):
        jx, px = _inputs(cols, s)
        jp, jh = _j_resolve(jx)
        pp, ph = linker.resolve_parents(px)
        _eq(pp, jp, "parent")
        _eq(ph, jh, "has_child")
        kind = np.where(cols.valid, cols.kind, 0)
        ja, jr = _j_chase(jp, kind)
        pa, pr = linker.chase_ancestors(pp, torch.from_numpy(kind.astype(np.int64)))
        _eq(pa, ja, "anc")
        _eq(pr, jr, "root_ok")
        jc = _j_context(jx)
        pc = linker.link_context(px)
        for name, g, w in zip(jc._fields, pc, jc):
            _eq(g, w, f"LinkContext.{name}")
        emit = torch.from_numpy(cols.valid & (np.arange(n) % 3 != 0))
        for g, w in zip(linker.emit_links(pc, emit, 256),
                        _j_emit(jc, emit.numpy(), 256)):
            _eq(g, w, "edge matrix")
        slot = np.arange(n, dtype=np.int32) % 3
        for g, w in zip(
            linker.emit_links_bucketed(pc, torch.from_numpy(slot.astype(np.int64)), 3, emit, 256),
            _j_emit_bucketed(jc, slot, 3, emit.numpy(), 256),
        ):
            _eq(g, w, "bucketed edge matrix")


MATRIX = sorted(n for n in vars(ref_linker_tests.TestDeviceLinkerMatrix) if n.startswith("test_"))


@pytest.mark.parametrize("case", MATRIX)
def test_dependency_linker_matrix(case, monkeypatch):
    captured = []
    monkeypatch.setattr(ref_linker_tests, "assert_parity", lambda *t: captured.append(t))
    getattr(ref_linker_tests.TestDeviceLinkerMatrix(), case)()
    assert captured
    for traces in captured:
        assert_port_matches(traces)


@pytest.mark.parametrize("case,seed", [
    ("test_lots_of_spans_parity", 0), ("test_mixed_shapes_parity", 7),
    ("test_mixed_shapes_parity", 8),
])
def test_linker_fuzz(case, seed, monkeypatch):
    captured = []
    monkeypatch.setattr(ref_linker_tests, "device_links", lambda tl: captured.append(tl) or {})
    monkeypatch.setattr(ref_linker_tests, "host_links", lambda tl: {})
    getattr(ref_linker_tests.TestDeviceLinkerFuzz(), case)(seed)
    assert captured
    for traces in captured:
        assert_port_matches(traces)


def test_cycles_terminate_and_match():
    """Malformed parent cycles: the pass cap ends the chase; root_ok is
    False on the cycle, as in the reference."""
    parent = np.array([1, 2, 0, -1, 3, 4, 4], np.int32)
    kind = np.array([0, 1, 0, 2, 0, 1, 0], np.int32)
    ja, jr = jlinker.chase_ancestors(parent, kind)
    pa, pr = linker.chase_ancestors(torch.from_numpy(parent.astype(np.int64)),
                                    torch.from_numpy(kind.astype(np.int64)))
    _eq(pa, ja, "anc")
    _eq(pr, jr, "root_ok")


def test_run_min_helpers_match():
    rng = np.random.default_rng(2)
    ids = np.sort(rng.integers(0, 40, 300)).astype(np.uint32)
    vals = rng.integers(0, 50, 300).astype(np.int32)
    sent = 40
    starts = np.asarray(jlinker.segment_starts(ids))
    rid = np.cumsum(starts).astype(np.int32)
    t = lambda a: torch.from_numpy(a.astype(np.int64) if a.dtype != bool else a.copy())
    _eq(linker._run_min_bcast(t(vals), t(starts), sent),
        jax.jit(jlinker._run_min_bcast, static_argnums=2)(vals, starts, sent), "run_min_bcast")
    for rev in (False, True):
        _eq(linker._seg_min_scan(t(vals), t(starts), rev),
            jax.jit(jlinker._seg_min_scan, static_argnums=2)(vals, starts, rev), "seg_min_scan")
    (got,) = linker._run_min_ladder([(t(vals), t(rid))], sent)
    (want,) = jax.jit(jlinker._run_min_ladder, static_argnums=1)([(vals, rid)], sent)
    _eq(got, want, "run_min_ladder")


# ----------------------------------------------------------------------
# incremental ctx: ingest / rollup interleavings, port vs JAX
# ----------------------------------------------------------------------

CTX_LEAVES = [f for f in AggState._fields if f.startswith("ctx_")]


def _assert_state_leaves(pstate, jstate, names, where):
    pleaves = dict(zip(AggState._fields, convert.state_to_numpy([pstate])))
    for name in names:
        np.testing.assert_array_equal(
            pleaves[name], np.asarray(getattr(jstate, name))[None], err_msg=f"{name} {where}")


@pytest.mark.parametrize("seed,ring_pow", [(0, 6), (2, 7)])
def test_incremental_ctx_interleavings(seed, ring_pow):
    """The interleaving fuzz of tests/test_incremental_ctx.py run through
    both packages side by side: after every step and rollup the ring and
    ctx_* leaves are identical, and at sampled instants the fresh (delta)
    link context of the port equals the JAX one and the port's own
    from-scratch oracle."""
    jcfg = JConfig(max_services=64, max_keys=256, hll_precision=9,
                   digest_centroids=32, ring_capacity=1 << ring_pow)
    cfg = AggConfig(**dataclasses.asdict(jcfg))
    seg = cfg.rollup_segment
    vocab = Vocab(max_services=64, max_keys=256)
    cols = pack_spans(lots_of_spans(6 * (1 << ring_pow), seed=seed), vocab, pad_to_multiple=8)
    jstep = jax.jit(lambda s, b: jing.ingest_step(jcfg, s, b))
    jroll = jax.jit(lambda s: jing.rollup_step(jcfg, s))
    jfresh = jax.jit(lambda s: jing.fresh_link_context(jcfg, s))

    jstate = jinit_state(jcfg)
    (pstate,) = convert.state_from_numpy([np.asarray(a)[None] for a in jstate], cfg, device="cpu")
    rnd = random.Random(seed * 101 + 7)
    lo, since, checks = 0, 0, 0
    ring = [f for f in AggState._fields if f.startswith("r_")] + ["ring_pos"]
    while lo < cols.size:
        sz = rnd.choice([8, 16, 24, 32, seg // 2])
        sub = type(cols)(*(np.asarray(f[lo:lo + sz]) for f in cols))
        lo += sz
        lanes = sub.valid.shape[0]
        if since + lanes > seg:
            for _ in range(2 if rnd.random() < 0.25 else 1):  # incl. zero-delta advance
                jstate = jroll(jstate)
                pstate = ing.rollup_step(cfg, pstate)
                _assert_state_leaves(pstate, jstate, CTX_LEAVES + ["r_rolled"], f"after rollup at {lo}")
            since = 0
        jstate = jstep(jstate, sub)
        pstate = ing.ingest_step(cfg, pstate, unfuse_columns(u32.from_numpy(fuse_columns(sub), "cpu")))
        since += lanes
        _assert_state_leaves(pstate, jstate, ring + ["ctx_delta"], f"after step at {lo}")
        if rnd.random() < 0.35:
            got = ing.fresh_link_context(cfg, pstate)
            want = jfresh(jstate)
            oracle = linker.link_context(ing.ring_link_input(pstate))
            for name, g, w, o in zip(want._fields, got, want, oracle):
                _eq(g, w, f"fresh LinkContext.{name} at {lo}")
                _eq(g, o.numpy(), f"oracle LinkContext.{name} at {lo}")
            checks += 1
    assert checks >= 3
