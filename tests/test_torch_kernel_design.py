"""The design of the two hand kernels for the reference's XLA programs,
emulated in numpy on the CPU (the CUDA kernels run only on the card, where
``chip_smoke.py`` phase p1 holds each against its plain twin):

- ``csrc/link_chase.cu`` keeps each lane's pointers in registers and skips
  a lane's gathers and stores once a gather returned the value it holds
  (it points at a fixed point of ``x -> x[x]``). The emulation runs the
  kernel's passes, double buffers and skip rule and is held to the
  reference's ``chase_ancestors`` loop: equal ``anc``, ``root_ok`` and
  pass counts on forests, chains, cycles and drawn parent arrays, and no
  skipped lane would have changed had it run;
- ``csrc/ring_append.cu``'s tiled path ranks each tile with a block scan
  and finds its base by decoupled look-back over its predecessors' status
  words, 32 at a time, stopping at the nearest inclusive prefix. The
  emulation publishes the words in random orders and is held to the
  stable compaction the reference's ``argsort(~valid)`` gives.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import tests.torch_cpu  # noqa: F401  (one intra-op thread a test process)
from tests.test_torch_chase_kernel import _forest, _passes
from zipkin_tpu.ops import linker as jlinker
from zipkin_tpu_torch.ops import chase_kernel, ring_kernel

_j_chase = jax.jit(jlinker.chase_ancestors)


def emulate_chase(parent: np.ndarray, kind: np.ndarray):
    """``link_chase``'s passes in numpy: (anc, root_ok, passes). Asserts,
    every pass, that a lane the kernel skips would not have changed and
    that both buffers hold its value."""
    n = parent.shape[0]
    lanes = n + 1
    par = np.append(np.where(parent >= 0, parent, n), n)
    kind_x = np.append(kind, 0)
    idx = np.arange(lanes)
    # pass 0 gathers from parent and kind themselves: parent[p] for every
    # lane, kind[p] for a kindless one (p its parent or the sentinel)
    kinded = kind_x != 0
    j = np.where(kinded, idx, par)
    r = par.copy()
    parent_x = np.append(parent, -1)
    gp = np.where(par < n, parent_x[par], -1)
    gk = np.where(~kinded & (par < n), kind_x[par], 0)
    r2 = np.where(gp >= 0, gp, n)
    j2 = np.where(kinded, idx, np.where(gk != 0, par, r2))
    buf_j = [np.full(lanes, -7), np.full(lanes, -7)]  # never-written cells
    buf_r = [np.full(lanes, -7), np.full(lanes, -7)]
    moving_j, moving_r = j2 != j, r2 != r
    changed = bool(moving_j.any() or moving_r.any())
    buf_j[0][:] = j2
    buf_r[0][:] = r2
    buf_j[1][~moving_j] = j2[~moving_j]  # converged: both buffers hold it
    buf_r[1][~moving_r] = r2[~moving_r]
    j, r = j2, r2
    ran, cur, cap = 1, 0, chase_kernel.doubling_passes(n)
    while changed and ran < cap:
        jc, rc = buf_j[cur], buf_r[cur]
        # what the reference's pass computes for every lane
        full_j, full_r = jc[jc], rc[rc]
        assert np.array_equal(jc, j) and np.array_equal(rc, r)
        assert np.array_equal(full_j[~moving_j], j[~moving_j])
        assert np.array_equal(full_r[~moving_r], r[~moving_r])
        assert np.array_equal(buf_j[cur ^ 1][~moving_j], j[~moving_j])
        assert np.array_equal(buf_r[cur ^ 1][~moving_r], r[~moving_r])
        gj = np.where(moving_j, jc[j], j)
        gr = np.where(moving_r, rc[r], r)
        changed = bool(((gj != j) & moving_j).any() or ((gr != r) & moving_r).any())
        buf_j[cur ^ 1][moving_j] = gj[moving_j]
        buf_r[cur ^ 1][moving_r] = gr[moving_r]
        moving_j &= gj != j
        moving_r &= gr != r
        j, r = gj, gr
        cur ^= 1
        ran += 1
    final = buf_j[cur]
    assert np.array_equal(final, j) and (final >= 0).all()
    a = final[par[:n]]
    anc = np.where((a == n) | (kind_x[a] == 0), -1, a)
    return anc, r[:n] == n, ran


def _reference(parent: np.ndarray, kind: np.ndarray):
    ja, jr = _j_chase(jnp.asarray(parent.astype(np.int32)), jnp.asarray(kind.astype(np.int32)))
    return np.asarray(ja), np.asarray(jr), _passes(parent, kind)


@pytest.mark.parametrize("n,shape", [
    (1, "forest"), (2, "roots"), (3, "forest"), (257, "forest"), (1024, "chains_200"),
    (1024, "chains_1024"), (2048, "cycles"), (4096, "forest"),
])
def test_the_chase_with_converged_lanes_skipped_equals_the_references_loop(n, shape):
    rng = np.random.default_rng(n * 7 + len(shape))
    parent, kind = _forest(rng, n, shape)
    anc, ok, ran = emulate_chase(parent, kind)
    want_anc, want_ok, want_ran = _reference(parent, kind)
    np.testing.assert_array_equal(anc, want_anc)
    np.testing.assert_array_equal(ok, want_ok)
    assert ran == want_ran
    if shape == "cycles":
        assert ran == chase_kernel.doubling_passes(n)


# a few window sizes, so the reference's jit compiles a few shapes
_SIZES = (1, 2, 5, 64, 700, 3000)


@st.composite
def _parents(draw):
    n = draw(st.sampled_from(_SIZES))
    seed = draw(st.integers(0, 2 ** 32 - 1))
    rng = np.random.default_rng(seed)
    mode = draw(st.sampled_from(["any", "earlier", "self_and_cycles"]))
    idx = np.arange(n)
    if mode == "any":  # any lane may name any other: cycles of every length
        parent = rng.integers(-1, n, n)
    elif mode == "earlier":  # a forest
        parent = np.where(rng.random(n) < 0.1, -1, (rng.random(n) * idx).astype(np.int64))
    else:
        parent = np.where(rng.random(n) < 0.5, idx, rng.integers(-1, n, n))
    kind = np.where(rng.random(n) < draw(st.floats(0.0, 1.0)), rng.integers(1, 5, n), 0)
    return parent.astype(np.int64), kind.astype(np.int64)


@settings(max_examples=60, deadline=None, database=None)
@given(_parents())
def test_the_skip_rule_holds_on_drawn_parent_arrays(case):
    parent, kind = case
    anc, ok, ran = emulate_chase(parent, kind)
    want_anc, want_ok, want_ran = _reference(parent, kind)
    np.testing.assert_array_equal(anc, want_anc)
    np.testing.assert_array_equal(ok, want_ok)
    assert ran == want_ran


def emulate_ring_ranks(valid: np.ndarray, tile: int, rng) -> np.ndarray:
    """Each valid lane's rank as ``ring_append``'s tiled path finds it: a
    tile's ranks from its scan, its base from a look-back over status
    words published in a random order (a tile publishes its count, looks
    back once every word it reads is there, then publishes its prefix)."""
    n = valid.shape[0]
    tiles = -(-n // tile)
    counts = [int(valid[t * tile:(t + 1) * tile].sum()) for t in range(tiles)]
    status = [None] * tiles  # ("count" | "prefix", value)
    base = [None] * tiles
    todo = list(range(tiles))
    published = set()
    while todo:
        t = todo.pop(int(rng.integers(0, len(todo))))
        if t not in published:
            status[t] = ("prefix", counts[t]) if t == 0 else ("count", counts[t])
            published.add(t)
            if t == 0:
                base[0] = 0
                continue
        # look back 32 at a time; a word not yet there: try again later
        before, hi, ready = 0, t - 1, True
        while hi >= 0:
            window = [status[j] for j in range(hi, max(hi - 32, -1), -1)]
            if any(w is None for w in window):
                ready = False
                break
            stop = next((i for i, w in enumerate(window) if w[0] == "prefix"), None)
            before += sum(w[1] for w in window[:len(window) if stop is None else stop + 1])
            if stop is not None:
                break
            hi -= 32
        if not ready:
            todo.append(t)
            continue
        base[t] = before
        status[t] = ("prefix", before + counts[t])
    ranks = np.full(n, -1)
    for t in range(tiles):
        lanes = np.flatnonzero(valid[t * tile:(t + 1) * tile]) + t * tile
        ranks[lanes] = base[t] + np.arange(lanes.size)
    return ranks


@pytest.mark.parametrize("n,pattern", [
    (1, "full"), (1025, "full"), (4096, "pads_in_the_middle"), (70000, "random"), (131072, "all_pad"),
    (40 * 1024 + 3, "sparse"),
])
def test_the_look_back_ranks_are_the_stable_compaction(n, pattern):
    rng = np.random.default_rng(n)
    valid = {"full": np.ones(n, bool), "all_pad": np.zeros(n, bool),
             "pads_in_the_middle": np.r_[np.ones(n // 3, bool), np.zeros(n // 3, bool),
                                         rng.random(n - 2 * (n // 3)) < 0.7],
             "random": rng.random(n) < 0.6, "sparse": rng.random(n) < 0.01}[pattern]
    ranks = emulate_ring_ranks(valid, ring_kernel.TILE_LANES, rng)
    order = np.argsort(~valid, kind="stable")  # the reference's argsort(~valid)
    want = np.full(n, -1)
    want[order[:valid.sum()]] = np.arange(valid.sum())
    np.testing.assert_array_equal(ranks, want)


def test_the_chase_refuses_lanes_its_int32_pointers_cannot_hold():
    chase_kernel.check_lanes((1 << 31) - 2)  # n + 1 = 2^31 - 1 fits
    with pytest.raises(ValueError, match="int32 pointers"):
        chase_kernel.check_lanes((1 << 31) - 1)
    with pytest.raises(ValueError, match="int32 pointers"):
        chase_kernel.check_lanes(1 << 40)
    with pytest.raises(ValueError, match="one launch holds"):
        chase_kernel.check_lanes(1 << 20, capacity=1 << 20)
    chase_kernel.check_lanes((1 << 20) - 1, capacity=1 << 20)


def test_the_ring_append_refuses_batches_past_its_status_words():
    import torch

    n = ring_kernel.TILE_LANES * ring_kernel.MAX_TILES + 1
    ring = [torch.zeros(n, dtype=torch.bool)]
    with pytest.raises(ValueError, match="the kernel takes"):
        ring_kernel._check(ring, [None], torch.zeros(n, dtype=torch.bool),
                           torch.zeros((), dtype=torch.int64))
