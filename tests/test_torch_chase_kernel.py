"""The hand kernels' plain twins on the CPU: ``ops/chase_kernel.py``
(the chase's ``lax.while_loop``) and ``ops/ring_kernel.py`` (the ring
append's drop scatter) against the JAX package's programs they replace.

The CUDA kernels themselves run only on the card (``chip_smoke.py`` phase
p1 holds each against its twin there); here the twins are held bit for bit
against ``zipkin_tpu.ops.linker.chase_ancestors`` and the reference's
``col.at[pos].set(new[order], mode="drop")``, and the wrappers' checks,
constants and CPU routing are pinned.
"""

from __future__ import annotations

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.torch_cpu  # noqa: F401  (one intra-op thread a test process)
from zipkin_tpu.ops import linker as jlinker
from zipkin_tpu_torch.ops import chase_kernel, hll_kernel, linker, ring_kernel

CSRC = Path(__file__).resolve().parents[1] / "zipkin_tpu_torch" / "csrc"
_j_chase = jax.jit(jlinker.chase_ancestors)


def _forest(rng, n: int, shape: str):
    """(parent, kind) int64 numpy: a random forest (parents earlier in the
    window), chains ``depth`` deep, or a forest with 3-cycles and one long
    ring (malformed parent cycles: the chase runs to its cap)."""
    idx = np.arange(n)
    parent = np.where(rng.random(n) < 0.15, -1, (rng.random(n) * idx).astype(np.int64))
    parent[0] = -1
    if shape.startswith("chains"):
        depth = int(shape.split("_")[1])
        parent = np.where(idx % depth == 0, -1, idx - 1)
    elif shape == "cycles":
        for a in range(5, n - 3, 97):
            parent[a], parent[a + 1], parent[a + 2] = a + 1, a + 2, a
        ring = n // 8
        parent[n // 2:n // 2 + ring] = n // 2 + (np.arange(ring) + 1) % ring
    elif shape == "roots":
        parent[:] = -1
    kind = np.where(rng.random(n) < 0.3, rng.integers(1, 5, n), 0)
    return parent.astype(np.int64), kind.astype(np.int64)


def _passes(parent: np.ndarray, kind: np.ndarray) -> int:
    """The reference's loop count, in numpy: passes up to and including
    the first that changes nothing, at most ceil(log2(n+1))."""
    n = parent.shape[0]
    par = np.append(np.where(parent >= 0, parent, n), n)
    jump = np.where(np.append(kind, 0) != 0, np.arange(n + 1), par)
    root = par.copy()
    ran, cap = 0, max(n.bit_length(), 1)
    while ran < cap:
        j2, r2 = jump[jump], root[root]
        ran += 1
        if np.array_equal(j2, jump) and np.array_equal(r2, root):
            break
        jump, root = j2, r2
    return ran


@pytest.mark.parametrize("n,shape", [
    (1, "forest"), (2, "roots"), (257, "forest"), (1024, "chains_200"), (1024, "chains_1024"),
    (2048, "cycles"), (4096, "forest"),
])
def test_chase_plain_equals_the_references_while_loop(n, shape):
    rng = np.random.default_rng(n + len(shape))
    parent, kind = _forest(rng, n, shape)
    ja, jr = _j_chase(jnp.asarray(parent.astype(np.int32)), jnp.asarray(kind.astype(np.int32)))
    passes = torch.zeros((), dtype=torch.int32)
    anc, ok = chase_kernel.chase_plain(torch.from_numpy(parent), torch.from_numpy(kind), passes)
    np.testing.assert_array_equal(anc.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jr))
    assert int(passes) == _passes(parent, kind)
    if shape == "cycles":
        assert int(passes) == chase_kernel.doubling_passes(n)


def test_chase_on_the_cpu_is_its_plain_twin_and_counts_no_launch():
    rng = np.random.default_rng(3)
    parent, kind = (torch.from_numpy(a) for a in _forest(rng, 512, "forest"))
    before = chase_kernel.chase.launches
    got = chase_kernel.chase(parent, kind)
    want = chase_kernel.chase_plain(parent, kind)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert chase_kernel.chase.launches == before


def test_chase_ancestors_reads_nothing_back_to_the_host(monkeypatch):
    """The convergence test stays on the device: no ``.item()``, no
    tensor truth value, in the linker's chase and its two users."""
    rng = np.random.default_rng(5)
    parent, kind = (torch.from_numpy(a) for a in _forest(rng, 300, "cycles"))
    want = chase_kernel.chase_plain(parent, kind)

    def refuse(*_a, **_k):
        raise AssertionError("a device value was read back to the host")

    monkeypatch.setattr(torch.Tensor, "item", refuse)
    monkeypatch.setattr(torch.Tensor, "__bool__", refuse)
    anc, ok = linker.chase_ancestors(parent, kind)
    roots = linker.reaches_root(parent)
    nearest = linker.nearest_rpc_ancestor(parent, kind)
    monkeypatch.undo()
    assert torch.equal(anc, want[0]) and torch.equal(ok, want[1])
    assert torch.equal(nearest, want[0])
    assert torch.equal(roots, chase_kernel.chase_plain(parent, torch.zeros_like(parent))[1])


def test_chase_refuses_what_the_kernel_cannot_take():
    meta = torch.empty(4, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        chase_kernel.chase(meta, meta)


def _reference_put(ring: np.ndarray, new: np.ndarray, valid: np.ndarray, ring_pos: int) -> np.ndarray:
    """The reference's append of one column (zipkin_tpu/tpu/ingest.py:138-151)."""
    n, cap = valid.shape[0], ring.shape[0]
    order = jnp.argsort(~jnp.asarray(valid))
    live = jnp.sum(jnp.asarray(valid).astype(jnp.int32))
    lane = jnp.arange(n, dtype=jnp.int32)
    pos = jnp.where(lane < live, (ring_pos + lane) % cap, cap)
    return np.asarray(jnp.asarray(ring).at[pos].set(jnp.asarray(new)[order], mode="drop"))


@pytest.mark.parametrize("pattern,start", [
    ("full", 0), ("all_pad", 37), ("pads_in_the_middle", 100), ("ring_wrap", 230), ("trailing_pads", 255),
])
def test_ring_append_plain_equals_the_references_drop_scatter(pattern, start):
    rng = np.random.default_rng(len(pattern) * 7 + start)
    cap, n = 256, 96
    valid = {"full": np.ones(n, bool), "all_pad": np.zeros(n, bool),
             "pads_in_the_middle": np.r_[np.ones(30, bool), np.zeros(36, bool), rng.random(30) < 0.5],
             "ring_wrap": rng.random(n) < 0.8,
             "trailing_pads": np.arange(n) < 70}[pattern]
    cols = [rng.integers(0, 1 << 32, cap, dtype=np.int64), rng.random(cap) < 0.5,
            rng.integers(0, 1 << 32, cap, dtype=np.int64)]
    lanes = [rng.integers(0, 1 << 32, n, dtype=np.int64), rng.random(n) < 0.5, None]
    ring = [torch.from_numpy(c.copy()) for c in cols]
    ring_kernel.append(ring, [None if x is None else torch.from_numpy(x) for x in lanes],
                       torch.from_numpy(valid), torch.tensor(start))
    for got, col, new in zip(ring, cols, lanes):
        new = np.zeros(n, col.dtype) if new is None else new
        want = _reference_put(col.astype(np.uint32) if col.dtype == np.int64 else col,
                              new.astype(np.uint32) if new.dtype == np.int64 else new, valid, start)
        np.testing.assert_array_equal(got.numpy(), want.astype(got.numpy().dtype))


def test_ring_append_checks_its_columns():
    cap, n = 64, 8
    ring = [torch.zeros(cap, dtype=torch.int64), torch.zeros(cap, dtype=torch.bool)]
    lanes = [torch.zeros(n, dtype=torch.int64), torch.zeros(n, dtype=torch.bool)]
    valid, pos = torch.ones(n, dtype=torch.bool), torch.zeros((), dtype=torch.int64)
    assert ring_kernel._check(ring, lanes, valid, pos) == cap
    with pytest.raises(ValueError, match="lane column 1"):
        ring_kernel._check(ring, [lanes[0], torch.zeros(n, dtype=torch.uint8)], valid, pos)
    with pytest.raises(ValueError, match="4-byte elements"):
        ring_kernel._check([torch.zeros(cap, dtype=torch.int32)], [None], valid, pos)
    with pytest.raises(ValueError, match="ring columns"):
        ring_kernel._check(ring * 9, lanes * 9, valid, pos)
    with pytest.raises(ValueError, match="lanes into a ring"):
        ring_kernel._check([torch.zeros(4, dtype=torch.int64)], [None], valid, pos)
    with pytest.raises(ValueError, match="unsupported device"):
        ring_kernel.append(ring, lanes, valid.to("meta"), pos)


@pytest.mark.parametrize("source,pairs", [
    ("ring_append.cu", [("kMaxCols", ring_kernel.MAX_COLUMNS),
                        ("kTileLanes", ring_kernel.TILE_LANES), ("kMaxTiles", ring_kernel.MAX_TILES),
                        ("kHeaderWords", ring_kernel.HEADER_WORDS)]),
    ("link_chase.cu", [("kMaxPasses", chase_kernel.MAX_PASSES), ("kThreads", chase_kernel.THREADS),
                       ("kMaxOwned", chase_kernel.MAX_OWNED)]),
    ("hll_update.cu", [("kScratchHeader", hll_kernel.SCRATCH_HEADER), ("kTagWord", hll_kernel.TAG_WORD),
                       ("kTagLimit", hll_kernel.TAG_LIMIT)]),
])
def test_wrapper_constants_match_the_kernel_sources(source, pairs):
    # every single ``constexpr <type> kName = <expr>;`` at the source's
    # namespace scope, each evaluated with the ones before it
    text = (CSRC / source).read_text()
    known = {}
    for name, expr in re.findall(r"^constexpr \w+ (k\w+) = ([^;,=]+);", text, re.M):
        known[name] = eval(re.sub(r"(\d)u\b", r"\1", expr), {}, dict(known))  # noqa: S307
    for name, value in pairs:
        assert name in known, name
        assert known[name] == value, (name, known[name])
