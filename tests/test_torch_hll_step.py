"""The ingest step's fused HLL update (``hll_kernel.update_step``) against
the JAX package's four separate updates, on the CPU, on the same seeded
numpy inputs.

The JAX side is ``zipkin_tpu/tpu/ingest.py:77-82,116-122`` written out:
the time-tier wipe, then ``hll.update`` (and ``pallas_hll.update`` in the
Pallas interpreter) with the ingest step's rows and masks. Registers are
u8 and integer max is order-free, so they are held bit-exact.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.torch_cpu  # noqa: F401  (one intra-op thread a test process)
from zipkin_tpu.ops import hll as jhll
from zipkin_tpu.ops import pallas_hll
from zipkin_tpu_torch import kernels, u32
from zipkin_tpu_torch.ops import hll, hll_kernel

EDGE_U32 = np.array([0, 1, 2, 3, 0x7FFFFFFF, 1 << 31, (1 << 31) + 1,
                     0xFFFFFFFE, 0xFFFFFFFF], np.uint32)


def _lanes(seed: int, n: int, max_services: int, slots: int):
    """Lanes with svc 0, svc past max_services (clamped), invalid lanes,
    tb_keep false, every slot and the edge hashes."""
    rng = np.random.default_rng(seed)
    h = rng.integers(0, 1 << 32, n, dtype=np.uint32)
    h[:len(EDGE_U32)] = EDGE_U32
    svc = rng.integers(0, max_services + 4, n).astype(np.int32)
    svc[:4] = [0, max_services - 1, max_services, max_services + 3]
    valid = rng.random(n) < 0.85
    slot = rng.integers(0, max(slots, 1), n).astype(np.uint8)
    keep = valid & (rng.random(n) < 0.8)
    return h, svc, valid, keep, slot


def _start(seed: int, rows: int, p: int) -> np.ndarray:
    """Register files that are not empty, so the max is exercised."""
    rng = np.random.default_rng(seed + 100)
    return np.where(rng.random((rows, 1 << p)) < 0.3,
                    rng.integers(0, 34 - p, (rows, 1 << p)), 0).astype(np.uint8)


def _jax_step(update, hll0, tb0, wipe, h, svc, valid, keep, slot, s: int, r: int):
    """The reference's four updates with its rows and masks."""
    svc_rows = jnp.clip(svc, 0, s - 1)
    new = update(jnp.asarray(hll0), svc_rows, h, valid & (svc > 0))
    new = update(new, jnp.full(h.shape, s, jnp.int32), h, valid)
    if tb0 is None:
        return np.asarray(new), None
    tb = jnp.where(jnp.asarray(wipe)[:, None, None], jnp.uint8(0), jnp.asarray(tb0))
    sl = jnp.asarray(slot.astype(np.int32))
    flat = tb.reshape(tb.shape[0] * r, -1)
    flat = update(flat, sl * r + svc_rows, h, keep & (svc > 0))
    flat = update(flat, sl * r + s, h, keep)
    return np.asarray(new), np.asarray(flat.reshape(tb.shape))


CASES = [  # (max_services, precision, time_buckets, lanes)
    (5, 6, 3, 700), (7, 8, 4, 1500), (4, 7, 0, 600), (3, 6, 4, 257),
]


@pytest.mark.parametrize("reference", ["xla", "pallas"])
@pytest.mark.parametrize("s,p,w,n", CASES)
def test_update_step_matches_the_four_reference_updates(s, p, w, n, reference):
    r = s + 1
    update = jhll.update if reference == "xla" else (
        lambda *a: pallas_hll.update(*a, interpret=True))
    hll0 = _start(n, r, p)
    tb0 = _start(n + 1, w * r, p).reshape(w, r, -1) if w else None
    wipe = np.arange(w) % 2 == 0
    for seed in range(2):
        h, svc, valid, keep, slot = _lanes(seed, n, s, w)
        want_hll, want_tb = _jax_step(update, hll0, tb0, wipe, h, svc, valid, keep, slot, s, r)

        got_hll = torch.from_numpy(hll0.copy())
        tb_flat = None
        lanes = dict(hashes=u32.bits32(u32.from_numpy(h, "cpu")), svc=torch.from_numpy(svc),
                     valid=torch.from_numpy(valid), tb_keep=None, slot=None)
        if w:
            tb = torch.from_numpy(tb0.copy())
            tb.masked_fill_(torch.from_numpy(wipe)[:, None, None], 0)  # as ingest_step does
            tb_flat = tb.view(w * r, -1)
            lanes.update(tb_keep=torch.from_numpy(keep), slot=torch.from_numpy(slot))
        out = hll.update_step(got_hll, tb_flat, **lanes, max_services=s, hll_rows=r, global_row=s)
        assert out[0] is got_hll and out[1] is tb_flat  # in place
        np.testing.assert_array_equal(got_hll.numpy(), want_hll)
        if w:
            np.testing.assert_array_equal(tb.numpy(), want_tb)
        hll0 = want_hll
        tb0 = want_tb


def test_update_step_plain_takes_int64_ids_and_u32_values():
    """The plain twin also takes the wide forms (int64 svc and slot, u32
    hash values as int64) and gives the same registers."""
    s, p, w, n = 6, 7, 3, 900
    r = s + 1
    h, svc, valid, keep, slot = _lanes(5, n, s, w)
    narrow = (torch.zeros((r, 1 << p), dtype=torch.uint8), torch.zeros((w * r, 1 << p), dtype=torch.uint8))
    wide = (narrow[0].clone(), narrow[1].clone())
    kw = dict(max_services=s, hll_rows=r, global_row=s)
    hll_kernel.update_step_plain(*narrow, u32.bits32(u32.from_numpy(h, "cpu")), torch.from_numpy(svc),
                                 torch.from_numpy(valid), torch.from_numpy(keep),
                                 torch.from_numpy(slot), **kw)
    hll_kernel.update_step_plain(*wide, u32.from_numpy(h, "cpu"), torch.from_numpy(svc.astype(np.int64)),
                                 torch.from_numpy(valid), torch.from_numpy(keep),
                                 torch.from_numpy(slot.astype(np.int64)), **kw)
    assert int(narrow[0].sum()) > 0 and int(narrow[1].sum()) > 0
    for a, b in zip(narrow, wide):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def _good(n=8, rows=5, p=4, slots=2, device="cpu"):
    z = lambda dt: torch.zeros(n, dtype=dt, device=device)
    return dict(
        hll=torch.zeros((rows, 1 << p), dtype=torch.uint8, device=device),
        tb_flat=torch.zeros((slots * rows, 1 << p), dtype=torch.uint8, device=device),
        hashes=z(torch.int32), svc=z(torch.int32), valid=z(torch.bool),
        tb_keep=z(torch.bool), slot=z(torch.uint8),
    )


KW = dict(max_services=4, hll_rows=5, global_row=4)
BAD = {
    "int64 svc": dict(svc=torch.zeros(8, dtype=torch.int64)),
    "int64 hashes": dict(hashes=torch.zeros(8, dtype=torch.int64)),
    "uint8 valid": dict(valid=torch.zeros(8, dtype=torch.uint8)),
    "int64 slot": dict(slot=torch.zeros(8, dtype=torch.int64)),
    "short keep": dict(tb_keep=torch.zeros(7, dtype=torch.bool)),
    "2-D svc": dict(svc=torch.zeros((8, 1), dtype=torch.int32)),
    "strided hashes": dict(hashes=torch.zeros(16, dtype=torch.int32)[::2]),
    "int32 registers": dict(hll=torch.zeros((5, 16), dtype=torch.int32)),
    "width not 2**p": dict(hll=torch.zeros((5, 12), dtype=torch.uint8)),
    "wrong row count": dict(hll=torch.zeros((6, 16), dtype=torch.uint8)),
    "ragged tier": dict(tb_flat=torch.zeros((7, 16), dtype=torch.uint8)),
    "tier width": dict(tb_flat=torch.zeros((10, 32), dtype=torch.uint8)),
    "lanes on another device": dict(valid=torch.zeros(8, dtype=torch.bool, device="meta")),
    "keep without tier": dict(tb_flat=None),
    "too many slots": dict(tb_flat=torch.zeros((257 * 5, 16), dtype=torch.uint8)),
}


@pytest.mark.parametrize("case", sorted(BAD))
def test_update_step_refuses_bad_inputs_before_building(case, monkeypatch):
    """What the CUDA path requires is checked in Python, before any build
    (``check_step``, which ``update_step`` runs for a CUDA tensor); a tensor
    on neither the CPU nor a card is refused by ``update_step`` itself."""
    def no_build(*a, **k):
        raise AssertionError("a kernel build was attempted")

    monkeypatch.setattr(kernels, "build", no_build)
    monkeypatch.setattr(kernels, "load", no_build)
    args = _good()
    args.update(BAD[case])
    with pytest.raises(ValueError, match="hll update_step"):
        hll_kernel.check_step(*args.values(), **KW)
    assert hll_kernel.check_step(*_good().values(), **KW) == 2
    meta = _good(device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        hll_kernel.update_step(*meta.values(), **KW)


def test_update_step_on_cpu_counts_no_launch():
    before = (hll_kernel.update_step.launches, hll_kernel.update.launches)
    args = _good()
    args["valid"][:] = True
    args["tb_keep"][:] = True
    args["hashes"][:] = 12345
    args["svc"][:] = torch.arange(8, dtype=torch.int32)
    hll_kernel.update_step(*args.values(), **KW)
    assert int(args["hll"].sum()) > 0 and int(args["tb_flat"].sum()) > 0
    assert (hll_kernel.update_step.launches, hll_kernel.update.launches) == before


def test_ingest_step_raises_the_registers_with_one_update_step(monkeypatch):
    """The main path makes one update_step call per step and never the
    single-target update; the state it leaves is the reference's
    (tests/test_torch_ingest.py holds every leaf)."""
    from zipkin_tpu_torch.parallel.aggregator import TorchAggregator
    from zipkin_tpu_torch.tpu.state import AggConfig
    from zipkin_tpu_torch.workload import generate, slice_columns

    calls = []
    plain = hll_kernel.update_step_plain
    monkeypatch.setattr(hll_kernel, "update_step_plain",
                        lambda *a, **k: calls.append(a[1] is not None) or plain(*a, **k))
    monkeypatch.setattr(hll_kernel, "update", lambda *a, **k: pytest.fail("single-target update called"))
    for time_buckets in (4, 0):
        calls.clear()
        cfg = AggConfig(max_services=16, max_keys=64, hll_precision=6, digest_centroids=8,
                        digest_buffer=512, ring_capacity=512, time_buckets=time_buckets)
        agg = TorchAggregator(cfg, device="cpu")
        cols = generate(512, seed=3, services=12, names_per_service=4).cols
        for lo in range(0, 512, 128):
            agg.ingest(slice_columns(cols, lo, lo + 128))
        assert calls == [time_buckets > 0] * 4
        assert int(agg.states[0].hll.sum()) > 0
