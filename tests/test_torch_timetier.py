"""The port's time-tier read and sealer against the JAX package's.

A ``TorchAggregator(device="cpu")`` and a one-shard ``ShardedAggregator``
take the same seeded stream (flushes, rollups, ring wraps, ~13 bucket
epochs), each with its package's ``TimeTier`` in its own directory,
sealing after every step:

- ``tt_read`` over several ``[lo, hi]`` epoch ranges equals the
  reference's: slot epochs, HLL registers and edges exact, digest weights
  exact, means within rtol 1e-5 (cluster sums run in another order);
- ``seal_due``, ``seal_up_to`` and ``sealed_through`` agree step by step,
  and every window answer agrees, in memory and after a reboot from disk;
- a flipped, zeroed or truncated segment is quarantined by the port's
  copy and costs coverage, and a crash before a seal's commit reseals.
"""

from __future__ import annotations

import dataclasses
import glob
import os

import numpy as np
import pytest

import tests.torch_cpu  # noqa: F401  (one intra-op thread a test process)
from zipkin_tpu.parallel.mesh import make_mesh
from zipkin_tpu.parallel.sharded import ShardedAggregator
from zipkin_tpu.tpu.state import AggConfig as JConfig
from zipkin_tpu.tpu.timetier import TimeTier as JTimeTier
from zipkin_tpu_torch import faults
from zipkin_tpu_torch.parallel.aggregator import TorchAggregator
from zipkin_tpu_torch.tpu.state import AggConfig
from zipkin_tpu_torch.tpu.timetier import TimeTier
from zipkin_tpu_torch.workload import BASE_MINUTE, generate, slice_columns

JCFG = JConfig(
    max_services=16, max_keys=64, hll_precision=6, digest_centroids=8,
    digest_buffer=512, ring_capacity=512, link_buckets=4, bucket_minutes=10,
    hist_slices=3, hist_slice_minutes=5, time_buckets=4, time_bucket_minutes=3,
    time_digest_centroids=4,
)
CFG = AggConfig(**dataclasses.asdict(JCFG))
G = CFG.time_bucket_minutes
BASE_EP = BASE_MINUTE // G


@pytest.fixture(autouse=True)
def _always_disarm():
    yield
    faults.disarm()


def _cols():
    return generate(2400, seed=21, services=12, names_per_service=4, minutes=40).cols


def _steps(cols):
    lo, step = 0, 0
    while lo < cols.size:
        hi = min(lo + (80, 112, 96)[step % 3], cols.size)
        yield slice_columns(cols, lo, hi, pad_to=128)
        lo, step = hi, step + 1


def assert_parts_match(got, want, where):
    """(epochs|None, regs, digest, calls, errs) from both packages."""
    names = ("epochs", "hll", "digest", "calls", "errs")
    for name, g, w in zip(names, got, want):
        if g is None:
            continue
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape, (name, where)
        if name == "digest":
            np.testing.assert_array_equal(g[..., 1], w[..., 1], err_msg=f"digest weights {where}")
            np.testing.assert_allclose(g[..., 0], w[..., 0], rtol=1e-5, err_msg=f"digest {where}")
        else:
            np.testing.assert_array_equal(g.astype(w.dtype), w, err_msg=f"{name} {where}")


def assert_windows_match(got, want, where):
    for field in ("lo_ep", "hi_ep", "covered", "missing", "unsealed"):
        assert getattr(got, field) == getattr(want, field), (field, where)
    assert_parts_match((None, got.hll, got.digest, got.calls, got.errs),
                       (None, want.hll, want.digest, want.calls, want.errs), where)


def _windows(top, sealed):
    return [
        (BASE_EP, sealed),                   # sealed only
        (sealed - 2, top),                   # sealed + the unsealed bucket
        (top, top),                          # unsealed only
        (BASE_EP - 5, BASE_EP + 2),          # older than anything: missing
        (sealed - 1, sealed - 1),            # one sealed bucket
    ]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Both packages through the stream; returns what the tests compare."""
    root = tmp_path_factory.mktemp("tiers")
    port = TorchAggregator(CFG, device="cpu")
    ref = ShardedAggregator(JCFG, mesh=make_mesh(1))
    tp = TimeTier(CFG, directory=str(root / "port"))
    tr = JTimeTier(JCFG, directory=str(root / "ref"))
    seals, reads = [], 0
    for i, batch in enumerate(_steps(_cols())):
        port.ingest(batch)
        ref.ingest(batch)
        assert port.tt_max_epoch == ref.tt_max_epoch
        due = tp.seal_due(port)
        assert due == tr.seal_due(ref)
        n = tp.seal_up_to(port)
        assert n == tr.seal_up_to(ref)
        seals.append(n)
        assert tp.sealed_through == tr.sealed_through
        if i % 4 == 1:
            top = port.tt_max_epoch
            for lo, hi in ((top - 3, top), (top - 1, top - 1), (0, (1 << 31) - 1), (top, top),
                           (top - 2, top - 1)):
                got, want = port.tt_read(lo, hi), ref.tt_read(lo, hi)
                assert [a.dtype for a in got] == [a.dtype for a in want]
                assert_parts_match(got, want, f"tt_read({lo}, {hi}) at step {i}")
                reads += 1
        if i % 7 == 6:
            port.rollup_now()
            ref.rollup_now()
    return dict(port=port, ref=ref, tp=tp, tr=tr, seals=seals, reads=reads, root=root)


def test_tt_read_matches_reference_through_flushes_rollups_and_wraps(run):
    port = run["port"]
    assert run["reads"] >= 20
    assert port.ctx_stats["ctx_advances"] >= 4  # rollups ran; the ring wrapped
    assert port.host_counters["spans"] > 4 * CFG.ring_capacity
    assert port.tt_max_epoch - BASE_EP >= 12


def test_seal_protocol_matches_reference(run):
    tp, tr = run["tp"], run["tr"]
    assert sum(run["seals"]) >= 10 and max(run["seals"]) >= 1
    assert tp.sealed_through == tr.sealed_through == run["port"].tt_max_epoch - 1
    for key in ("ttSeals", "ttSegmentsFine", "ttSegmentsCoarse", "ttSegmentsDisk"):
        assert tp.counters[key] == tr.counters[key], key


def test_window_answers_match_reference_in_memory(run):
    port, ref, tp, tr = run["port"], run["ref"], run["tp"], run["tr"]
    top, sealed = port.tt_max_epoch, tp.sealed_through
    for lo, hi in _windows(top, sealed):
        assert_windows_match(tp.window(port, lo, hi), tr.window(ref, lo, hi), f"window {lo}-{hi}")
    assert tp.counters["ttMissingEpochs"] == tr.counters["ttMissingEpochs"] > 0


def test_window_answers_match_reference_from_disk(run):
    """A reboot adopts the committed segments; windows then load them from
    disk (the fine ring is empty) and still equal the reference's."""
    port, ref, root = run["port"], run["ref"], run["root"]
    tp = TimeTier(CFG, directory=str(root / "port"))
    tr = JTimeTier(JCFG, directory=str(root / "ref"))
    assert tp.sealed_through == tr.sealed_through == run["tp"].sealed_through
    top, sealed = port.tt_max_epoch, tp.sealed_through
    for lo, hi in _windows(top, sealed):
        assert_windows_match(tp.window(port, lo, hi), tr.window(ref, lo, hi), f"disk window {lo}-{hi}")
    assert tp.counters["ttDiskLoads"] == tr.counters["ttDiskLoads"] > 0
    # a sealed-only window from disk equals the in-memory one
    mem = run["tp"].window(port, BASE_EP, sealed)
    disk = tp.window(port, BASE_EP, sealed)
    assert_windows_match(disk, mem, "disk vs memory")


def _sealed_port(directory):
    """A port aggregator fed the buckets BASE_EP .. BASE_EP + 3 (the ring's
    four slots: three to seal and the current one), and its tier."""
    port = TorchAggregator(CFG, device="cpu")
    cols = _cols()
    n = int(np.searchsorted(cols.ts_min // G, BASE_EP + 4))
    for lo in range(0, n, 120):
        port.ingest(slice_columns(cols, lo, min(lo + 120, n), pad_to=128))
    return port, TimeTier(CFG, directory=directory)


@pytest.mark.parametrize("mode", ["flip", "zero", "truncate"])
def test_segment_bit_rot_is_quarantined(tmp_path, mode):
    port, tier = _sealed_port(str(tmp_path))
    faults.arm_corrupt("timetier.segment", mode=mode, nth=2)
    assert tier.seal_up_to(port) == 3  # the second segment damaged at rest
    fresh = TimeTier(CFG, directory=str(tmp_path))
    assert fresh.sealed_through == BASE_EP + 2
    ans = fresh.window(port, BASE_EP, BASE_EP + 2)
    assert ans.missing == 1 and ans.covered == 2
    assert fresh.counters["ttSegmentsQuarantined"] == 1
    assert glob.glob(os.path.join(str(tmp_path), "*.quarantine"))
    again = fresh.window(port, BASE_EP, BASE_EP + 2)
    assert again.missing == 1 and again.covered == 2


@pytest.mark.parametrize("site,adopted", [("timetier.seal.pre_commit", False),
                                          ("timetier.seal.post_commit", True)])
def test_crash_mid_seal_reseals_or_adopts(tmp_path, site, adopted):
    """A crash before the rename leaves no segment (the next seal redoes
    it); one after the rename leaves a committed segment the reboot
    adopts. Either way the window equals an uninterrupted tier's."""
    port, tier = _sealed_port(str(tmp_path / "crash"))
    faults.arm(site, nth=2, action="raise")
    with pytest.raises(faults.CrashpointTriggered):
        tier.seal_up_to(port)
    resumed = TimeTier(CFG, directory=str(tmp_path / "crash"))
    assert resumed.sealed_through == BASE_EP + (1 if adopted else 0)
    resumed.seal_up_to(port)
    clean = TimeTier(CFG, directory=str(tmp_path / "clean"))
    clean.seal_up_to(port)
    assert resumed.sealed_through == clean.sealed_through == BASE_EP + 2
    a, b = resumed.window(port, BASE_EP, BASE_EP + 2), clean.window(port, BASE_EP, BASE_EP + 2)
    assert a.covered == b.covered == 3 and a.missing == b.missing == 0
    assert_windows_match(a, b, site)


def test_env_arming_uses_the_reference_variables(monkeypatch):
    monkeypatch.setenv(faults.ENV_VAR, "timetier.seal.post_commit:3,bogus.site")
    monkeypatch.setenv(faults.ENV_ACTION, "raise")
    monkeypatch.setenv(faults.ENV_CORRUPT, "timetier.segment:zero:2")
    faults._arm_from_env()
    assert faults._armed == {"timetier.seal.post_commit": [3, "raise"]}
    assert faults._corrupt_armed == {"timetier.segment": [2, "zero"]}
    for _ in range(2):
        faults.crashpoint("timetier.seal.post_commit")
    with pytest.raises(faults.CrashpointTriggered):
        faults.crashpoint("timetier.seal.post_commit")
    faults.crashpoint("timetier.seal.post_commit")  # one-shot: disarmed


def test_a_seal_between_the_window_halves_drops_no_epoch():
    """A seal that lands while a window is read (a server's seal ticker)
    must not drop its epoch: the window reads ``sealed_through`` once, so
    the epoch comes from the device. Reading it twice, as the reference
    does, lost the newly sealed epochs from the answer."""
    agg = TorchAggregator(CFG, device="cpu")
    steps = list(_steps(_cols()))
    for batch in steps[:8]:
        agg.ingest(batch)
    top = agg.tt_max_epoch
    want = TimeTier(CFG).window(agg, top - 2, top)  # nothing sealed: one device read
    tier = TimeTier(CFG)
    cover = tier.cover

    def cover_then_seal(*args, **kw):
        out = cover(*args, **kw)
        assert tier.seal_up_to(agg) >= 2  # the ticker's seal lands here
        return out

    tier.cover = cover_then_seal
    got = tier.window(agg, top - 2, top)
    assert tier.sealed_through == top - 1 and want.calls.sum() > 0
    assert_windows_match(got, want, "a seal between the halves")
