"""The port's snapshots (``zipkin_tpu_torch.tpu.snapshot``) against the JAX
package's, on the CPU.

Stores are the small ones of ``tests/test_torch_store.py``: the port's
``TorchStorage(device="cpu")`` and the reference's ``TpuStorage`` on one
shard, fed the same batches. The file format is shared:

- a snapshot written by either package restores in the other to the
  writer's leaves, and saved again gives the same crc manifest;
- each refusal by cause (version, config, shards, leaf count, leaf shape,
  missing state file) refuses in both packages, and the store stays usable;
- a digest mismatch quarantines the newest generation and falls back;
- commits prune to the newest K generations, and ``retained_coverage`` and
  ``generation_status`` read a directory as the reference's do;
- a crash at ``snapshot.post_state`` or ``snapshot.post_meta`` leaves a
  complete pair, and the resume adapters of both packages boot from it to
  the same state.
"""

from __future__ import annotations

import json
import logging
import os
import shutil

import numpy as np
import pytest

import tests.torch_cpu  # noqa: F401  (one intra-op thread a test process)
from tests.fixtures import lots_of_spans
from tests.test_torch_store import JSMALL, links, ref_store, small_store, to_port
from tests.test_torch_wal import (
    assert_store_parity, batches, crash, end_of, feed, port_adapter, ref_adapter)
from zipkin_tpu import faults as ref_faults
from zipkin_tpu.parallel.mesh import make_mesh
from zipkin_tpu.tpu import snapshot as ref_snap
from zipkin_tpu.tpu.store import TpuStorage
from zipkin_tpu_torch import faults
from zipkin_tpu_torch.tpu import snapshot as snap
from zipkin_tpu_torch.tpu.state import AggState

WEEK_MS = 7 * 86_400_000


@pytest.fixture(autouse=True)
def _disarm():
    yield
    faults.disarm()
    ref_faults.disarm()


def spans(seed: int, n: int = 400):
    return lots_of_spans(n, seed=seed, services=5, span_names=6)


def loaded(kind: str, seed: int = 7):
    """A port or reference store holding one batch."""
    if kind == "port":
        store = small_store()
        store.accept(to_port(spans(seed))).execute()
    else:
        store = ref_store()
        store.accept(spans(seed)).execute()
    return store


def leaves(store):
    """Every leaf as the file holds it: the reference's dtypes and the
    leading shard axis."""
    return store.agg.state_arrays()


def meta_of(d):
    with open(os.path.join(d, snap.META_FILE)) as f:
        return json.load(f)


def write_meta(d, meta):
    with open(os.path.join(d, snap.META_FILE), "w") as f:
        json.dump(meta, f)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_cross_restore_with_identical_manifests(tmp_path, writer):
    src = loaded(writer)
    reader = small_store() if writer == "reference" else ref_store()
    save = snap.save if writer == "port" else ref_snap.save
    restore = ref_snap.maybe_restore if writer == "port" else snap.maybe_restore
    save(src, str(tmp_path / "a"))
    assert restore(reader, str(tmp_path / "a"))
    for name, got, want in zip(AggState._fields, leaves(reader), leaves(src)):
        np.testing.assert_array_equal(got, want, err_msg=name)
    assert reader.agg.host_counters == src.agg.host_counters
    assert reader.vocab._key_list == src.vocab._key_list
    assert reader.vocab.services._names == src.vocab.services._names
    # saved again by the reader: the same bytes, so the same manifest
    (ref_snap.save if writer == "port" else snap.save)(reader, str(tmp_path / "b"))
    assert meta_of(tmp_path / "b")["leaf_crcs"] == meta_of(tmp_path / "a")["leaf_crcs"]
    end_ts = max(s.timestamp for s in spans(7)) // 1000 + 60_000
    assert links(reader.get_dependencies(end_ts, WEEK_MS).execute()) == \
        links(src.get_dependencies(end_ts, WEEK_MS).execute())


def _drop_leaf(d):
    path = os.path.join(d, meta_of(d)["state_file"])
    loaded_ = np.load(path)
    arrays = {f"f{i}": loaded_[f"f{i}"] for i in range(len(loaded_.files) - 1)}
    with open(path, "wb") as f:
        np.savez_compressed(f, **arrays)


def _grow_leaf(d):
    path = os.path.join(d, meta_of(d)["state_file"])
    loaded_ = np.load(path)
    arrays = {k: loaded_[k] for k in loaded_.files}
    arrays["f0"] = np.zeros(tuple(s + 1 for s in arrays["f0"].shape), arrays["f0"].dtype)
    with open(path, "wb") as f:
        np.savez_compressed(f, **arrays)


# cause -> (damage to a port snapshot, the port's warning, what restore does with it)
REFUSALS = {
    "version": (lambda d: write_meta(d, dict(meta_of(d), version=snap.SNAPSHOT_VERSION - 1)),
                "format version", "incompatible"),
    "config": (lambda d: write_meta(d, dict(meta_of(d), config=dict(meta_of(d)["config"],
                                                                     max_keys=9999))),
               "another AggConfig", "incompatible"),
    "shards": (None, "shards", "incompatible"),
    "leaf_count": (_drop_leaf, "state leaves", "incompatible"),
    "leaf_shape": (_grow_leaf, "layout drift", "incompatible"),
    "missing_file": (lambda d: os.unlink(os.path.join(d, meta_of(d)["state_file"])),
                     "missing state file", "integrity"),
}


@pytest.mark.parametrize("cause", list(REFUSALS))
def test_refusal_by_cause(tmp_path, caplog, cause):
    damage, needle, kind = REFUSALS[cause]
    d = str(tmp_path / "snap")
    if cause == "shards":
        two = TpuStorage(config=JSMALL, mesh=make_mesh(2), pad_to_multiple=256)
        two.accept(spans(7)).execute()
        ref_snap.save(two, d)
    else:
        snap.save(loaded("port"), d)
        damage(d)
    shutil.copytree(d, tmp_path / "copy")
    store = small_store()
    caplog.clear()
    with caplog.at_level(logging.WARNING):
        assert not snap.maybe_restore(store, d)
    assert needle in caplog.text, caplog.text
    if cause == "leaf_shape":
        assert "leaf hll" in caplog.text  # names the drifted leaf
    # the reference refuses the same files for the same class of cause
    ref = ref_store()
    assert not ref_snap.maybe_restore(ref, str(tmp_path / "copy"))
    quarantined = int(kind == "integrity")
    assert store.restore_stats["generationsQuarantined"] == quarantined
    assert ref.restore_stats["generationsQuarantined"] == quarantined
    # still a fresh, usable store
    assert store.agg.host_counters["spans"] == 0
    store.accept(to_port(spans(9, 60))).execute()
    assert store.agg.host_counters["spans"] == 60 and store.trace_cardinalities()


def _two_generations(d):
    """Two generations of different states; (counters at the first, at the
    second)."""
    store = loaded("port")
    snap.save(store, d)
    first = dict(store.agg.host_counters)
    store.accept(to_port(spans(8, 200))).execute()
    snap.save(store, d)
    return first, dict(store.agg.host_counters)


def _tamper_leaf(d, state_name):
    """Change one value of one leaf, keeping the zip valid: rot only the
    digest manifest sees."""
    path = os.path.join(d, state_name)
    loaded_ = np.load(path)
    arrays = {k: loaded_[k].copy() for k in loaded_.files}
    arrays["f1"].reshape(-1)[0] += 1  # hist, u32
    with open(path, "wb") as f:
        np.savez_compressed(f, **arrays)


def test_digest_mismatch_quarantines_and_falls_back(tmp_path, caplog):
    d = str(tmp_path / "snap")
    first, _ = _two_generations(d)
    newest = meta_of(d)["state_file"]
    _tamper_leaf(d, newest)
    shutil.copytree(d, tmp_path / "copy")
    store, ref = small_store(), ref_store()
    with caplog.at_level(logging.WARNING):
        assert snap.maybe_restore(store, d)
    assert "digest mismatch" in caplog.text and "leaf hist" in caplog.text
    assert ref_snap.maybe_restore(ref, str(tmp_path / "copy"))
    assert store.agg.host_counters == ref.agg.host_counters == first
    for stats in (store.restore_stats, ref.restore_stats):
        assert stats["restoreFallbacks"] == 1 and stats["generationsQuarantined"] == 1
    assert os.path.exists(os.path.join(d, newest + snap.QUARANTINE_SUFFIX))
    # a later save never reuses the quarantined generation's name
    snap.save(store, d)
    assert meta_of(d)["state_file"] > newest


def test_generations_pruned_and_coverage_is_the_oldest_retained(tmp_path):
    d = str(tmp_path / "snap")
    assert snap.retained_coverage(d) is None and snap.generation_status(d) == []
    store = loaded("port")
    for seq in (3, 7, 11):
        store.agg.wal_seq = seq
        snap.save(store, d, keep=2)
    states = sorted(n for n in os.listdir(d) if n.endswith(".npz"))
    assert states == ["sketch_state-00000002.npz", "sketch_state-00000003.npz"]
    assert meta_of(d)["state_file"] == states[-1]
    assert snap.retained_coverage(d) == ref_snap.retained_coverage(d) == 7
    assert snap.generation_status(d) == ref_snap.generation_status(d)
    assert [g["walSeq"] for g in snap.generation_status(d)] == [11, 7]


@pytest.mark.parametrize("site", ["snapshot.post_state", "snapshot.post_meta"])
def test_crash_inside_a_save_keeps_a_complete_pair(tmp_path, site):
    """post_state: the new state file is in but meta.json names the old
    one, so the old pair restores and the longer WAL tail replays.
    post_meta: the new pair is committed but nothing was pruned or
    truncated; replay skips the records it covers."""
    bs = batches(4)
    port, ref = port_adapter(tmp_path / "p"), ref_adapter(tmp_path / "r")
    for b in bs[:2]:
        feed((port, ref), b)
    assert port.snapshot() and ref.snapshot()
    for b in bs[2:]:
        feed((port, ref), b)
    faults.arm(site, action="raise")
    ref_faults.arm(site, action="raise")
    with pytest.raises(faults.CrashpointTriggered):
        port.snapshot()
    with pytest.raises(ref_faults.CrashpointTriggered):
        ref.snapshot()
    crash(port)
    crash(ref)
    want_seq = 2 if site == "snapshot.post_state" else 4
    assert meta_of(tmp_path / "p" / "ckpt")["wal_seq"] == want_seq
    port, ref = port_adapter(tmp_path / "p"), ref_adapter(tmp_path / "r")
    assert port.restore_stats["walReplayBatches"] == 4 - want_seq
    assert_store_parity(port, ref, end_of(bs))
