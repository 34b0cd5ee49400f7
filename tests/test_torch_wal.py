"""The port's write-ahead log (``zipkin_tpu_torch.tpu.wal``) against the
JAX package's, on the CPU.

Both packages' resume adapters run at the small config of
``tests/test_torch_store.py``: the port's ``storage.tpu.TorchStorage``
(device "cpu") and the reference's ``storage.tpu.TpuStorage`` on one shard.
The same batches go through both, in the same order:

- the logs they write are equal record for record (seq, meta, payload);
- each package replays a log the other wrote to the writer's leaves;
- the log's edges (a torn tail record, a torn segment, ``truncate_covered``,
  the seq watermark after a reopen, append after close) behave the same in
  both;
- a crash at the ``wal.append.mid`` crashpoint recovers to the reference's
  state, and a full disk at the ``wal.append`` resource site (armed in
  process or through ``ZT_RESOURCE``) sets the same gauges until a snapshot
  clears them;
- ``wal_fsync`` syncs once per append, and once per ``batched()`` block.

A "crash" abandons the store: its controller and seal threads are stopped
first, and the test checks that its log gained no record before the next
store boots on the same dirs.
Tolerances are those of ``tests/test_torch_fastpath.py``: integer leaves
bit for bit, digest weights exact and means rtol 1e-5.
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import tests.torch_cpu  # noqa: F401  (one intra-op thread a test process)
from tests.fixtures import lots_of_spans
from tests.test_torch_fastpath import assert_leaves_equal
from tests.test_torch_store import (
    JSMALL, QS, SMALL, WEEK_MS, assert_cards_match, assert_rows_match, links, to_port)
from zipkin_tpu import faults as ref_faults
from zipkin_tpu.storage.tpu import TpuStorage as RefAdapter
from zipkin_tpu.tpu import wal as ref_wal
from zipkin_tpu_torch import faults
from zipkin_tpu_torch.storage.tpu import TorchStorage
from zipkin_tpu_torch.tpu import wal
from zipkin_tpu_torch.tpu.state import AggConfig


@pytest.fixture(autouse=True)
def _disarm():
    yield
    faults.disarm()
    ref_faults.disarm()


def port_adapter(root, wal_dir=True, checkpoint=True, config=SMALL, **kw) -> TorchStorage:
    kw.setdefault("snapshot_keep", 2)
    return TorchStorage(
        config=config, device="cpu", batch_size=256,
        checkpoint_dir=str(root / "ckpt") if checkpoint else None,
        wal_dir=str(root / "wal") if wal_dir else None, **kw)


def ref_adapter(root, wal_dir=True, checkpoint=True, config=JSMALL, **kw) -> RefAdapter:
    return RefAdapter(
        config=config, num_devices=1, batch_size=256,
        checkpoint_dir=str(root / "ckpt") if checkpoint else None,
        wal_dir=str(root / "wal") if wal_dir else None, scrub_interval_s=0.0, **kw)


def sampled(cfg):
    """The same sampled config for both packages."""
    j = dataclasses.replace(cfg, sampling=True)
    return AggConfig(**dataclasses.asdict(j)), j


def batches(n: int, per: int = 300):
    return [lots_of_spans(per, seed=60 + b, services=6, span_names=5) for b in range(n)]


def feed(stores, spans) -> None:
    """One batch into (port, reference) stores."""
    port, ref = stores
    port.accept(to_port(spans)).execute()
    ref.accept(spans).execute()


def log_records(directory):
    """[(seq, meta, payload bytes)] of every complete record in a WAL dir,
    read without opening it for writing."""
    log = wal.WriteAheadLog.__new__(wal.WriteAheadLog)
    log.directory = str(directory)
    return [(s, m, f.tobytes()) for s, m, f in wal.WriteAheadLog.records(log)]


def crash(store):
    """Abandon a store as a crash would: its threads stop, nothing is
    flushed, closed or snapshotted. Returns its log's records so the
    caller can check that none are added after the crash."""
    if store.sampling_controller is not None:
        store.sampling_controller.stop()
    directory = getattr(store.wal, "directory", None)
    return log_records(directory) if directory else None


def assert_store_parity(port, ref, end_ts=None) -> None:
    """Leaves, host counters, vocab ids, wal_seq and reads of two stores."""
    assert_leaves_equal(port, ref)
    assert port.agg.host_counters == ref.agg.host_counters
    assert port.agg.wal_seq == ref.agg.wal_seq
    assert port.vocab.services._names == ref.vocab.services._names
    assert port.vocab.span_names._names == ref.vocab.span_names._names
    assert port.vocab._key_list == ref.vocab._key_list
    if end_ts is not None:
        port._deps_max_stale_ms = ref._deps_max_stale_ms = 0.0
        assert links(port.get_dependencies(end_ts, WEEK_MS).execute()) == \
            links(ref.get_dependencies(end_ts, WEEK_MS).execute())
        assert_rows_match(port.latency_quantiles(QS, use_digest=False),
                          ref.latency_quantiles(QS, use_digest=False), rtol=1e-6)
        assert_cards_match(port.trace_cardinalities(), ref.trace_cardinalities())


def end_of(bs) -> int:
    return max(s.timestamp for b in bs for s in b) // 1000 + 60_000


def test_records_equal_record_for_record(tmp_path):
    """Batches, an explicit digest flush (a percentile read) and a seal's
    rollup: every record's seq, meta and payload bytes equal."""
    port, ref = port_adapter(tmp_path / "p"), ref_adapter(tmp_path / "r")
    bs = batches(4)
    for i, b in enumerate(bs):
        feed((port, ref), b)
        if i == 1:
            port.latency_quantiles(QS)  # flush-then-read logs a ttflush marker
            ref.latency_quantiles(QS)
    port.agg.rollup_now()
    ref.agg.rollup_now()
    got, want = log_records(tmp_path / "p" / "wal"), log_records(tmp_path / "r" / "wal")
    assert [m.get("ttflush") for _, m, _ in got].count(1) == 1
    assert [m.get("ttroll") for _, m, _ in got].count(1) == 1
    assert len(got) == 6 and got == want
    assert port.agg.wal_seq == ref.agg.wal_seq == 6


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_each_package_replays_the_others_log(tmp_path, writer):
    """A log written by one package boots the other's adapter (no
    snapshot) to the writer's leaves, counters, vocab and reads. The
    writers end on a percentile read, whose digest flush is logged: a boot
    flushes pending digest points, so this way the reader's boot has none
    left to flush and stays comparable to the writer."""
    bs = batches(3)
    port, ref = port_adapter(tmp_path / "p"), ref_adapter(tmp_path / "r")
    for b in bs:
        feed((port, ref), b)
    port.latency_quantiles(QS)
    ref.latency_quantiles(QS)
    crash(port)
    crash(ref)
    src = tmp_path / ("p" if writer == "port" else "r")
    if writer == "port":
        reader = ref_adapter(src, checkpoint=False)
        assert_store_parity(port, reader, end_of(bs))
    else:
        reader = port_adapter(src, checkpoint=False)
        assert_store_parity(reader, ref, end_of(bs))
    assert reader.restore_stats["walReplayBatches"] == 4


def _two_logs(tmp_path, max_segment_bytes=1 << 30):
    """(port log, reference log) over their own dirs."""
    return (wal.WriteAheadLog(str(tmp_path / "p"), max_segment_bytes=max_segment_bytes),
            ref_wal.WriteAheadLog(str(tmp_path / "r"), max_segment_bytes=max_segment_bytes))


def _image(k: int) -> np.ndarray:
    return (np.arange(11 * 8, dtype=np.uint32).reshape(1, 11, 8) + k).astype(np.uint32)


def _segment_files(log):
    return [p for _, p in log._segments()]


@pytest.mark.parametrize("case", ["torn_tail", "torn_segment", "truncate_covered",
                                  "reopen_watermark", "append_after_close"])
def test_log_edges_match_the_reference(tmp_path, case):
    """The same appends and the same damage to both packages' logs give
    the same records, seqs and files."""
    small = case in ("torn_segment", "truncate_covered")
    logs = _two_logs(tmp_path, max_segment_bytes=800 if small else 1 << 30)
    for log in logs:
        for k in range(6):
            log.append(_image(k), {"n_spans": k})
    outcome = []
    for log, mod in zip(logs, (wal, ref_wal)):
        segs = _segment_files(log)
        if case == "torn_tail":
            log.close()
            size = os.path.getsize(segs[-1])
            with open(segs[-1], "r+b") as fh:
                fh.truncate(size - 10)  # the last record's payload is torn
            log = mod.WriteAheadLog(log.directory)
        elif case == "torn_segment":
            log.close()
            with open(segs[0], "r+b") as fh:  # rot mid-way through the first segment
                fh.seek(os.path.getsize(segs[0]) - 20)
                fh.write(b"\xff" * 4)
            log = mod.WriteAheadLog(log.directory)
        elif case == "truncate_covered":
            log.truncate_covered(4)
        elif case == "reopen_watermark":
            log.close()
            log = mod.WriteAheadLog(log.directory)
            log.truncate_covered(6)  # the newest segment carries the watermark
            log.close()
            log = mod.WriteAheadLog(log.directory)
            outcome.append(log.append(_image(9), {"n_spans": 9}))
        else:
            log.close()
            with pytest.raises(RuntimeError, match="closed"):
                log.append(_image(9), {})
            with pytest.raises(RuntimeError, match="closed"):
                with log.batched():
                    pass
        recs = [(s, m, f.tobytes()) for s, m, f in log.records()]
        outcome.append((recs, log._seq, [os.path.basename(p) for p in _segment_files(log)],
                        [mod.verify_segment(p)["ok"] for p in _segment_files(log)],
                        [os.path.basename(p) for p in log.sealed_segment_paths()]))
    half = len(outcome) // 2
    assert outcome[:half] == outcome[half:]
    recs, seq, files, ok, sealed = outcome[half - 1]
    assert sealed == files[:-1]
    if case == "torn_tail":
        assert [s for s, _, _ in recs] == [1, 2, 3, 4, 5] and seq == 6 and ok == [False]
    elif case == "torn_segment":
        assert len(files) > 2 and ok[0] is False and all(ok[1:])
        assert [s for s, _, _ in recs][-1] == 6 and len(recs) < 6
    elif case == "truncate_covered":
        assert len(files) < 6 and [s for s, _, _ in recs][-1] == 6 and recs[0][0] <= 5
    elif case == "reopen_watermark":
        assert outcome[0] == 7 and [s for s, _, _ in recs] == [1, 2, 3, 4, 5, 6, 7]
    else:
        assert [s for s, _, _ in recs] == [1, 2, 3, 4, 5, 6]


def test_crash_mid_append_recovers_to_parity(tmp_path):
    """A torn record (header and meta on disk, payload missing) at the
    ``wal.append.mid`` crashpoint: that batch was never acked, everything
    before it replays, and further traffic lands and stays durable."""
    bs = batches(5)
    port, ref = port_adapter(tmp_path / "p"), ref_adapter(tmp_path / "r")
    for b in bs[:3]:
        feed((port, ref), b)
    faults.arm("wal.append.mid", action="raise")
    ref_faults.arm("wal.append.mid", action="raise")
    with pytest.raises(faults.CrashpointTriggered):
        port.accept(to_port(bs[3])).execute()
    with pytest.raises(ref_faults.CrashpointTriggered):
        ref.accept(bs[3]).execute()
    left = crash(port)
    crash(ref)
    assert log_records(tmp_path / "p" / "wal") == left  # the victim wrote nothing since
    port, ref = port_adapter(tmp_path / "p"), ref_adapter(tmp_path / "r")
    assert port.restore_stats["walReplayBatches"] == 3
    assert_store_parity(port, ref, end_of(bs[:3]))
    for b in bs[3:]:
        feed((port, ref), b)
    crash(port)
    crash(ref)
    assert_store_parity(port_adapter(tmp_path / "p"), ref_adapter(tmp_path / "r"), end_of(bs))


def test_enospc_puts_durability_at_risk_until_a_snapshot(tmp_path):
    """A full disk at ``wal.append``: the batch is ingested but its record
    is missed; the gauges flag it until a snapshot covers the state."""
    port, ref = port_adapter(tmp_path / "p"), ref_adapter(tmp_path / "r")
    bs = batches(3)
    feed((port, ref), bs[0])
    faults.arm_resource("wal.append")
    ref_faults.arm_resource("wal.append")
    feed((port, ref), bs[1])
    assert not faults.is_resource_armed("wal.append")  # one traversal, then room again
    feed((port, ref), bs[2])
    keys = ("walEnospc", "walMissedRecords", "durabilityAtRisk", "snapshotEnospc", "spans")
    got = {k: port.ingest_counters()[k] for k in keys}
    assert got == {k: ref.ingest_counters()[k] for k in keys}
    assert got["walEnospc"] == got["walMissedRecords"] == got["durabilityAtRisk"] == 1
    # the records after the gap went to a fresh segment
    assert len(os.listdir(tmp_path / "p" / "wal")) == 2
    assert port.snapshot() and ref.snapshot()
    assert port.ingest_counters()["durabilityAtRisk"] == ref.ingest_counters()["durabilityAtRisk"] == 0
    assert port.ingest_counters()["walEnospc"] == 1
    # a full disk at the snapshot degrades it the same way
    faults.arm_resource("snapshot")
    assert port.snapshot() is None
    c = port.ingest_counters()
    assert c["snapshotEnospc"] == 1 and c["durabilityAtRisk"] == 1
    crash(port)
    crash(ref)
    assert_store_parity(port_adapter(tmp_path / "p"), ref_adapter(tmp_path / "r"), end_of(bs))


def test_resource_site_armed_from_the_environment(tmp_path):
    """``ZT_RESOURCE=wal.append:2`` arms the site at import: the second
    append misses its record and puts the log at risk; a site outside the
    catalog (the reference's five) is ignored with a warning."""
    code = textwrap.dedent("""
        import sys
        import numpy as np
        from zipkin_tpu_torch import faults
        from zipkin_tpu_torch.tpu.wal import WriteAheadLog
        assert faults.RESOURCE_SITES == ("wal.append", "snapshot", "archive", "feed.latency", "alloc")
        assert faults.is_resource_armed("wal.append")
        log = WriteAheadLog(sys.argv[1])
        img = np.zeros((1, 11, 4), np.uint32)
        out = [log.append(img, {}), log.at_risk, log.append(img, {}), log.at_risk,
               log.append(img, {}), log.enospc_count, faults.is_resource_armed("wal.append")]
        print(out)
    """)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, ZT_RESOURCE="wal.append:2,no.such.site", PYTHONPATH=root)
    done = subprocess.run([sys.executable, "-c", code, str(tmp_path / "wal")], env=env, cwd=root,
                          capture_output=True, text=True, timeout=120)
    assert done.returncode == 0, done.stderr
    assert done.stdout.strip() == "[1, False, 2, True, 3, 1, False]"
    assert "ignoring ZT_RESOURCE" in done.stderr
    assert [s for s, _, _ in log_records(tmp_path / "wal")] == [1, 3]


def test_wal_fsync_once_per_append_and_once_per_batched_block(tmp_path, monkeypatch):
    """``wal_fsync=True``: each batch the adapter logs is synced as it is
    appended; inside ``batched()`` the run is synced once, as it leaves;
    a log without the option never syncs. The records replay alike."""
    synced = []
    real_fsync = os.fsync
    monkeypatch.setattr(os, "fsync", lambda fd: synced.append(fd) or real_fsync(fd))
    bs = batches(5)
    plain = port_adapter(tmp_path / "plain", checkpoint=False)
    plain.accept(to_port(bs[0])).execute()
    assert synced == []
    store = port_adapter(tmp_path / "p", checkpoint=False, wal_fsync=True)
    for b in bs[:2]:
        store.accept(to_port(b)).execute()
    assert len(synced) == store.agg.wal_seq == 2
    with store.wal.batched():
        for b in bs[2:]:
            store.accept(to_port(b)).execute()
        assert len(synced) == 2
    assert len(synced) == 3 and store.agg.wal_seq == 5
    crash(store)
    reborn = port_adapter(tmp_path / "p", checkpoint=False)
    assert reborn.restore_stats["walReplayBatches"] == 5
    assert reborn.agg.host_counters == store.agg.host_counters
