"""The port's at-rest scrubber (``zipkin_tpu_torch.runtime.scrub``) and the
durable plane around it, on the CPU.

The reference's ``tests/test_scrub.py`` cases on the port: the WAL leg's
covered/uncovered quarantine bar, a rotted snapshot generation quarantined
at rest (and the older one still restoring), the vocab sidecar detected but
never pulled from a running store, pacing, lifecycle and the adapter's
wiring. Then the archive leg: a rotted sealed segment is quarantined by
both packages' scrubbers alike (the same pass summary, the same files
renamed), and later reads return the traces that remain, never an error.
Then the server: the durability gauges on ``/metrics``, ``stop()``
stopping the scrubber before its final snapshot, an unusable archive dir
degrading to a store without one, and ``TPU_RESUME_DIR`` serving every
trace acked before a crash from ``<dir>/archive`` after the restart.
"""

from __future__ import annotations

import glob
import json
import logging
import os
import shutil
import time
import zlib
from types import SimpleNamespace

import numpy as np
import pytest

from tests.fixtures import lots_of_spans
from tests.test_torch_server import Client
from tests.test_torch_store import SMALL, to_port
from tests.test_torch_wal import port_adapter
import tests.torch_cpu  # noqa: F401  (one intra-op thread a test process)
from zipkin_tpu import faults as ref_faults
from zipkin_tpu import native as ref_native
from zipkin_tpu.model import json_v2 as ref_json
from zipkin_tpu.runtime.scrub import Scrubber as RefScrubber
from zipkin_tpu.tpu.archive import SpanArchive as RefArchive
from zipkin_tpu_torch import faults, native
from zipkin_tpu_torch.model import json_v2 as port_json
from zipkin_tpu_torch.runtime.scrub import Scrubber
from zipkin_tpu_torch.server.app import ZipkinServer, build_storage
from zipkin_tpu_torch.server.config import ServerConfig
from zipkin_tpu_torch.storage.spi import QueryRequest
from zipkin_tpu_torch.tpu import snapshot as snap
from zipkin_tpu_torch.tpu import wal as wal_mod
from zipkin_tpu_torch.tpu.archive import SpanArchive
from zipkin_tpu_torch.tpu.store import TorchStorage


@pytest.fixture(autouse=True)
def _disarm():
    yield
    faults.disarm()
    ref_faults.disarm()


@pytest.fixture
def compiler():
    if not native.available() or not ref_native.available():
        pytest.skip("no C compiler for the native parser")


def _bare(**kw):
    """A store with no durable artifacts unless given."""
    return SimpleNamespace(**{"wal": None, "_disk": None, "checkpoint_dir": None, **kw})


def _flip_tail_byte(path):
    with open(path, "r+b") as fh:
        fh.seek(os.path.getsize(path) - 3)
        b = fh.read(1)
        fh.seek(-1, os.SEEK_CUR)
        fh.write(bytes([b[0] ^ 0xFF]))


# -- the WAL leg -----------------------------------------------------------------


def _wal_three_segments(tmp_path):
    """seg0 holds records 1 and 2, seg1 record 3, the live seg2 record 4."""
    w = wal_mod.WriteAheadLog(str(tmp_path / "wal"))
    fused = np.arange(44, dtype=np.uint32).reshape(1, 11, 4)
    meta = {"n_spans": 4, "n_dur": 0, "n_err": 0}
    w.append(fused, meta)
    w.append(fused, meta)
    w.max_segment_bytes = 1  # every later append rotates
    w.append(fused, meta)
    w.append(fused, meta)
    paths = [p for _, p in w._segments()]
    assert len(paths) == 3 and w.sealed_segment_paths() == paths[:-1]
    return w, paths


def test_wal_uncovered_rot_detected_but_left_in_place(tmp_path):
    w, paths = _wal_three_segments(tmp_path)
    _flip_tail_byte(paths[0])  # record 2's payload
    res = wal_mod.verify_segment(paths[0])
    assert not res["ok"] and res["bad_seq"] == 2 and res["max_seq"] == 1 and res["bad_offset"] > 0
    # no snapshot covers record 1, which only this file can replay: kept
    s = Scrubber(_bare(wal=w, checkpoint_dir=str(tmp_path / "ckpt")), bytes_per_sec=0)
    out = s.scan_once()
    assert out["corrupt"] == 1 and out["quarantined"] == 0 and os.path.exists(paths[0])
    # a snapshot covering every good record: pulling the file loses nothing
    os.makedirs(tmp_path / "ckpt")
    (tmp_path / "ckpt" / snap.META_FILE).write_text(json.dumps({"wal_seq": 1}))
    assert s.scan_once()["quarantined"] == 1
    assert os.path.exists(paths[0] + ".quarantine") and not os.path.exists(paths[0])
    c = s.counters()
    assert (c["scrubPasses"], c["scrubCorruptDetected"], c["segmentsQuarantined"]) == (2, 2, 1)


def test_wal_clean_segments_counted_not_touched(tmp_path):
    w, paths = _wal_three_segments(tmp_path)
    out = Scrubber(_bare(wal=w), bytes_per_sec=0).scan_once()
    assert (out["corrupt"], out["quarantined"], out["files"]) == (0, 0, 2)
    assert out["bytes"] == sum(os.path.getsize(p) for p in paths[:-1])
    assert all(os.path.exists(p) for p in paths)


# -- the generation and vocab-sidecar legs ---------------------------------------


def test_generation_rot_quarantined_at_rest(tmp_path):
    store = port_adapter(tmp_path, wal_dir=False)
    store.accept(to_port(lots_of_spans(200, seed=3, services=4, span_names=6))).execute()
    store.snapshot()
    faults.arm_corrupt("snapshot.state", mode="zero")
    store.snapshot()  # the second generation commits, then rots
    s = Scrubber(store, bytes_per_sec=0)
    out = s.scan_once()
    assert out["corrupt"] == 1 and out["quarantined"] == 1
    assert len(glob.glob(str(tmp_path / "ckpt" / "*.npz.quarantine"))) == 1
    assert s.scan_once()["corrupt"] == 0  # it left the scan set
    fresh = port_adapter(tmp_path / "fresh", wal_dir=False, checkpoint=False)
    assert snap.maybe_restore(fresh, str(tmp_path / "ckpt"))  # the older one restores


def test_vocab_sidecar_rot_detected_never_quarantined(tmp_path):
    path = tmp_path / "vocab.json"
    meta = {"services": ["", "a"]}
    crc = zlib.crc32(json.dumps(meta, sort_keys=True, separators=(",", ":")).encode())
    path.write_text(json.dumps(dict(meta, crc32=crc)))
    s = Scrubber(_bare(_archive_vocab_path=str(path)), bytes_per_sec=0)
    assert s.scan_once()["corrupt"] == 0
    # another payload under the old digest: a running store's live sidecar,
    # so warned about and left for the next vocab growth to rewrite
    path.write_text(json.dumps({"services": ["", "b"], "crc32": crc}))
    assert s.scan_once()["corrupt"] == 1 and path.exists()


# -- pacing, counters, lifecycle -------------------------------------------------


def test_pacing_enforces_the_byte_budget():
    s = Scrubber(_bare(), bytes_per_sec=2000)
    s._t0, s._debt = time.monotonic(), 0.0
    t0 = time.monotonic()
    s._pace(500)  # 0.25 s of budget
    assert time.monotonic() - t0 >= 0.2


def test_pacing_off_is_free():
    s = Scrubber(_bare(), bytes_per_sec=0)
    s._t0 = time.monotonic()
    t0 = time.monotonic()
    s._pace(10 << 30)
    assert time.monotonic() - t0 < 0.05


def test_lifecycle_and_status():
    s = Scrubber(_bare(), interval_s=3600.0)
    st = s.status()
    assert not st["running"] and st["lastPass"] is None
    s.start()
    assert s.status()["running"]
    s.stop()
    assert not s.status()["running"]
    s.scan_once()  # without a thread, and it feeds lastPass
    assert s.status()["lastPass"]["files"] == 0


def test_adapter_wires_the_scrubber_and_its_counters(tmp_path):
    store = port_adapter(tmp_path, wal_dir=False, scrub_interval_s=3600.0)
    try:
        assert store.scrubber is not None and store.scrubber.status()["running"]
        counters = store.ingest_counters()
        for name in ("scrubPasses", "scrubBytes", "segmentsQuarantined"):
            assert name in counters
    finally:
        store.close()
    assert not store.scrubber.status()["running"]


def test_adapter_without_an_interval_or_a_durable_dir_has_no_scrubber(tmp_path):
    for store in (port_adapter(tmp_path), port_adapter(tmp_path / "x", wal_dir=False,
                                                       checkpoint=False, scrub_interval_s=60.0)):
        try:
            assert store.scrubber is None and "scrubPasses" not in store.ingest_counters()
        finally:
            store.close()


# -- the archive leg ---------------------------------------------------------------


def _rows(n, base):
    z = np.zeros(n, np.uint32)
    return dict(payload=b"s" * (n * 10), span_off=np.arange(n, dtype=np.uint32) * 10,
                span_len=np.full(n, 10, np.uint32),
                tl0=(base + np.arange(n) // 4).astype(np.uint32), tl1=z, th0=z, th1=z,
                svc=np.ones(n, np.uint32), rsvc=z, name=np.ones(n, np.uint32),
                key=np.ones(n, np.uint32), ts_min=np.full(n, 9, np.uint32),
                dur=np.ones(n, np.uint64), err=np.zeros(n, bool))


def test_rotted_archive_segment_quarantined_alike_by_both_packages(tmp_path):
    """Three sealed segments and a live one; the middle one's last frame
    rots. Each package's scrubber, over its own copy of the directory,
    reports the same pass and renames the same files aside; the live
    segment is never scrubbed; a read that took its views before the
    quarantine still reads through the retained fd."""
    d = tmp_path / "arc"
    arc = SpanArchive(str(d), segment_bytes=800)  # a segment per batch
    for i in range(4):
        arc.append_batch(**_rows(16, 100 * (i + 1)))
    arc.close()
    live = SpanArchive(str(d), segment_bytes=1 << 20)
    live.append_batch(**_rows(8, 5000))  # stays live
    sealed = live.sealed_segment_paths()
    assert len(sealed) == 4
    live._live_fh.close()  # a crash: the live segment stays unsealed
    live._live_fh = None
    size = sum(os.path.getsize(p) for p in sealed)
    _flip_tail_byte(sealed[1])
    shutil.copytree(d, tmp_path / "ref")
    outs = []
    for directory, make, scrubber in ((d, SpanArchive, Scrubber),
                                      (tmp_path / "ref", RefArchive, RefScrubber)):
        archive = make(str(directory), segment_bytes=1 << 20)
        held = archive.views()
        out = scrubber(_bare(_disk=archive), bytes_per_sec=0).scan_once()
        out.pop("ms")
        outs.append((out, sorted(os.listdir(directory)), archive.counters()))
        # traces of the pulled segment are gone, the rest complete
        assert archive.fetch_trace_raw(200, 0, 0, 0, strict=False) == []
        assert len(archive.fetch_trace_raw(100, 0, 0, 0, strict=False)) == 4
        assert len(archive.fetch_trace_raw(5000, 0, 0, 0, strict=False)) == 4
        assert len(archive.fetch_trace_raw(200, 0, 0, 0, strict=False, views=held)) == 4
        archive.close()
    assert outs[0] == outs[1]
    out, files, counters = outs[0]
    assert out == dict(files=4, bytes=size, corrupt=1, quarantined=1, spans_quarantined=16)
    assert os.path.basename(sealed[1]) + ".quarantine" in files
    assert counters["archiveSegmentsQuarantined"] == 1 and counters["archiveSpansQuarantined"] == 16


def test_store_reads_after_a_quarantine_are_partial_never_an_error(tmp_path, compiler):
    store = TorchStorage(config=SMALL, device="cpu", pad_to_multiple=256,
                         archive_dir=str(tmp_path / "arc"), archive_segment_bytes=1 << 16,
                         archive_max_span_count=8)
    batches = [lots_of_spans(300, seed=40 + i, services=4, span_names=4) for i in range(4)]
    for b in batches:
        store.ingest_json_fast(ref_json.encode_span_list(b))
    sealed = store._disk.sealed_segment_paths()
    assert sealed
    _flip_tail_byte(sealed[0])
    store.scrubber = Scrubber(store, bytes_per_sec=0)
    out = store.scrubber.scan_once()
    lost = out["spans_quarantined"]
    assert out["quarantined"] == 1 and lost > 0
    c = store.ingest_counters()
    assert (c["archiveSpansQuarantined"], c["spansQuarantined"], c["scrubPasses"]) == (lost, lost, 1)
    ids = sorted({s.trace_id for b in batches for s in b})
    got = store.get_traces(ids).execute()
    assert sum(len(t) for t in got) == 1200 - lost
    spans = store.get_traces_query(QueryRequest(end_ts=1 << 50, lookback=1 << 50,
                                                limit=10_000)).execute()
    assert sum(len(t) for t in spans) == 1200 - lost
    store.close()


# -- the server ----------------------------------------------------------------------


def _tpu_config(tmp_path, **kw):
    kw.setdefault("tpu_agg", {k: getattr(SMALL, k) for k in (
        "max_services", "max_keys", "hll_precision", "digest_centroids", "ring_capacity")})
    return ServerConfig(host="127.0.0.1", port=0, storage_type="tpu", tpu_deps_max_stale_ms=0.0,
                        tpu_fast_ingest=True, **kw)


def test_server_gauges_and_stop_order(tmp_path, compiler):
    """/metrics carries the durability gauges; stop() stops the scrubber
    before its final snapshot, which still lands."""
    config = _tpu_config(tmp_path, tpu_checkpoint_dir=str(tmp_path / "snap"),
                         tpu_wal_dir=str(tmp_path / "wal"), tpu_archive_dir=str(tmp_path / "arc"))
    server = ZipkinServer(config, seal_interval_s=0, device="cpu").start()
    scrubber = server.storage.scrubber
    order = []
    stop, save = scrubber.stop, server.storage.snapshot
    scrubber.stop = lambda: order.append("scrubber") or stop()
    server.storage.snapshot = lambda: order.append("snapshot") or save()
    try:
        c = Client(server)
        assert c.post("/api/v2/spans", ref_json.encode_span_list(lots_of_spans(200, seed=5)))[0] == 202
        metrics = c.json("/metrics")
        for name in ("scrubBytes", "scrubPasses", "scrubCorruptDetected", "segmentsQuarantined",
                     "spansQuarantined", "archiveSegmentsQuarantined", "archiveSpansQuarantined"):
            assert metrics[f"gauge.zipkin_tpu.{name}"] == 0, name
    finally:
        server.stop()
    assert order[:2] == ["scrubber", "snapshot"] and not scrubber.status()["running"]
    assert glob.glob(str(tmp_path / "snap" / "*.npz"))


def test_an_unusable_archive_dir_degrades_with_a_warning(tmp_path, caplog):
    (tmp_path / "file").write_text("not a directory")
    config = _tpu_config(tmp_path, tpu_archive_dir=str(tmp_path / "file" / "arc"))
    with caplog.at_level(logging.WARNING, logger="zipkin_tpu_torch.server.app"):
        store = build_storage(config, device="cpu")
    try:
        assert store._disk is None and store.agg.device.type == "cpu"
        assert any("unusable" in r.getMessage() for r in caplog.records)
    finally:
        store.close()


def test_resume_dir_serves_every_pre_crash_trace_after_the_restart(monkeypatch, tmp_path, compiler):
    """TPU_RESUME_DIR derives <dir>/archive: after a crash (nothing
    closed, sealed or snapshotted) the reborn store recovers the unsealed
    tail and answers every acked trace complete, with the same names."""
    for k, v in dict(TPU_RESUME_DIR=str(tmp_path / "state"), TPU_FAST_INGEST="1",
                     TPU_MAX_SERVICES="128", TPU_MAX_KEYS="512", TPU_HLL_PRECISION="10",
                     TPU_DIGEST_CENTROIDS="32", TPU_RING_CAPACITY="16384").items():
        monkeypatch.setenv(k, v)
    monkeypatch.delenv("TPU_ARCHIVE_DIR", raising=False)
    cfg = ServerConfig.from_env()
    assert cfg.tpu_archive_dir == str(tmp_path / "state" / "archive")
    victim = build_storage(cfg, device="cpu")
    spans = lots_of_spans(1500, seed=8, services=5, span_names=6)
    for lo in range(0, 1500, 500):
        victim.ingest_json_fast(ref_json.encode_span_list(spans[lo:lo + 500]))
    want_names = victim.get_service_names().execute()
    victim.scrubber.stop()  # a crash: the threads end, nothing is closed
    reborn = build_storage(cfg, device="cpu")
    try:
        assert reborn.restore_stats["walReplayBatches"] == 3
        by_trace = {}
        for s in spans:
            by_trace.setdefault(s.trace_id, []).append(s)
        got = reborn.get_traces(sorted(by_trace)).execute()
        assert len(got) == len(by_trace)
        for trace in got:
            assert sorted(port_json.encode_span(s) for s in trace) == \
                sorted(port_json.encode_span(s) for s in to_port(by_trace[trace[0].trace_id]))
        assert reborn.get_service_names().execute() == want_names
    finally:
        reborn.close()
