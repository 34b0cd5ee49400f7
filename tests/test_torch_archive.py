"""The port's disk span archive (``zipkin_tpu_torch.tpu.archive`` and the
archive paths of ``TorchStorage``) against the JAX package's, on the CPU.

- **Files**: the same payloads (the native path, JSON v2 and proto3 by
  turns) and the same Span batches (the object path) go through the
  reference's ``TpuStorage(archive_dir=A)`` on one shard and the port's
  ``TorchStorage(archive_dir=B, device="cpu")``: every segment data file,
  ``.ids.npy`` and ``.cols.npy`` byte-equal, ``.meta.npz`` arrays and
  ``vocab.json`` contents equal.
- **Reads**: get_trace, get_traces, get_traces_query (an annotationQuery,
  and a limit the post-filter starves, which widens the scan) and the
  three name reads equal, strict and lenient, with the host archive too
  small to answer (8 spans); each package also reopens the other's
  directory and answers the same.
- **Contract**: ``tests/storage_contract.py`` over the port with the disk
  as the store of record, strict and lenient.
- **Units**: the reference's ``tests/test_disk_archive.py`` cases on the
  port's archive, the ``archive`` resource site (a full disk drops and
  flags, and appends resume when it frees), and the default posture of
  ``ServerConfig.from_env``.

Integer answers and the files are compared exactly; spans compare as their
JSON v2 bytes.
"""

from __future__ import annotations

import dataclasses
import filecmp
import json
import os

import numpy as np
import pytest

from tests.fixtures import TRACE, lots_of_spans
from tests.storage_contract import QUERY_TS, StorageContract
from tests.test_torch_store import JSMALL, SMALL, WireStorage, to_port
import tests.torch_cpu  # noqa: F401  (one intra-op thread a test process)
from zipkin_tpu import native as ref_native
from zipkin_tpu.model import json_v2 as ref_json
from zipkin_tpu.model import proto3 as ref_proto3
from zipkin_tpu.model.span import Endpoint, Span
from zipkin_tpu.parallel.mesh import make_mesh
from zipkin_tpu.storage.spi import QueryRequest as RefQuery
from zipkin_tpu.tpu.store import TpuStorage
from zipkin_tpu_torch import faults, native
from zipkin_tpu_torch.model import json_v2 as port_json
from zipkin_tpu_torch.storage.spi import QueryRequest
from zipkin_tpu_torch.tpu.archive import SpanArchive
from zipkin_tpu_torch.tpu.state import AggConfig
from zipkin_tpu_torch.tpu.store import TorchStorage

DAY_MS = 86_400_000
SEGMENT = 1 << 16  # small segments: the payloads seal several


@pytest.fixture(autouse=True)
def _disarm():
    yield
    faults.disarm()


@pytest.fixture
def compiler():
    if not native.available() or not ref_native.available():
        pytest.skip("no C compiler for the native parser")


def port_store(archive_dir, **kw) -> TorchStorage:
    kw.setdefault("config", SMALL)
    kw.setdefault("pad_to_multiple", 256)
    kw.setdefault("archive_max_span_count", 8)
    kw.setdefault("archive_segment_bytes", SEGMENT)
    return TorchStorage(device="cpu", archive_dir=str(archive_dir), **kw)


def ref_store(archive_dir, **kw) -> TpuStorage:
    kw.setdefault("config", JSMALL)
    kw.setdefault("pad_to_multiple", 256)
    kw.setdefault("archive_max_span_count", 8)
    return TpuStorage(mesh=make_mesh(1), archive_dir=str(archive_dir),
                      archive_segment_bytes=SEGMENT, **kw)


def wide_spans(seed: int):
    """Client/server pairs under 128-bit trace ids, two ids per low 64 bits
    (the high halves differ), so strict and lenient trace ids part."""
    rng = np.random.default_rng(seed)
    ep = [Endpoint.create(f"wide{i}", f"10.1.0.{i + 1}") for i in range(3)]
    out = []
    for t in range(24):
        low = int(rng.integers(1, 1 << 62))
        ts = 1_700_000_000_000_000 + 60_000_000 * t
        for high in (int(rng.integers(1, 1 << 62)), int(rng.integers(1, 1 << 62))):
            tid = f"{high:016x}{low:016x}"
            out.append(Span.create(tid, "a1", name="call", kind="CLIENT", timestamp=ts,
                                   duration=500 + t, local_endpoint=ep[t % 3],
                                   remote_endpoint=ep[(t + 1) % 3],
                                   tags={"error": "x"} if t % 5 == 0 else {}))
            out.append(Span.create(tid, "a1", name="serve", kind="SERVER", timestamp=ts + 5,
                                   duration=400 + t, local_endpoint=ep[(t + 1) % 3], shared=True))
    return out


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    """The same traffic through both stores (strict trace ids): four
    payloads through the line-rate path, JSON v2 and proto3 by turns, then
    two Span batches through the object path."""
    if not native.available() or not ref_native.available():
        pytest.skip("no C compiler for the native parser")
    root = tmp_path_factory.mktemp("archives")
    ref, port = ref_store(root / "ref"), port_store(root / "port")
    spans = lots_of_spans(2400, seed=17, services=6, span_names=8)
    for i, lo in enumerate(range(0, 2000, 500)):
        payload = (ref_proto3 if i % 2 else ref_json).encode_span_list(spans[lo:lo + 500])
        got, want = port.ingest_json_fast(payload), ref.ingest_json_fast(payload)
        assert got == want == (500, 0)
    wide = wide_spans(3)
    for batch in (spans[2000:], wide):
        ref.accept(batch).execute()
        port.accept(to_port(batch)).execute()
    return dict(root=root, ref=ref, port=port, spans=spans + wide)


def _canon(traces):
    return [sorted(ref_json.encode_span(s) for s in t) for t in traces]


def _port_canon(traces):
    return [sorted(port_json.encode_span(s) for s in t) for t in traces]


def test_files_equal_across_packages(written):
    a, b = written["root"] / "ref", written["root"] / "port"
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    data = [n for n in names if n.endswith(".dat")]
    sealed = [n for n in names if n.endswith(".ids.npy")]
    assert len(data) >= 3 and len(sealed) >= 2, names  # sealed segments and a live one
    for name in names:
        pa, pb = a / name, b / name
        if pa.is_dir():
            continue  # the time tier's, empty until a seal
        if name.endswith(".meta.npz"):
            with np.load(pa) as za, np.load(pb) as zb:
                assert za.files == zb.files
                for k in za.files:
                    np.testing.assert_array_equal(za[k], zb[k], err_msg=f"{name} {k}")
        elif name == "vocab.json":
            assert json.loads(pa.read_text()) == json.loads(pb.read_text())
        else:
            assert filecmp.cmp(pa, pb, shallow=False), name
    assert written["port"].ingest_counters()["archiveSpansWritten"] == len(written["spans"])


def _queries():
    """(service, remote, span name, min duration, annotationQuery, limit)."""
    return [
        dict(service_name="svc01"),
        dict(service_name="svc02", span_name="op03"),
        dict(remote_service_name="svc04", service_name="svc00"),
        dict(min_duration=3000),
        dict(service_name="svc03", min_duration=1500, max_duration=40_000),
        dict(annotation_query={"error": ""}, limit=3),
        dict(service_name="wide1", annotation_query={"error": ""}),
        dict(span_name="serve", limit=50),
        # the post-filter starves the first scan: it widens once
        dict(service_name="svc01", annotation_query={"error": "boom"}, limit=20),
        dict(service_name="nobody"),
    ]


def assert_reads_equal(port, ref, spans) -> None:
    ids = sorted({s.trace_id for s in spans})
    for tid in ids:
        want = _canon([ref.get_trace(tid).execute()])
        assert _port_canon([port.get_trace(tid).execute()]) == want and want[0], tid
    # 64-bit renditions of the wide ids: their low halves only
    lows = sorted({s.trace_id[16:] for s in spans if len(s.trace_id) == 32})
    for tid in lows[:6]:
        assert _port_canon([port.get_trace(tid).execute()]) == _canon([ref.get_trace(tid).execute()])
    assert _port_canon(port.get_traces(ids + lows[:4]).execute()) == \
        _canon(ref.get_traces(ids + lows[:4]).execute())
    end_ts = max(s.timestamp for s in spans) // 1000 + 60_000
    for q in _queries():
        kw = {"end_ts": end_ts, "lookback": 30 * DAY_MS, "limit": 10, **q}
        want = _canon(ref.get_traces_query(RefQuery(**kw)).execute())
        assert _port_canon(port.get_traces_query(QueryRequest(**kw)).execute()) == want, q
    names = ref.get_service_names().execute()
    assert port.get_service_names().execute() == names and "wide2" in names
    for svc in names + ["nobody"]:
        assert port.get_span_names(svc).execute() == ref.get_span_names(svc).execute(), svc
        assert port.get_remote_service_names(svc).execute() == \
            ref.get_remote_service_names(svc).execute(), svc


def test_reads_equal(written):
    assert_reads_equal(written["port"], written["ref"], written["spans"])
    got = written["port"].get_traces_query(QueryRequest(
        end_ts=QUERY_TS + 400 * DAY_MS, lookback=800 * DAY_MS, limit=20, service_name="svc01",
        annotation_query={"error": "boom"})).execute()
    assert got and all(any(s.tags.get("error") == "boom" for s in t) for t in got)


@pytest.mark.parametrize("strict", [True, False], ids=["strict", "lenient"])
def test_each_package_reads_the_others_directory(written, strict):
    """A reference store on the port's directory and a port store on the
    reference's, both with an empty vocab (the sidecar brings the ids
    back), answer alike; lenient trace ids merge the wide renditions."""
    root = written["root"]
    ref = ref_store(root / "port", strict_trace_id=strict)
    port = port_store(root / "ref", strict_trace_id=strict)
    assert port.vocab._key_list == written["port"].vocab._key_list
    assert_reads_equal(port, ref, written["spans"])
    wide = [s for s in written["spans"] if len(s.trace_id) == 32][0]
    both = port.get_trace(wide.trace_id[16:]).execute()
    assert len(both) == (4 if not strict else 0)


# -- the storage contract with the disk as the store of record --------------


class TestDiskArchiveContract(StorageContract):
    @pytest.fixture(autouse=True)
    def _tmp(self, tmp_path_factory):
        self._tpf = tmp_path_factory

    def make_storage(self, **kwargs):
        kwargs.setdefault("pad_to_multiple", 256)
        kwargs.setdefault("archive_max_span_count", 8)
        return WireStorage(TorchStorage(
            config=kwargs.pop("config", SMALL), device="cpu",
            archive_dir=str(self._tpf.mktemp("span_archive")), **kwargs))


class TestDiskArchiveContractLenient(TestDiskArchiveContract):
    def make_storage(self, **kwargs):
        kwargs.setdefault("strict_trace_id", False)
        return super().make_storage(**kwargs)


# -- units: the archive itself -----------------------------------------------


def _batch(n, seed=0, trace_base=1000):
    rng = np.random.default_rng(seed)
    z = np.zeros(n, np.uint32)
    return dict(
        payload=b"x" * (n * 10), span_off=np.arange(n, dtype=np.uint32) * 10,
        span_len=np.full(n, 10, np.uint32),
        tl0=(trace_base + np.arange(n) // 4).astype(np.uint32), tl1=z, th0=z, th1=z,
        svc=rng.integers(1, 5, n).astype(np.uint32), rsvc=z,
        name=rng.integers(1, 9, n).astype(np.uint32), key=rng.integers(1, 9, n).astype(np.uint32),
        ts_min=np.full(n, 500, np.uint32), dur=rng.integers(1, 1000, n).astype(np.uint64),
        err=np.zeros(n, bool),
    )


def test_roundtrip_live_and_sealed(tmp_path):
    arc = SpanArchive(str(tmp_path / "a"), segment_bytes=1 << 20)
    arc.append_batch(**_batch(16))
    raw = arc.fetch_trace_raw(1000, 0, 0, 0, strict=False)
    assert len(raw) == 4 and all(r == b"x" * 10 for r in raw)
    arc.flush()
    assert len(arc.fetch_trace_raw(1000, 0, 0, 0, strict=False)) == 4
    arc.close()


def test_strict_high_lane_filter(tmp_path):
    arc = SpanArchive(str(tmp_path / "a"))
    b = _batch(4)
    b["th0"] = np.array([7, 7, 8, 8], np.uint32)
    b["tl0"] = np.full(4, 42, np.uint32)
    arc.append_batch(**b)
    assert len(arc.fetch_trace_raw(42, 0, 0, 0, strict=False)) == 4
    assert len(arc.fetch_trace_raw(42, 0, 7, 0, strict=True)) == 2
    arc.close()


def test_retention_drops_oldest_whole_segments(tmp_path):
    arc = SpanArchive(str(tmp_path / "a"), max_bytes=6000, segment_bytes=2000)
    for i in range(8):
        arc.append_batch(**_batch(64, seed=i, trace_base=10_000 * (i + 1)))
    arc.flush()
    c = arc.counters()
    assert c["archiveSpansDroppedRetention"] > 0
    assert c["archiveBytes"] <= 6000 + 4000  # the budget and one live segment
    assert arc.fetch_trace_raw(80_000, 0, 0, 0, strict=False)
    assert not arc.fetch_trace_raw(10_000, 0, 0, 0, strict=False)
    arc.close()


@pytest.mark.parametrize("torn", [False, True], ids=["clean", "torn"])
def test_recovery_rebuilds_the_unsealed_tail(tmp_path, torn):
    d = str(tmp_path / "a")
    arc = SpanArchive(d)
    arc.append_batch(**_batch(8))
    path = arc._live_path
    arc._live_fh.close()  # a crash: no flush, no close
    arc._live_fh = None
    if torn:
        with open(path, "ab") as fh:  # a partial frame
            fh.write(b"\x43\x52\x41\x5agarbage")
    arc2 = SpanArchive(d)
    assert len(arc2.fetch_trace_raw(1000, 0, 0, 0, strict=False)) == 4
    arc2.append_batch(**_batch(8, trace_base=5000))  # appends still work
    assert len(arc2.fetch_trace_raw(5000, 0, 0, 0, strict=False)) == 4
    assert arc2.counters()["archiveSpansWritten"] == 16
    arc2.close()


def test_candidate_scan_filters(tmp_path):
    arc = SpanArchive(str(tmp_path / "a"))
    b = _batch(16)
    b["svc"] = np.array([1] * 8 + [2] * 8, np.uint32)
    b["dur"] = np.arange(1, 17, dtype=np.uint64) * 100
    arc.append_batch(**b)
    got = arc.candidate_trace_ids(ts_lo_min=0, ts_hi_min=1 << 30, svc_id=2, min_dur=1500)
    assert got and all(i64 >= 1003 for i64, _ in got)
    arc.close()


def _y_base(n):
    z = np.zeros(n, np.uint32)
    return dict(span_off=np.arange(n, dtype=np.uint32) * 10, span_len=np.full(n, 10, np.uint32),
                tl1=z, th0=z, th1=z, svc=np.ones(n, np.uint32), rsvc=z,
                name=np.ones(n, np.uint32), key=np.ones(n, np.uint32),
                ts_min=np.full(n, 5, np.uint32), dur=np.ones(n, np.uint64),
                err=np.zeros(n, bool))


@pytest.mark.parametrize("live", [False, True], ids=["sealed", "live"])
def test_a_held_view_reads_after_retention_unlinks(tmp_path, live):
    """A views() snapshot keeps reading a segment that retention deleted
    under it, through the segment's retained fd: partial, never an error
    (and a snapshot of the live segment resolves after it seals)."""
    arc = SpanArchive(str(tmp_path / "a"), max_bytes=1 << 30, segment_bytes=1 << 20)
    n, payload = 64, b"y" * 640
    arc.append_batch(payload=payload, tl0=np.full(n, 7, np.uint32), **_y_base(n))
    if not live:
        arc.flush()
    views = arc.views()
    assert isinstance(views[0][2], str) == live
    path = views[0][2] if live else views[0][2].path
    arc.flush()
    arc.max_bytes = 1
    arc.append_batch(payload=payload, tl0=np.full(n, 9, np.uint32), **_y_base(n))
    arc.flush()
    assert not os.path.exists(path)
    raw = arc.fetch_trace_raw(7, 0, 0, 0, strict=False, views=views)
    assert len(raw) == n and raw[0] == b"y" * 10
    arc.close()


def _zone_archive(tmp_path, n_segments=6):
    arc = SpanArchive(str(tmp_path / "z"), max_bytes=1 << 30, segment_bytes=1 << 14)
    for seg in range(n_segments):
        b = _batch(64, seed=seg, trace_base=10_000 * (seg + 1))
        # segment k holds only service k+10 at minute 1000*k
        b["svc"] = np.full(64, seg + 10, np.uint32)
        b["ts_min"] = np.full(64, 1000 * seg, np.uint32)
        arc.append_batch(**b)
        arc.flush()
    return arc


def test_zone_map_skips_and_never_changes_an_answer(tmp_path):
    arc = _zone_archive(tmp_path)
    views = arc.views()
    blind = [(i, c, s, None) for (i, c, s, _m) in views]
    for kwargs in (
        dict(ts_lo_min=0, ts_hi_min=1 << 31, svc_id=12),
        dict(ts_lo_min=2000, ts_hi_min=2999),
        dict(ts_lo_min=0, ts_hi_min=1 << 31, svc_id=12, name_id=3),
        dict(ts_lo_min=0, ts_hi_min=1 << 31, svc_id=999),
        dict(ts_lo_min=0, ts_hi_min=1 << 31, min_dur=100_000_000),
    ):
        assert arc.candidate_trace_ids(limit=1000, views=views, **kwargs) == \
            arc.candidate_trace_ids(limit=1000, views=blind, **kwargs), kwargs
    base = arc.segments_skipped
    assert arc.candidate_trace_ids(ts_lo_min=0, ts_hi_min=1 << 31, svc_id=12, limit=1000)
    assert arc.segments_skipped - base == 5  # all but segment 2
    base = arc.segments_skipped
    assert arc.candidate_trace_ids(ts_lo_min=4000, ts_hi_min=4999, limit=1000)
    assert arc.segments_skipped - base == 5
    arc.close()


def test_zone_map_rebuilt_when_missing(tmp_path):
    arc = _zone_archive(tmp_path, n_segments=3)
    want = arc.candidate_trace_ids(ts_lo_min=0, ts_hi_min=1 << 31, svc_id=11, limit=1000)
    arc.close()
    for f in os.listdir(tmp_path / "z"):
        if f.endswith(".meta.npz"):
            os.remove(tmp_path / "z" / f)
    arc2 = SpanArchive(str(tmp_path / "z"), max_bytes=1 << 30, segment_bytes=1 << 14)
    got = arc2.candidate_trace_ids(ts_lo_min=0, ts_hi_min=1 << 31, svc_id=11, limit=1000)
    assert got == want and got
    assert len([f for f in os.listdir(tmp_path / "z") if f.endswith(".meta.npz")]) == 3
    arc2.close()


def test_service_capacity_guard():
    """The index packs svc and rsvc into 16 bits each: AggConfig refuses a
    service capacity past the packed wire's limit, the same bound, so no
    config can truncate the archive's lanes."""
    from zipkin_tpu_torch.tpu.columnar import MAX_WIRE_SERVICES

    with pytest.raises(ValueError, match="65536"):
        AggConfig(max_services=1 << 17)
    assert MAX_WIRE_SERVICES <= 1 << 16


# -- units: the store's archive paths ----------------------------------------


def test_every_acked_trace_readable_after_the_fast_path(tmp_path, compiler):
    store = port_store(tmp_path / "arc")
    spans = lots_of_spans(2048, seed=3, services=6, span_names=12)
    assert store.ingest_json_fast(ref_json.encode_span_list(spans)) == (2048, 0)
    by_trace = {}
    for s in spans:
        by_trace.setdefault(s.trace_id, []).append(s)
    got = store.get_traces(list(by_trace)).execute()
    assert len(got) == len(by_trace)  # every trace, not 1 in 64
    for trace in got:
        assert {s.id for s in trace} == {s.id for s in by_trace[trace[0].trace_id]}
    assert store.ingest_counters()["archiveSpansWritten"] == 2048
    assert store._archive.span_count == 0  # the host sample is skipped
    store.close()


def test_min_duration_and_annotation_query_post_filter(tmp_path, compiler):
    store = port_store(tmp_path / "arc")
    store.ingest_json_fast(ref_json.encode_span_list(TRACE))
    q = dict(end_ts=QUERY_TS, lookback=DAY_MS, limit=10, service_name="backend")
    assert len(store.get_traces_query(QueryRequest(
        min_duration=50_000, annotation_query={"error": ""}, **q)).execute()) == 1
    assert store.get_traces_query(QueryRequest(annotation_query={"nope": ""}, **q)).execute() == []
    store.close()


def test_search_and_names_survive_a_restart(tmp_path, compiler):
    """The columns hold vocab ids: the sidecar brings the id space back on
    an archive-only restart, and the name maps with it."""
    d = tmp_path / "arc"
    store = port_store(d)
    spans = lots_of_spans(512, seed=4, services=3, span_names=6)
    store.ingest_json_fast(ref_json.encode_span_list(spans))
    svc, tid = spans[0].local_service_name, spans[100].trace_id
    names = store.get_service_names().execute()
    store.close()
    store2 = port_store(d)
    assert store2.get_traces_query(QueryRequest(
        end_ts=1 << 50, lookback=1 << 50, limit=5, service_name=svc)).execute()
    got = store2.get_trace(tid).execute()
    assert got and all(s.trace_id == tid for s in got)
    assert store2.get_service_names().execute() == names
    store2.close()


def test_remote_names_first_seen_after_the_vocab_stops_growing_survive_a_restart(
        tmp_path, compiler):
    """A (service, remote service) pair whose names are both interned
    already grows no vocab entry, but the sidecar must still record it: the
    reference writes the sidecar only when the vocab grows, and an
    archive-only restart then lost such pairs from getRemoteServiceNames."""
    a, b, c = (Endpoint.create(n, "10.2.0.1") for n in ("a", "b", "c"))

    def client(i, remote):
        return Span.create(f"{i:016x}", "1", name="get", kind="CLIENT", duration=10,
                           timestamp=1_700_000_000_000_000 + i, local_endpoint=a,
                           remote_endpoint=remote)

    store = port_store(tmp_path / "arc")
    alone = Span.create(f"{9:016x}", "2", name="get", timestamp=1_700_000_000_000_000,
                        duration=5, local_endpoint=c)
    store.ingest_json_fast(ref_json.encode_span_list([client(1, b), alone]))
    size = len(store.vocab.services), store.vocab.num_keys
    store.ingest_json_fast(ref_json.encode_span_list([client(2, c)]))
    assert (len(store.vocab.services), store.vocab.num_keys) == size  # no vocab growth
    assert store.get_remote_service_names("a").execute() == ["b", "c"]
    store2 = port_store(tmp_path / "arc")  # an archive-only restart
    assert store2.get_remote_service_names("a").execute() == ["b", "c"]
    assert store2.get_service_names().execute() == ["a", "c"]
    store2.close()


def test_a_rotted_vocab_sidecar_is_quarantined_at_boot(tmp_path, compiler):
    d = tmp_path / "arc"
    store = port_store(d)
    store.ingest_json_fast(ref_json.encode_span_list(TRACE))
    store.close()
    meta = json.loads((d / "vocab.json").read_text())
    meta["services"][1] = "mallory"
    (d / "vocab.json").write_text(json.dumps(meta))
    store2 = port_store(d)
    assert (d / "vocab.json.quarantine").exists() and not (d / "vocab.json").exists()
    assert len(store2.vocab.services) == 1 and store2.get_service_names().execute() == []
    assert store2.get_trace(TRACE[0].trace_id).execute()  # id reads need no vocab
    store2.close()


def test_autocomplete_fed_with_the_disk_archive_on(tmp_path, compiler):
    """autocompleteTags answers from the host archive only, so with
    autocomplete keys the fast path keeps feeding its sample."""
    store = port_store(tmp_path / "arc", fast_archive_sample=1, autocomplete_keys=("env",))
    ep = Endpoint.create("svc", "127.0.0.1")
    spans = [Span.create(f"{i + 1:032x}", f"{i + 1:016x}", name="get", local_endpoint=ep,
                         timestamp=1_700_000_000_000_000 + i, duration=1000, tags={"env": "prod"})
             for i in range(8)]
    store.ingest_json_fast(ref_json.encode_span_list(spans))
    assert store.get_keys().execute() == ["env"]
    assert store.get_values("env").execute() == ["prod"]
    assert store.get_trace(spans[3].trace_id).execute()  # merged from both archives
    store.close()


def test_sampled_fast_path_archives_only_the_kept_spans(tmp_path, compiler):
    """Sampling on: the device sees every span, the disk archive only the
    verdict-kept ones, compacted from the payload's holes."""
    cfg = AggConfig(**{**dataclasses.asdict(SMALL), "sampling": True})
    store = port_store(tmp_path / "arc", config=cfg)
    rate = np.full(SMALL.max_services, 65536 // 4, np.uint32)
    store.sampler.set_tables(rate, store.sampler.tail, np.full_like(store.sampler.link, 1 << 20))
    store.install_sampler()
    spans = lots_of_spans(1000, seed=9, services=6, span_names=5)
    store.ingest_json_fast(ref_json.encode_span_list(spans))
    counters = store.ingest_counters()
    kept = counters["sampledKept"]
    assert counters["spans"] == 1000 and 0 < kept < 1000
    assert counters["archiveSpansWritten"] == kept
    got = store.get_traces(sorted({s.trace_id for s in spans})).execute()
    assert sum(len(t) for t in got) == kept
    data = (tmp_path / "arc" / "arc-00000000.dat").stat().st_size
    assert data < len(ref_json.encode_span_list(spans)) * 0.6  # dropped bytes not written
    store.close()


def test_full_disk_drops_and_flags_then_appends_resume(tmp_path, compiler):
    """The ``archive`` resource site: a full disk drops the batch and the
    live segment's rows, counted and flagged (the archive is a bounded,
    lossy cache; the device still ingests every span); the next append
    after the disk frees clears the flag."""
    store = port_store(tmp_path / "arc", archive_segment_bytes=1 << 20)
    bs = [lots_of_spans(300, seed=70 + i, services=4, span_names=4) for i in range(3)]
    faults.arm_resource("archive", nth=2, count=1)
    for b in bs:
        assert store.ingest_json_fast(ref_json.encode_span_list(b)) == (300, 0)
        if b is bs[1]:
            c = store.ingest_counters()
            assert (c["archiveAtRisk"], c["archiveEnospc"], c["archiveSpansDroppedEnospc"]) == (1, 1, 600)
    c = store.ingest_counters()
    assert c["archiveAtRisk"] == 0 and c["spans"] == 900 and c["archiveSpansWritten"] == 600
    assert not store.get_trace(bs[0][0].trace_id).execute()  # dropped with its segment
    assert store.get_trace(bs[2][0].trace_id).execute()
    assert not faults.is_resource_armed("archive")
    store.close()


@pytest.mark.parametrize("case", ["explicit", "off", "none", "0", "resume", "fast", "object"])
def test_default_posture(monkeypatch, tmp_path, case):
    """TPU_ARCHIVE_DIR when set (off/none/0: none), else <resume>/archive,
    else ./zipkin-tpu-archive made absolute in fast mode, else none."""
    from zipkin_tpu_torch.server.config import ServerConfig

    monkeypatch.chdir(tmp_path)
    for var in ("TPU_ARCHIVE_DIR", "TPU_RESUME_DIR", "TPU_ARCHIVE_MAX_BYTES",
                "TPU_ARCHIVE_SEGMENT_BYTES"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("TPU_FAST_INGEST", "false" if case == "object" else "true")
    want = None
    if case == "explicit":
        monkeypatch.setenv("TPU_ARCHIVE_DIR", str(tmp_path / "data" / "arc"))
        want = str(tmp_path / "data" / "arc")
    elif case in ("off", "none", "0"):
        monkeypatch.setenv("TPU_ARCHIVE_DIR", case.upper() if case == "off" else case)
    elif case == "resume":
        monkeypatch.setenv("TPU_RESUME_DIR", "state")
        want = str(tmp_path / "state" / "archive")
    elif case == "fast":
        want = str(tmp_path / "zipkin-tpu-archive")
    cfg = ServerConfig.from_env()
    assert cfg.tpu_archive_dir == want
    assert (cfg.tpu_archive_max_bytes, cfg.tpu_archive_segment_bytes) == (2 << 30, 64 << 20)
    assert os.listdir(tmp_path) == []  # resolving the posture writes nothing
