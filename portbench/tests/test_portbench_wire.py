"""The wire cell's stream and messages: the feed's stream unchanged by the
trace hash rule, the rule ``"id"`` equal to the port's own hash of the
ids it parses, the messages holding the generator's lanes one for one,
and a message off the native path failing the run."""

import hashlib
import json

import numpy as np
import pytest

from portbench import drive, run
from portbench.feeds import collector_json
from portbench.generator import Pool, service_name, span_name
from portbench.reference.sketch import trace_id_hash
from portbench.tests.small import small_cell

# sha256 of the feed mix's columns and trace hashes (batches 0, 7, 32, 39:
# two passes), as the generator made them before the rule existed
FEED_DIGESTS = {
    2_147_483_659: "5c27820f641c30e5cb1ee7b0122e00083172b483b17ea124745d37188b65490e",
    9_876_543_210_123: "55b4275eedf7c54e01498f1fd2f582587d7c9db6274ee49626aae13a01d4e779",
}


@pytest.mark.parametrize("seed", sorted(FEED_DIGESTS))
def test_the_feed_stream_is_unchanged(seed):
    p = Pool(run.load_json(run.HERE / "traffic" / "feed.json"), seed)
    h = hashlib.sha256()
    for g in (0, 7, p.size, p.size + 7):
        c = p.columns(g)
        for k in sorted(c):
            h.update(k.encode())
            h.update(np.ascontiguousarray(c[k]).tobytes())
        h.update(p.trace_hashes(g).tobytes())
    assert h.hexdigest() == FEED_DIGESTS[seed]


def wire():
    """The wire cell at the tests' size: its configuration, mix, pool, a
    CPU store and the feed entry on it."""
    _, _, config, mix = small_cell("default.wire-json")
    pool = Pool(mix, 3_000_000_019)
    store = drive.build_store(config, "cpu")
    return pool, store, collector_json.Entry(store, pool)


def test_the_id_rule_is_the_ports_hash_of_the_parsed_ids():
    from zipkin_tpu_torch import native
    from zipkin_tpu_torch.tpu.columnar import _hash2_np, pack_parsed

    rng = np.random.default_rng(5)
    a, b = rng.integers(0, 1 << 32, (2, 4096), dtype=np.uint32)
    zero = np.zeros(1, np.uint32)
    np.testing.assert_array_equal(trace_id_hash(a, b),
                                  _hash2_np(_hash2_np(a, b), _hash2_np(zero, zero)))
    pool, store, entry = wire()
    for g in (1, pool.size + 2):
        parsed = native.parse_spans(entry.inputs(g))
        cols = pack_parsed(parsed, store.vocab, pool.batch_spans)
        want = pool.columns(g)["trace_h"]
        np.testing.assert_array_equal(cols.trace_h, want)
        np.testing.assert_array_equal(
            np.repeat(pool.trace_hashes(g), pool.per_trace), want)


def test_the_messages_hold_the_columns():
    pool, _, entry = wire()
    names = int(pool.mix["names_per_service"])
    for g in (0, 3, pool.size, pool.size + 3):  # two passes
        msg = entry.inputs(g)
        assert len(msg) <= collector_json.MAX_MESSAGE_BYTES
        spans = json.loads(msg)
        c = pool.columns(g)
        assert len(spans) == pool.batch_spans
        for i, s in enumerate(spans):
            assert int(s["traceId"], 16) == int(c["tl1"][i]) << 32 | int(c["tl0"][i])
            assert int(s["id"], 16) == int(c["s1"][i]) << 32 | int(c["s0"][i])
            parent = int(c["p1"][i]) << 32 | int(c["p0"][i])
            assert int(s.get("parentId", "0"), 16) == parent
            assert s["kind"] == ("CLIENT", "SERVER")[int(c["kind"][i]) - 1]
            assert s.get("shared", False) == bool(c["shared"][i])
            assert s["name"] == span_name(int(c["key"][i]) % names)
            assert s["localEndpoint"]["serviceName"] == service_name(int(c["svc"][i]))
            remote = s.get("remoteEndpoint", {}).get("serviceName")
            assert remote == (service_name(int(c["rsvc"][i])) if c["rsvc"][i] else None)
            assert ("error" in s["tags"]) == bool(c["err"][i])
            assert s["duration"] == int(c["dur"][i])
            assert s["timestamp"] // 60_000_000 == int(c["ts_min"][i])


def test_a_message_off_the_native_path_fails_the_run(monkeypatch):
    from zipkin_tpu_torch import native

    pool, store, entry = wire()
    entry(entry.inputs(0))
    monkeypatch.setattr(native, "parse_spans", lambda *a, **k: None)
    with pytest.raises(collector_json.FastPathLeft):
        entry(entry.inputs(1))
