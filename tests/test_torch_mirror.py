"""The port's epoch-published read mirror (``zipkin_tpu_torch.tpu.mirror`` and
the store's wiring) on the CPU, against the JAX package's.

The reference's own cases (tests/test_read_mirror.py) run against the port:
the seqlock never serves a torn generation under a hammering publisher;
serve and age gauges; the bound and ``None``; idle epochs skipped, new
demand honored; the paced duty cycle; registry expiry and its bound; the
store's mirror serve equal to the fresh locked read at the publish instant
(quantiles, cardinalities, overview, dependencies); ``staleness_ms=0`` as
the lock path's escape hatch; exact default reads on a quiet lock; a
version-stale epoch served without the lock (zero acquisitions) while
another thread holds it; ``clear()``; the resume adapter publishing before
the first serve. Across packages: the four reads and a ``ttq:`` window
served from each package's mirror, on the same payloads, give the same
answers. The reference's brownout case: cache first loosens the bound to
the controller's, cache only serves any age, and both carry the served age.
The port's repair of in-process serves: the shaped answer of a mirror serve
is memoized for its generation (equal to a freshly shaped one), dropped by a
new generation and by ``clear()``, and bounded.

Tolerances are those of ``tests/test_torch_store.py``: counts, names and
links exact, histogram quantiles and cardinalities rtol 1e-6, digest
quantiles rtol 1e-5; a mirror serve against the same store's fresh read is
compared byte for byte.
"""

from __future__ import annotations

import dataclasses
import json
import threading
import time

import pytest

import tests.torch_cpu  # noqa: F401  (one intra-op thread a test process)
from tests.fixtures import lots_of_spans
from tests.test_torch_store import (
    QS, WEEK_MS, assert_cards_match, assert_rows_match, links, ref_store, small_store, to_port)
from tests.test_torch_wal import port_adapter
from zipkin_tpu_torch.tpu.mirror import ReadMirror


class _FakeAgg:
    """A versioned value source: every registered compute derives from
    ``value``, so a torn epoch shows as a mismatch."""

    def __init__(self):
        self.write_version = 0
        self.value = 0


def _mirror(agg, **kw):
    kw.setdefault("enabled", True)
    kw.setdefault("max_stale_ms", 5000.0)
    return ReadMirror(lambda: agg, **kw)


def _ingest(store, n=400, seed=7) -> int:
    """Ingest n spans; returns an endTs (ms) just past them."""
    spans = lots_of_spans(n, seed=seed, services=8, span_names=12)
    store.span_consumer().accept(to_port(spans)).execute()
    return max(s.timestamp for s in spans) // 1000 + 60_000


# -- the publication protocol -------------------------------------------------


def test_seqlock_fuzz_never_serves_a_torn_generation():
    agg = _FakeAgg()
    m = _mirror(agg)
    m.register("a", lambda: agg.value, pinned=True)
    m.register("b", lambda: agg.value, pinned=True)
    m.publish(force=True)
    stop = threading.Event()
    violations = []

    def publisher():
        while not stop.is_set():
            agg.value += 1
            agg.write_version += 1
            m.publish(force=True)

    def reader():
        for _ in range(3000):
            snap = m.snapshot()
            if snap is None:
                violations.append("no snapshot")
            elif snap.generation & 1:
                violations.append(f"odd generation {snap.generation}")
            elif snap.values["a"] != snap.values["b"]:
                violations.append(f"torn epoch: {snap.values['a']} != {snap.values['b']}")

    readers = [threading.Thread(target=reader) for _ in range(4)]
    pub = threading.Thread(target=publisher)
    for t in readers:
        t.start()
    pub.start()
    for t in readers:
        t.join()
    stop.set()
    pub.join()
    assert violations == [] and m.publishes > 0


def test_serve_counts_and_age_gauges():
    agg = _FakeAgg()
    m = _mirror(agg)
    m.register("k", lambda: agg.value, pinned=True)
    assert m.serve("k", 5000.0, agg.write_version) is None  # no epoch yet
    assert m.misses == 1
    m.publish(force=True)
    assert m.serve("k", 5000.0, agg.write_version) == (0, 0.0)  # version-fresh
    agg.write_version += 1  # stale, within the bound
    value, age = m.serve("k", 5000.0, agg.write_version)
    assert value == 0 and age >= 0.0
    assert (m.serves, m.stale_serves) == (2, 1)
    c = m.counters()
    assert c["mirrorServes"] == 2 and c["mirrorStaleServes"] == 1
    assert c["mirrorServeAgeMaxMs"] >= c["mirrorServeAgeMs"] >= 0.0
    # ages grow between publishes, and a publish at the live version resets
    ages = []
    for _ in range(4):
        time.sleep(0.002)
        ages.append(m.serve("k", None, agg.write_version)[1])
    assert ages == sorted(ages) and ages[0] > 0.0
    m.publish(force=True)
    assert m.serve("k", None, agg.write_version)[1] == 0.0
    assert m.serve("k", 5000.0, agg.write_version + 1, allow_stale=False) is None


def test_stale_beyond_bound_misses_and_bound_none_serves_any_age():
    agg = _FakeAgg()
    m = _mirror(agg)
    m.register("k", lambda: agg.value, pinned=True)
    m.publish(force=True)
    agg.write_version += 1
    m._snap.published_at -= 10.0  # the epoch is 10 s old
    assert m.serve("k", 5000.0, agg.write_version) is None
    hit = m.serve("k", None, agg.write_version)
    assert hit is not None and hit[1] >= 10_000.0


def test_publish_skips_idle_epochs_but_honors_new_demand():
    agg = _FakeAgg()
    m = _mirror(agg)
    m.register("k", lambda: agg.value, pinned=True)
    assert m.publish() is True
    assert m.publish() is False and m.publish_skips == 1  # nothing changed
    agg.write_version += 1
    assert m.publish() is True
    m.register("k2", lambda: agg.value)  # new demand alone cuts an epoch
    assert m.publish() is True and "k2" in m.snapshot().values


def test_paced_publish_caps_the_lock_duty_cycle():
    agg = _FakeAgg()
    m = _mirror(agg)
    m.register("k", lambda: agg.value, pinned=True)
    assert m.publish(paced=True) is True
    agg.write_version += 1
    m.last_publish_ms = 3_600_000.0  # as if the last epoch held the lock an hour
    assert m.publish(paced=True) is False
    assert m.publish_backoffs == 1 and m.publish_skips == 0
    assert m.publish() is True  # unpaced calls never back off
    agg.write_version += 1
    m.last_publish_ms = 3_600_000.0
    assert m.publish(force=True, paced=True) is True
    # a key registered during a backoff rides the next allowed epoch
    agg.write_version += 1
    m.last_publish_ms = 3_600_000.0
    m.register("late", lambda: agg.value)
    assert m.publish(paced=True) is False
    m.last_publish_ms = 0.001
    assert m.publish(paced=True) is True and "late" in m.snapshot().values


def test_demand_registry_expiry_and_bound():
    agg = _FakeAgg()
    m = _mirror(agg, max_keys=4)
    m.register("pin", lambda: 1, pinned=True)
    m.register("cold", lambda: 2)
    for _ in range(m.DEMAND_TTL_PUBLISHES + 2):
        agg.write_version += 1
        m.publish()
    assert "cold" not in m._demand and "pin" in m._demand
    for k in "abc":
        assert m.register(k, lambda: 1)
    assert m.register("overflow", lambda: 1) is False and m.demand_overflow == 1


# -- the store's wiring --------------------------------------------------------


@pytest.fixture
def store():
    s = small_store(archive_max_span_count=100_000)
    yield s
    s.close()


def test_mirror_serve_equals_the_fresh_read_at_the_publish_instant(store):
    _ingest(store)
    assert store.publish_mirror(force=True)
    for mirrored, fresh in (
        (lambda: store.latency_quantiles(QS), lambda: store.latency_quantiles(QS, staleness_ms=0)),
        (lambda: store.trace_cardinalities(), lambda: store.trace_cardinalities(staleness_ms=0)),
    ):
        serves = store.mirror.serves
        got = mirrored()
        assert store.mirror.serves == serves + 1, "the read did not come from the mirror"
        assert json.dumps(got, sort_keys=True) == json.dumps(fresh(), sort_keys=True)
    over_m = store.sketch_overview(QS)
    over_f = store.sketch_overview(QS, staleness_ms=0)
    assert over_m["percentiles"] == over_f["percentiles"]
    assert over_m["cardinalities"] == over_f["cardinalities"]
    # every value the epoch holds is host data: nothing a reader process
    # could not unpickle
    assert not [k for k, v in store.mirror.snapshot().values.items()
                if "torch" in type(v).__module__
                or any("torch" in type(x).__module__ for x in (v if isinstance(v, tuple) else ()))]


def test_dependencies_mirror_parity_and_demand_registration(store):
    end_ts = _ingest(store)
    fresh = store.get_dependencies(end_ts, WEEK_MS).execute()  # a miss registers the key
    assert store.publish_mirror(force=True)
    serves = store.mirror.serves
    mirrored = store.get_dependencies(end_ts, WEEK_MS).execute()
    assert store.mirror.serves == serves + 1
    assert fresh and links(mirrored) == links(fresh)


def test_staleness_zero_is_the_lock_path_escape_hatch(store):
    _ingest(store)
    store.publish_mirror(force=True)
    serves = store.mirror.serves
    store.trace_cardinalities(staleness_ms=0)
    assert store.mirror.serves == serves
    store.mirror.enabled = False  # off wholesale: every read takes the lock
    store.trace_cardinalities()
    assert store.mirror.serves == serves


def test_default_reads_stay_exact_on_a_quiet_lock(store):
    store.publish_mirror(force=True)  # an epoch of the empty state
    _ingest(store)
    assert store.trace_cardinalities()["_global"] > 0.0, "served the stale epoch"
    store.publish_mirror(force=True)
    serves = store.mirror.serves
    assert store.trace_cardinalities()["_global"] > 0.0
    assert store.mirror.serves == serves + 1


def test_contended_lock_serves_the_stale_epoch_without_the_lock(store):
    _ingest(store)
    store.publish_mirror(force=True)
    store.agg.write_version += 1  # the epoch is now version-stale
    held, release = threading.Event(), threading.Event()

    def holder():
        with store.agg.lock:
            held.set()
            release.wait(10.0)

    t = threading.Thread(target=holder)
    t.start()
    assert held.wait(10.0)
    try:
        lock = store.agg.lock
        acquired = (lock.acquisitions, lock.reentries, lock.contended)
        serves, stale = store.mirror.serves, store.mirror.stale_serves
        store.trace_cardinalities()  # a default request while the lock is busy
        assert (store.mirror.serves, store.mirror.stale_serves) == (serves + 1, stale + 1)
        assert (lock.acquisitions, lock.reentries, lock.contended) == acquired
    finally:
        release.set()
        t.join()


def test_clear_resets_the_published_epoch(store):
    _ingest(store)
    store.publish_mirror(force=True)
    assert store.mirror.snapshot() is not None
    store.clear()
    assert store.mirror.snapshot() is None
    assert store.publish_mirror(force=True)  # pinned demand refills
    assert store.trace_cardinalities().get("_global", 0.0) == 0.0


def test_crash_resume_publishes_before_the_first_serve(tmp_path):
    victim = port_adapter(tmp_path)
    _ingest(victim)
    victim.snapshot()
    want = victim.trace_cardinalities(staleness_ms=0)
    victim.close()
    revived = port_adapter(tmp_path)
    try:
        assert revived.mirror.publishes >= 1
        serves = revived.mirror.serves
        got = revived.trace_cardinalities()
        assert revived.mirror.serves == serves + 1, "the first read did not serve from the mirror"
        assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
        assert revived.agg.read_stats["host_transfers"] == 0  # boot pulls are not queries
    finally:
        revived.close()


# -- across packages -------------------------------------------------------------


def test_the_four_reads_and_a_window_from_both_mirrors_agree():
    """The same payloads through both stores, the time tier sealed, each
    read registered by a miss and then served from each package's own
    published epoch."""
    base = lots_of_spans(3000, seed=8, services=5, span_names=4)
    minute = 60_000_000
    spans = [dataclasses.replace(s, timestamp=s.timestamp + (i // 1000) * 5 * minute)
             for i, s in enumerate(base)]
    ref, port = ref_store(), small_store()
    ref._deps_max_stale_ms = port._deps_max_stale_ms = 5000.0
    port.accept(to_port(spans)).execute()
    ref.accept(spans).execute()
    assert port.tt_seal() == ref.tt_seal() == 3
    first_ms = min(s.timestamp for s in spans) // 1000
    win = dict(end_ts=first_ms + 9 * 60_000, lookback=9 * 60_000)  # sealed buckets only
    end_ts = max(s.timestamp for s in spans) // 1000 + 60_000

    def reads(store):
        return dict(
            quant=store.latency_quantiles(QS),
            hist=store.latency_quantiles(QS, use_digest=False),
            card=store.trace_cardinalities(),
            over=store.sketch_overview(QS),
            deps=links(store.get_dependencies(end_ts, WEEK_MS).execute()),
            wquant=store.latency_quantiles(QS, **win),
            wcard=store.trace_cardinalities(**win),
            wdeps=links(store.get_dependencies(win["end_ts"], win["lookback"]).execute()),
        )

    for store in (ref, port):
        reads(store)  # misses: each key registers its demand
        assert store.publish_mirror(force=True)
    out = {}
    for name, store in (("ref", ref), ("port", port)):
        serves = store.mirror.serves
        out[name] = reads(store)
        assert store.mirror.serves - serves == 8, name  # every read a mirror serve
        assert any(k.startswith("ttq:") for k in store.mirror.snapshot().values)
    got, want = out["port"], out["ref"]
    assert_rows_match(got["quant"], want["quant"], rtol=1e-5)
    assert_rows_match(got["hist"], want["hist"], rtol=1e-6)
    assert_rows_match(got["wquant"], want["wquant"], rtol=1e-5)
    assert_rows_match(got["over"]["percentiles"], want["over"]["percentiles"], rtol=1e-5)
    for k in ("card", "wcard"):
        assert_cards_match(got[k], want[k])
    assert_cards_match(got["over"]["cardinalities"], want["over"]["cardinalities"])
    assert got["deps"] and got["deps"] == want["deps"]
    assert got["wdeps"] and got["wdeps"] == want["wdeps"]
    port.close()
    ref.close()


class _FakeCtl:
    def __init__(self, mode="normal", max_stale_ms=60_000):
        self.mode = mode
        self.max_stale_ms = max_stale_ms

    def read_mode(self):
        return self.mode


def test_brownout_cache_first_and_cache_only_carry_mirror_age(store):
    """B1/B2 (cache first) loosen the bound to the controller's
    ``max_stale_ms``; B3 (cache only) serves any age; both serve the mirror
    and the staleness gauges carry the served age."""
    _ingest(store)
    store.publish_mirror(force=True)
    store.agg.write_version += 1  # the epoch is now version-stale
    store.mirror._snap.published_at -= 10.0  # and 10 s old
    serves = store.mirror.serves
    store.trace_cardinalities()  # normal: 10 s is past the 5 s bound
    assert store.mirror.serves == serves
    store.overload = _FakeCtl("cache_first", max_stale_ms=60_000)
    store.trace_cardinalities()
    assert store.mirror.serves == serves + 1
    assert store.ingest_counters()["mirrorServeAgeMs"] >= 10_000.0
    store.mirror._snap.published_at -= 100.0
    store.overload = _FakeCtl("cache_only", max_stale_ms=0)
    store.trace_cardinalities()
    assert store.mirror.serves == serves + 2
    assert store.ingest_counters()["mirrorServeAgeMs"] >= 100_000.0
    assert store.ingest_counters()["mirrorStaleServes"] >= 2


def test_a_mirror_serve_memoizes_its_shaped_answer_for_the_generation(store):
    """Concurrent serves of one epoch shape it once: at one generation the
    memoized answer equals a freshly shaped one (and the same store's fresh
    read); a new generation and ``clear()`` drop the memo; the memo keeps
    at most ``_SHAPE_MEMO_MAX`` entries."""
    from zipkin_tpu_torch.tpu import store as store_mod

    _ingest(store)
    assert store.publish_mirror(force=True)
    svc = [n for n in store.vocab.services.names if n][:2]

    def overview(name):
        out = store.sketch_overview(QS, name)
        del out["counters"]  # live gauges, read per request
        return out

    reads = [lambda: store.latency_quantiles(QS), lambda: store.trace_cardinalities(),
             lambda: overview(svc[0]), lambda: store.latency_quantiles(QS, service_name=svc[1])]
    first = [json.dumps(r(), sort_keys=True, default=str) for r in reads]
    assert all(json.loads(f) for f in first)
    hits = store._shape_memo_hits
    again = [r() for r in reads]
    assert store._shape_memo_hits == hits + len(reads)  # every serve came from the memo
    for got, want in zip(again, first):
        assert json.dumps(got, sort_keys=True, default=str) == want
    assert store.latency_quantiles(QS) == store.latency_quantiles(QS, staleness_ms=0)
    assert store.trace_cardinalities() == store.trace_cardinalities(staleness_ms=0)
    gen = store.mirror.gen
    assert store._shape_memo[0] == gen and len(store._shape_memo[1]) == len(reads)
    # a new generation: the first serve shapes afresh
    _ingest(store, seed=8)
    assert store.publish_mirror(force=True) and store.mirror.gen != gen
    hits = store._shape_memo_hits
    assert store.latency_quantiles(QS) == store.latency_quantiles(QS, staleness_ms=0)
    assert store._shape_memo_hits == hits and store._shape_memo[0] == store.mirror.gen
    store.clear()
    assert store._shape_memo == (-1, {})
    # bounded: distinct shaping arguments past the cap are served unmemoized
    _ingest(store)
    assert store.publish_mirror(force=True)
    for i in range(store_mod._SHAPE_MEMO_MAX + 10):
        store.latency_quantiles(QS, service_name=f"none{i}")
    assert len(store._shape_memo[1]) == store_mod._SHAPE_MEMO_MAX
