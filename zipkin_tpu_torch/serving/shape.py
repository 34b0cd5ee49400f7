"""Reader-side serving: payload decode + the store's row shaping, replicated
(the port's copy of ``zipkin_tpu/serving/shape.py``).

A :class:`SegmentView` wraps one attached :class:`MirrorSegment` and
serves the four read endpoints from the deserialized epoch payload —
the same mirror keys, the same route selection (time-tier vs minute
windows), and byte-identical row shaping to `tpu/store.py`'s
``_quantile_rows_inner`` / ``_cardinality_rows`` /
``_tt_dependency_links`` — so reader-vs-ingest parity at a shared
generation holds by construction (`tests/test_torch_serving.py`
enforces it endpoint by endpoint).

Staleness contract (the 503 half of the mirror's): every answer is
stamped with its real age (monotonic now − the epoch's publish
instant in the segment header, which an idle publisher re-stamps;
CLOCK_MONOTONIC is cross-process comparable on Linux). An
age over the effective bound — the request's ``staleness_ms`` when
given, else the bound the publisher stamped into the payload — raises
:class:`StalenessExceeded`; ``staleness_ms <= 0`` (the fresh-read
escape hatch) always raises, because a reader process CANNOT serve
fresh — the front end maps both to 503 + Retry-After, never a silent
stale answer. A key the epoch does not carry raises
:class:`SegmentMiss` after registering the key on the reader's demand
stripe, so the next epoch carries it.

Serve cost: decoded payloads and shaped responses are memoized PER
SEGMENT GENERATION (the reader-side analogue of the store's versioned
``_cached_read``) — a polling dashboard's repeat query is one header
word compare + one dict hit.

Imported by reader processes: numpy + stdlib only, no torch:
it imports ``obs``, ``obs.querytrace``, ``ops.ttmerge`` and
``internal.hex``, all four torch-free.
"""

from __future__ import annotations

import pickle
import time
import zlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from zipkin_tpu_torch import obs
from zipkin_tpu_torch.internal.hex import epoch_minutes
from zipkin_tpu_torch.obs import querytrace
from zipkin_tpu_torch.ops import ttmerge
from zipkin_tpu_torch.serving.segment import MirrorSegment, SegmentUnavailable

_MEMO_MAX = 256


class SegmentMiss(Exception):
    """The epoch does not carry this key; it has been demanded back to
    the publisher (503 + Retry-After — the next epoch carries it)."""

    def __init__(self, key: str, registered: bool) -> None:
        super().__init__(f"mirror key {key!r} not in the published epoch")
        self.key = key
        self.registered = registered


class StalenessExceeded(Exception):
    """The epoch is older than the request's bound (or the request
    demanded a fresh read, which a reader process cannot serve)."""

    def __init__(self, age_ms: float, bound_ms: float,
                 fresh_required: bool = False) -> None:
        super().__init__(
            f"epoch age {age_ms:.1f}ms exceeds bound {bound_ms:.1f}ms"
            if not fresh_required
            else "fresh read requested; readers serve published epochs only"
        )
        self.age_ms = age_ms
        self.bound_ms = bound_ms
        self.fresh_required = fresh_required


class _VocabView:
    """Read-only interner view rebuilt from the serialized name lists —
    the exact lookup/get semantics of `tpu/columnar.py` (id 0 = "",
    ``names`` excludes it, ``get`` knows only real ids)."""

    def __init__(self, services: List[str], span_names: List[str],
                 key_list) -> None:
        self.services = list(services)
        self.span_names = list(span_names)
        self.key_list = np.asarray(key_list, np.int32)
        self.svc_ids = {n: i for i, n in enumerate(self.services) if i}
        self.span_ids = {n: i for i, n in enumerate(self.span_names) if i}

    def svc_lookup(self, nid: int) -> str:
        return self.services[nid] if 0 <= nid < len(self.services) else ""

    def span_lookup(self, nid: int) -> str:
        return (
            self.span_names[nid] if 0 <= nid < len(self.span_names) else ""
        )


def quantile_rows(
    vv: _VocabView,
    qs: Sequence[float],
    source_q: np.ndarray,
    counts: np.ndarray,
    service_name: Optional[str],
    span_name: Optional[str],
) -> List[dict]:  # zt-reader-process: pure shaping over the decoded payload — replicates store._quantile_rows_inner byte-for-byte
    want_svc = vv.svc_ids.get(service_name.lower()) if service_name else None
    if service_name and want_svc is None:
        return []
    pairs = vv.key_list
    kids = np.arange(1, pairs.shape[0])
    mask = counts[kids] > 0
    if want_svc is not None:
        mask &= pairs[kids, 0] == want_svc
    if span_name:
        want_name = vv.span_ids.get(span_name.lower())
        if want_name is None:
            return []
        mask &= pairs[kids, 1] == want_name
    out = []
    for kid in kids[mask]:
        out.append(
            {
                "serviceName": vv.svc_lookup(int(pairs[kid, 0])),
                "spanName": vv.span_lookup(int(pairs[kid, 1])),
                "count": int(counts[kid]),
                "quantiles": {
                    float(q): float(source_q[kid, i])
                    for i, q in enumerate(qs)
                },
            }
        )
    return out


def cardinality_rows(
    vv: _VocabView, est: np.ndarray, global_row: int
) -> dict:  # zt-reader-process: pure shaping — replicates store._cardinality_rows output (envelope accounting is ingest-side)
    out = {"_global": float(est[global_row])}
    for name in vv.services[1:]:
        sid = vv.svc_ids.get(name)
        if sid:
            out[name] = float(est[sid])
    return out


def dependency_rows(
    vv: _VocabView, calls: np.ndarray, errs: np.ndarray
) -> List[dict]:  # zt-reader-process: pure shaping — store._tt_dependency_links + json_v2.link_to_dict, fused
    dense_c = np.asarray(calls)
    dense_e = np.asarray(errs)
    p_idx, c_idx = np.nonzero(dense_c)
    out: List[dict] = []
    for p, c in zip(p_idx, c_idx):
        parent = vv.svc_lookup(int(p))
        child = vv.svc_lookup(int(c))
        if not parent or not child:
            continue
        row = {
            "parent": parent,
            "child": child,
            "callCount": int(dense_c[p, c]),
        }
        if int(dense_e[p, c]):
            row["errorCount"] = int(dense_e[p, c])
        out.append(row)
    return out


def tt_epochs(end_ts: int, lookback: Optional[int], g: int) -> Tuple[int, int]:
    """Bucket-aligned epoch range — store._tt_epochs, replicated."""
    lb = lookback if lookback is not None else end_ts
    lo_ep = max(0, epoch_minutes(end_ts - lb) // g)
    hi_ep = max(0, epoch_minutes(end_ts) // g)
    return lo_ep, hi_ep


def _qkey(qs: Sequence[float]) -> str:
    return ",".join(f"{q:.6g}" for q in qs)


class _Epoch:
    """One decoded segment generation: the payload, its vocab view and its
    memo. Immutable but for the memo's GIL-atomic item stores, and swapped
    in as one reference, so request threads need no lock between them."""

    __slots__ = ("gen", "crc", "mgen", "pub_s", "p", "vv", "memo")

    def __init__(self, gen: int, crc: int, mgen: int, pub_ns: int, p: dict,
                 vv: Optional["_VocabView"] = None, memo: Optional[dict] = None) -> None:
        self.gen = gen
        self.crc = crc
        self.mgen = mgen
        self.pub_s = pub_ns / 1e9  # the header's publish instant, monotonic
        self.p = p
        self.vv = vv if vv is not None else _VocabView(p["services"], p["span_names"],
                                                       p["key_list"])
        self.memo: Dict[tuple, object] = memo if memo is not None else {}

    def restamped(self, gen: int, pub_ns: int) -> "_Epoch":
        """The same decoded epoch under a re-stamped header."""
        return _Epoch(gen, self.crc, self.mgen, pub_ns, self.p, self.vv, self.memo)


class SegmentView:
    """One reader's lock-free serving facade over the mirror segment.

    One view per reader process, shared by the front end's request
    threads: each serve takes the current :class:`_Epoch` once and reads
    only it, so a refresh racing a serve never pairs one generation's
    values with another's vocab (the reference serves from one asyncio
    loop; the counters are debug gauges, torn increments tolerated). All
    segment access is the seqlock read protocol — no lock, in any
    process, anywhere on the serve path.
    """

    def __init__(self, segment: MirrorSegment, reader_idx: int = 0) -> None:
        self._seg = segment
        self.reader_idx = int(reader_idx)
        self._ep: Optional[_Epoch] = None
        # reader-local ledger (heartbeat words mirror the highlights)
        self.serves = 0
        self.misses = 0
        self.stale_rejects = 0
        self.fresh_rejects = 0
        self.unavailable = 0
        self.decodes = 0
        self.memo_hits = 0
        self.demand_requests = 0
        self.demand_overflow = 0
        self.errors = 0
        self.serve_age_ms = 0.0
        self.serve_age_max_ms = 0.0

    # -- epoch refresh -----------------------------------------------------

    @property
    def _gen(self) -> int:
        ep = self._ep
        return ep.gen if ep is not None else -1

    def refresh(self) -> dict:  # zt-reader-process: seqlock frame read + unpickle; memoized per segment generation
        """The current epoch's decoded payload."""
        return self._epoch().p

    def _epoch(self) -> _Epoch:
        """Seqlock frame read + unpickle, memoized per segment generation;
        a generation that only re-stamped the same payload (same CRC and
        mirror generation) keeps the decoded epoch and its memo."""
        ep = self._ep
        if ep is not None:
            if self._seg.generation() == ep.gen:
                return ep
            stamp = self._seg.read_stamp()
            if stamp is not None and (stamp[1], stamp[2]) == (ep.crc, ep.mgen):
                ep = ep.restamped(stamp[0], stamp[3])
                self._ep = ep
                return ep
        frame = self._seg.read_frame()
        ep = _Epoch(frame.gen, zlib.crc32(frame.payload), frame.mirror_generation,
                    frame.published_ns, pickle.loads(frame.payload))
        self._ep = ep
        self.decodes += 1
        return ep

    # -- staleness / miss plumbing ----------------------------------------

    def _age_ms(self, ep: _Epoch) -> float:
        return max(0.0, (time.monotonic() - ep.pub_s) * 1000.0)

    def _check_bound(self, ep: _Epoch, staleness_ms: Optional[float],
                     default_ms: float) -> float:
        age = self._age_ms(ep)
        if staleness_ms is not None and staleness_ms <= 0:
            self.fresh_rejects += 1
            raise StalenessExceeded(age, 0.0, fresh_required=True)
        bound = (
            float(staleness_ms) if staleness_ms is not None
            else float(default_ms)
        )
        if age > bound:
            self.stale_rejects += 1
            raise StalenessExceeded(age, bound)
        return age

    def _value(self, p: dict, key: str):
        val = p["values"].get(key)
        if val is None:
            self.demand_requests += 1
            registered = self._seg.demand_push(self.reader_idx, key)
            if not registered:
                self.demand_overflow += 1
            self.misses += 1
            self._beat()
            raise SegmentMiss(key, registered)
        return val

    def _k(self, tenant: Optional[str], base: str) -> str:
        return f"tenant:{tenant}:{base}" if tenant else base

    def _memoize(self, ep: _Epoch, mkey: tuple, build):
        hit = ep.memo.get(mkey)
        if hit is not None:
            self.memo_hits += 1
            return hit
        out = build()
        if len(ep.memo) < _MEMO_MAX:
            ep.memo[mkey] = out
        return out

    def _done(self, age_ms: float, t0: float, t0_ns: int) -> None:
        self.serves += 1
        self.serve_age_ms = age_ms
        if age_ms > self.serve_age_max_ms:
            self.serve_age_max_ms = age_ms
        self._beat()
        obs.record("reader_serve", time.perf_counter() - t0)
        querytrace.stamp_active(
            querytrace.QSEG_READER_SERVE, t0_ns, time.perf_counter_ns()
        )

    def _beat(self) -> None:
        self._seg.heartbeat(
            self.reader_idx,
            gen_seen=self._gen,
            serves=self.serves,
            age_us=int(self.serve_age_ms * 1000),
            demands=self.demand_requests,
            demand_overflow=self.demand_overflow,
            errors=self.errors,
        )

    # -- the four endpoints ------------------------------------------------

    def serve_dependencies(
        self, end_ts: int, lookback: int,
        staleness_ms: Optional[float] = None,
        tenant: Optional[str] = None,
    ) -> Tuple[List[dict], float]:  # zt-reader-process: route selection + shaping over the decoded epoch; no lock in any process
        t0 = time.perf_counter()
        t0_ns = time.perf_counter_ns()
        ep = self._epoch()
        p, vv = ep.p, ep.vv
        if p["tt_enabled"]:
            lo_ep, hi_ep = tt_epochs(
                end_ts, lookback, p["time_bucket_minutes"]
            )
            if lo_ep <= p["tt_sealed_through"]:
                key = self._k(tenant, f"ttq:{lo_ep}:{hi_ep}")
                ans = self._value(p, key)[1]
                age = self._check_bound(ep, staleness_ms, p["deps_max_stale_ms"])
                rows = self._memoize(
                    ep, ("deps", key),
                    lambda: dependency_rows(
                        vv, ans["calls"], ans["errs"]
                    ),
                )
                self._done(age, t0, t0_ns)
                return rows, age
        lo_min = epoch_minutes(end_ts - lookback)
        hi_min = epoch_minutes(end_ts)
        key = self._k(tenant, f"deps:{lo_min}:{hi_min}")
        val = self._value(p, key)
        age = self._check_bound(ep, staleness_ms, p["deps_max_stale_ms"])
        rows = val[1]
        self._done(age, t0, t0_ns)
        return rows, age

    def serve_quantiles(
        self,
        qs: Sequence[float],
        service_name: Optional[str] = None,
        span_name: Optional[str] = None,
        use_digest: bool = True,
        end_ts: Optional[int] = None,
        lookback: Optional[int] = None,
        staleness_ms: Optional[float] = None,
        tenant: Optional[str] = None,
    ) -> Tuple[List[dict], float]:  # zt-reader-process: store.latency_quantiles route selection, replicated over the epoch
        t0 = time.perf_counter()
        t0_ns = time.perf_counter_ns()
        ep = self._epoch()
        p, vv = ep.p, ep.vv
        if end_ts is None and lookback is not None:
            end_ts = int(time.time() * 1000)
        qkey = _qkey(qs)
        qs = tuple(qs)
        if end_ts is not None:
            lo_ep, hi_ep = (
                tt_epochs(end_ts, lookback, p["time_bucket_minutes"])
                if p["tt_enabled"] else (0, -1)
            )
            if (
                use_digest and p["tt_enabled"]
                and lo_ep <= p["tt_sealed_through"]
            ):
                key = self._k(tenant, f"ttq:{lo_ep}:{hi_ep}")
                ans = self._value(p, key)[1]
                age = self._check_bound(ep, staleness_ms, p["max_stale_ms"])
                rows = self._memoize(
                    ep, ("quant", key, qs, service_name, span_name),
                    lambda: quantile_rows(
                        vv, qs,
                        ttmerge.digest_quantile(
                            np.asarray(ans["digest"]), qs
                        ),
                        ttmerge.digest_total(np.asarray(ans["digest"])),
                        service_name, span_name,
                    ),
                )
                self._done(age, t0, t0_ns)
                return rows, age
            lb = lookback if lookback is not None else end_ts
            lo_min = epoch_minutes(end_ts - lb)
            hi_min = epoch_minutes(end_ts)
            key = self._k(tenant, f"quant:w:{lo_min}:{hi_min}:{qkey}")
        else:
            src = "digest" if use_digest else "hist"
            key = self._k(tenant, f"quant:{src}:{qkey}")
        val = self._value(p, key)
        age = self._check_bound(ep, staleness_ms, p["max_stale_ms"])
        source_q, counts = val[1], val[2]
        rows = self._memoize(
            ep, ("quant", key, qs, service_name, span_name),
            lambda: quantile_rows(
                vv, qs, source_q, counts, service_name, span_name
            ),
        )
        self._done(age, t0, t0_ns)
        return rows, age

    def serve_cardinalities(
        self,
        staleness_ms: Optional[float] = None,
        end_ts: Optional[int] = None,
        lookback: Optional[int] = None,
        tenant: Optional[str] = None,
    ) -> Tuple[dict, float]:  # zt-reader-process: store.trace_cardinalities route selection, replicated over the epoch
        t0 = time.perf_counter()
        t0_ns = time.perf_counter_ns()
        ep = self._epoch()
        p, vv = ep.p, ep.vv
        if end_ts is None and lookback is not None:
            end_ts = int(time.time() * 1000)
        if end_ts is not None and p["tt_enabled"]:
            lo_ep, hi_ep = tt_epochs(
                end_ts, lookback, p["time_bucket_minutes"]
            )
            key = self._k(tenant, f"ttq:{lo_ep}:{hi_ep}")
            ans = self._value(p, key)[1]
            age = self._check_bound(ep, staleness_ms, p["max_stale_ms"])
            rows = self._memoize(
                ep, ("card", key),
                lambda: cardinality_rows(
                    vv,
                    ttmerge.hll_estimate(np.asarray(ans["hll"])),
                    p["global_hll_row"],
                ),
            )
            self._done(age, t0, t0_ns)
            return rows, age
        key = self._k(tenant, "card")
        val = self._value(p, key)
        age = self._check_bound(ep, staleness_ms, p["max_stale_ms"])
        est = val[1]
        rows = self._memoize(
            ep, ("card", key),
            lambda: cardinality_rows(vv, est, p["global_hll_row"]),
        )
        self._done(age, t0, t0_ns)
        return rows, age

    def serve_overview(
        self,
        qs: Sequence[float],
        service_name: Optional[str] = None,
        span_name: Optional[str] = None,
        staleness_ms: Optional[float] = None,
        tenant: Optional[str] = None,
    ) -> Tuple[dict, float]:  # zt-reader-process: one-key overview serve; counters are the publish-instant snapshot, stamped as such
        t0 = time.perf_counter()
        t0_ns = time.perf_counter_ns()
        ep = self._epoch()
        p, vv = ep.p, ep.vv
        qs = tuple(qs)
        key = self._k(tenant, f"overview:{_qkey(qs)}")
        val = self._value(p, key)
        age = self._check_bound(ep, staleness_ms, p["max_stale_ms"])
        source_q, counts, est = val[1], val[2], val[3]
        body = self._memoize(
            ep, ("overview", key, qs, service_name, span_name),
            lambda: {
                "percentiles": quantile_rows(
                    vv, qs, source_q, counts,
                    service_name, span_name,
                ),
                "cardinalities": cardinality_rows(
                    vv, est, p["global_hll_row"]
                ),
                # the ingest_counters snapshot the publisher cut with
                # the epoch — consistent with the sketches above, not
                # with the ingest process's live counters
                "counters": p["counters"],
            },
        )
        self._done(age, t0, t0_ns)
        return body, age

    # -- observability -----------------------------------------------------

    def counters(self) -> Dict:
        """Flat gauges for the reader's ``/metrics`` (the mirror's
        counter-naming idiom, reader-prefixed)."""
        return {
            "readerIndex": self.reader_idx,
            "readerGeneration": self._gen,
            "readerSegmentGeneration": self._seg.generation(),
            "readerServes": self.serves,
            "readerMisses": self.misses,
            "readerStaleRejects": self.stale_rejects,
            "readerFreshRejects": self.fresh_rejects,
            "readerUnavailable": self.unavailable,
            "readerDecodes": self.decodes,
            "readerMemoHits": self.memo_hits,
            "readerDemandRequests": self.demand_requests,
            "readerDemandOverflow": self.demand_overflow,
            "readerErrors": self.errors,
            "readerServeAgeMs": round(self.serve_age_ms, 3),
            "readerServeAgeMaxMs": round(self.serve_age_max_ms, 3),
        }
