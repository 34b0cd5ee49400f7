"""Ingest-side segment publisher: mirror epoch → shared-memory payload (the
port's copy of ``zipkin_tpu/serving/publisher.py``).

Hooks the ReadMirror's ``segment_sink`` seam: after each mirror swap
(OUTSIDE the aggregator lock — the one-hold-per-tick invariant is the
mirror's, and serialization must never stretch it), the publisher
sanitizes the snapshot's raw read-program outputs into plain
dict/list/ndarray structures — nothing a reader would need the store,
torch (no ``torch.Tensor`` is ever pickled), or any repo class to unpickle — and lands them in the segment
behind the seqlock stamp.

Sanitization is by mirror-key kind, tenant-prefix transparent: a
``tenant:<slug>:`` prefix is stripped for kind detection only, so
tenant-scoped planes serialize (and serve) exactly like the default
tenant's. Keys of unknown shape are skipped and counted — an epoch
must publish even when one registered closure returns something the
wire format does not know.

A key whose value alone makes the payload outgrow the segment (a
``ttq:`` window's dense planes are 21.4 MB at the default config) is left
out of the epoch and counted (``segmentOversizedKeys``), largest first, so
every other key still publishes; the reference drops the whole epoch. An
idle publisher re-stamps the unchanged epoch (:meth:`SegmentPublisher.restamp`).

The publisher also owns the reverse demand path: ``drain_demand()``
empties every reader stripe each tick so `store.publish_mirror` can
re-register missed keys BEFORE the mirror cuts the next epoch — a
reader miss costs exactly one tick, like an in-process miss costs one
lock-path read.
"""

from __future__ import annotations

import logging
import pickle
import time
from typing import Dict, List, Optional

import numpy as np

from zipkin_tpu_torch.model import json_v2
from zipkin_tpu_torch.serving.segment import MirrorSegment

logger = logging.getLogger(__name__)


def split_tenant(key: str) -> tuple:
    """``("acme", "card")`` for ``tenant:acme:card``; ``(None, key)``
    otherwise."""
    if key.startswith("tenant:"):
        parts = key.split(":", 2)
        if len(parts) == 3 and parts[1]:
            return parts[1], parts[2]
    return None, key


# zt-lint: disable=ZT02 — not a device read: mirror snapshot values are
# already host arrays (the publisher pulled them packed, once, at epoch
# cut); np.asarray here only normalizes lists/scalars for pickling
def sanitize_value(key: str, value) -> Optional[tuple]:
    """One mirror value → its wire tuple ``(kind, ...)``, or None for
    a shape the format does not carry."""
    _, base = split_tenant(key)
    if base == "card":
        return ("card", np.asarray(value))
    if base.startswith("overview:"):
        source_q, counts, est = value
        return (
            "overview", np.asarray(source_q), np.asarray(counts),
            np.asarray(est),
        )
    if base.startswith("quant:"):
        source_q, counts = value
        return ("quant", np.asarray(source_q), np.asarray(counts))
    if base.startswith("deps:"):
        return ("deps", [json_v2.link_to_dict(x) for x in value])
    if base.startswith("ttq:"):
        return ("ttq", {
            "lo_ep": int(value.lo_ep),
            "hi_ep": int(value.hi_ep),
            "covered": int(value.covered),
            "missing": int(value.missing),
            "unsealed": bool(value.unsealed),
            "digest": np.asarray(value.digest),
            "hll": np.asarray(value.hll),
            "calls": np.asarray(value.calls),
            "errs": np.asarray(value.errs),
        })
    return None


def _plain_counters(counters: Dict) -> Dict:
    """Scalars only — the auto-rendered gauge subset (`/prometheus`
    skips nested tables the same way)."""
    return {
        k: v for k, v in counters.items()
        if isinstance(v, (int, float, bool, str))
    }


class SegmentPublisher:
    """The writer half: one ``publish_snapshot`` per mirror epoch."""

    def __init__(self, segment: MirrorSegment) -> None:
        self.segment = segment
        self.publishes = 0
        self.errors = 0
        self.skipped_keys = 0
        self.oversized_keys = 0
        self.restamps = 0
        self.payload_bytes = 0
        self.serialize_ms = 0.0
        self.demand_drained = 0

    def publish_snapshot(
        self,
        snap,
        *,
        vocab,
        max_stale_ms: float,
        deps_max_stale_ms: float,
        time_bucket_minutes: int,
        global_hll_row: int,
        tt_sealed_through: Optional[int],
        counters: Dict,
        mirror_generation: int,
    ) -> bool:
        """Serialize + land one MirrorSnapshot. Never raises — a
        serialization failure is counted and the previous epoch keeps
        serving (same never-abort-the-epoch posture as the mirror's
        per-key compute guard)."""
        t0 = time.perf_counter()
        try:
            values: Dict[str, tuple] = {}
            for key, raw in snap.values.items():
                try:
                    wire = sanitize_value(key, raw)
                except (TypeError, ValueError, AttributeError):
                    wire = None
                if wire is None:
                    self.skipped_keys += 1
                    continue
                values[key] = wire
            with vocab._lock:
                key_list = np.asarray(vocab._key_list, np.int32)
            body = {
                "format": 1,
                "mirror_generation": mirror_generation,
                "write_version": snap.write_version,
                "published_at": snap.published_at,
                "publish_ms": snap.publish_ms,
                "max_stale_ms": float(max_stale_ms),
                "deps_max_stale_ms": float(deps_max_stale_ms),
                "tt_enabled": tt_sealed_through is not None,
                "tt_sealed_through": (
                    -1 if tt_sealed_through is None
                    else int(tt_sealed_through)
                ),
                "time_bucket_minutes": int(time_bucket_minutes),
                "global_hll_row": int(global_hll_row),
                "services": list(vocab.services._names),
                "span_names": list(vocab.span_names._names),
                "key_list": key_list,
                "values": values,
                "counters": _plain_counters(counters),
            }
            payload = pickle.dumps(body, protocol=4)
            if len(payload) > self.segment.capacity:
                payload = self._fit(body, values, len(payload))
            ok = self.segment.write(
                payload,
                mirror_generation=mirror_generation,
                write_version=snap.write_version,
                published_ns=int(snap.published_at * 1e9),
            )
            self.serialize_ms = (time.perf_counter() - t0) * 1000.0
            self.payload_bytes = len(payload)
            if ok:
                self.publishes += 1
            else:
                self.errors += 1
                logger.warning(
                    "mirror segment publish dropped: payload %d bytes "
                    "exceeds segment capacity %d",
                    len(payload), self.segment.capacity,
                )
            return ok
        except Exception:
            self.errors += 1
            logger.exception("mirror segment publish failed")
            return False

    def _fit(self, body: Dict, values: Dict[str, tuple], size: int) -> bytes:
        """Leave out the largest keys until the payload fits the segment
        (``values`` is ``body["values"]``, edited in place), each counted."""
        sizes = {k: len(pickle.dumps(v, protocol=4)) for k, v in values.items()}
        order = sorted(sizes, key=sizes.get, reverse=True)
        payload = b""
        while order:
            # drop by the estimate first, then check the real size
            while order and size > self.segment.capacity:
                key = order.pop(0)
                del values[key]
                size -= sizes[key]
                self.oversized_keys += 1
                logger.warning("mirror segment: key %r (%d bytes) left out of the epoch; "
                               "the segment holds %d bytes", key, sizes[key],
                               self.segment.capacity)
            payload = pickle.dumps(body, protocol=4)
            size = len(payload)
            if size <= self.segment.capacity:
                break
        return payload or pickle.dumps(body, protocol=4)

    def restamp(self, write_version: int) -> bool:
        """Re-stamp the live epoch's publish time when it was cut at
        ``write_version`` (the mirror skipped a publish: nothing changed)."""
        ok = self.segment.restamp(write_version)
        if ok:
            self.restamps += 1
        return ok

    def drain_demand(self) -> List[str]:
        keys = self.segment.demand_drain()
        self.demand_drained += len(keys)
        return keys

    def counters(self) -> Dict:
        """Flat gauges merged into ``store.ingest_counters`` → the
        ``/metrics`` serving block and the auto-rendered
        ``zipkin_tpu_segment_*`` / ``zipkin_tpu_reader_*`` families."""
        seg = self.segment.status()
        age_ms = 0.0
        lag = 0
        for r in seg["readers"]:
            if r["alive"]:
                age_ms = max(age_ms, r["lastServeAgeMs"])
                lag = max(lag, r["generationLag"])
        return {
            "segmentPublishes": self.publishes,
            "segmentPublishErrors": self.errors,
            "segmentOverflows": seg["overflows"],
            "segmentSkippedKeys": self.skipped_keys,
            "segmentOversizedKeys": self.oversized_keys,
            "segmentRestamps": self.restamps,
            "segmentPayloadBytes": self.payload_bytes,
            "segmentSerializeMs": round(self.serialize_ms, 3),
            "segmentGeneration": seg["generation"],
            "readerRespawns": seg["respawns"],
            "readerDemandRequests": self.demand_drained,
            "readerDemandOverflow": sum(
                r["demandOverflow"] for r in seg["readers"]
            ),
            "readerServeAgeMs": age_ms,
            "readerGenerationLagMax": lag,
        }
