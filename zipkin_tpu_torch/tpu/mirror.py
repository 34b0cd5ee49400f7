"""Epoch-published read mirror: lock-free concurrent query serving (the
port's copy of ``zipkin_tpu/tpu/mirror.py``).

Readers that each take the aggregator lock queue behind ingest steps and
behind one another. The mirror is the "Fast Concurrent Data Sketches"
publication pattern at system scale: a single publisher takes the
aggregator lock ONCE per epoch, runs the store's one-transfer packed read
programs (each ends in one device->host copy, so on the card the hold
includes that sync), keeps the host results in an immutable
:class:`MirrorSnapshot`, and publishes it behind the seqlock generation
stamp ``obs/recorder.py`` uses — readers spin-retry on a torn (odd)
generation and otherwise serve entirely without locks, stamping each
answer with its staleness age.

Publication protocol (the recorder's writer/reader idiom, verbatim):

- writer: ``gen += 1`` (odd = publish in progress) → swap the snapshot
  reference → ``gen += 1`` (even = stable). One writer at a time — the
  windows ticker is the only publisher in production; the boot path
  publishes before the ticker starts.
- reader: up to ``_TORN_RETRIES`` times, read ``gen``; if odd, retry;
  copy the snapshot reference; if ``gen`` is unchanged the copy is
  consistent. Retries beyond the cap mean a publisher died mid-swap
  (impossible without a killed thread) — take the read.

Staleness contract: a snapshot whose ``write_version`` still matches
the aggregator's is FRESH (age 0 — no query-visible mutation happened
since publish, the same version reasoning ``store._cached_read`` uses)
and serves unconditionally. A version-STALE snapshot carries age
now − published_at and serves only when BOTH hold: (1) the caller may
see staleness at all — an explicit per-request ``staleness_ms`` or an
actually-contended aggregator lock (the store probes non-blocking; on a
quiet lock an exact read is cheap, so default requests stay exact), or a
brownout read mode in force (the store folds the overload controller's
read mode into the bound: cache first loosens it to the controller's
``max_stale_ms``, cache only serves any age); and (2) the
age is within the effective bound: the per-request ``staleness_ms``
when given, else ``max_stale_ms`` (``TPU_MIRROR_MAX_STALE_MS``,
default 5000 — the number the ``query_mirror_staleness`` SLO is
bounded by). ``staleness_ms <= 0`` is the per-request escape hatch
back to the lock path, and ``TPU_READ_MIRROR=0`` disables the mirror
wholesale.

What the mirror holds is demand-keyed: the store registers each read's
cache key + compute closure on a mirror miss (seeding the dashboard
defaults at construction so the first post-boot serve is already
lock-free), the publisher computes every registered key under its one
lock hold, and keys not served for a while expire so shifting query
windows cannot grow the registry without bound. Values are the RAW
read-program outputs at ``_cached_read`` granularity — the exact
objects the fresh path would have produced — so mirror-vs-fresh parity
at the publish instant is byte-identical by construction.

The store's serve path (``TorchStorage._mirror_serve``) never takes the
aggregator lock; ``tests/test_torch_mirror.py`` counts its acquisitions.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from contextlib import nullcontext
from typing import Callable, Dict, Optional, Tuple

from zipkin_tpu_torch import obs
from zipkin_tpu_torch.obs import querytrace

logger = logging.getLogger(__name__)

# Same cap as the recorder's fuzz-tested reader: retries beyond this
# mean a publisher died mid-swap (impossible without a killed thread).
_TORN_RETRIES = 1000

DEFAULT_MAX_STALE_MS = 5000.0


def _env_on(name: str, default: str = "1") -> bool:
    return os.environ.get(name, default).strip().lower() \
        not in ("0", "false", "no")


class MirrorSnapshot:
    """One published epoch: immutable after construction.

    ``values`` maps the store's read-cache keys to the raw read-program
    outputs computed under the publisher's single lock hold;
    ``write_version`` is the aggregator version they were computed at
    (captured inside the hold, so every value is consistent with it).
    """

    __slots__ = (
        "values", "write_version", "published_at", "generation",
        "publish_ms",
    )

    def __init__(
        self,
        values: Dict[str, object],
        write_version: int,
        published_at: float,
        generation: int,
        publish_ms: float,
    ) -> None:
        self.values = values
        self.write_version = write_version
        self.published_at = published_at
        self.generation = generation
        self.publish_ms = publish_ms


class ReadMirror:
    """The publisher/reader pair around one store's aggregator.

    ``agg_provider`` resolves the aggregator lazily (``store.clear()``
    swaps it wholesale, same contract as the querytrace lock provider).
    Serve-path counter writes are GIL-atomic and tolerated torn by
    readers — debug-gauge contract, same as ``obs/device.py``.
    """

    # demand keys not served for this many publishes are dropped
    # (seeded keys are pinned); shifting endTs windows register fresh
    # keys every few minutes, so expiry is what bounds the registry
    DEMAND_TTL_PUBLISHES = 8

    def __init__(
        self,
        agg_provider: Callable,
        max_stale_ms: Optional[float] = None,
        enabled: Optional[bool] = None,
        max_keys: int = 64,
    ) -> None:
        self._agg = agg_provider
        self.enabled = (
            _env_on("TPU_READ_MIRROR") if enabled is None else bool(enabled)
        )
        self.max_stale_ms = (
            float(os.environ.get("TPU_MIRROR_MAX_STALE_MS",
                                 DEFAULT_MAX_STALE_MS))
            if max_stale_ms is None else float(max_stale_ms)
        )
        self.max_keys = max_keys
        # seqlock state: gen even = self._snap is stable, odd = a
        # publish is swapping it. Only the publisher writes either.
        self.gen = 0
        self._snap: Optional[MirrorSnapshot] = None
        # demand registry: key -> [compute, last_used_publish, pinned].
        # The lock covers registration and expiry only — the serve path
        # touches the registry with one GIL-atomic dict read + item
        # write (last-used refresh) and never blocks on it.
        self._demand: Dict[str, list] = {}
        self._demand_lock = threading.Lock()
        self._dirty = False
        # ledger (torn reads tolerated; see class docstring)
        self.publishes = 0
        self.publish_skips = 0
        self.publish_backoffs = 0
        self._publish_done_at: Optional[float] = None
        self.last_publish_ms = 0.0
        self.publish_ms_sum = 0.0
        self.serves = 0
        self.stale_serves = 0
        self.misses = 0
        self.serve_age_ms = 0.0
        self.serve_age_max_ms = 0.0
        self.demand_overflow = 0
        # scale-out seam (serving/): called with each newly
        # published snapshot AFTER the swap — outside the aggregator
        # lock, so shm serialization can never stretch the one hold.
        # The store installs it via attach_mirror_segment().
        self.segment_sink: Optional[Callable] = None
        self.segment_sink_errors = 0
        # called with the live snapshot when a publish is skipped because
        # nothing changed: the segment re-stamps that epoch's publish time,
        # so reader processes of an idle server keep serving it
        self.segment_restamp: Optional[Callable] = None

    # -- demand registry (serving threads) -------------------------------

    def register(self, key: str, compute: Callable,
                 pinned: bool = False) -> bool:
        """Ask the publisher to carry ``key`` from the next epoch on.
        Called on a mirror miss (the read falls through to the lock path
        this once); bounded — a full registry refuses new unpinned keys
        so a key-churning client cannot grow publish cost unboundedly."""
        if not self.enabled:
            return False
        with self._demand_lock:
            ent = self._demand.get(key)
            if ent is not None:
                ent[1] = self.publishes
                return True
            if len(self._demand) >= self.max_keys and not pinned:
                self.demand_overflow += 1
                return False
            self._demand[key] = [compute, self.publishes, bool(pinned)]
            self._dirty = True
            return True

    # -- reader side (lock-free) -----------------------------------------

    def snapshot(self) -> Optional[MirrorSnapshot]:  # zt-mirror-served: seqlock spin + one reference copy; no lock of any kind
        """The current stable snapshot via the seqlock read protocol."""
        for _ in range(_TORN_RETRIES):
            g1 = self.gen
            if g1 & 1:
                continue  # publish in progress: spin
            snap = self._snap
            if self.gen == g1:
                return snap
        return self._snap  # publisher died mid-swap: take the read

    def serve(self, key: str, bound_ms: Optional[float],
              live_version: int,
              allow_stale: bool = True) -> Optional[Tuple[object, float]]:  # zt-mirror-served: the lock-free read path — ZT10 proves no aggregator-lock acquire can appear here
        """Serve ``key`` from the published epoch: ``(value, age_ms)``,
        or None on a miss (no snapshot, key not carried, or the age
        exceeds ``bound_ms``; ``bound_ms=None`` serves any age — the
        brownout cache-only posture). ``allow_stale=False`` restricts
        the serve to version-FRESH epochs: the store passes it for
        default requests on an uncontended lock, where an exact read is
        cheap and a within-bound stale answer would still surprise a
        caller that never opted into staleness (the same version
        reasoning that keeps ``_cached_read`` exact outside brownout)."""
        if not self.enabled:
            return None
        snap = self.snapshot()
        if snap is None or key not in snap.values:
            self.misses += 1
            return None
        fresh = snap.write_version == live_version
        age_ms = (
            0.0 if fresh
            else (time.monotonic() - snap.published_at) * 1000.0
        )
        if not fresh and not allow_stale:
            self.misses += 1
            return None
        if not fresh and bound_ms is not None and age_ms > bound_ms:
            self.misses += 1
            return None
        self.serves += 1
        if not fresh:
            self.stale_serves += 1
        self.serve_age_ms = age_ms
        if age_ms > self.serve_age_max_ms:
            self.serve_age_max_ms = age_ms
        ent = self._demand.get(key)  # GIL-atomic read; no lock
        if ent is not None:
            ent[1] = self.publishes  # keep served keys alive
        return (snap.values[key], age_ms)

    # -- publisher side (ticker thread / boot) ---------------------------

    def publish(self, force: bool = False, paced: bool = False) -> bool:
        """One epoch: lock once, run every demanded read program, swap.

        Skipped (returns False) when nothing could have changed — the
        aggregator's write_version still matches the published snapshot
        and no new demand key arrived — so an idle system never pulls
        the device at tick cadence just to republish identical bytes;
        the segment then re-stamps the unchanged epoch (``segment_restamp``).

        ``paced=True`` (the ticker's call) additionally caps the
        publisher's lock duty cycle at 50%: a new epoch is refused
        until at least one last-publish-duration has elapsed since the
        previous one finished. On hardware where the read programs run
        in milliseconds the window is always long past at tick cadence;
        on a host where device reads run in seconds (CPU mesh, cold
        box) it is what stops back-to-back multi-second lock holds from
        convoying every fresh read and ingest tick behind the
        publisher. Explicit calls (boot, tests, benchmarks) stay
        unpaced.
        """
        if not self.enabled:
            return False
        agg = self._agg()
        if agg is None:
            return False
        if (
            paced and not force and self.last_publish_ms > 0.0
            and self._publish_done_at is not None
            and (time.monotonic() - self._publish_done_at) * 1000.0
            < self.last_publish_ms
        ):
            self.publish_backoffs += 1
            return False
        with self._demand_lock:
            entries = list(self._demand.items())
            dirty = self._dirty
            self._dirty = False
        version = getattr(agg, "write_version", 0)
        snap = self._snap
        if (
            not force and not dirty and snap is not None
            and snap.write_version == version
        ):
            self.publish_skips += 1
            restamp = self.segment_restamp
            if restamp is not None:
                try:
                    restamp(snap)
                except Exception:
                    self.segment_sink_errors += 1
                    logger.exception("mirror publish: segment re-stamp failed")
            return False
        t0 = time.perf_counter()
        values: Dict[str, object] = {}
        lock = getattr(agg, "lock", None)
        with querytrace.lock_label("mirror_publish"):
            # the ONE lock hold of the epoch; the read programs below
            # re-enter it (counted, never measured — an RLock re-acquire
            # by its holder cannot block)
            with (lock if lock is not None else nullcontext()):
                version = getattr(agg, "write_version", 0)
                for key, ent in entries:
                    try:
                        values[key] = ent[0]()
                    except Exception:
                        # one bad closure (e.g. a window that aged out)
                        # must not abort the epoch or kill the ticker
                        logger.exception(
                            "mirror publish: compute for %r failed", key
                        )
        publish_ms = (time.perf_counter() - t0) * 1000.0
        new = MirrorSnapshot(
            values=values,
            write_version=version,
            published_at=time.monotonic(),
            generation=self.gen + 2,
            publish_ms=publish_ms,
        )
        self.gen += 1   # odd: publish in progress
        self._snap = new
        self.gen += 1   # even: stable
        self.publishes += 1
        self.last_publish_ms = publish_ms
        self._publish_done_at = time.monotonic()
        self.publish_ms_sum += publish_ms
        obs.record("mirror_publish", publish_ms / 1000.0)
        sink = self.segment_sink
        if sink is not None:
            try:
                sink(new)
            except Exception:
                # the shm epoch lags one publish; in-process serving is
                # unaffected — never abort the epoch for the segment
                self.segment_sink_errors += 1
                logger.exception("mirror publish: segment sink failed")
        with self._demand_lock:
            for k, ent in list(self._demand.items()):
                if not ent[2] and (
                    self.publishes - ent[1] > self.DEMAND_TTL_PUBLISHES
                ):
                    del self._demand[k]
        return True

    def reset(self) -> None:
        """Drop the published snapshot (``store.clear()`` swaps the
        aggregator; its versions no longer compare). Demand and the
        ledger survive — the next publish refills from the new agg."""
        self.gen += 1
        self._snap = None
        self.gen += 1

    # -- observability ----------------------------------------------------

    def counters(self) -> Dict:
        """Flat gauges for ``ingest_counters`` → ``/metrics`` and the
        auto-rendered ``zipkin_tpu_mirror_*`` prometheus families."""
        snap = self.snapshot()
        return {
            "mirrorEnabled": int(self.enabled),
            "mirrorGeneration": self.gen,
            "mirrorPublishes": self.publishes,
            "mirrorPublishSkips": self.publish_skips,
            "mirrorPublishBackoffs": self.publish_backoffs,
            "mirrorPublishMs": round(self.last_publish_ms, 3),
            "mirrorPublishMsSum": round(self.publish_ms_sum, 3),
            "mirrorServes": self.serves,
            "mirrorStaleServes": self.stale_serves,
            "mirrorMisses": self.misses,
            "mirrorServeAgeMs": round(self.serve_age_ms, 3),
            "mirrorServeAgeMaxMs": round(self.serve_age_max_ms, 3),
            "mirrorKeys": len(snap.values) if snap is not None else 0,
            "mirrorDemandKeys": len(self._demand),
            "mirrorDemandOverflow": self.demand_overflow,
            "mirrorMaxStaleMs": self.max_stale_ms,
        }

    def status(self) -> Dict:
        """The ``/statusz`` mirror block: the flat ledger plus snapshot
        detail (carried keys, live age, the version it was cut at)."""
        body = dict(self.counters())
        snap = self.snapshot()
        if snap is not None:
            body["snapshot"] = {
                "generation": snap.generation,
                "writeVersion": snap.write_version,
                "ageMs": round(
                    (time.monotonic() - snap.published_at) * 1000.0, 3
                ),
                "publishMs": round(snap.publish_ms, 3),
                "keys": sorted(snap.values),
            }
        return body
