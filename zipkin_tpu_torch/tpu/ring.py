"""Shared-memory span ring: the fan-out tier's seam between the parse
workers and the dispatcher (the port's copy of ``zipkin_tpu/tpu/ring.py``;
the header words, magic, slot layout and lifecycle are the reference's, so
either package's producer can fill a ring the other's consumer reads).

Parse workers write the packed columnar wire image and the chunk's
pickled sidecar (vocab-journal delta, archive slices, disk record) straight
into a ring slot; the dispatcher drains contiguous runs of ready slots and
reads each image as a zero-copy view until its device flush gathers it.

Topology: the ring is striped by producer. Worker ``w`` owns slots
``w*S .. w*S+S-1`` (S = ``stripe_slots``) and claims them strictly in
order, so each stripe is a single-producer/single-consumer ring with a
lock-free (head, tail) pair: the head advances only on the owning worker's
publish, the tail only on the dispatcher's free. No cross-process lock
exists on the claim/publish/consume path, which is what lets the ring
survive a SIGKILLed producer.

Slot lifecycle (seqlock-stamped):

- ``claim`` (worker): generation bumped to odd, state WRITING, pid
  recorded. The head does not move yet: an unpublished slot is invisible
  to the consumer.
- ``publish`` (worker): header fields written, generation bumped to even,
  state READY, then the stripe head advances (the release fence).
- ``free`` (dispatcher): state FREE, tail advances.
- ``reclaim_stripe`` (dispatcher, pid-guarded): a worker that died leaves
  READY slots the reaper discards (their payloads re-ingest whole through
  the fallback path) and, at the head, possibly one torn slot (generation
  odd, state WRITING, owner dead). Both are reset; nothing acked is lost,
  because nothing is acked until the dispatcher's flush applies it.

Backpressure: a worker whose stripe is full blocks in ``claim``;
``occupancy()`` is the submit side's gauge.

Spawned parse workers import this module: numpy and the standard library
only.
"""

from __future__ import annotations

import os
import pickle
import time
from typing import Optional

import numpy as np

RING_MAGIC = 0x53525247  # 'SRRG'

# header words (int64): [magic, n_workers, stripe_slots, img_cap_u32,
#                        aux_cap, slot_bytes, pad, pad]
_HDR_WORDS = 8
# per-stripe control words: [head, tail]
_CTL_WORDS = 2

# slot header (int64 words); the image and aux regions follow at fixed
# byte offsets inside the slot
_S_GEN = 0        # seqlock generation: odd while the owner writes
_S_STATE = 1      # FREE / WRITING / READY
_S_PID = 2        # owner process id (the reclaim guard)
_S_PIDX = 3       # payload id (dispatcher _pending key)
_S_WSEQ = 4       # per-worker chunk sequence (cross-channel ordering)
_S_PER = 5        # per-shard lane count of the image
_S_NSPANS = 6
_S_NDUR = 7
_S_NERR = 8
_S_DROPPED = 9    # -1 = continuation chunk
_S_CSLOT = 10     # critical-path ledger slot (-1: untraced)
_S_TS_MIN = 11
_S_TS_MAX = 12
_S_PARSE_NS = 13
_S_PACK_NS = 14
_S_ROUTE_NS = 15
_S_AUX_LEN = 16
_S_PUBLISH_NS = 17
_S_TENANT = 18    # tenant index; the port writes 0 (the default tenant)
SLOT_HDR_WORDS = 19

ST_FREE, ST_WRITING, ST_READY = 0, 1, 2

_ALIGN = 64


def _align(n: int) -> int:
    return (n + _ALIGN - 1) // _ALIGN * _ALIGN


class SpanRing:
    """Owner (dispatcher-process) side of the striped span ring.

    ``img_cap_u32`` is the worst-case fused-image word count of one
    chunk; ``aux_cap`` bounds the pickled sidecar. A chunk whose sidecar
    outgrows ``aux_cap`` does not deadlock the ring — the worker routes
    it through the queue fallback instead (mp_ingest ``_KIND_BATCH_OBJ``).
    """

    def __init__(
        self,
        n_workers: int,
        stripe_slots: int,
        img_cap_u32: int,
        aux_cap: int = 1 << 18,
        *,
        name: Optional[str] = None,
    ) -> None:
        from multiprocessing import shared_memory

        self.n_workers = int(n_workers)
        self.stripe_slots = int(stripe_slots)
        self.img_cap_u32 = int(img_cap_u32)
        self.aux_cap = int(aux_cap)
        self.slot_bytes = _align(
            SLOT_HDR_WORDS * 8 + self.img_cap_u32 * 4 + self.aux_cap
        )
        self._ctl_base = _HDR_WORDS
        self._slots_off = _align(
            (self._ctl_base + _CTL_WORDS * self.n_workers) * 8
        )
        total = self._slots_off + (
            self.n_workers * self.stripe_slots * self.slot_bytes
        )
        if name is None:
            self._shm = shared_memory.SharedMemory(create=True, size=total)
            self._owner = True
        else:
            self._shm = shared_memory.SharedMemory(name=name)
            self._owner = False
        self._a = np.frombuffer(
            self._shm.buf, np.int64, count=self._slots_off // 8
        )
        if self._owner:
            self._a[:] = 0
            self._a[0] = RING_MAGIC
            self._a[1] = self.n_workers
            self._a[2] = self.stripe_slots
            self._a[3] = self.img_cap_u32
            self._a[4] = self.aux_cap
            self._a[5] = self.slot_bytes
        self._closed = False

    # -- attach plumbing --------------------------------------------------

    def params(self) -> dict:
        """Spawn-safe attach info for :class:`RingProducer`."""
        return {
            "name": self._shm.name,
            "n_workers": self.n_workers,
            "stripe_slots": self.stripe_slots,
            "img_cap_u32": self.img_cap_u32,
            "aux_cap": self.aux_cap,
        }

    # -- addressing -------------------------------------------------------

    def _head(self, w: int) -> int:
        return int(self._a[self._ctl_base + _CTL_WORDS * w])

    def _tail(self, w: int) -> int:
        return int(self._a[self._ctl_base + _CTL_WORDS * w + 1])

    def _set_tail(self, w: int, v: int) -> None:
        self._a[self._ctl_base + _CTL_WORDS * w + 1] = v

    def _slot_base(self, w: int, seq: int) -> int:
        g = w * self.stripe_slots + (seq % self.stripe_slots)
        return self._slots_off + g * self.slot_bytes

    def _hdr(self, byte_base: int) -> np.ndarray:
        return np.frombuffer(
            self._shm.buf, np.int64, count=SLOT_HDR_WORDS, offset=byte_base
        )

    def image(self, w: int, seq: int, count: int) -> np.ndarray:
        """u32 view of a slot's image region (zero-copy into shm)."""
        return np.frombuffer(
            self._shm.buf, np.uint32, count=count,
            offset=self._slot_base(w, seq) + SLOT_HDR_WORDS * 8,
        )

    def aux(self, w: int, seq: int, length: int) -> bytes:
        base = self._slot_base(w, seq) + SLOT_HDR_WORDS * 8 + (
            self.img_cap_u32 * 4
        )
        return bytes(self._shm.buf[base:base + length])

    # -- consumer side (dispatcher only) ----------------------------------

    def peek(self, w: int, ahead: int = 0):
        """``(header_copy, seq)`` of stripe ``w``'s next unconsumed slot
        (``ahead`` slots past the tail — the dispatcher's drain pass
        consumes several slots before freeing any), or None. A published
        slot is complete by construction (the head is the release
        fence), so a READY state with an even generation below the head
        cannot be torn."""
        seq = self._tail(w) + ahead
        if seq >= self._head(w):
            return None
        hdr = self._hdr(self._slot_base(w, seq)).copy()
        if hdr[_S_STATE] != ST_READY or hdr[_S_GEN] % 2:
            return None  # pragma: no cover - head fence makes this unreachable
        return hdr, seq

    def free_next(self, w: int) -> None:
        """Consume stripe ``w``'s tail slot (dispatcher has fully used
        the image view; the region may be overwritten by the producer)."""
        t = self._tail(w)
        hdr = self._hdr(self._slot_base(w, t))
        hdr[_S_STATE] = ST_FREE
        self._set_tail(w, t + 1)

    def reclaim_stripe(self, w: int, dead_pid: int = -1) -> dict:
        """Reset a dead worker's stripe (dispatcher only). Discards
        published-but-unconsumed slots and the torn WRITING slot a
        mid-write SIGKILL leaves at the head. ``dead_pid`` guards the
        torn-slot reset: a slot claimed by any OTHER pid (a stale
        header from a previous owner) is reset too, but counted apart
        so tests can assert the torn case precisely."""
        t, h = self._tail(w), self._head(w)
        discarded = 0
        for seq in range(t, h):
            self._hdr(self._slot_base(w, seq))[_S_STATE] = ST_FREE
            discarded += 1
        torn = 0
        hdr = self._hdr(self._slot_base(w, h))
        if hdr[_S_STATE] == ST_WRITING and hdr[_S_GEN] % 2:
            if dead_pid < 0 or int(hdr[_S_PID]) == dead_pid:
                torn = 1
            hdr[_S_GEN] += 1  # re-even the generation for the next owner
            hdr[_S_STATE] = ST_FREE
        self._set_tail(w, h)
        return {"discarded": discarded, "torn": torn}

    # -- gauges -----------------------------------------------------------

    @property
    def capacity(self) -> int:
        return self.n_workers * self.stripe_slots

    def stripe_depth(self, w: int) -> int:
        return self._head(w) - self._tail(w)

    def stripe_full(self, w: int) -> bool:
        return self.stripe_depth(w) >= self.stripe_slots

    def occupancy(self) -> int:
        return sum(self.stripe_depth(w) for w in range(self.n_workers))

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._a = None
        self._shm.close()
        if self._owner:
            try:
                self._shm.unlink()
            except FileNotFoundError:  # pragma: no cover
                pass


class RingProducer:
    """Worker-process half: claim -> write image/aux -> publish.

    Single producer per stripe; every mutation is plain word stores on
    the mapped buffer, so a SIGKILL at any instruction leaves at most
    one torn slot (odd generation) that ``reclaim_stripe`` resets."""

    def __init__(self, params: dict, widx: int) -> None:
        from multiprocessing import shared_memory

        self.widx = int(widx)
        self.stripe_slots = int(params["stripe_slots"])
        self.img_cap_u32 = int(params["img_cap_u32"])
        self.aux_cap = int(params["aux_cap"])
        n_workers = int(params["n_workers"])
        self.slot_bytes = _align(
            SLOT_HDR_WORDS * 8 + self.img_cap_u32 * 4 + self.aux_cap
        )
        self._shm = shared_memory.SharedMemory(name=params["name"])
        self._ctl_base = _HDR_WORDS
        self._slots_off = _align((_HDR_WORDS + _CTL_WORDS * n_workers) * 8)
        self._a = np.frombuffer(
            self._shm.buf, np.int64, count=self._slots_off // 8
        )
        self._wseq = 0  # per-worker chunk sequence (cross-channel order)

    def next_wseq(self) -> int:
        """Allocate the next chunk sequence number; also consumed by the
        queue-fallback path so ring and queue chunks stay totally
        ordered per worker."""
        s = self._wseq
        self._wseq += 1
        return s

    def _head(self) -> int:
        return int(self._a[self._ctl_base + _CTL_WORDS * self.widx])

    def _advance_head(self) -> None:
        self._a[self._ctl_base + _CTL_WORDS * self.widx] += 1

    def _tail(self) -> int:
        return int(self._a[self._ctl_base + _CTL_WORDS * self.widx + 1])

    def _slot_base(self, seq: int) -> int:
        g = self.widx * self.stripe_slots + (seq % self.stripe_slots)
        return self._slots_off + g * self.slot_bytes

    def _hdr(self, byte_base: int) -> np.ndarray:
        return np.frombuffer(
            self._shm.buf, np.int64, count=SLOT_HDR_WORDS, offset=byte_base
        )

    def try_claim(self) -> bool:
        """Claim the next stripe slot if the stripe has room. The slot
        is marked WRITING with an odd generation + this pid before any
        payload byte lands (the torn-write fence)."""
        seq = self._head()
        if seq - self._tail() >= self.stripe_slots:
            return False
        hdr = self._hdr(self._slot_base(seq))
        if hdr[_S_GEN] % 2 == 0:
            hdr[_S_GEN] += 1  # odd: mid-write
        hdr[_S_STATE] = ST_WRITING
        hdr[_S_PID] = os.getpid()
        return True

    def claim(self, poll_s: float = 0.0002, max_poll_s: float = 0.01) -> float:
        """Blocking claim; returns the seconds spent waiting for a free
        slot.

        The poll interval backs off exponentially to ``max_poll_s``: a
        stripe stays full for as long as one device step takes, and on
        shared-core hosts N workers re-polling a full stripe every
        0.2 ms steal enough scheduler quanta from the dispatcher's host
        dispatch to visibly stretch the very step they are waiting on
        (no condition variable can live in the shared segment, so a
        backed-off poll is the wake mechanism)."""
        t0 = time.perf_counter()
        wait = poll_s
        while not self.try_claim():
            time.sleep(wait)
            wait = min(wait * 2, max_poll_s)
        return time.perf_counter() - t0

    def image(self, count: int) -> np.ndarray:
        """Writable u32 view of the CLAIMED slot's image region."""
        if count > self.img_cap_u32:
            raise ValueError(
                f"image of {count} u32 words exceeds the slot capacity "
                f"({self.img_cap_u32}); route the chunk through the "
                "result queue instead"
            )
        return np.frombuffer(
            self._shm.buf, np.uint32, count=count,
            offset=self._slot_base(self._head()) + SLOT_HDR_WORDS * 8,
        )

    def publish(
        self,
        *,
        pidx: int,
        wseq: int,
        per: int,
        n_spans: int,
        n_dur: int,
        n_err: int,
        dropped: int,
        cslot: int = -1,
        ts_min: int,
        ts_max: int,
        parse_ns: int,
        pack_ns: int,
        route_ns: int,
        aux: bytes,
        tenant: int = 0,
    ) -> None:
        """Fill the claimed slot's header + aux and make it visible:
        generation re-evened, state READY, then the head fence moves."""
        if len(aux) > self.aux_cap:
            raise ValueError(
                f"sidecar of {len(aux)} bytes exceeds the slot aux "
                f"capacity ({self.aux_cap}); route the chunk through "
                "the result queue instead"
            )
        base = self._slot_base(self._head())
        if aux:
            off = base + SLOT_HDR_WORDS * 8 + self.img_cap_u32 * 4
            self._shm.buf[off:off + len(aux)] = aux
        hdr = self._hdr(base)
        hdr[_S_PIDX] = pidx
        hdr[_S_WSEQ] = wseq
        hdr[_S_PER] = per
        hdr[_S_NSPANS] = n_spans
        hdr[_S_NDUR] = n_dur
        hdr[_S_NERR] = n_err
        hdr[_S_DROPPED] = dropped
        hdr[_S_CSLOT] = cslot
        hdr[_S_TS_MIN] = ts_min
        hdr[_S_TS_MAX] = ts_max
        hdr[_S_PARSE_NS] = parse_ns
        hdr[_S_PACK_NS] = pack_ns
        hdr[_S_ROUTE_NS] = route_ns
        hdr[_S_AUX_LEN] = len(aux)
        hdr[_S_PUBLISH_NS] = time.perf_counter_ns()
        hdr[_S_TENANT] = tenant
        hdr[_S_GEN] += 1  # even: contents complete
        hdr[_S_STATE] = ST_READY
        self._advance_head()

    def close(self) -> None:
        self._a = None
        self._shm.close()


def pack_aux(svc_new, name_new, pairs_new, arch, rec) -> bytes:
    """Serialize a chunk's sidecar for the slot aux region."""
    return pickle.dumps(
        (svc_new, name_new, pairs_new, arch, rec), protocol=4
    )


def unpack_aux(raw: bytes):
    return pickle.loads(raw)
