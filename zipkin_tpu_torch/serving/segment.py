"""Shared-memory mirror segment: the ingest→reader epoch seam (the port's
copy of ``zipkin_tpu/serving/segment.py``; the header layout is the
reference's, so a segment either package creates attaches with either
package's :class:`MirrorSegment`).

One shm block carries the mirror's published epoch across process
boundaries, behind the seqlock idiom the span ring (`tpu/ring.py`)
already fuzz-proves: the writer stamps the generation ODD before
touching the header, EVEN after, and readers spin-retry a torn (odd or
moved) generation. Two payload buffers alternate so a reader mid-copy
of the live buffer is never overwritten by the next publish — the
writer always lands in the inactive one — and a CRC32 over the payload
is the cross-process backstop the in-process seqlock never needed: a
reader that raced TWO publishes (its buffer reused underneath it)
fails the CRC and retries.

Writer death is detectable, never silent: the writer pid lives in the
header, and a generation stuck odd with a dead pid means the ingest
process died mid-publish — readers raise :class:`SegmentUnavailable`
(the 503 Retry-After path) instead of serving the torn epoch.

Reader→writer backchannel: per-reader SPSC demand stripes (the ring's
striped-ownership topology) let a reader register a missed mirror key
back to the publisher without any cross-process lock — reader writes
the key then advances its head (the release fence); the publisher
drains below the head at each tick. Next to each stripe sit heartbeat
words (pid, last generation seen, serve counters) feeding the ingest
``/statusz`` serving block.

An idle publisher re-stamps its unchanged epoch (:meth:`MirrorSegment.restamp`):
when the live write version still equals the epoch's, only the header's
publish time moves, under the seqlock, so a reader's staleness bound measures
the time since the state last could have changed, not since the last
write. The reference leaves an idle epoch to age past the bound.

This module is imported by reader processes: numpy + stdlib only,
no torch.
"""

from __future__ import annotations

import os
import time
import zlib
from typing import Dict, List, Optional

import numpy as np

SEG_MAGIC = 0x5A54534D  # 'ZTSM'

# header words (int64)
H_MAGIC = 0
H_GEN = 1         # seqlock generation: odd while a publish is landing
H_BUF = 2         # active payload buffer (0/1)
H_LEN = 3         # payload length, bytes
H_CRC = 4         # crc32 of the payload
H_PID = 5         # writer (ingest) pid — the liveness guard
H_PUB_NS = 6      # time.monotonic_ns() at publish (cross-process on Linux)
H_WALL_MS = 7     # wall clock ms at publish
H_MGEN = 8        # mirror generation the payload was cut from
H_WVER = 9        # aggregator write_version of the epoch
H_PUBLISHES = 10  # total segment publishes
H_CAP = 11        # per-buffer payload capacity
H_READERS = 12    # reader stripe count
H_SUP_PID = 13    # supervisor pid (0 = standalone readers)
H_RESPAWNS = 14   # supervisor respawn total
H_OVERFLOWS = 15  # publishes dropped: payload outgrew the buffer
H_DEMAND_SLOTS = 16  # geometry, so attach-by-name needs no side channel
H_KEY_CAP = 17
HDR_WORDS = 18

# per-reader heartbeat words, then the SPSC demand (head, tail) pair
R_PID = 0
R_GEN_SEEN = 1    # segment generation at the reader's last serve
R_SERVE_NS = 2    # monotonic_ns of the last serve
R_SERVES = 3
R_AGE_US = 4      # staleness of the last serve, µs
R_DEMANDS = 5     # demand keys this reader pushed
R_DEMAND_OVF = 6  # pushes refused: stripe full
R_ERRORS = 7      # 503s this reader returned
HB_WORDS = 8
_D_HEAD = HB_WORDS      # reader-advanced (producer)
_D_TAIL = HB_WORDS + 1  # publisher-advanced (consumer)
STRIPE_WORDS = HB_WORDS + 2

DEFAULT_SEGMENT_BYTES = 4 << 20
DEFAULT_DEMAND_SLOTS = 32
DEFAULT_KEY_CAP = 120

# same cap family as the recorder/mirror seqlock readers; segment spins
# also sleep (another PROCESS holds the odd generation, so burning the
# reader's GIL slice cannot help the writer finish)
_TORN_RETRIES = 1000
_SPIN_SLEEP_S = 0.0002

_ALIGN = 64


def _align(n: int) -> int:
    return (n + _ALIGN - 1) // _ALIGN * _ALIGN


class SegmentUnavailable(Exception):
    """No consistent epoch could be read: never published yet, torn
    past the retry budget, or the writer died mid-publish. The reader
    front end maps this to 503 + Retry-After — never a silent stale or
    torn answer."""

    def __init__(self, reason: str, *, torn: int = 0,
                 writer_alive: bool = False, gen: int = -1) -> None:
        super().__init__(reason)
        self.reason = reason
        self.torn = torn
        self.writer_alive = writer_alive
        self.gen = gen


class SegmentFrame:
    """One consistent copy of the published epoch (header + payload)."""

    __slots__ = (
        "payload", "gen", "mirror_generation", "write_version",
        "published_ns", "wall_ms", "publishes",
    )

    def __init__(self, payload: bytes, gen: int, mirror_generation: int,
                 write_version: int, published_ns: int, wall_ms: int,
                 publishes: int) -> None:
        self.payload = payload
        self.gen = gen
        self.mirror_generation = mirror_generation
        self.write_version = write_version
        self.published_ns = published_ns
        self.wall_ms = wall_ms
        self.publishes = publishes


# blocks this process created (and will unlink): an attach here keeps the
# creator's registration with the resource tracker
_CREATED: set = set()


def _attach_untracked(name: str):
    """Attach an existing block without handing it to this process's
    resource tracker. Python 3.12 registers an attached block too, and the
    tracker unlinks what is still registered when its process tree exits:
    a reader front end that exits would unlink the ingest process's
    segment, and no later reader could attach (the reference keeps that
    fault)."""
    from multiprocessing import resource_tracker, shared_memory

    shm = shared_memory.SharedMemory(name=name)
    if shm.name not in _CREATED:
        resource_tracker.unregister(shm._name, "shared_memory")
    return shm


def _pid_alive(pid: int) -> bool:
    if pid <= 0:
        return False
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:  # pragma: no cover - exists, not ours
        return True
    return True


class MirrorSegment:
    """Owner/attach handle over one shared-memory mirror segment.

    The ingest process creates it (``name=None``); readers and the
    supervisor attach by name via :meth:`params`. All control state is
    int64 words on the mapped buffer — no cross-process lock exists
    anywhere, which is what lets a SIGKILL'd reader leave nothing to
    clean up (its demand stripe head simply stops moving).
    """

    def __init__(
        self,
        *,
        readers: int = 4,
        capacity: int = DEFAULT_SEGMENT_BYTES,
        demand_slots: int = DEFAULT_DEMAND_SLOTS,
        key_cap: int = DEFAULT_KEY_CAP,
        name: Optional[str] = None,
    ) -> None:
        from multiprocessing import shared_memory

        if name is not None:
            # attach: geometry comes from the creator's header words,
            # so a name alone (statusz, env var) is a complete address
            self._shm = _attach_untracked(name)
            self._owner = False
            hdr = np.frombuffer(self._shm.buf, np.int64, count=HDR_WORDS)
            magic = int(hdr[H_MAGIC])
            readers = int(hdr[H_READERS])
            capacity = int(hdr[H_CAP])
            demand_slots = int(hdr[H_DEMAND_SLOTS])
            key_cap = int(hdr[H_KEY_CAP])
            del hdr  # the view must die before close() can unmap
            if magic != SEG_MAGIC:
                self._shm.close()
                raise ValueError(
                    f"shm block {name!r} is not a mirror segment"
                )
        self.readers = int(readers)
        self.capacity = int(capacity)
        self.demand_slots = int(demand_slots)
        self.key_cap = int(key_cap)
        self.slot_bytes = _align(8 + self.key_cap)
        self._ctl_words = HDR_WORDS + self.readers * STRIPE_WORDS
        self._slots_off = _align(self._ctl_words * 8)
        self._buf0_off = _align(
            self._slots_off
            + self.readers * self.demand_slots * self.slot_bytes
        )
        self._buf1_off = self._buf0_off + _align(self.capacity)
        total = self._buf1_off + _align(self.capacity)
        if name is None:
            self._shm = shared_memory.SharedMemory(create=True, size=total)
            self._owner = True
            _CREATED.add(self._shm.name)
        self._a = np.frombuffer(
            self._shm.buf, np.int64, count=self._ctl_words
        )
        if self._owner:
            self._a[:] = 0
            self._a[H_MAGIC] = SEG_MAGIC
            self._a[H_CAP] = self.capacity
            self._a[H_READERS] = self.readers
            self._a[H_DEMAND_SLOTS] = self.demand_slots
            self._a[H_KEY_CAP] = self.key_cap
        self._closed = False

    @property
    def name(self) -> str:
        return self._shm.name

    def params(self) -> dict:
        """Spawn-safe attach info (the ring's ``params()`` contract)."""
        return {
            "name": self._shm.name,
            "readers": self.readers,
            "capacity": self.capacity,
            "demand_slots": self.demand_slots,
            "key_cap": self.key_cap,
        }

    @classmethod
    def attach(cls, params: dict) -> "MirrorSegment":
        return cls(
            readers=params["readers"],
            capacity=params["capacity"],
            demand_slots=params["demand_slots"],
            key_cap=params["key_cap"],
            name=params["name"],
        )

    # -- writer side (ingest process only) --------------------------------

    def write(
        self,
        payload: bytes,
        *,
        mirror_generation: int,
        write_version: int,
        wall_ms: Optional[int] = None,
        published_ns: Optional[int] = None,
    ) -> bool:
        """Publish one epoch: land the payload in the INACTIVE buffer,
        then seqlock-stamp the header around the swap. Returns False
        (counted, epoch dropped, previous one keeps serving) when the
        payload outgrew the buffer — a reader must never see a
        truncated pickle. ``published_ns`` (monotonic ns, default now) is
        the instant a reader measures the epoch's age from."""
        a = self._a
        if len(payload) > self.capacity:
            a[H_OVERFLOWS] += 1
            return False
        target = 1 - int(a[H_BUF])
        off = self._buf0_off if target == 0 else self._buf1_off
        self._shm.buf[off:off + len(payload)] = payload
        g = int(a[H_GEN])
        if g & 1:
            g += 1  # re-even a claim a crashed previous writer left
        a[H_GEN] = g + 1  # odd: publish landing
        a[H_BUF] = target
        a[H_LEN] = len(payload)
        a[H_CRC] = zlib.crc32(payload)
        a[H_PID] = os.getpid()
        a[H_PUB_NS] = time.monotonic_ns() if published_ns is None else int(published_ns)
        a[H_WALL_MS] = (
            int(time.time() * 1000) if wall_ms is None else int(wall_ms)
        )
        a[H_MGEN] = int(mirror_generation)
        a[H_WVER] = int(write_version)
        a[H_PUBLISHES] += 1
        a[H_GEN] = g + 2  # even: stable
        return True

    def restamp(self, write_version: int) -> bool:
        """Move the live epoch's publish time to now, leaving its payload
        as it is, when that epoch was cut at ``write_version`` (the
        publisher's live version: nothing query-visible changed since).
        False when no epoch is live or it is older than that version."""
        a = self._a
        if a is None:  # closed
            return False
        g = int(a[H_GEN])
        if g == 0 or g & 1 or int(a[H_WVER]) != int(write_version):
            return False
        a[H_GEN] = g + 1  # odd: the stamp is moving
        a[H_PUB_NS] = time.monotonic_ns()
        a[H_WALL_MS] = int(time.time() * 1000)
        a[H_GEN] = g + 2  # even: stable
        return True

    # -- reader side (lock-free, any process) -----------------------------

    def generation(self) -> int:
        return int(self._a[H_GEN])

    def writer_alive(self) -> bool:
        return _pid_alive(int(self._a[H_PID]))

    def read_stamp(self, spins: int = _TORN_RETRIES) -> Optional[tuple]:
        """``(gen, crc, mirror_generation, published_ns)`` of the live epoch
        under the seqlock, without copying its payload; None when nothing
        consistent could be read (the caller falls back to a frame read)."""
        a = self._a
        for attempt in range(spins):
            g1 = int(a[H_GEN])
            if g1 == 0:
                return None
            if g1 & 1:
                if attempt >= 8:
                    time.sleep(_SPIN_SLEEP_S)
                continue
            out = (g1, int(a[H_CRC]), int(a[H_MGEN]), int(a[H_PUB_NS]))
            if int(a[H_GEN]) == g1:
                return out
        return None

    def read_frame(
        self, spins: int = _TORN_RETRIES, spin_sleep_s: float = _SPIN_SLEEP_S
    ) -> SegmentFrame:
        """One consistent epoch copy via the seqlock read protocol,
        with the CRC as the two-publish-race backstop. Raises
        :class:`SegmentUnavailable` (the 503 path) when no consistent
        read lands inside the spin budget or nothing was published."""
        a = self._a
        torn = 0
        for attempt in range(spins):
            g1 = int(a[H_GEN])
            if g1 == 0:
                raise SegmentUnavailable(
                    "segment never published", gen=0,
                    writer_alive=self.writer_alive(),
                )
            if g1 & 1:
                if attempt >= 8:
                    time.sleep(spin_sleep_s)
                continue
            buf = int(a[H_BUF])
            length = int(a[H_LEN])
            crc = int(a[H_CRC])
            mgen = int(a[H_MGEN])
            wver = int(a[H_WVER])
            pub_ns = int(a[H_PUB_NS])
            wall_ms = int(a[H_WALL_MS])
            publishes = int(a[H_PUBLISHES])
            off = self._buf0_off if buf == 0 else self._buf1_off
            payload = bytes(self._shm.buf[off:off + length])
            if int(a[H_GEN]) != g1:
                torn += 1
                continue
            if zlib.crc32(payload) != crc:
                torn += 1
                continue
            return SegmentFrame(
                payload, g1, mgen, wver, pub_ns, wall_ms, publishes
            )
        raise SegmentUnavailable(
            "torn past the retry budget (writer "
            + ("mid-publish)" if self.writer_alive() else "died mid-publish)"),
            torn=torn, writer_alive=self.writer_alive(),
            gen=int(a[H_GEN]),
        )

    # -- demand backchannel (reader produces, publisher drains) -----------

    def _stripe_base(self, r: int) -> int:
        return HDR_WORDS + r * STRIPE_WORDS

    def _slot_off(self, r: int, seq: int) -> int:
        g = r * self.demand_slots + (seq % self.demand_slots)
        return self._slots_off + g * self.slot_bytes

    def demand_push(self, r: int, key: str) -> bool:
        """Register a missed mirror key back to the publisher. Bounded:
        a full stripe refuses (counted by the caller) — a key-churning
        client cannot wedge its reader, only lose the registration."""
        a = self._a
        base = self._stripe_base(r)
        head = int(a[base + _D_HEAD])
        tail = int(a[base + _D_TAIL])
        if head - tail >= self.demand_slots:
            return False
        raw = key.encode("utf-8")[: self.key_cap]
        off = self._slot_off(r, head)
        self._shm.buf[off:off + 8] = len(raw).to_bytes(8, "little")
        self._shm.buf[off + 8:off + 8 + len(raw)] = raw
        a[base + _D_HEAD] = head + 1  # the release fence
        return True

    def demand_drain(self) -> List[str]:
        """Publisher side: every pushed key across all stripes. A
        reader SIGKILL'd mid-push left its head unmoved, so a torn
        slot is simply never visible here."""
        out: List[str] = []
        a = self._a
        for r in range(self.readers):
            base = self._stripe_base(r)
            head = int(a[base + _D_HEAD])
            tail = int(a[base + _D_TAIL])
            for seq in range(tail, head):
                off = self._slot_off(r, seq)
                n = int.from_bytes(self._shm.buf[off:off + 8], "little")
                n = max(0, min(n, self.key_cap))
                out.append(
                    bytes(self._shm.buf[off + 8:off + 8 + n])
                    .decode("utf-8", "replace")
                )
            if head != tail:
                a[base + _D_TAIL] = head
        return out

    # -- heartbeats / supervisor words ------------------------------------

    def heartbeat(
        self, r: int, *, gen_seen: int, serves: int, age_us: int,
        demands: int, demand_overflow: int, errors: int,
    ) -> None:
        a = self._a
        base = self._stripe_base(r)
        a[base + R_PID] = os.getpid()
        a[base + R_GEN_SEEN] = gen_seen
        a[base + R_SERVE_NS] = time.monotonic_ns()
        a[base + R_SERVES] = serves
        a[base + R_AGE_US] = age_us
        a[base + R_DEMANDS] = demands
        a[base + R_DEMAND_OVF] = demand_overflow
        a[base + R_ERRORS] = errors

    def reader_status(self) -> List[Dict]:
        """Per-reader heartbeat view for the ``/statusz`` serving block:
        generation lag, last serve age, liveness."""
        a = self._a
        now_ns = time.monotonic_ns()
        gen = int(a[H_GEN])
        out: List[Dict] = []
        for r in range(self.readers):
            base = self._stripe_base(r)
            pid = int(a[base + R_PID])
            serve_ns = int(a[base + R_SERVE_NS])
            out.append({
                "reader": f"r{r}",
                "pid": pid,
                "alive": _pid_alive(pid),
                "generationLag": max(0, gen - int(a[base + R_GEN_SEEN])),
                "serves": int(a[base + R_SERVES]),
                "lastServeAgeMs": round(int(a[base + R_AGE_US]) / 1000.0, 3),
                "sinceServeMs": (
                    round((now_ns - serve_ns) / 1e6, 3) if serve_ns else None
                ),
                "demandRequests": int(a[base + R_DEMANDS]),
                "demandOverflow": int(a[base + R_DEMAND_OVF]),
                "errors": int(a[base + R_ERRORS]),
                "demandQueued": int(a[base + _D_HEAD])
                - int(a[base + _D_TAIL]),
            })
        return out

    def note_supervisor(self, pid: int, respawns: int) -> None:
        self._a[H_SUP_PID] = pid
        self._a[H_RESPAWNS] = respawns

    def status(self) -> Dict:
        """Segment-level header view (ingest statusz + supervisor)."""
        a = self._a
        return {
            "name": self._shm.name,
            "bytes": self.capacity,
            "generation": int(a[H_GEN]),
            "publishes": int(a[H_PUBLISHES]),
            "overflows": int(a[H_OVERFLOWS]),
            "payloadBytes": int(a[H_LEN]),
            "mirrorGeneration": int(a[H_MGEN]),
            "writeVersion": int(a[H_WVER]),
            "writerPid": int(a[H_PID]),
            "writerAlive": self.writer_alive(),
            "supervisorPid": int(a[H_SUP_PID]),
            "respawns": int(a[H_RESPAWNS]),
            "readers": self.reader_status(),
        }

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._a = None
        try:
            self._shm.close()
        except BufferError:  # pragma: no cover - traceback-pinned view
            # a live exception traceback (e.g. a caught
            # SegmentUnavailable) can pin a numpy view of the mapping
            # in its frame locals; let GC unmap later rather than
            # refusing to close — unlink below still retires the block
            pass
        if self._owner:
            _CREATED.discard(self._shm.name)
            try:
                self._shm.unlink()
            except FileNotFoundError:  # pragma: no cover
                pass
