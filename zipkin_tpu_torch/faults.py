"""Crashpoint, corruption and resource-exhaustion fault injection (the
port's copy of the part of ``zipkin_tpu/faults.py`` that its time tier, WAL,
snapshots, span archive, collector and multi-process ingest tier call:
``:96-125,152-310``).

A crashpoint names an instant inside a write path where a crash is most
likely to tear on-disk state; a corrupt site names an artifact the write
path just made durable and, when armed, damages those bytes on disk (silent
bit rot); a resource site names a point where a resource can run out, and
when armed raises ``OSError(ENOSPC)`` there (``alloc`` raises
``MemoryError``; ``feed.latency`` sleeps ``latency_ms`` and returns). The
WAL carries ``wal.append.mid`` (header and meta written, payload not),
``wal.append.pre_fsync``, the corrupt site
``wal.record`` and the resource site ``wal.append``; a snapshot carries
``snapshot.post_state`` / ``snapshot.post_meta``, the corrupt site
``snapshot.state`` and the resource site ``snapshot``; the span archive
carries ``archive.mid_segment`` (a frame's header and rows written, its
payload not), the corrupt site ``archive.frame`` and the resource site
``archive``; the time tier's seal
carries ``timetier.seal.pre_commit`` (the segment's tmp file written, not
yet renamed), ``timetier.seal.post_commit`` (renamed, ``sealed_through``
not yet advanced) and the corrupt site ``timetier.segment``; the
collector's boundary carries the resource site ``alloc`` (an allocation
failure, answered as backpressure) and the multi-process ingest tier's
group flush ``feed.latency`` (a slow device feed). The three catalogs are
the reference's, so a test arms the same names against either package.

Arming is programmatic (:func:`arm`, :func:`arm_corrupt`,
:func:`arm_resource`) or through the environment, read once at import:
``ZT_CRASHPOINT=<site>[:nth][,...]`` with ``ZT_CRASHPOINT_ACTION`` one of
``kill`` (SIGKILL), ``exit`` (``os._exit(137)``) or ``raise``
(:class:`CrashpointTriggered`), ``ZT_CORRUPT=<site>[:mode[:nth]][,...]``
with mode ``flip``, ``zero`` or ``truncate``, and
``ZT_RESOURCE=<site>[:nth[:count]][,...]`` with ``ZT_RESOURCE_LATENCY_MS``
the ``feed.latency`` sleep (25 ms by default). Crash and corrupt sites
are one-shot: they disarm as they fire. A resource site fails ``count``
traversals in a row from its ``nth`` (0: until :func:`disarm`). Disarmed, a
hook is one dict probe.

A resource site can also target one tenant: ``arm_resource(site,
tenant="B")`` or ``ZT_RESOURCE=feed.latency:tenant=B`` fires only on
traversals attributed to that tenant, either the ``tenant=`` the call site
passes (the fan-out dispatcher knows its group's tenant) or the ambient
:data:`~zipkin_tpu_torch.runtime.tenant.CURRENT_TENANT` at boundary sites.
Other tenants' traversals consume neither ``nth`` nor ``count``.
"""

from __future__ import annotations

import errno
import logging
import os
import signal
import time
from typing import Dict, List, Optional

logger = logging.getLogger(__name__)

SITES = (
    "wal.append.mid",
    "wal.append.pre_fsync",
    "snapshot.post_state",
    "snapshot.post_meta",
    "archive.mid_segment",
    "timetier.seal.pre_commit",
    "timetier.seal.post_commit",
)
CORRUPT_SITES = (
    "snapshot.state",
    "wal.record",
    "archive.frame",
    "timetier.segment",
)
CORRUPT_MODES = ("flip", "truncate", "zero")
RESOURCE_SITES = (
    "wal.append",
    "snapshot",
    "archive",
    "feed.latency",
    "alloc",
)

ENV_VAR = "ZT_CRASHPOINT"
ENV_ACTION = "ZT_CRASHPOINT_ACTION"
ENV_CORRUPT = "ZT_CORRUPT"
ENV_RESOURCE = "ZT_RESOURCE"
ENV_RESOURCE_LATENCY = "ZT_RESOURCE_LATENCY_MS"
EXIT_CODE = 137  # what a SIGKILL'd child reports; `exit` mimics it

_ACTIONS = ("kill", "exit", "raise")


class CrashpointTriggered(RuntimeError):
    """Raised by a crashpoint armed with action="raise": the owning
    object is notionally dead at this instant and must be abandoned."""


# site -> [remaining_nth, action]; mutated in place by crashpoint()
_armed: Dict[str, List] = {}
# site -> [remaining_nth, mode]; mutated in place by corrupt_point()
_corrupt_armed: Dict[str, List] = {}
# site -> [remaining_nth, remaining_count, latency_s, tenant|None]; mutated in
# place by resource_point()
_resource_armed: Dict[str, List] = {}


def arm(site: str, nth: int = 1, action: str = "kill") -> None:
    """Arm one site to fire on its ``nth`` traversal."""
    if site not in SITES:
        raise ValueError(f"unknown crashpoint site {site!r} (see faults.SITES)")
    if action not in _ACTIONS:
        raise ValueError(f"unknown crashpoint action {action!r}")
    _armed[site] = [max(1, int(nth)), action]


def arm_corrupt(site: str, mode: str = "flip", nth: int = 1) -> None:
    """Arm a corruption site to damage its ``nth`` written artifact."""
    if site not in CORRUPT_SITES:
        raise ValueError(f"unknown corrupt site {site!r} (see faults.CORRUPT_SITES)")
    if mode not in CORRUPT_MODES:
        raise ValueError(f"unknown corrupt mode {mode!r} (see faults.CORRUPT_MODES)")
    _corrupt_armed[site] = [max(1, int(nth)), mode]


def arm_resource(site: str, nth: int = 1, count: int = 1, latency_ms: float = 25.0,
                 tenant: Optional[str] = None) -> None:
    """Arm a resource site: it starts failing on its ``nth`` traversal and
    fails ``count`` traversals in a row (0: until :func:`disarm`), a disk
    that fills and later frees; ``feed.latency`` sleeps ``latency_ms`` a
    traversal instead of failing. ``tenant`` scopes it to that tenant's
    traversals."""
    if site not in RESOURCE_SITES:
        raise ValueError(f"unknown resource site {site!r} (see faults.RESOURCE_SITES)")
    _resource_armed[site] = [max(1, int(nth)), max(0, int(count)), max(0.0, latency_ms) / 1000.0,
                             tenant or None]


def armed_site() -> Optional[str]:
    """First armed crashpoint site (None when disarmed)."""
    return next(iter(_armed), None)


def disarm() -> None:
    _armed.clear()
    _corrupt_armed.clear()
    _resource_armed.clear()


def is_armed(site: str) -> bool:
    return site in _armed


def is_corrupt_armed(site: str) -> bool:
    return site in _corrupt_armed


def is_resource_armed(site: str) -> bool:
    return site in _resource_armed


def crashpoint(site: str) -> None:
    """Hot-path hook: a no-op unless ``site`` is armed."""
    spec = _armed.get(site)
    if spec is None:
        return
    spec[0] -= 1
    if spec[0] > 0:
        return
    del _armed[site]  # one-shot: recovery code may re-enter this path
    action = spec[1]
    logger.warning("crashpoint %s firing (action=%s)", site, action)
    if action == "kill":
        os.kill(os.getpid(), signal.SIGKILL)
    if action == "exit":
        os._exit(EXIT_CODE)
    raise CrashpointTriggered(site)


def corrupt_point(site: str, path: str, start: int, length: int) -> bool:
    """Write-path hook: the caller just made ``length`` bytes at ``start``
    of ``path`` durable. If ``site`` is armed, damage them in place
    (deterministically: the middle of the range) and return True."""
    spec = _corrupt_armed.get(site)
    if spec is None or length <= 0:
        return False
    spec[0] -= 1
    if spec[0] > 0:
        return False
    del _corrupt_armed[site]
    mode = spec[1]
    mid = start + length // 2
    logger.warning("corrupt point %s firing (mode=%s) on %s [%d:+%d]",
                   site, mode, path, start, length)
    if mode == "truncate":
        os.truncate(path, mid)
        return True
    with open(path, "r+b") as fh:
        if mode == "flip":
            fh.seek(mid)
            b = fh.read(1)
            fh.seek(mid)
            fh.write(bytes([b[0] ^ 0xFF]) if b else b"\xff")
        else:  # zero
            run = min(256, max(1, length // 3))
            fh.seek(start + length // 3)
            fh.write(b"\x00" * run)
        fh.flush()
        os.fsync(fh.fileno())
    return True


def resource_point(site: str, tenant: Optional[str] = None) -> None:
    """Hot-path hook for exhaustion sites: a no-op unless ``site`` is armed.
    Disk sites raise ``OSError(ENOSPC)``, ``alloc`` raises ``MemoryError``,
    ``feed.latency`` sleeps and returns; the caller's own handling is what
    is under test. A site armed for one tenant fires only for it:
    ``tenant`` is the caller's attribution, else the ambient
    ``CURRENT_TENANT``."""
    spec = _resource_armed.get(site)
    if spec is None:
        return
    want = spec[3]
    if want is not None:
        if tenant is None:
            # imported here: faults loads before runtime/
            from zipkin_tpu_torch.runtime.tenant import CURRENT_TENANT

            tenant = CURRENT_TENANT.get()
        if tenant != want:
            return  # another tenant's traversal: nth and count untouched
    if spec[0] > 1:
        spec[0] -= 1  # not yet at the nth traversal
        return
    if spec[1] > 0:
        spec[1] -= 1
        if spec[1] == 0:
            del _resource_armed[site]  # the disk has room again
    if site == "feed.latency":
        logger.warning("resource fault %s firing (sleep %.1f ms)", site, spec[2] * 1000.0)
        time.sleep(spec[2])
        return
    logger.warning("resource fault %s firing", site)
    if site == "alloc":
        raise MemoryError(f"injected allocation failure at {site}")
    raise OSError(errno.ENOSPC, f"injected ENOSPC at {site}")


def _arm_from_env() -> None:
    raw = os.environ.get(ENV_VAR)
    if raw:
        action = os.environ.get(ENV_ACTION, "kill").strip() or "kill"
        for spec in raw.split(","):
            spec = spec.strip()
            if not spec:
                continue
            site, _, nth = spec.partition(":")
            try:
                arm(site.strip(), int(nth) if nth.strip() else 1, action)
            except ValueError as e:
                # a typo'd variable must not stop a boot
                logger.warning("ignoring %s=%r: %s", ENV_VAR, raw, e)
    raw = os.environ.get(ENV_CORRUPT)
    if raw:
        for spec in raw.split(","):
            spec = spec.strip()
            if not spec:
                continue
            parts = spec.split(":")
            try:
                arm_corrupt(
                    parts[0].strip(),
                    parts[1].strip() if len(parts) > 1 and parts[1].strip() else "flip",
                    int(parts[2]) if len(parts) > 2 and parts[2].strip() else 1,
                )
            except ValueError as e:
                logger.warning("ignoring %s=%r: %s", ENV_CORRUPT, raw, e)
    raw = os.environ.get(ENV_RESOURCE)
    if raw:
        try:
            lat_ms = float(os.environ.get(ENV_RESOURCE_LATENCY, "25"))
        except ValueError:
            lat_ms = 25.0
        for spec in raw.split(","):
            spec = spec.strip()
            if not spec:
                continue
            parts = [p.strip() for p in spec.split(":")]
            tenant = None
            pos = []
            for part in parts[1:]:
                if part.startswith("tenant="):
                    tenant = part[len("tenant="):] or None
                elif part:
                    pos.append(part)
            try:
                arm_resource(parts[0], int(pos[0]) if pos else 1,
                             int(pos[1]) if len(pos) > 1 else 1, latency_ms=lat_ms, tenant=tenant)
            except ValueError as e:
                logger.warning("ignoring %s=%r: %s", ENV_RESOURCE, raw, e)


_arm_from_env()
