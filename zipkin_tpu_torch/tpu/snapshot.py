"""Checkpoint and resume of the device sketch state (port of
``zipkin_tpu/tpu/snapshot.py:79-543``).

The aggregates live in volatile memory on the card, so durability is
explicit: the state is cloned on the card, pulled to the host, and written
as one ``.npz`` with the string vocabularies in a JSON meta; boot restores
it onto the store's device.

The file format is the reference's: ``SNAPSHOT_VERSION`` 5, leaves ``f0`` to
``f50`` in ``AggState`` order with the reference's dtypes (u32 leaves as
uint32, not the port's int64) and a leading shard axis of S (the mesh's
shard count; ``n_shards`` in the meta), a crc32 per
leaf in the meta, and ``dataclasses.asdict(config)``, which is field for
field the reference's. A snapshot written by either package restores in the
other.

Crash consistency: a snapshot is two files, and ``meta.json`` is the single
commit point.

1. the state goes to a fresh generation-named file
   (``sketch_state-<gen>.npz``): written, fsynced, renamed in, directory
   fsynced; the previous generation is untouched;
2. a per-generation meta sidecar (``sketch_state-<gen>.meta.json``) is
   committed the same way: it makes the generation restorable after
   ``meta.json`` moves on;
3. ``meta.json``, which names its state file, is committed the same way:
   ``os.replace`` flips the snapshot from the old pair to the new in one
   step;
4. only then are the generations older than the newest K deleted.

A crash at any instant (the ``snapshot.post_state`` / ``post_meta``
crashpoints pin the two worst) leaves ``meta.json`` naming one complete
state file.

Bit rot: restore recomputes each leaf's crc32 against the meta's manifest
and refuses a mismatching generation. It is quarantined (renamed aside with
``.quarantine``, never deleted) and restore falls back to the next older
retained generation; the WAL keeps the suffix back to the oldest retained
generation (:func:`retained_coverage`), so the replay makes up the
difference. The ``snapshot.state`` corrupt site damages a just-committed
generation so the fallback can be tested. A compatibility failure (version,
config, shards, leaf count or layout) stops the restore instead: an older
generation is at least as foreign.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import tempfile
import time
import zlib
from typing import List, Optional

import numpy as np

from zipkin_tpu_torch import convert, faults
from zipkin_tpu_torch.tpu.state import LEAF_DTYPES, AggState

logger = logging.getLogger(__name__)

STATE_FILE = "sketch_state.npz"  # the legacy single-generation name (read only)
META_FILE = "meta.json"
_STATE_PREFIX = "sketch_state-"
QUARANTINE_SUFFIX = ".quarantine"
# intact generations a commit retains (the fallback depth); a store's
# ``snapshot_keep`` overrides it
DEFAULT_KEEP_GENERATIONS = 2
# the reference's format version: v5 is the time tier's layout
SNAPSHOT_VERSION = 5


def _fsync_dir(directory: str) -> None:
    dfd = os.open(directory, os.O_RDONLY)
    try:
        os.fsync(dfd)
    finally:
        os.close(dfd)


def _state_generations(directory: str):
    """[(gen, filename)] of every generation-named state file, sorted;
    quarantined generations left out, a missing directory has none."""
    out = []
    try:
        names = os.listdir(directory)
    except FileNotFoundError:
        return out
    for name in names:
        if name.startswith(_STATE_PREFIX) and name.endswith(".npz"):
            try:
                out.append((int(name[len(_STATE_PREFIX):-4]), name))
            except ValueError:
                continue
    out.sort()
    return out


def _gen_meta_name(state_name: str) -> str:
    """sketch_state-<gen>.npz -> sketch_state-<gen>.meta.json"""
    return state_name[:-4] + ".meta.json"


def _next_generation(directory: str) -> int:
    """One past the highest generation ever used, quarantined ones counted,
    so a new state file never takes a quarantined file's name."""
    top = 0
    for name in os.listdir(directory):
        stem = name.removesuffix(QUARANTINE_SUFFIX)
        if stem.startswith(_STATE_PREFIX) and stem.endswith(".npz"):
            try:
                top = max(top, int(stem[len(_STATE_PREFIX):-4]))
            except ValueError:
                continue
    return top + 1


def _write_atomic(directory: str, name: str, text: str) -> None:
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".json.tmp")
    with os.fdopen(fd, "w") as f:
        f.write(text)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, os.path.join(directory, name))
    _fsync_dir(directory)


def _quarantine(path: str) -> bool:
    """Rename ``path`` aside with the quarantine suffix, never delete it:
    it is the evidence of what rotted."""
    try:
        os.replace(path, path + QUARANTINE_SUFFIX)
        return True
    except OSError:
        return False


def quarantine_generation(directory: str, state_name: str) -> None:
    """Move one generation (state file and its meta sidecar) aside."""
    quarantined = _quarantine(os.path.join(directory, state_name))
    _quarantine(os.path.join(directory, _gen_meta_name(state_name)))
    if quarantined:
        logger.warning("snapshot generation %s quarantined (-> %s%s)",
                       state_name, state_name, QUARANTINE_SUFFIX)


def leaf_digests(arrays: List[np.ndarray]) -> List[int]:
    """crc32 of each serialized state leaf: the integrity manifest (read
    through the buffer protocol, so the 0.9 GiB state is not copied)."""
    return [zlib.crc32(np.ascontiguousarray(a)) for a in arrays]


def _template(store) -> List[tuple]:
    """(shape, dtype) of every leaf as the file holds it: the reference's
    dtype and a leading shard axis of S."""
    agg = store.agg
    return [((agg.n_shards, *t.shape), np.dtype(LEAF_DTYPES[name]))
            for name, t in zip(AggState._fields, agg.states[0])]


def save(store, directory: str, keep: Optional[int] = None) -> str:
    """Snapshot the sketches and the vocab into ``directory`` (atomic).
    Returns the directory."""
    os.makedirs(directory, exist_ok=True)
    if keep is None:
        keep = getattr(store, "snapshot_keep", DEFAULT_KEEP_GENERATIONS)
    keep = max(1, int(keep))
    # one instant: the state is cloned on the card under the aggregator
    # lock together with wal_seq and the host counters, then pulled to the
    # host without the lock while ingest goes on. At the default AggConfig
    # the clone is a second 0.906 GiB on the card for the pull's duration.
    clone, wal_seq, counters = store.agg.state_clone()
    leaves = convert.state_to_numpy(clone)
    arrays = {f"f{i}": a for i, a in enumerate(leaves)}
    del clone

    # stray temp files of a crashed earlier save are dead weight
    for name in os.listdir(directory):
        if name.endswith(".tmp"):
            try:
                os.unlink(os.path.join(directory, name))
            except OSError:
                pass

    gen = _next_generation(directory)
    state_name = f"{_STATE_PREFIX}{gen:08d}.npz"
    # the disk-full site fires before any rename: every retained
    # generation stays intact, and the caller retries next cycle
    faults.resource_point("snapshot")
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".npz.tmp")
    with os.fdopen(fd, "wb") as f:  # a file object: savez appends no ".npz"
        np.savez_compressed(f, **arrays)
        f.flush()
        os.fsync(f.fileno())
    state_path = os.path.join(directory, state_name)
    os.replace(tmp, state_path)
    _fsync_dir(directory)
    faults.crashpoint("snapshot.post_state")

    meta = {
        "version": SNAPSHOT_VERSION,
        "saved_at": time.time(),
        "wal_seq": wal_seq,
        "state_file": state_name,
        "digest": "crc32",
        "leaf_crcs": leaf_digests([arrays[f"f{i}"] for i in range(len(arrays))]),
        "n_shards": store.agg.n_shards,
        "config": dataclasses.asdict(store.config),
        # the aggregator's counters from the locked capture; the store's own
        # are monotonic and not restored, so reading them late is harmless
        "counters": {**store.ingest_counters(), **counters},
        "services": store.vocab.services._names,
        "span_names": store.vocab.span_names._names,
        "keys": store.vocab._key_list,
    }
    meta_text = json.dumps(meta)
    # the sidecar first: once meta.json moves on, it is this generation's
    # only record of its wal_seq and digests
    _write_atomic(directory, _gen_meta_name(state_name), meta_text)
    _write_atomic(directory, META_FILE, meta_text)
    faults.crashpoint("snapshot.post_meta")
    # bit-rot site: damage the generation just committed, at rest
    faults.corrupt_point("snapshot.state", state_path, 0, os.path.getsize(state_path))

    # the new pair is durable: generations past the newest ``keep`` and the
    # legacy file go; quarantined generations are evidence and stay
    for _, name in _state_generations(directory)[:-keep]:
        for victim in (name, _gen_meta_name(name)):
            try:
                os.unlink(os.path.join(directory, victim))
            except OSError:
                pass
    try:
        os.unlink(os.path.join(directory, STATE_FILE))
    except OSError:
        pass
    return directory


def maybe_restore(store, directory: str) -> bool:
    """Restore the state and vocab if a compatible snapshot exists.

    Candidates go newest first: ``meta.json``'s generation, then every older
    retained generation through its sidecar. An integrity failure (missing
    or unreadable state file, digest mismatch) quarantines that generation
    and tries the next; a compatibility failure stops the restore."""
    meta_path = os.path.join(directory, META_FILE)
    if not os.path.exists(meta_path):
        return False
    candidates = []  # (meta, state_name), newest first
    primary_name = None
    try:
        with open(meta_path) as f:
            meta = json.load(f)
        primary_name = meta.get("state_file", STATE_FILE)
        candidates.append((meta, primary_name))
    except (OSError, ValueError):
        logger.warning("snapshot at %s: meta.json unreadable; trying retained generations",
                       directory)
    primary_gen = None
    if primary_name and primary_name.startswith(_STATE_PREFIX):
        try:
            primary_gen = int(primary_name[len(_STATE_PREFIX):-4])
        except ValueError:
            pass
    for gen, name in reversed(_state_generations(directory)):
        if name == primary_name:
            continue
        if primary_gen is not None and gen > primary_gen:
            continue  # landed, but meta.json never flipped to it: uncommitted
        try:
            with open(os.path.join(directory, _gen_meta_name(name))) as f:
                candidates.append((json.load(f), name))
        except (OSError, ValueError):
            continue  # an orphan: crashed between the state and its sidecar

    stats = getattr(store, "restore_stats", None)
    for i, (cand, state_name) in enumerate(candidates):
        outcome = _restore_one(store, directory, cand, state_name)
        if outcome == "ok":
            if i:
                if stats is not None:
                    stats["restoreFallbacks"] = stats.get("restoreFallbacks", 0) + 1
                logger.warning("snapshot restore fell back %d generation(s) to %s; the WAL "
                               "suffix past its wal_seq replays the rest", i, state_name)
            return True
        if outcome == "incompatible":
            return False
        quarantine_generation(directory, state_name)
        if stats is not None:
            stats["generationsQuarantined"] = stats.get("generationsQuarantined", 0) + 1
    return False


def _restore_one(store, directory: str, meta: dict, state_name: str) -> str:
    """Try one generation: "ok", "incompatible" or "integrity"."""
    state_path = os.path.join(directory, state_name)
    if not os.path.exists(state_path):
        logger.warning("snapshot at %s: meta names missing state file %s; ignoring",
                       directory, state_name)
        return "integrity"
    if meta.get("version") != SNAPSHOT_VERSION:
        logger.warning("snapshot at %s has format version %s (this build writes %s); ignoring",
                       directory, meta.get("version"), SNAPSHOT_VERSION)
        return "incompatible"
    if meta.get("config") != dataclasses.asdict(store.config):
        logger.warning("snapshot at %s was taken under another AggConfig; ignoring", directory)
        return "incompatible"
    if meta.get("n_shards") != store.agg.n_shards:
        logger.warning("snapshot at %s has %s shards but this store has %s; ignoring",
                       directory, meta.get("n_shards"), store.agg.n_shards)
        return "incompatible"
    try:
        # np.load reads through zipfile, which checks each member's crc:
        # gross rot (truncation, zeroed ranges) raises here
        loaded = np.load(state_path)
        leaves = [loaded[f"f{i}"] for i in range(len(loaded.files))]
    except Exception as e:
        logger.warning("snapshot at %s: state file %s unreadable (%s); quarantining",
                       directory, state_name, e)
        return "integrity"
    template = _template(store)
    fields = AggState._fields
    if len(leaves) != len(template):
        logger.warning("snapshot at %s has %d state leaves but this build expects %d; ignoring",
                       directory, len(leaves), len(template))
        return "incompatible"
    for name, leaf, (shape, dtype) in zip(fields, leaves, template):
        if tuple(leaf.shape) != shape or leaf.dtype != dtype:
            logger.warning("snapshot at %s: leaf %s has shape %s dtype %s but the live state "
                           "expects shape %s dtype %s (layout drift); ignoring",
                           directory, name, tuple(leaf.shape), leaf.dtype, shape, dtype)
            return "incompatible"
    crcs = meta.get("leaf_crcs")
    if crcs is not None:  # a legacy meta has no manifest and restores unchecked
        if len(crcs) != len(leaves):
            logger.warning("snapshot at %s: digest manifest has %d entries for %d leaves; "
                           "quarantining", directory, len(crcs), len(leaves))
            return "integrity"
        for name, want_crc, got_crc in zip(fields, crcs, leaf_digests(leaves)):
            if int(want_crc) != got_crc:
                logger.warning("snapshot at %s: leaf %s digest mismatch (crc32 %08x != manifest "
                               "%08x): bit rot in %s; quarantining",
                               directory, name, got_crc, int(want_crc), state_name)
                return "integrity"
    agg = store.agg
    # straight onto the store's mesh, shard s onto mesh[s] (the card
    # unless the caller named another)
    states = convert.state_from_numpy(leaves, store.config, mesh=agg.mesh)
    with agg.lock:
        agg.states = states
        agg.sync_pend_lanes()

    saved = meta.get("counters", {})
    for key in agg.host_counters:
        if key in saved:
            agg.host_counters[key] = int(saved[key])
    # the vocab: ids keep their meaning across restarts
    v = store.vocab
    with store._intern_lock:
        v.services._names = list(meta["services"])
        v.services._ids = {n: i for i, n in enumerate(meta["services"]) if i}
        v.span_names._names = list(meta["span_names"])
        v.span_names._ids = {n: i for i, n in enumerate(meta["span_names"]) if i}
        v._key_list = [tuple(k) for k in meta["keys"]]
        v._keys = {tuple(k): i for i, k in enumerate(meta["keys"]) if i}
        # the C interner of the line-rate path is rebuilt from this vocab
        # at the next fast ingest
        store._nvocab = None
    agg.wal_seq = int(meta.get("wal_seq", 0))
    # host mirrors of restored leaves (the sampling tier's tables, the same
    # on every shard), given with the shard axis
    store.on_restored_leaves(dict(zip(fields, leaves)))
    logger.info("restored the sketch snapshot from %s", directory)
    return "ok"


def retained_coverage(directory: str) -> Optional[int]:
    """The wal_seq the WAL must keep replayable: the least wal_seq over
    every retained generation (a fallback restore needs the suffix back to
    the oldest). None when nothing restorable exists."""
    seqs = []
    try:
        with open(os.path.join(directory, META_FILE)) as f:
            seqs.append(int(json.load(f).get("wal_seq", 0)))
    except (OSError, ValueError):
        pass
    for _, name in _state_generations(directory):
        try:
            with open(os.path.join(directory, _gen_meta_name(name))) as f:
                seqs.append(int(json.load(f).get("wal_seq", 0)))
        except (OSError, ValueError):
            continue
    return min(seqs) if seqs else None


def generation_status(directory: str) -> List[dict]:
    """Every generation on disk, quarantined ones included, newest first."""
    out = []
    try:
        names = os.listdir(directory)
    except OSError:
        return out
    for name in names:
        stem = name.removesuffix(QUARANTINE_SUFFIX)
        quarantined = stem != name
        if not (stem.startswith(_STATE_PREFIX) and stem.endswith(".npz")):
            continue
        try:
            gen = int(stem[len(_STATE_PREFIX):-4])
        except ValueError:
            continue
        entry = {"generation": gen, "stateFile": name, "quarantined": quarantined,
                 "walSeq": None, "bytes": 0}
        try:
            entry["bytes"] = os.path.getsize(os.path.join(directory, name))
        except OSError:
            pass
        for gm in (_gen_meta_name(stem), _gen_meta_name(stem) + QUARANTINE_SUFFIX):
            try:
                with open(os.path.join(directory, gm)) as f:
                    entry["walSeq"] = int(json.load(f).get("wal_seq", 0))
                break
            except (OSError, ValueError):
                continue
        out.append(entry)
    out.sort(key=lambda e: -e["generation"])
    return out
