"""Native host tier: the C fast-path span parser (the port's own copy of
``zipkin_tpu/native/__init__.py`` and ``span_json.c``).

The C source in this package is compiled on first use with the system's
C compiler (``cc``, ``gcc`` or ``clang``) into ``zipkin_tpu_torch/build/``
and loaded through ctypes; no extension module, no pip dependency.

Graceful degradation is part of the contract: without a compiler, or on a
payload the fast path does not cover (escaped strings, malformed input),
:func:`parse_spans` returns None and callers fall back to the pure-Python
codec, which is the semantic reference.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from typing import Optional

import numpy as np

logger = logging.getLogger(__name__)

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "span_json.c")
_BUILD_DIR = os.path.join(os.path.dirname(_DIR), "build")

_lib = None
_lib_lock = threading.Lock()
_build_failed = False


def _compile() -> Optional[str]:
    """Path of the shared library built from ``span_json.c``, keyed by the
    source's digest; None when no compiler builds it. Each build writes a
    temp file named by the pid and moves it into place, so processes that
    build at once never write the same file."""
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    so_path = os.path.join(_BUILD_DIR, f"span_json-{digest}.so")
    if os.path.exists(so_path):
        return so_path
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{so_path}.{os.getpid()}.tmp"
    for cc in ("cc", "gcc", "clang"):
        try:
            subprocess.run(
                [cc, "-O2", "-fPIC", "-shared", "-o", tmp, _SRC],
                check=True, capture_output=True, timeout=120,
            )
            os.replace(tmp, so_path)
            return so_path
        except FileNotFoundError:
            continue
        except subprocess.CalledProcessError as e:
            logger.warning("native parser build failed with %s: %s", cc, e.stderr)
            return None
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    logger.warning("no C compiler found; native parser disabled")
    return None


def _declare(lib) -> None:
    u32p = ctypes.POINTER(ctypes.c_uint32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    base = (
        [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_long]
        + [u32p] * 8  # id lanes
        + [u8p] * 4  # shared, kind, err, has_dur
        + [u64p, u32p, u8p]  # ts, dur, debug
        + [u32p] * 6  # string slices
        + [u32p] * 2  # span byte extents
    )
    interned = base[:3] + [ctypes.c_void_p] + base[3:] + [i32p] * 4
    for fn, args in ((lib.zt_parse_spans, base), (lib.zt_parse_spans_interned, interned),
                     (lib.zt_parse_proto3, base), (lib.zt_parse_proto3_interned, interned)):
        fn.restype = ctypes.c_long
        fn.argtypes = args
    lib.zt_vocab_new.restype = ctypes.c_void_p
    lib.zt_vocab_new.argtypes = [ctypes.c_uint32] * 3
    lib.zt_vocab_free.restype = None
    lib.zt_vocab_free.argtypes = [ctypes.c_void_p]
    lib.zt_vocab_drain_strings.restype = ctypes.c_long
    lib.zt_vocab_drain_strings.argtypes = [ctypes.c_void_p, ctypes.c_int, u8p, ctypes.c_size_t]
    lib.zt_vocab_drain_pairs.restype = ctypes.c_long
    lib.zt_vocab_drain_pairs.argtypes = [ctypes.c_void_p, u64p, ctypes.c_long]
    lib.zt_vocab_overflow.restype = ctypes.c_long
    lib.zt_vocab_overflow.argtypes = [ctypes.c_void_p]
    lib.zt_vocab_counts.restype = None
    lib.zt_vocab_counts.argtypes = [ctypes.c_void_p] + [u32p] * 3
    for fn in (lib.zt_intern_service, lib.zt_intern_name):
        fn.restype = ctypes.c_long
        fn.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint32]
    for fn in (lib.zt_intern_pair, lib.zt_intern_pair_raw):
        fn.restype = ctypes.c_long
        fn.argtypes = [ctypes.c_void_p, ctypes.c_uint32, ctypes.c_uint32]


def _load():
    global _lib, _build_failed
    if _lib is not None or _build_failed:
        return _lib
    with _lib_lock:
        if _lib is not None or _build_failed:
            return _lib
        so_path = _compile()
        lib = None
        if so_path is not None:
            try:
                lib = ctypes.CDLL(so_path)
            except OSError:
                # a stale cached build (another arch or libc) would disable
                # the parser for good, since the digest still matches:
                # evict it and rebuild once
                with contextlib.suppress(OSError):
                    os.unlink(so_path)
                so_path = _compile()
                try:
                    lib = ctypes.CDLL(so_path) if so_path else None
                except OSError as e:
                    logger.warning("native parser load failed (%s); disabled", e)
        if lib is None:
            _build_failed = True
            return None
        _declare(lib)
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


#: every per-span column of a parse result (the set that chunking and
#: sampler filtering slice; ``data``/``n`` are handled apart)
PARSED_FIELDS = (
    "tl0", "tl1", "th0", "th1", "s0", "s1", "p0", "p1",
    "shared", "kind", "err", "has_dur", "ts_us", "dur_us",
    "debug", "svc_off", "svc_len", "rsvc_off", "rsvc_len",
    "name_off", "name_len", "span_off", "span_len",
    "svc_id", "rsvc_id", "name_id", "key_id",
)


class ParsedColumns:
    """Raw columnar parse result; string fields are (offset, len) slices
    into ``data`` (kept alive here). Parsed against a :class:`NativeVocab`,
    the ``*_id`` columns are filled and interning is done."""

    __slots__ = ("data", "n") + PARSED_FIELDS

    def select(self, idx) -> "ParsedColumns":
        """The lanes ``idx`` (a slice or an index array of the first
        ``n``) as a new parse result over the same ``data``."""
        sub = ParsedColumns()
        sub.data = self.data
        for f in PARSED_FIELDS:
            col = getattr(self, f, None)
            setattr(sub, f, None if col is None else col[: self.n][idx])
        sub.n = len(range(self.n)[idx]) if isinstance(idx, slice) else len(idx)
        return sub


def sampler_keep(parsed, n: int, boundary: int) -> np.ndarray:
    """[n] bool: which parsed spans a boundary sampler keeps, the numpy
    mirror of ``CollectorSampler.is_sampled`` on the trace id's low 64 bits
    (Java parity: abs(Long.MIN_VALUE) maps to Long.MAX_VALUE, so that id
    drops at every rate below 1); debug spans always pass."""
    lo = (parsed.tl1[:n].astype(np.uint64) << np.uint64(32)) | parsed.tl0[:n].astype(np.uint64)
    t = np.abs(lo.view(np.int64))
    t = np.where(t == np.iinfo(np.int64).min, np.iinfo(np.int64).max, t)
    return (t <= boundary) | (parsed.debug[:n] != 0)


class NativeVocab:
    """C interning tables mirroring a Python :class:`Vocab`.

    C assigns ids in first-seen order; :meth:`sync` drains its insertion
    journal into the Python vocab, whose ids then line up, so everything
    downstream (lookups, row shaping) keeps working. Not thread-safe:
    callers serialize parse and sync (the store does, under its intern
    lock)."""

    def __init__(self, vocab) -> None:
        lib = _load()
        if lib is None:
            raise RuntimeError("native parser unavailable")
        self._lib = lib
        self.vocab = vocab
        self.handle = lib.zt_vocab_new(
            vocab.services.capacity - 1, vocab.span_names.capacity - 1, vocab.max_keys - 1)
        if not self.handle:
            raise MemoryError("zt_vocab_new failed")
        self._drain_buf = np.zeros(1 << 20, np.uint8)
        self._pair_buf = np.zeros(1 << 16, np.uint64)

    @property
    def overflow(self) -> int:
        """Intern attempts the C tables rejected at capacity (these never
        reach the Python journal, so they are read from C)."""
        return int(self._lib.zt_vocab_overflow(self.handle))

    def counts(self):
        a, b, c = ctypes.c_uint32(), ctypes.c_uint32(), ctypes.c_uint32()
        self._lib.zt_vocab_counts(self.handle, ctypes.byref(a), ctypes.byref(b), ctypes.byref(c))
        return a.value, b.value, c.value

    def ensure_synced(self) -> None:
        """Bring the C tables up to the Python vocab: both assign ids in
        first-seen order, so entries the object path interned are replayed
        into C in id order."""
        c_svc, c_name, c_pair = self.counts()
        v = self.vocab
        py = (len(v.services) - 1, len(v.span_names) - 1, v.num_keys - 1)
        if (c_svc, c_name, c_pair) == py:
            return
        if c_svc > py[0] or c_name > py[1] or c_pair > py[2]:
            # C ahead of Python: a sync() was missed; drain it now
            self.sync()
            c_svc, c_name, c_pair = self.counts()
        lib = self._lib
        for table, start, fn in ((v.services, c_svc, lib.zt_intern_service),
                                 (v.span_names, c_name, lib.zt_intern_name)):
            for nid in range(start + 1, len(table)):
                raw = table.lookup(nid).encode()
                got = fn(self.handle, raw, len(raw))
                if got != nid:
                    raise RuntimeError(f"native vocab diverged: {raw!r} got {got}, want {nid}")
        for kid in range(c_pair + 1, v.num_keys):
            # raw: replays the recorded id order as it is, without the live
            # rules' catch-all insertions, or ids would shift
            s, n = v.key_pair(kid)
            got = lib.zt_intern_pair_raw(self.handle, s, n)
            if got != kid:
                raise RuntimeError(f"native vocab diverged: pair {(s, n)} got {got}, want {kid}")
        # drain the journals so the replay is not reported as new
        self.sync()

    def sync(self) -> None:
        """Mirror newly interned strings and pairs into the Python vocab."""
        lib = self._lib
        buf = self._drain_buf
        for table, interner in ((0, self.vocab.services), (1, self.vocab.span_names)):
            while True:
                n = lib.zt_vocab_drain_strings(
                    self.handle, table, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), buf.nbytes)
                if n <= 0:
                    break
                pos = 0
                for _ in range(n):
                    ln = int.from_bytes(buf[pos : pos + 4], "little")
                    interner.intern(bytes(buf[pos + 4 : pos + 4 + ln]).decode("utf-8", "replace"))
                    pos += 4 + ln
                if n < 16384:
                    break
        while True:
            n = lib.zt_vocab_drain_pairs(
                self.handle, self._pair_buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
                len(self._pair_buf))
            if n <= 0:
                break
            for v in self._pair_buf[:n].tolist():
                self.vocab.key_id(v >> 32, v & 0xFFFFFFFF)
            if n < len(self._pair_buf):
                break

    def __del__(self):  # pragma: no cover - interpreter teardown
        handle, self.handle = getattr(self, "handle", None), None
        if handle:
            self._lib.zt_vocab_free(handle)


def parse_spans(data: bytes, cap: Optional[int] = None,
                nvocab: Optional[NativeVocab] = None) -> Optional[ParsedColumns]:
    """Parse a JSON v2 span array or a proto3 ``ListOfSpans`` into
    columns; None means: use the Python codec (parse error, unsupported
    feature, or no native library). The format is sniffed as the codec's
    dispatcher sniffs it (:func:`zipkin_tpu_torch.model.codec.detect`).

    With ``nvocab``, interning happens inside the parse (the ``*_id``
    columns are filled); the caller holds the store's intern lock and calls
    ``nvocab.sync()`` afterwards."""
    lib = _load()
    if lib is None:
        return None
    # 0x0A is both proto3's field-1 tag and a newline, and a ListOfSpans
    # whose first span is 0x5B ('[') bytes long starts like JSON: detect()
    # resolves both with a walk over the proto3 frame headers
    from zipkin_tpu_torch.model import codec

    try:
        enc = codec.detect(data)
    except ValueError:
        return None
    if enc is codec.Encoding.JSON_V2:
        fn_plain, fn_interned = lib.zt_parse_spans, lib.zt_parse_spans_interned
    elif enc is codec.Encoding.PROTO3:
        fn_plain, fn_interned = lib.zt_parse_proto3, lib.zt_parse_proto3_interned
    else:
        return None
    if cap is None:
        # every span contributes at least ~20 bytes: never truncates, and
        # keeps allocation linear in the payload
        cap = max(len(data) // 20, 16)

    def u32():
        return np.zeros(cap, np.uint32)

    def u8():
        return np.zeros(cap, np.uint8)

    out = ParsedColumns()
    out.data = data
    out.tl0, out.tl1, out.th0, out.th1 = u32(), u32(), u32(), u32()
    out.s0, out.s1, out.p0, out.p1 = u32(), u32(), u32(), u32()
    out.shared, out.kind, out.err, out.has_dur = u8(), u8(), u8(), u8()
    out.ts_us = np.zeros(cap, np.uint64)
    out.dur_us = u32()
    out.debug = u8()
    out.svc_off, out.svc_len = u32(), u32()
    out.rsvc_off, out.rsvc_len = u32(), u32()
    out.name_off, out.name_len = u32(), u32()
    out.span_off, out.span_len = u32(), u32()

    def ptr(a, ctype):
        return a.ctypes.data_as(ctypes.POINTER(ctype))

    c32, c8 = ctypes.c_uint32, ctypes.c_uint8
    common = (
        ptr(out.tl0, c32), ptr(out.tl1, c32), ptr(out.th0, c32), ptr(out.th1, c32),
        ptr(out.s0, c32), ptr(out.s1, c32), ptr(out.p0, c32), ptr(out.p1, c32),
        ptr(out.shared, c8), ptr(out.kind, c8), ptr(out.err, c8), ptr(out.has_dur, c8),
        ptr(out.ts_us, ctypes.c_uint64), ptr(out.dur_us, c32), ptr(out.debug, c8),
        ptr(out.svc_off, c32), ptr(out.svc_len, c32),
        ptr(out.rsvc_off, c32), ptr(out.rsvc_len, c32),
        ptr(out.name_off, c32), ptr(out.name_len, c32),
        ptr(out.span_off, c32), ptr(out.span_len, c32),
    )
    if nvocab is not None:
        out.svc_id, out.rsvc_id = np.zeros(cap, np.int32), np.zeros(cap, np.int32)
        out.name_id, out.key_id = np.zeros(cap, np.int32), np.zeros(cap, np.int32)
        ci32 = ctypes.c_int32
        n = fn_interned(data, len(data), cap, nvocab.handle, *common,
                        ptr(out.svc_id, ci32), ptr(out.rsvc_id, ci32),
                        ptr(out.name_id, ci32), ptr(out.key_id, ci32))
    else:
        out.svc_id = out.rsvc_id = out.name_id = out.key_id = None
        n = fn_plain(data, len(data), cap, *common)
    if n < 0:
        return None
    out.n = int(n)
    return out
