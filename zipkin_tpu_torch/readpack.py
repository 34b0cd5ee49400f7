"""One-transfer reads: pack a read's outputs into one buffer (port of
``zipkin_tpu/readpack.py``).

Every read of :class:`zipkin_tpu_torch.parallel.aggregator.TorchAggregator`
ends in exactly one device->host copy:

- :func:`pack` runs on the outputs' device: each section is narrowed to
  the dtype the reference returns for it and flattened into 32-bit words
  behind a fixed header, and the whole answer is one ``torch.cat``;
- :func:`device_get` is the one counted pull (one ``.cpu()`` per call),
  so transfers per read can be read off :func:`transfer_count`; its wall
  is the flight recorder's ``readpack_transfer`` stage and a traced
  query's transfer segment;
- :func:`unpack` splits the pulled buffer into zero-copy numpy views.

The wire format is the reference's ZPK1, word for word, so a buffer
packed here unpacks with the reference's ``unpack`` and back::

    word 0                MAGIC 0x5A504B31 ("ZPK1")
    word 1                n_sections
    words 2 .. 2+8n-1     per section: dtype code, byte offset of the
                          payload, payload byte length (unpadded), ndim
                          (0..4), the 4 dims (unused 0)
    then the payloads, each padded to a 4-byte word

The port holds u32 values as int64 (:mod:`zipkin_tpu_torch.u32`), so the
caller names each section's reference dtype and a u32 section leaves as
its 4-byte bit pattern. Booleans and u8 are stored one byte each, padded
to a word. The buffer travels as int32 and is viewed as uint32 on the host.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from zipkin_tpu_torch import obs, u32
from zipkin_tpu_torch.obs import querytrace

MAGIC = 0x5A504B31  # "ZPK1"
_SECTION_WORDS = 8
_MAX_NDIM = 4

# dtype code <-> numpy dtype: part of the wire format (append only)
DTYPE_CODES = {
    np.dtype(np.uint8): 0,
    np.dtype(np.uint32): 1,
    np.dtype(np.int32): 2,
    np.dtype(np.float32): 3,
    np.dtype(np.bool_): 4,
    np.dtype(np.uint64): 5,
    np.dtype(np.int64): 6,
    np.dtype(np.float64): 7,
}
CODE_DTYPES = {v: k for k, v in DTYPE_CODES.items()}

# -- transfer accounting (the one chokepoint) -----------------------------

_counter_lock = threading.Lock()
_transfers = 0
_transfer_bytes = 0


def device_get(buf: torch.Tensor) -> np.ndarray:
    """THE device->host pull of the read path: one ``.cpu()``, counted
    with its bytes. ``buf`` is a packed int32 buffer; returns its words as
    numpy ``uint32``."""
    global _transfers, _transfer_bytes
    with _counter_lock:
        _transfers += 1
    t0 = time.perf_counter_ns()
    out = buf.cpu().numpy().view(np.uint32)
    t1 = time.perf_counter_ns()
    obs.record("readpack_transfer", (t1 - t0) / 1e9)
    querytrace.stamp_active(querytrace.QSEG_READPACK_TRANSFER, t0, t1)
    with _counter_lock:
        _transfer_bytes += out.nbytes
    return out


def transfer_count() -> int:
    """Process-wide device->host transfer count (monotonic)."""
    with _counter_lock:
        return _transfers


def transfer_bytes() -> int:
    """Process-wide device->host transfer volume in bytes (monotonic)."""
    with _counter_lock:
        return _transfer_bytes


# -- device-side pack ------------------------------------------------------

# (header words, device) -> the header on that device: a read's header
# depends only on its sections' dtypes and shapes, so it is copied to the
# card once per read shape (at most _MAX_HEADERS kept)
_headers: Dict[Tuple[bytes, torch.device], torch.Tensor] = {}
_headers_lock = threading.Lock()
_MAX_HEADERS = 256


def _words(t: torch.Tensor, dtype: np.dtype) -> torch.Tensor:
    """One section as int32 words, narrowed to its reference dtype."""
    flat = t.reshape(-1)
    if dtype == np.uint32:
        return u32.bits32(flat.to(torch.int64))
    if dtype == np.int32:
        return flat.to(torch.int32)
    if dtype == np.float32:
        return flat.to(torch.float32).view(torch.int32)
    if dtype in (np.uint8, np.bool_):
        b = flat.to(torch.uint8)
        pad = (-b.shape[0]) % 4
        if pad:
            b = torch.cat([b, b.new_zeros(pad)])
        return b.view(torch.int32)
    # 8-byte types: two words each, low word first (little-endian); a
    # u64 section is given as the int64 holding its bits
    wide = torch.float64 if dtype == np.float64 else torch.int64
    return flat.to(wide).view(torch.int32)


def pack(arrays: Sequence[torch.Tensor], dtypes: Sequence) -> torch.Tensor:
    """Pack ``arrays`` (tensors on one device) into one 1-D int32 ZPK1
    buffer on that device; section ``i`` goes out as ``dtypes[i]`` (a
    numpy dtype: what the reference returns for it)."""
    if len(arrays) != len(dtypes):
        raise ValueError(f"readpack.pack: {len(arrays)} sections, {len(dtypes)} dtypes")
    n = len(arrays)
    if n == 0:
        raise ValueError("readpack.pack: need at least one section")
    header_words = 2 + _SECTION_WORDS * n
    header = np.zeros(header_words, np.uint32)
    header[0] = MAGIC
    header[1] = n
    sections = []
    off = header_words * 4
    for i, (a, dt) in enumerate(zip(arrays, dtypes)):
        dt = np.dtype(dt)
        code = DTYPE_CODES.get(dt)
        if code is None:
            raise NotImplementedError(f"readpack: unsupported dtype {dt}")
        if a.dim() > _MAX_NDIM:
            raise ValueError(f"readpack.pack: ndim {a.dim()} > {_MAX_NDIM} (section {i})")
        stored = np.dtype(np.uint8) if dt == np.bool_ else dt
        h = 2 + _SECTION_WORDS * i
        header[h + 0] = code
        header[h + 1] = off
        header[h + 2] = a.numel() * stored.itemsize
        header[h + 3] = a.dim()
        header[h + 4:h + 4 + a.dim()] = a.shape
        words = _words(a, dt)
        sections.append(words)
        off += int(words.shape[0]) * 4
    dev = arrays[0].device
    key = (header.tobytes(), dev)
    with _headers_lock:
        head = _headers.get(key)
        if head is None:
            if len(_headers) >= _MAX_HEADERS:
                _headers.clear()
            head = torch.from_numpy(header.view(np.int32).copy()).to(dev)
            _headers[key] = head
    return torch.cat([head] + sections)


# -- host-side unpack ------------------------------------------------------


def unpack(buf: np.ndarray) -> List[np.ndarray]:
    """Split one pulled buffer into its arrays, as zero-copy views (every
    returned array shares ``buf``'s memory)."""
    buf = np.asarray(buf)
    if buf.ndim != 1 or buf.dtype != np.uint32:
        raise ValueError(f"readpack.unpack: expected 1-D uint32, got {buf.dtype}{buf.shape}")
    if buf.shape[0] < 2 or int(buf[0]) != MAGIC:
        raise ValueError("readpack.unpack: bad magic (not a ZPK1 buffer)")
    n = int(buf[1])
    raw = buf.view(np.uint8)
    out: List[np.ndarray] = []
    for i in range(n):
        h = buf[2 + _SECTION_WORDS * i: 2 + _SECTION_WORDS * (i + 1)]
        dt = CODE_DTYPES[int(h[0])]
        off, nbytes, ndim = int(h[1]), int(h[2]), int(h[3])
        dims = tuple(int(d) for d in h[4:4 + ndim])
        out.append(raw[off:off + nbytes].view(dt).reshape(dims))
    return out


def pull(packed: torch.Tensor) -> List[np.ndarray]:
    """One transfer + unpack: the host half of a packed read."""
    buf = device_get(packed)
    if querytrace.active() is None:
        return unpack(buf)
    t0 = time.perf_counter_ns()
    out = unpack(buf)
    querytrace.stamp_active(querytrace.QSEG_UNPACK, t0, time.perf_counter_ns())
    return out


def describe(buf: np.ndarray) -> List[Tuple[str, tuple, int]]:
    """Header introspection: [(dtype_name, shape, byte_len), ...]."""
    return [(a.dtype.name, a.shape, a.nbytes) for a in unpack(np.asarray(buf))]
