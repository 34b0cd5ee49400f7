"""Feed entry ``collector_json``: one JSON v2 ``ListOfSpans`` message a
batch through ``Collector.accept_spans_bytes``, the collector a single
zipkin-server process runs with ``TPU_FAST_INGEST=true`` and
``TPU_ARCHIVE_DIR=off``: the native parse and intern, the pack, the host
archive's 1-in-64 trace sample, then the aggregation tier's step.

A message holds the batch's lanes as zipkin-reporter's JSON v2 encoder
writes them, compact: 16-hex ``traceId``, ``parentId`` (where there is a
parent) and ``id``, ``kind``, ``name``, ``timestamp`` (microseconds inside
the batch's data minute), ``duration``, ``localEndpoint``,
``remoteEndpoint`` (the client half), ``tags`` (``http.method``,
``http.path`` and ``error`` on a failed hop) and ``shared`` (the server
half). Set-up encodes each pool batch once into a template and notes
where its varying bytes lie; a batch's message is then its template with
the pass's ids, the minute and the durations written in by numpy.

A message that leaves the native path, or spans that the collector does
not store, fail the run: the cell measures the line-rate path or
nothing."""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from portbench.feeds.columns import intern_names
from portbench.generator import Pool, service_name, span_name

# zipkin-reporter's KafkaSender default messageMaxBytes
MAX_MESSAGE_BYTES = 1_000_000
US_PER_MINUTE = 60_000_000
TS_LOW = 10 ** 7  # a timestamp's low 7 digits stay the template's
DUR_SLOT = 10  # digits of the largest u32 duration
POW10 = 10 ** np.arange(DUR_SLOT, dtype=np.int64)
LANE = np.arange(DUR_SLOT)
EIGHT = np.arange(8)
# each u16's 4 hex digits and each number below 10,000's 4 decimal digits,
# as the u32 whose bytes they are
HEX4 = np.frombuffer("".join(f"{v:04x}" for v in range(1 << 16)).encode(), np.uint32)
DEC4 = np.frombuffer("".join(f"{v:04d}" for v in range(10_000)).encode(), np.uint32)


class FastPathLeft(RuntimeError):
    """A message left the native path, or spans of it were not stored."""


def hex8(x: np.ndarray) -> np.ndarray:
    """[n, 8] the lowercase hex digits of u32 ``x``."""
    x = np.asarray(x, np.uint32)
    return np.stack([HEX4[x >> 16], HEX4[x & 0xFFFF]], 1).view(np.uint8)


def hex_words(x: np.ndarray) -> np.ndarray:
    """[n] the 8 hex digits of u32 ``x`` as the u64 whose bytes they are."""
    return hex8(x).view(np.uint64)[:, 0]


def decimal(x: np.ndarray, width: int) -> np.ndarray:
    """[n, width] the ASCII decimal digits of ``x`` < 10^12, zero-padded."""
    x = np.asarray(x, np.int64)
    words = np.stack([DEC4[x // 10 ** 8], DEC4[x // 10 ** 4 % 10 ** 4], DEC4[x % 10 ** 4]], 1)
    return words.view(np.uint8)[:, 12 - width:]


def words8(x: np.ndarray) -> np.ndarray:
    """[n] the 8 decimal digits of ``x`` < 10^8, zero-padded, as the u64
    whose bytes they are."""
    x = np.asarray(x, np.int64)
    return np.stack([DEC4[x // 10 ** 4], DEC4[x % 10 ** 4]], 1).view(np.uint64)[:, 0]


def digits(x: np.ndarray) -> np.ndarray:
    """The number of decimal digits of each ``x`` >= 1."""
    return np.searchsorted(POW10, np.asarray(x, np.int64), side="right")


def ipv4(svc: np.ndarray) -> np.ndarray:
    """[n, 12] each service's address, ``10.0.1xx.1yy``."""
    s = np.asarray(svc, np.int64)
    out = np.frombuffer(b"10.0.100.100", np.uint8)[None, :].repeat(len(s), 0)
    out[:, 5:8] = decimal(100 + s // 100 % 100, 3)
    out[:, 9:12] = decimal(100 + s % 100, 3)
    return out


def text(values: List[str]) -> np.ndarray:
    """[len(values), w] the ASCII bytes of equally long strings."""
    return np.frombuffer("".join(values).encode(), np.uint8).reshape(len(values), -1)


class Row:
    """One span's JSON with every optional part in place: a byte template
    and the column where each named part starts. A lane's row keeps the
    parts it has; :func:`build` drops the rest."""

    def __init__(self, parts: List[Tuple[str, bytes]]):
        self.cols: Dict[str, Tuple[int, int]] = {}
        out = b""
        for name, raw in parts:
            self.cols[name] = (len(out), len(out) + len(raw))
            out += raw
        self.template = np.frombuffer(out, np.uint8)

    def after(self, part: str, marker: bytes) -> int:
        """The column just after ``marker`` inside ``part``."""
        a, b = self.cols[part]
        return a + self.template[a:b].tobytes().index(marker) + len(marker)


ROW = Row([
    ("trace", b'{"traceId":"' + b"0" * 16 + b'"'),
    ("parent", b',"parentId":"' + b"0" * 16 + b'"'),
    ("id", b',"id":"' + b"0" * 16 + b'","kind":"'),
    ("client", b'CLIENT'),
    ("server", b'SERVER'),
    ("name", b'","name":"op00","timestamp":' + b"0" * 16 + b',"duration":'),
    ("dur", b"0" * DUR_SLOT),
    ("local", b',"localEndpoint":{"serviceName":"svc0000","ipv4":"10.0.100.100"}'),
    ("remote", b',"remoteEndpoint":{"serviceName":"svc0000","ipv4":"10.0.100.100",'
               b'"port":8080}'),
    ("tags", b',"tags":{'),
    ("error", b'"error":"500",'),
    ("get", b'"http.method":"GET"'),
    ("post", b'"http.method":"POST"'),
    ("path", b',"http.path":"/svc0000/op00"}'),
    ("shared", b',"shared":true'),
    ("end", b"},"),
])
# the byte columns of the fields written per lane (a 16-hex id's high
# half, then its low half 8 columns on)
TRACE_HI = ROW.after("trace", b'"traceId":"')
PARENT_HI = ROW.after("parent", b'"parentId":"')
ID_HI = ROW.after("id", b'"id":"')
TRACE_LO, PARENT_LO, ID_LO = TRACE_HI + 8, PARENT_HI + 8, ID_HI + 8
NAME, TS = ROW.after("name", b'"name":"'), ROW.after("name", b'"timestamp":')
LOCAL_SVC, LOCAL_IP = ROW.after("local", b'"serviceName":"'), ROW.after("local", b'"ipv4":"')
REMOTE_SVC, REMOTE_IP = ROW.after("remote", b'"serviceName":"'), ROW.after("remote", b'"ipv4":"')
PATH_SVC = ROW.after("path", b'"http.path":"/')
PATH_NAME = PATH_SVC + 8
DUR = ROW.cols["dur"][0]


class Template:
    """One pool batch's message as set-up encoded it, and where each lane's
    varying bytes lie in it: the low halves of its trace, span and parent
    ids, its timestamp's digits after the first and its duration. A batch's
    message rewrites them all in place, 8 bytes at a time, so the template
    serves every pass."""

    def __init__(self, pb, data: np.ndarray, offsets: Dict[str, np.ndarray],
                 dur_digits: np.ndarray, parent: np.ndarray, ts_tens: np.ndarray):
        c = pb.cols
        n = len(dur_digits)
        self.data = data
        # the 8 bytes from each offset of the message, as one word
        self.words = np.ndarray((len(data) - 7,), np.uint64, buffer=data, strides=(1,))
        # the ids' low halves as the pool batch has them: the trace's and
        # the span's of every lane, then the parent's of the lanes with one
        self.ids = np.concatenate([c["tl0"], c["s0"], c["p0"][parent]])
        self.n = n
        self.ts_tens = ts_tens  # each lane's start in its minute, in tens of seconds
        self.dur = offsets["dur"]
        self.dur_digits = dur_digits
        # the lanes whose duration can change its length from pass to pass:
        # its histogram bucket spans a power of ten, or it passes 8 digits
        hi = digits(pb.dur_lo.astype(np.int64) + pb.dur_mask)
        self.dur_check = np.nonzero((digits(pb.dur_lo) != hi) | (hi > 8))[0]
        # a duration of up to 8 digits, as long as the template's, is the
        # word that ends where its digits end; the bytes before its digits
        # keep what they hold
        dur_end = self.dur + dur_digits - 8
        self.dur_mask = ~np.uint64(0) << (8 * np.maximum(8 - dur_digits, 0)).astype(np.uint64)
        self.dur_fill = self.words[dur_end] & ~self.dur_mask
        # every word a batch writes, in the order inputs() lays them out
        self.at = np.concatenate([offsets["trace_lo"], offsets["id_lo"],
                                  offsets["parent_lo"][parent], offsets["ts"] + 1, dur_end])


def build(pb, svc_names: np.ndarray, span_names: np.ndarray, minute: int,
          ts_off: np.ndarray) -> Template:
    """The message of pool batch ``pb`` in data minute ``minute``, each
    lane ``ts_off`` microseconds into it: its lanes' rows, each without the
    parts it lacks, between ``[`` and ``]``. ``svc_names`` and
    ``span_names``: [ids, 7] and [ids, 4] the generator's names."""
    c = pb.cols
    n = len(c["svc"])
    name = c["key"] % len(span_names)
    svc, rsvc = c["svc"], c["rsvc"]
    parent = (c["p0"] | c["p1"]) != 0
    dur_digits = digits(c["dur"])

    rows = np.repeat(ROW.template[None, :], n, 0)
    rows[:, TRACE_HI:TRACE_HI + 8] = hex8(c["tl1"])
    rows[:, TRACE_LO:TRACE_LO + 8] = hex8(c["tl0"])
    rows[:, PARENT_HI:PARENT_HI + 8] = hex8(c["p1"])
    rows[:, PARENT_LO:PARENT_LO + 8] = hex8(c["p0"])
    rows[:, ID_HI:ID_HI + 8] = hex8(c["s1"])
    rows[:, ID_LO:ID_LO + 8] = hex8(c["s0"])
    rows[:, NAME:NAME + 4] = span_names[name]
    rows[:, TS:TS + 9] = decimal(minute * (US_PER_MINUTE // TS_LOW) + ts_off // TS_LOW, 9)
    rows[:, TS + 9:TS + 16] = decimal(ts_off % TS_LOW, 7)
    rows[:, DUR:DUR + DUR_SLOT] = decimal(c["dur"], DUR_SLOT)  # leading zeros dropped below
    rows[:, LOCAL_SVC:LOCAL_SVC + 7] = svc_names[svc]
    rows[:, LOCAL_IP:LOCAL_IP + 12] = ipv4(svc)
    rows[:, REMOTE_SVC:REMOTE_SVC + 7] = svc_names[rsvc]
    rows[:, REMOTE_IP:REMOTE_IP + 12] = ipv4(rsvc)
    rows[:, PATH_SVC:PATH_SVC + 7] = svc_names[svc]
    rows[:, PATH_NAME:PATH_NAME + 4] = span_names[name]

    client = c["kind"] == 1
    has = {"parent": parent, "client": client, "server": ~client, "remote": rsvc != 0,
           "error": c["err"], "get": name % 2 == 0, "post": name % 2 == 1,
           "shared": c["shared"]}
    keep = np.ones(rows.shape, bool)
    kept = {}  # the bytes each lane keeps of each part
    for part, (a, b) in ROW.cols.items():
        if part == "dur":
            kept[part] = dur_digits
            keep[:, a:b] = LANE >= DUR_SLOT - dur_digits[:, None]
        elif part in has:
            kept[part] = np.where(has[part], b - a, 0)
            keep[~has[part], a:b] = False
        else:
            kept[part] = np.full(n, b - a)
    # a field's offset in the message: "[", the rows before, then the
    # kept bytes of its row's parts before it
    parts = list(ROW.cols)
    row_len = sum(kept.values())
    start = 1 + np.cumsum(row_len) - row_len

    def offset(part: str, col: int) -> np.ndarray:
        before = sum(kept[p] for p in parts[:parts.index(part)])
        return start + before + col - ROW.cols[part][0]

    offsets = {"trace_lo": offset("trace", TRACE_LO), "parent_lo": offset("parent", PARENT_LO),
               "id_lo": offset("id", ID_LO), "ts": offset("name", TS), "dur": offset("dur", DUR)}
    data = np.concatenate([np.frombuffer(b"[", np.uint8), rows[keep]])
    data[-1] = ord("]")  # the last row's "," closes the list
    return Template(pb, data, offsets, dur_digits, np.nonzero(parent)[0], ts_off // TS_LOW)


class Entry:
    def __init__(self, store, pool: Pool):
        from zipkin_tpu_torch.collector.core import Collector, CollectorSampler

        self.store = store
        self.pool = pool
        mix = pool.mix
        services, names = int(mix["services"]), int(mix["names_per_service"])
        if services > 9999 or names > 100:
            raise ValueError("the messages' names hold at most 9,999 services and 100 names")
        self.svc_map, self.key_map = intern_names(store.vocab, mix)

        # each lane's start inside its minute, from the seed
        rng = np.random.default_rng([pool.seed, 3])
        ts_off = rng.integers(0, US_PER_MINUTE, (pool.size, pool.batch_spans))
        svc_names = text([service_name(s) for s in range(services + 1)])
        span_names = text([span_name(k) for k in range(names)])
        self.templates = [build(b, svc_names, span_names, pool.base_minute, off)
                          for b, off in zip(pool.batches, ts_off)]
        self._lead = pool.base_minute * (US_PER_MINUTE // TS_LOW) // 10 ** 8
        self._tops = (None, None)  # (minute, its timestamps' top digits as words)

        self.collector = Collector(store, sampler=CollectorSampler(1.0), fast_ingest=True)
        fast = store.ingest_json_fast

        def native_only(data, sampler=None):
            try:
                out = fast(data, sampler)
            except ValueError as e:
                raise FastPathLeft(f"the native parse refused a message: {e}") from e
            if out is None:
                raise FastPathLeft("a message left the native path")
            return out

        # the collector falls back to the object path on None or a parse's
        # ValueError; here either fails the run
        store.ingest_json_fast = native_only

    def inputs(self, g: int) -> bytes:
        """Global batch ``g`` as one JSON v2 message: its pool batch's
        template with the pass's trace, span and parent ids, the batch's
        minute and the pass's durations written in."""
        t = self.templates[g % self.pool.size]
        _, k_tl0, k_span, _ = self.pool.stamp(g)  # the pass's ids, as Pool.columns has them
        ids = t.ids ^ k_span
        ids[:t.n] ^= k_span ^ k_tl0
        dur = self.pool.durations(g)
        nd = digits(dur[t.dur_check])
        moved = t.dur_check[(nd != t.dur_digits[t.dur_check]) | (nd > 8)]
        minute = self.pool.minute(g)
        if minute != self._tops[0]:
            # a timestamp's 9 top digits: the minute's, and the lane's 10 s in it
            top = minute * (US_PER_MINUTE // TS_LOW)
            if top // 10 ** 8 != self._lead or (top + 5) // 10 ** 8 != self._lead:
                raise ValueError("the stream's timestamps outgrew the templates' first digit")
            self._tops = (minute, words8(top % 10 ** 8 + np.arange(6)))
        buf = t.data
        t.words[t.at] = np.concatenate([
            hex_words(ids), self._tops[1][t.ts_tens],
            words8(dur % 10 ** 8) & t.dur_mask | t.dur_fill])
        if not len(moved):
            msg = buf.tobytes()
        else:  # a duration that crossed a power of ten: the rest shifts
            view = memoryview(buf)
            parts, prev = [], 0
            for i in moved.tolist():
                parts += [view[prev:t.dur[i]], str(int(dur[i])).encode()]
                prev = t.dur[i] + t.dur_digits[i]
            parts.append(view[prev:])
            msg = b"".join(parts)
        if len(msg) > MAX_MESSAGE_BYTES:
            raise ValueError(f"a message of {len(msg)} B passes {MAX_MESSAGE_BYTES} B")
        return msg

    def __call__(self, msg: bytes) -> None:
        stored = self.collector.accept_spans_bytes(msg)
        if stored != self.pool.batch_spans:
            raise FastPathLeft(f"the collector stored {stored} of {self.pool.batch_spans} spans")
