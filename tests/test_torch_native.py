"""The port's native parser (``zipkin_tpu_torch.native``) against the JAX
package's (``zipkin_tpu.native``): the same payload bytes through both
give equal columns, equal interned ids, equal sampler verdicts and
bit-equal packed batches, and the port's ``pack_parsed`` equals its own
object path's ``pack_spans``.

Both parsers are compiled from their own copy of ``span_json.c``. The
tests skip only when no C compiler is present (the fixture decides, not
the import).
"""

from __future__ import annotations

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from tests.fixtures import TRACE, TODAY_US, lots_of_spans
import tests.torch_cpu  # noqa: F401  (one intra-op thread a test process)
from zipkin_tpu import native as ref_native
from zipkin_tpu.model import json_v2 as ref_json
from zipkin_tpu.model import proto3 as ref_proto3
from zipkin_tpu.model.span import Endpoint, Kind, Span
from zipkin_tpu.tpu import columnar as ref_columnar
from zipkin_tpu_torch import native
from zipkin_tpu_torch.model import codec as port_codec
from zipkin_tpu_torch.tpu.columnar import Vocab, pack_parsed, pack_spans

ENCODERS = {"json": ref_json.encode_span_list, "proto3": ref_proto3.encode_span_list}


@pytest.fixture(autouse=True)
def _needs_a_compiler():
    if not native.available() or not ref_native.available():
        pytest.skip("no C compiler for the native parser")


def assert_parsed_equal(got, want) -> None:
    """Every PARSED_FIELDS column and ``n`` equal (absent on both, or
    equal over the first ``n`` lanes and the capacity)."""
    assert (got is None) == (want is None)
    if got is None:
        return
    assert got.n == want.n
    for f in native.PARSED_FIELDS:
        g, w = getattr(got, f, None), getattr(want, f, None)
        assert (g is None) == (w is None), f
        if g is not None:
            assert g.dtype == w.dtype, f
            np.testing.assert_array_equal(g, w, err_msg=f)


def both(data: bytes):
    return native.parse_spans(data), ref_native.parse_spans(data)


def assert_cols_equal(got, want) -> None:
    assert got._fields == want._fields
    for f in got._fields:
        g, w = getattr(got, f), getattr(want, f)
        assert g.dtype == w.dtype, f
        np.testing.assert_array_equal(g, w, err_msg=f)


# -- parse ------------------------------------------------------------------


@pytest.mark.parametrize("fmt", sorted(ENCODERS))
@pytest.mark.parametrize("which", ["trace", "lots"])
def test_parse_columns_equal(fmt, which):
    spans = TRACE if which == "trace" else lots_of_spans(2000, seed=11)
    got, want = both(ENCODERS[fmt](spans))
    assert got is not None and got.n == len(spans)
    assert_parsed_equal(got, want)


_HEX = "0123456789abcdef"
_ids = st.text(_HEX, min_size=16, max_size=16).filter(lambda s: s.strip("0"))
# printable ASCII without the characters JSON escapes: the fast path's domain
_names = st.text(st.characters(min_codepoint=0x20, max_codepoint=0x7E,
                               blacklist_characters='"\\'), max_size=12)


@settings(max_examples=40, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(
    trace_hi=st.one_of(st.just(""), _ids), trace_lo=_ids, span_id=_ids,
    parent=st.one_of(st.none(), _ids), name=_names, svc=_names, remote=_names,
    duration=st.one_of(st.none(), st.integers(1, 1 << 40)),
    kind=st.sampled_from([None, Kind.CLIENT, Kind.SERVER, Kind.PRODUCER, Kind.CONSUMER]),
    fmt=st.sampled_from(sorted(ENCODERS)),
)
def test_generated_ids_and_names_parse_equal(trace_hi, trace_lo, span_id, parent, name, svc,
                                             remote, duration, kind, fmt):
    span = Span.create(
        trace_hi + trace_lo, span_id, parent_id=parent if parent != span_id else None,
        name=name or None, kind=kind, timestamp=TODAY_US, duration=duration,
        local_endpoint=Endpoint.create(svc) if svc.strip() else None,
        remote_endpoint=Endpoint.create(remote) if remote.strip() else None,
    )
    got, want = both(ENCODERS[fmt]([span, span]))
    assert got is not None
    assert_parsed_equal(got, want)


@pytest.mark.parametrize("data", [
    b'[{"traceId":"a","id":"b","name":"we\\"ird"}]',  # escaped string: Python codec
    b'[{"traceId": }]',
    b"{",
    b"\xffnot-spans",
    b"[]",
    b'[{"traceId":"a","id":"b","duration":99999999999999}]',  # clamps to u32
], ids=["escaped", "malformed", "open-brace", "garbage", "empty", "huge-duration"])
def test_edge_payloads_parse_equal(data):
    got, want = both(data)
    assert_parsed_equal(got, want)
    if data == b"[]":
        assert got.n == 0
    elif data.startswith(b'[{"traceId":"a","id":"b","d'):
        assert got.n == 1 and got.dur_us[0] == 0xFFFFFFFF
    else:
        assert got is None


def test_proto3_first_span_of_length_0x5b_is_proto3():
    """A ListOfSpans whose first span is 0x5B ('[') bytes long starts
    ``0A 5B``: the sniff walks the frames and parses it as proto3."""
    for pad in range(200):
        span = Span.create("000000000000000a", "000000000000000b", name="x",
                           local_endpoint=Endpoint.create("svc"), tags={"k": "v" * pad})
        if len(ref_proto3.encode_span(span)) == 0x5B:
            break
    else:
        pytest.fail("no padding gives a 0x5B-byte span")
    data = ref_proto3.encode_span_list([span, span])
    assert data[:2] == b"\x0a\x5b"
    assert port_codec.detect(data) is port_codec.Encoding.PROTO3
    got, want = both(data)
    assert got is not None and got.n == 2
    assert_parsed_equal(got, want)


# -- vocab, sampler and packing -------------------------------------------


@pytest.mark.parametrize("fmt", sorted(ENCODERS))
def test_interned_ids_equal_reference_native_vocab(fmt):
    """Parsing against each package's NativeVocab interns the same ids,
    and after sync() both Python vocabs hold the same lists."""
    payloads = [ENCODERS[fmt](lots_of_spans(800, seed=s, services=4 + s, span_names=3 + 2 * s))
                for s in range(3)]
    port_v, ref_v = Vocab(64, 256), ref_columnar.Vocab(64, 256)
    port_nv, ref_nv = native.NativeVocab(port_v), ref_native.NativeVocab(ref_v)
    for data in payloads:
        port_nv.ensure_synced()
        ref_nv.ensure_synced()
        got, want = native.parse_spans(data, nvocab=port_nv), ref_native.parse_spans(data, nvocab=ref_nv)
        port_nv.sync()
        ref_nv.sync()
        assert_parsed_equal(got, want)
    assert port_v.services._names == ref_v.services._names
    assert port_v.span_names._names == ref_v.span_names._names
    assert port_v._key_list == ref_v._key_list
    assert port_nv.counts() == ref_nv.counts() == (
        len(port_v.services) - 1, len(port_v.span_names) - 1, port_v.num_keys - 1)
    # the Python vocab of the object path assigns the same ids
    obj = Vocab(64, 256)
    for data in payloads:
        pack_spans(port_codec.decode_spans(data), obj, 256)
    assert obj._key_list == port_v._key_list and obj.services._names == port_v.services._names
    assert port_v.key_pair(port_v.num_keys - 1) == port_v._key_list[-1]
    assert port_v.key_pair(port_v.num_keys) == (0, 0)


def test_vocab_overflow_is_counted_in_c():
    v = Vocab(4, 8)
    nv = native.NativeVocab(v)
    parsed = native.parse_spans(ref_json.encode_span_list(lots_of_spans(300, seed=3, services=9)),
                                nvocab=nv)
    nv.sync()
    assert parsed.n == 300 and nv.overflow > 0
    assert len(v.services) == 4 and v.num_keys <= 8


@pytest.mark.parametrize("rate", [0.0, 0.3, 0.999999, 1.0])
def test_sampler_keep_equals_reference(rate):
    from zipkin_tpu.collector.core import CollectorSampler as RefSampler

    spans = lots_of_spans(1500, seed=9)
    # Long.MIN_VALUE and the largest magnitudes in the low 64 bits, one debug
    spans += [Span.create(f"{tid:016x}", "1", timestamp=TODAY_US, duration=1, debug=dbg)
              for tid, dbg in ((1 << 63, False), ((1 << 64) - 1, False), ((1 << 63) - 1, False),
                               (1 << 63, True))]
    parsed = native.parse_spans(ref_json.encode_span_list(spans))
    boundary = RefSampler(rate)._boundary
    got = native.sampler_keep(parsed, parsed.n, boundary)
    np.testing.assert_array_equal(got, ref_native.sampler_keep(parsed, parsed.n, boundary))
    scalar = [RefSampler(rate).is_sampled(int(s.trace_id[-16:], 16), bool(s.debug)) for s in spans]
    np.testing.assert_array_equal(got, scalar)


@pytest.mark.parametrize("fmt", sorted(ENCODERS))
@pytest.mark.parametrize("interned", [False, True], ids=["python-intern", "c-intern"])
def test_pack_parsed_equals_reference_and_pack_spans(fmt, interned):
    spans = lots_of_spans(1000, seed=13)
    data = ENCODERS[fmt](spans)
    port_v, ref_v, obj_v = Vocab(256, 1024), ref_columnar.Vocab(256, 1024), Vocab(256, 1024)
    if interned:
        port_nv, ref_nv = native.NativeVocab(port_v), ref_native.NativeVocab(ref_v)
        port_p = native.parse_spans(data, nvocab=port_nv)
        ref_p = ref_native.parse_spans(data, nvocab=ref_nv)
        port_nv.sync()
        ref_nv.sync()
    else:
        port_p, ref_p = native.parse_spans(data), ref_native.parse_spans(data)
    got = pack_parsed(port_p, port_v, pad_to_multiple=256)
    assert_cols_equal(got, ref_columnar.pack_parsed(ref_p, ref_v, pad_to_multiple=256))
    assert_cols_equal(got, pack_spans(port_codec.decode_spans(data), obj_v, pad_to_multiple=256))
    assert port_v._key_list == ref_v._key_list == obj_v._key_list


def test_select_takes_lanes_and_slices():
    parsed = native.parse_spans(ref_json.encode_span_list(lots_of_spans(50, seed=1)))
    idx = np.array([0, 3, 49])
    sub = parsed.select(idx)
    assert sub.n == 3 and sub.data is parsed.data
    np.testing.assert_array_equal(sub.s0, parsed.s0[idx])
    part = parsed.select(slice(40, 64))
    assert part.n == 10
    np.testing.assert_array_equal(part.ts_us, parsed.ts_us[40:50])
