"""The port's model, codecs, span packing and HLL envelope against the JAX
package's.

Each payload is encoded by the JAX package's codec; the port decodes it and
encodes it again, and the bytes must equal the reference's own round trip
(for the formats whose decode is lossless, the original bytes), in all four
formats, on the canonical TRACE and on 500 synthetic spans. ``pack_spans``
from both packages on the same spans and a fresh vocab gives bit-equal wire
images; the id helpers and the HLL envelope agree exactly.
"""

from __future__ import annotations

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from tests.fixtures import TRACE, lots_of_spans
import tests.torch_cpu  # noqa: F401  (one intra-op thread a test process)
from zipkin_tpu.internal import hex as ref_hex
from zipkin_tpu.internal.dependency_linker import DependencyLinker as RefLinker
from zipkin_tpu.internal.span_node import merge_trace as ref_merge_trace
from zipkin_tpu.model import codec as ref_codec
from zipkin_tpu.model import json_v2 as ref_json
from zipkin_tpu.ops import hll as ref_hll
from zipkin_tpu.tpu import columnar as ref_columnar
from zipkin_tpu_torch.internal import hex as port_hex
from zipkin_tpu_torch.internal.dependency_linker import DependencyLinker as PortLinker
from zipkin_tpu_torch.internal.span_node import merge_trace as port_merge_trace
from zipkin_tpu_torch.model import codec as port_codec
from zipkin_tpu_torch.model import json_v2 as port_json
from zipkin_tpu_torch.model.span import Kind
from zipkin_tpu_torch.ops import hll as port_hll
from zipkin_tpu_torch.storage.spi import group_by_trace_id
from zipkin_tpu_torch.tpu import columnar as port_columnar

FORMATS = ["JSON_V2", "JSON_V1", "PROTO3", "THRIFT"]
DATASETS = {"trace": TRACE, "lots": lots_of_spans(500, seed=7)}
SETTINGS = settings(max_examples=300, deadline=None, database=None)


def _payload(fmt: str, data: str) -> bytes:
    return ref_codec.encode_spans(DATASETS[data], ref_codec.Encoding[fmt])


@pytest.mark.parametrize("data", list(DATASETS))
@pytest.mark.parametrize("fmt", FORMATS)
def test_codec_round_trip_bytes_equal_the_reference(fmt, data):
    payload = _payload(fmt, data)
    enc = ref_codec.Encoding[fmt]
    assert port_codec.detect(payload).value == ref_codec.detect(payload).value == enc.value
    ref_spans = ref_codec.decode_spans(payload)
    port_spans = port_codec.decode_spans(payload)
    assert len(port_spans) == len(ref_spans) > 0
    assert all(type(s).__module__ == "zipkin_tpu_torch.model.span" for s in port_spans)
    # the decoded spans, field by field, as JSON v2
    assert port_json.encode_span_list(port_spans) == ref_json.encode_span_list(ref_spans)
    again = port_codec.encode_spans(port_spans, port_codec.Encoding[fmt])
    assert again == ref_codec.encode_spans(ref_spans, enc)
    if fmt in ("JSON_V2", "PROTO3"):
        assert again == payload


@pytest.mark.parametrize("data", list(DATASETS))
def test_pack_spans_images_are_bit_equal(data):
    spans = DATASETS[data]
    port_spans = port_json.decode_span_list(ref_json.encode_span_list(spans))
    rv, pv = ref_columnar.Vocab(64, 256), port_columnar.Vocab(64, 256)
    for pad in (128, 1024):
        want = ref_columnar.fuse_columns(ref_columnar.pack_spans(spans, rv, pad))
        got = port_columnar.fuse_columns(port_columnar.pack_spans(port_spans, pv, pad))
        assert got.dtype == want.dtype and got.shape == want.shape
        assert (got == want).all()
    assert pv.services._names == rv.services._names
    assert pv.span_names._names == rv.span_names._names
    assert pv._key_list == rv._key_list
    assert port_columnar.KIND_TO_ID[Kind.SERVER] == ref_columnar.KIND_TO_ID[
        ref_columnar.Kind.SERVER]


def test_vocab_overflow_lands_in_the_catch_all_rows():
    """Past capacity a new span name lands in its service's catch-all row,
    in both packages, with the same overflow counts."""
    rv, pv = ref_columnar.Vocab(4, 6), port_columnar.Vocab(4, 6)
    seq = [("a", "x"), ("a", "y"), ("b", "x"), ("a", "z"), ("c", "w"), ("b", "q")]
    for svc, name in seq:
        got = pv.key_id(pv.services.intern(svc), pv.span_names.intern(name))
        want = rv.key_id(rv.services.intern(svc), rv.span_names.intern(name))
        assert got == want
    assert (pv._overflow, pv.services.overflow) == (rv._overflow, rv.services.overflow)
    assert pv._overflow > 0


@pytest.mark.parametrize("data", list(DATASETS))
def test_host_linker_and_trace_merge_agree(data):
    spans = DATASETS[data]
    port_spans = port_json.decode_span_list(ref_json.encode_span_list(spans))
    ref_l, port_l = RefLinker(), PortLinker()
    for trace in group_by_trace_id(port_spans, True):
        port_l.put_trace(port_merge_trace(trace))
        ref_trace = ref_json.decode_span_list(port_json.encode_span_list(trace))
        ref_l.put_trace(ref_merge_trace(ref_trace))
    want = ref_json.encode_link_list(ref_l.link())
    assert port_json.encode_link_list(port_l.link()) == want and want != b"[]"


def _agree(fn_port, fn_ref, arg):
    try:
        want = fn_ref(arg)
    except ValueError:
        with pytest.raises(ValueError):
            fn_port(arg)
        return
    assert fn_port(arg) == want


@SETTINGS
@given(st.one_of(
    st.integers(0, (1 << 128) - 1).map(lambda v: f"{v:x}"),
    st.integers(0, (1 << 64) - 1).map(lambda v: f"{v:016X}"),
    st.text("0123456789abcdefABCDEFxz", min_size=0, max_size=34),
))
def test_trace_id_helpers_agree(trace_id):
    _agree(port_hex.normalize_trace_id, ref_hex.normalize_trace_id, trace_id)
    try:
        norm = ref_hex.normalize_trace_id(trace_id)
    except ValueError:
        return
    assert port_hex.lower_64(norm) == ref_hex.lower_64(norm)


@SETTINGS
@given(st.integers(-(1 << 40), 1 << 50))
def test_epoch_minutes_agree(epoch_ms):
    assert port_hex.epoch_minutes(epoch_ms) == ref_hex.epoch_minutes(epoch_ms)


@pytest.mark.parametrize("p", range(4, 17))
def test_hll_envelope_agrees(p):
    assert port_hll.standard_error(p) == ref_hll.standard_error(p)
    assert port_hll.envelope_max(p) == ref_hll.envelope_max(p)
    for n in (1.0, 5e8, 7.5e8, 1e9, 1.5e9, 3e9, 4e9, 1e10, port_hll.envelope_max(p)):
        assert port_hll.bias_fraction(n) == ref_hll.bias_fraction(n)
