"""The span model and wire codecs (JSON v2/v1, proto3, thrift): the port's
copies of ``zipkin_tpu/model``."""

from zipkin_tpu_torch.model.span import (  # noqa: F401
    Annotation,
    DependencyLink,
    Endpoint,
    Kind,
    Span,
)
