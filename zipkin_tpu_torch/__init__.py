"""PyTorch/CUDA port of the zipkin-tpu aggregation tier.

A single-device port of the main path of :mod:`zipkin_tpu`: the packed
span wire image is folded into device sketch state (HLL registers, log2
histograms, t-digests, the retention ring and its incremental link
context), and three aggregate reads are served from it — latency
quantiles, distinct-trace cardinalities and service dependency edges.
Users reach it through the storage SPI:
:class:`zipkin_tpu_torch.tpu.store.TorchStorage` takes Zipkin spans
(:mod:`zipkin_tpu_torch.model`, decoded from any of the four wire
formats) and answers trace, search, name and aggregate queries.

Layout mirrors the JAX package module for module
(``zipkin_tpu_torch/ops/hll.py`` is the counterpart of
``zipkin_tpu/ops/hll.py``). The package imports torch and numpy only;
what it needs of the JAX package's numpy helpers it keeps its own copy
of. Entry points run on ``cuda`` unless the caller passes
``device="cpu"`` (see :func:`zipkin_tpu_torch.device.resolve_device`).
"""

__version__ = "0.1.0"
