"""Internal helpers: hex/id codecs, trace reassembly, dependency linking
(the port's copies of ``zipkin_tpu/internal``)."""
