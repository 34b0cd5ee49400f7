"""The HTTP server exposing the Zipkin v2 API over the port's storage
(``python -m zipkin_tpu_torch.server``)."""
