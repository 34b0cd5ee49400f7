"""Port of zipkin_tpu/tpu."""
