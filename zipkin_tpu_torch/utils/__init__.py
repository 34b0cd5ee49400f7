"""Component lifecycle and the Call seam (the port's copies of
``zipkin_tpu/utils``)."""
