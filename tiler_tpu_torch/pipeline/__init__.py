"""The port's encoder steps, one module per tiler_tpu.pipeline step."""
