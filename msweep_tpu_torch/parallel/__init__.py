"""EC-axis sharding of the port (counterpart of msweep_tpu/parallel)."""
