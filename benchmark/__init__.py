"""The benchmark of the PyTorch and CUDA port (msweep_tpu_torch): one
run of one cell is `python3 -m benchmark.run`; see PERF.md."""
