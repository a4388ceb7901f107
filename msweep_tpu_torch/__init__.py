"""PyTorch/CUDA port of msweep-tpu.

The device side of the JAX package (msweep_tpu) rebuilt on PyTorch, with
the TPU kernels of the rcg and EM optimizers, of the bootstrap batch and
of the kernel profiler written by hand in CUDA C++ for Hopper (csrc/).  The host layers
(alignment parsing, EC collapse, likelihood build, bootstrap draws, output
writers) are the JAX package's own JAX-free modules, imported and not
copied.  This package never imports jax.

  device.py       the torch.device named by --backend (no silent fallback)
  inference/      packing, the implicit rcg optimizer and its bootstrap
                  batch, EM and its batch, RATE, fit dispatch
  ops/            the passes K1-K5 and the profiler's sweeps T1-T3: CUDA
                  kernels and plain PyTorch versions
  csrc/           the CUDA sources, built with nvcc at first use
  parallel/       EC-axis sharding over devices and processes
  cli.py          the mSWEEP-compatible command line
  prof_kernels.py the per-kernel profiler (python -m msweep_tpu_torch.prof_kernels)
"""

from msweep_tpu import __version__

__all__ = ["__version__"]
