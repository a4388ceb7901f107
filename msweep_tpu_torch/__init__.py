"""PyTorch/CUDA port of msweep-tpu.

The device side of the JAX package (msweep_tpu) rebuilt on PyTorch, with
the TPU kernels of the rcg optimizer written by hand in CUDA C++ for
Hopper (csrc/).  The host layers (alignment parsing, EC collapse,
likelihood build, output writers) are the JAX package's own JAX-free
modules, imported and not copied.  This package never imports jax.

  device.py       the torch.device named by --backend (no silent fallback)
  inference/      packing, the implicit rcg optimizer, fit dispatch
  ops/            the K1/K2 passes: CUDA kernels and plain PyTorch versions
  csrc/           the CUDA sources, built with nvcc at first use
  cli.py          the mSWEEP-compatible command line, rcg path
"""

from msweep_tpu import __version__

__all__ = ["__version__"]
