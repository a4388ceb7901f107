"""PyTorch/CUDA port of msweep-tpu.

The device side of the JAX package (msweep_tpu) rebuilt on PyTorch, with
the TPU kernels of the rcg and EM optimizers, of the bootstrap batch and
of the kernel profiler written by hand in CUDA C++ for Hopper (csrc/).  The host layers
(alignment parsing, EC collapse, likelihood build, bootstrap draws, output
writers) are this package's own copies of the JAX package's JAX-free
modules, at the same relative paths and with the same behaviour.  This
package imports neither jax nor anything of msweep_tpu.

  core/           alignment collapse, likelihood build, bootstrap draws, binning
  io/             Themisto and packed alignments, groupings, checkpoints, writers
  native/         the C++ host parser (g++ at first import; numpy fallback)
  log.py, utils.py, synth.py, cli_pack.py
                  logging, NEG / PAD_THRESHOLD, synthetic likelihoods, the pack tool
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

__version__ = "0.1.0"  # the outputs write msweep-tpu-{__version__}, as the JAX package does

__all__ = ["__version__"]
