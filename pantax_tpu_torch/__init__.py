"""pantax_tpu_torch — the PyTorch/CUDA port of pantax_tpu for NVIDIA Hopper.

The JAX package (pantax_tpu) stays the reference; every module here keeps its
counterpart's name so the two are easy to compare:

  _host.py             jax-free access to the reference's numpy host layer
  device.py            explicit device selection (require_cuda)
  align/aligner.py     host-side tables, seed stage, query epilogue,
                       the Aligner module (index tables as buffers)
  ops/extend.py        banded DP extension: the CUDA kernel (csrc/) and its
                       plain torch version
  ops/coverage_device  padded coverage tables and the coverage finalize
  ops/fused.py         fused align -> classify -> range-scatter coverage
                       pipeline and the short-read profiling entry point
  profile/             PAO solver (torch ADMM + HiGHS), two-stage engine,
                       pandas-free species/strain report writers
  benchmarks.py        synthetic community DB and read simulator
  convert.py           reference state -> port modules
"""

__version__ = "0.1.0"
