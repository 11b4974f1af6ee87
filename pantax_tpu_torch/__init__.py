"""pantax_tpu_torch — the PyTorch/CUDA port of pantax_tpu for NVIDIA Hopper.

The JAX package (pantax_tpu) stays the reference; every module here keeps its
counterpart's name so the two are easy to compare:

  config.py, io/, graph/, db/, align/{encode,index}.py,
  profile/{filters,coverage}.py, sim.py, utils/
                       the port's own copy of the numpy host layer (it
                       imports nothing of pantax_tpu)
  _host.py             one namespace over those host names
  device.py            explicit device selection (require_cuda)
  align/aligner.py     host-side tables, seed stage, query epilogue,
                       the Aligner module (index tables as buffers)
  ops/extend.py        banded DP extension: the CUDA kernel (csrc/) and its
                       plain torch version
  ops/coverage_device  padded coverage tables, the windowed coverage
                       scatter and the coverage finalize
  ops/fused.py         fused align -> classify -> coverage pipeline (range
                       scatter, or the windowed scatter and host residual
                       on graphs that revisit nodes) and the profiling
                       entry points
  profile/             PAO solver (torch ADMM + HiGHS), two-stage engine,
                       pandas-free species/strain report writers
  benchmarks.py        synthetic community DBs and read simulators
  convert.py           reference state -> port modules
"""

__version__ = "0.1.0"
