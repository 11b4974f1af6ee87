"""pantax_tpu_torch — the PyTorch/CUDA port of pantax_tpu for NVIDIA Hopper.

The JAX package (pantax_tpu) stays the reference; every module here keeps its
counterpart's name so the two are easy to compare:

  config.py, io/, graph/, db/, align/{encode,index}.py,
  profile/{filters,coverage}.py, utils/
                       the port's own copy of the numpy host layer (it
                       imports nothing of pantax_tpu)
  _host.py             one namespace over those host names
  device.py            explicit device selection (require_cuda,
                       card_unless)
  align/aligner.py     host-side tables, seed stage, query epilogue,
                       the Aligner module (index tables as buffers)
  ops/extend.py        banded DP extension: the CUDA kernel (csrc/) and its
                       plain torch version
  ops/coverage_device  padded coverage tables, the windowed coverage
                       scatter, the coverage finalize and the per-species
                       coverage (its rows sharded over a device mesh)
  ops/coverage.py      interval node coverage (no production caller)
  ops/fused.py         fused align -> classify -> coverage pipeline (range
                       scatter, or the windowed scatter and host residual
                       on graphs that revisit nodes) and the profiling
                       entry points
  profile/             PAO solver (torch ADMM + HiGHS), two-stage engine,
                       pandas-free species/strain report writers
  fastpath.py, pipeline.py
                       array-native and per-species (GAF) profiling
  parallel/            device meshes (mesh.py, auto_mesh), multi-process
                       runs over torch.distributed (distributed.py), the
                       mesh dry run (dryrun.py) and entry() (entry.py),
                       the single-device compile check: the query step
                       on tiny_db
  cli.py               the pantax-gpu command line (every flow of
                       pantax-tpu, plus --device cuda|cpu; --mesh and
                       --distributed): ``python -m pantax_tpu_torch.cli``
  db/{sketch,preprocess,rg,merge,md,sketch_cli}.py
                       genome sketches for --fast, and the DB-curation
                       tools pantax-gpu-rg, pantax-gpu-md, pantax-gpu-sketch
  benchmarks.py        synthetic community DBs, read simulators and the
                       benchmark runners (alignment, short / long / mixed
                       e2e, the 1:3:9 strain-accuracy runs)
  sim.py               read simulation with truth GAF records
  convert.py           reference state -> port modules
"""

__version__ = "0.1.0"
