"""jax-free access to the reference package's numpy host layer.

The port reuses pantax_tpu's host code (config, io, graph, DB construction,
the align index, the strain filters, the native C++ helpers) instead of
copying it.  Two package ``__init__``s stand in the way on a machine without
jax: ``pantax_tpu/align/__init__.py:2`` imports the JAX ``Aligner`` and
``pantax_tpu/profile/__init__.py:4`` imports the JAX PAO solver.  Worse, DB
construction reaches ``align.encode`` through a lazy import inside
``graph/pangenome.py``, whose failure DB construction logs per species
and skips: without jax a DB silently comes out with species missing.

So, only when jax cannot be found, ``pantax_tpu.align`` and
``pantax_tpu.profile`` are registered in ``sys.modules`` as bare packages
(their ``__path__`` is the real directory; their ``__init__`` never runs).
Their jax-free submodules (``align.encode``, ``align.index``,
``profile.filters``) then load from the reference's own files.  When jax is
present, as in the parity tests, nothing is stubbed.
"""
from __future__ import annotations

import importlib.util
import os
import sys
import types


def _jax_available() -> bool:
    try:
        return importlib.util.find_spec("jax") is not None
    except ImportError:  # a meta-path finder that refuses jax outright
        return False


def _register_bare_packages() -> None:
    import pantax_tpu

    root = os.path.dirname(pantax_tpu.__file__)
    for sub in ("align", "profile"):
        name = f"pantax_tpu.{sub}"
        if name in sys.modules:
            continue
        mod = types.ModuleType(name)
        mod.__path__ = [os.path.join(root, sub)]
        mod.__package__ = name
        sys.modules[name] = mod
        setattr(pantax_tpu, sub, mod)


if not _jax_available():
    _register_bare_packages()

from pantax_tpu.align.encode import _mix32 as mix32  # noqa: E402
from pantax_tpu.align.encode import encode_seq  # noqa: E402
from pantax_tpu.align.index import build_align_index  # noqa: E402
from pantax_tpu.config import AlignConfig, ProfilingConfig  # noqa: E402
from pantax_tpu.db.construct import build_database, load_database  # noqa: E402
from pantax_tpu.graph.core import load_species_range  # noqa: E402
from pantax_tpu.graph.trio import build_trio_index  # noqa: E402
from pantax_tpu.io.fastx import iter_fastx, write_fasta  # noqa: E402
from pantax_tpu.io.gaf import GafRecord  # noqa: E402
from pantax_tpu.io.metadata import (  # noqa: E402
    GenomeInfo, read_genomes_info, write_genomes_info,
)
from pantax_tpu.profile.filters import (  # noqa: E402
    HapMetrics, OtuState, first_filter_paths, second_filter_paths,
)
from pantax_tpu.profile.filters import _round2 as round2  # noqa: E402
from pantax_tpu.sim import revcomp  # noqa: E402
from pantax_tpu.utils.native import chd_build_native  # noqa: E402

__all__ = [
    "AlignConfig", "GafRecord", "GenomeInfo", "HapMetrics", "OtuState",
    "ProfilingConfig", "build_align_index", "build_database",
    "build_trio_index", "chd_build_native", "encode_seq",
    "first_filter_paths", "iter_fastx", "load_database", "load_species_range",
    "mix32", "read_genomes_info", "revcomp", "round2", "second_filter_paths",
    "write_fasta", "write_genomes_info",
]
