"""The port's numpy host layer in one namespace.

Config, I/O, graph and DB construction, the align index, the strain
filters, the native C++ helpers and the residual coverage oracle live in
the port's own copies of the reference's host modules (``config.py``,
``io/``, ``graph/``, ``db/``, ``align/encode.py``, ``align/index.py``,
``profile/filters.py``, ``profile/coverage.py``, ``sim.py``, ``utils/``),
laid out as in pantax_tpu so each has an obvious counterpart.  This module
re-exports the names the device modules, the smoke run and the tests use.
"""
from __future__ import annotations

from .align.encode import _mix32 as mix32
from .align.encode import encode_seq
from .align.index import build_align_index
from .config import AlignConfig, ProfilingConfig
from .db.construct import build_database, load_database
from .graph.core import load_species_range
from .graph.trio import build_trio_index
from .io.fastx import iter_fastx, write_fasta
from .io.gaf import GafRecord
from .io.metadata import GenomeInfo, read_genomes_info, write_genomes_info
from .profile.coverage import PackedReads, raw_contributions
from .profile.filters import (
    HapMetrics, OtuState, first_filter_paths, second_filter_paths,
)
from .profile.filters import _round2 as round2
from .sim import revcomp
from .utils.native import chd_build_native

__all__ = [
    "AlignConfig", "GafRecord", "GenomeInfo", "HapMetrics", "OtuState",
    "PackedReads", "ProfilingConfig", "build_align_index", "build_database",
    "build_trio_index", "chd_build_native", "encode_seq",
    "first_filter_paths", "iter_fastx", "load_database", "load_species_range",
    "mix32", "raw_contributions", "read_genomes_info", "revcomp", "round2",
    "second_filter_paths", "write_fasta", "write_genomes_info",
]
