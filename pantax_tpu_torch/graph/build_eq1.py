"""Chain graph for single-genome species: chop each contig into fixed-size
chunks; nodes are chunks, the genome is a single haplotype walking them.

Parity: PanTax's src/build_eq1.rs:38-119 (CHUNK_SIZE = 1024,
PanTax's src/constants.rs:3; W-line sample = first two '_' tokens
of the genome file name; multiple contigs concatenate into one haplotype path).
Unlike the reference (which rejects multi-contig genomes at build_eq1.rs:96-99),
multiple contigs are accepted and merged into one path, matching the W-line
merge semantics in zip.rs:154-158.
"""
from __future__ import annotations

import os

import numpy as np

from ..io.fastx import iter_fastx
from .core import SpeciesGraph

CHUNK_SIZE = 1024


def genome_hap_id(genome_path: str | os.PathLike) -> str:
    name = os.path.basename(os.fspath(genome_path))
    parts = name.split("_")
    if len(parts) >= 2:
        return "_".join(parts[:2])
    if name.endswith(".gz"):
        name = name[:-3]
    return name.rsplit(".", 1)[0]


def build_chain_graph(
    genome_path: str | os.PathLike,
    chunk_size: int = CHUNK_SIZE,
    hap_id: str | None = None,
) -> SpeciesGraph:
    if hap_id is None:
        hap_id = genome_hap_id(genome_path)
    node_seqs: list[bytes] = []
    path: list[int] = []
    for _, seq in iter_fastx(genome_path):
        for start in range(0, len(seq), chunk_size):
            path.append(len(node_seqs))
            node_seqs.append(seq[start : start + chunk_size])
    if not node_seqs:
        raise ValueError(f"{genome_path}: no sequence records")
    nodes_len = np.array([len(s) for s in node_seqs], dtype=np.int64)
    return SpeciesGraph.from_paths(
        nodes_len, {hap_id: np.array(path, dtype=np.int64)}, node_seqs
    )
