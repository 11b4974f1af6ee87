"""Per-read alignment records and grouping by species, the port's copy of
pantax_tpu/profile/records.py (``from_gaf`` builds one record from a GAF
record; pipeline.profile_from_gaf builds them from the node paths that
classification has already parsed).

Parity: PanTax's src/profile.rs:351-463 (Record,
group_reads_by_species, duplicate read-id fallback).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..io.gaf import GafRecord


@dataclass
class ReadRecord:
    read_id: str
    nodes: np.ndarray     # int64, global 1-based node ids in path order
    read_path_len: int    # GAF col 7
    read_start: int       # GAF col 8 (offset into first node)
    read_end: int         # GAF col 9
    species: str


def from_gaf(rec: GafRecord, species: str) -> ReadRecord:
    return ReadRecord(
        read_id=rec.read_id,
        nodes=np.array(rec.path_nodes(), dtype=np.int64),
        read_path_len=rec.path_len,
        read_start=rec.path_start,
        read_end=rec.path_end,
        species=species,
    )


def group_reads_by_species(records: list[ReadRecord]) -> dict[str, list[ReadRecord]]:
    """Group records by species. When read ids are duplicated, reads whose
    duplicates disagree on species are dropped and later duplicates are
    renamed ``_2, _3, ...`` (profile.rs:406-437)."""
    seen: set[str] = set()
    has_dups = False
    for r in records:
        if r.read_id in seen:
            has_dups = True
            break
        seen.add(r.read_id)

    grouped: dict[str, list[ReadRecord]] = {}
    if not has_dups:
        for r in records:
            grouped.setdefault(r.species, []).append(r)
        return grouped

    by_read: dict[str, list[ReadRecord]] = {}
    for r in records:
        by_read.setdefault(r.read_id, []).append(r)
    for read_id, group in by_read.items():
        species_set = {r.species for r in group}
        if len(species_set) != 1:
            continue
        species = group[0].species
        bucket = grouped.setdefault(species, [])
        for i, r in enumerate(group):
            if i > 0:
                r = ReadRecord(
                    read_id=f"{r.read_id}_{i + 1}",
                    nodes=r.nodes,
                    read_path_len=r.read_path_len,
                    read_start=r.read_start,
                    read_end=r.read_end,
                    species=species,
                )
            bucket.append(r)
    return grouped
