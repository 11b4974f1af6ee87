"""Merge multiple databases into one (pantax-md equivalent).

Parity: PanTax's src/bin/pantax_md.rs:211-326 —
  - genomes_info.txt and species_genomes_stats.txt concatenated in DB order
    (first DB keeps the metadata header);
  - per-species graph files copied;
  - species_range.txt re-offset: each DB's ranges shift by the previous DB's
    final end node id (species are NOT deduplicated, matching the reference).
The alignment index is rebuilt lazily on first use of the merged DB.

The port's copy of pantax_tpu/db/merge.py.
"""
from __future__ import annotations

import logging
import shutil
from pathlib import Path

from ..graph.core import SpeciesRange, load_species_range, save_species_range
from .construct import DatabasePaths

log = logging.getLogger(__name__)


def merge_databases(db_dirs: list, out_dir) -> DatabasePaths:
    dbs = [DatabasePaths(Path(d)) for d in db_dirs]
    for db in dbs:
        if not db.is_complete():
            raise FileNotFoundError(f"{db.root} is not a complete database")
    out = DatabasePaths(Path(out_dir))
    out.root.mkdir(parents=True, exist_ok=True)
    out.graph_dir.mkdir(exist_ok=True)

    # ranges: per-DB offset accumulation
    merged: list[SpeciesRange] = []
    offset = 0
    for db in dbs:
        ranges = load_species_range(db.range_file)
        for r in ranges:
            merged.append(
                SpeciesRange(r.species, r.start + offset, r.end + offset, r.is_pan)
            )
        if ranges:
            offset = merged[-1].end
    species_seen: set[str] = set()
    for r in merged:
        if r.species in species_seen:
            log.warning("species %s appears in multiple databases", r.species)
        species_seen.add(r.species)
    save_species_range(out.range_file, merged)

    # metadata + stats concatenation (header kept once)
    with open(out.genomes_info_file, "w") as dst:
        for i, db in enumerate(dbs):
            with open(db.genomes_info_file) as src:
                header = src.readline()
                if i == 0:
                    dst.write(header)
                dst.write(src.read())
    with open(out.stats_file, "w") as dst:
        for db in dbs:
            dst.write(open(db.stats_file).read())

    # graph files
    for db in dbs:
        for f in db.graph_dir.iterdir():
            target = out.graph_dir / f.name
            if target.exists():
                log.warning("overwriting merged graph %s", f.name)
            shutil.copy(f, target)
    return out
