"""End-to-end per-species profiling from GAF records, PyTorch port of
pantax_tpu/pipeline.py: GAF -> classification -> species profile -> strain
profile -> reports.

Parity: PanTax's src/profile.rs:3325-3436 (profile()) and rcls.rs:452-536
(rcls_profile), with file-existence checkpoint semantics (the species and
strain outputs are skipped when they already exist unless force=True,
profile.rs:136-156).
"""
from __future__ import annotations

import logging
import os
import time
from pathlib import Path

import numpy as np

from . import _host
from .io.gaf import GafRecord
from .profile.engine import strain_profiling
from .profile.rcls import UNCLASSIFIED, classify_reads
from .profile.records import ReadRecord, group_reads_by_species
from .profile.report import abundance_est
from .profile.species import (
    SpeciesProfile, read_species_mean_len, species_profiling,
)

log = logging.getLogger(__name__)


def classify_gaf(gaf_records: list[GafRecord], db
                 ) -> tuple[list[str], list[np.ndarray]]:
    """Species label per GAF record ('U' = unclassified) + parsed node paths."""
    node_paths = [np.array(r.path_nodes(), dtype=np.int64) for r in gaf_records]
    species = classify_reads(node_paths, _host.load_species_range(db.range_file))
    return species, node_paths


def write_reads_classification(path, gaf_records: list[GafRecord],
                               species: list[str]) -> None:
    """reads_classification.tsv: read_id, mapq, species, read_len (no header;
    rcls.rs:409-420 / profile.rs:3337-3351)."""
    with open(path, "w") as f:
        for rec, sp in zip(gaf_records, species):
            f.write(f"{rec.read_id}\t{rec.mapq}\t{sp}\t{rec.read_len}\n")


def profile_from_gaf(gaf_records: list[GafRecord], db, cfg,
                     out_dir: str | os.PathLike, force: bool = False, *,
                     device, mesh=None, stage_out: dict | None = None
                     ) -> None:
    """Classification, species and strain profiles from GAF records; the
    strain stage's device coverage and PAO run on ``device`` (the coverage
    rows sharded over ``mesh`` when one is given).
    ``stage_out`` receives host-clock seconds: classify_s (classification
    and its table), species_s, group_s (per-read records grouped by
    species), coverage_s (coverage, filters and solve preparation of every
    species), pao_s (the batched two-stage solve and the species
    constraint) and report_s."""
    stage = stage_out if stage_out is not None else {}
    t0 = time.perf_counter()
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    species_abund_file = out / "species_abundance.txt"
    strain_abund_file = out / "strain_abundance.txt"

    log.info("- Read classification...")
    species, node_paths = classify_gaf(gaf_records, db)
    write_reads_classification(out / "reads_classification.tsv", gaf_records,
                               species)
    keep = [i for i, s in enumerate(species) if s != UNCLASSIFIED]
    kept_records = [gaf_records[i] for i in keep]
    kept_species = [species[i] for i in keep]
    kept_paths = [node_paths[i] for i in keep]
    t1 = time.perf_counter()
    stage["classify_s"] = t1 - t0

    if cfg.species and (force or not species_abund_file.exists()):
        log.info("- Species level profiling...")
        profile = species_profiling(
            np.array(kept_species, dtype=object),
            np.array([r.read_len for r in kept_records], dtype=np.int64),
            np.array([r.mapq for r in kept_records], dtype=np.int64),
            read_species_mean_len(db.stats_file),
            filtered=cfg.filtered,
        )
        profile.save(species_abund_file)
    else:
        profile = SpeciesProfile.load(species_abund_file)
    t2 = time.perf_counter()
    stage["species_s"] = t2 - t1

    if cfg.strain and (force or not strain_abund_file.exists()):
        log.info("- Strain level profiling...")
        reads = [
            ReadRecord(read_id=r.read_id, nodes=p, read_path_len=r.path_len,
                       read_start=r.path_start, read_end=r.path_end,
                       species=s)
            for r, p, s in zip(kept_records, kept_paths, kept_species)
        ]
        by_species = group_reads_by_species(reads)
        stage["group_s"] = time.perf_counter() - t2
        metrics = strain_profiling(cfg, _host.load_species_range(db.range_file),
                                   profile, by_species, db.load_graph,
                                   device=device, mesh=mesh,
                                   stage_out=stage)
        t3 = time.perf_counter()
        abundance_est(cfg, metrics,
                      _host.read_genomes_info(db.genomes_info_file), out)
        stage["report_s"] = time.perf_counter() - t3
    log.info("- Profiling done.")
