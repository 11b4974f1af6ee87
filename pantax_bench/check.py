"""The comparison that decides a run's ``correct``: what each timed
``pantax-gpu`` invocation wrote against the reference profile of its
sample.

Three numbers an invocation, each the worst over the run's invocations,
each held to the limit its workload file gives:

- ``cls_mismatch``: of the reads the reference places, the share whose
  row in reads_classification.tsv is missing or names another species or
  another read length, with every row of an unknown or repeated read id
  counted as one more;
- ``species_cov_gap``: the largest relative gap between a species'
  predicted_coverage in species_abundance.txt and the reference's (a
  species on one side only reads 1);
- ``strain_cov_gap``: the largest gap between a strain's
  predicted_coverage in the strain table and the reference's, over the
  reference coverage of its species (a strain the table leaves out reads
  as coverage 0).
"""
from __future__ import annotations

import csv
from pathlib import Path

import numpy as np

from .reference.profile import Profile, _lines

NUMBERS = ("cls_mismatch", "species_cov_gap", "strain_cov_gap")


def read_classification(path: Path) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(ids, species, read lengths) of reads_classification.tsv's rows:
    id, mapq, species, read_len, tab-separated, no header."""
    data = np.fromfile(path, np.uint8)
    if not len(data):
        return (np.zeros(0, "S1"),) * 2 + (np.zeros(0, np.int64),)
    starts, ends = _lines(data)
    tabs = np.flatnonzero(data == 9)
    if len(tabs) != 3 * len(starts):
        raise ValueError(f"{path}: not 4 tab-separated columns a row")
    t = tabs.reshape(-1, 3)
    if np.any(t[:, 0] <= starts) or np.any(t[:, 2] >= ends):
        raise ValueError(f"{path}: not 4 tab-separated columns a row")
    ids = _field(data, starts, t[:, 0])
    species = _field(data, t[:, 1] + 1, t[:, 2])
    lens = _field(data, t[:, 2] + 1, ends).astype(np.int64)
    return ids, species, lens


def _field(data, starts, ends) -> np.ndarray:
    width = max(int((ends - starts).max(initial=1)), 1)
    col = np.arange(width)
    raw = data[np.minimum(starts[:, None] + col, len(data) - 1)]
    raw[col[None, :] >= (ends - starts)[:, None]] = 0
    return np.ascontiguousarray(raw).view(f"S{width}").ravel()


def read_table(path: Path, key: str) -> dict[str, float]:
    """{row[key]: predicted_coverage} of a species or strain table."""
    with open(path, newline="") as f:
        return {r[key]: float(r["predicted_coverage"])
                for r in csv.DictReader(f, delimiter="\t")}


def cls_mismatch(ref: Profile, ids, species, lens) -> float:
    order = np.argsort(ref.ids)
    sorted_ids = ref.ids[order]
    pos = np.minimum(np.searchsorted(sorted_ids, ids), len(order) - 1)
    known = sorted_ids[pos] == ids
    _, first = np.unique(ids, return_index=True)
    ok = np.zeros(len(ids), bool)
    ok[first] = True
    ok &= known
    bad = len(ids) - int(ok.sum())          # unknown or repeated ids
    j = order[pos[ok]]
    placed = ref.species_of[j] != b""
    bad += int(((placed & (ref.species_of[j] != species[ok]))
                | (ref.lens_of[j] != lens[ok])).sum())
    bad += ref.n_placed - int(placed.sum())  # placed reads with no row
    return bad / max(ref.n_placed, 1)


def species_cov_gap(ref: Profile, prog: dict[str, float]) -> float:
    gap = 0.0
    for sp in set(ref.species_cov) | set(prog):
        if sp not in ref.species_cov or sp not in prog:
            gap = max(gap, 1.0)
            continue
        gap = max(gap, abs(prog[sp] - ref.species_cov[sp]) / ref.species_cov[sp])
    return gap


def strain_cov_gap(ref: Profile, prog: dict[str, float],
                   hap_species: dict[str, str]) -> float:
    gap = 0.0
    for hap in set(ref.strain_cov) | set(prog):
        sp_cov = ref.species_cov.get(hap_species.get(hap))
        if not sp_cov:
            gap = max(gap, 1.0)
            continue
        gap = max(gap, abs(prog.get(hap, 0.0) - ref.strain_cov.get(hap, 0.0))
                  / sp_cov)
    return gap


def compare_outputs(ref: Profile, out: dict[str, Path],
                    hap_species: dict[str, str]) -> dict[str, float]:
    """The three numbers of one invocation's files ``out`` ("cls",
    "species", "strain"); a file missing or malformed reads 1 on its
    number."""
    got = {}
    try:
        got["cls_mismatch"] = cls_mismatch(ref, *read_classification(out["cls"]))
    except (OSError, ValueError):
        got["cls_mismatch"] = 1.0
    try:
        got["species_cov_gap"] = species_cov_gap(
            ref, read_table(out["species"], "species_taxid"))
    except (OSError, ValueError, KeyError):
        got["species_cov_gap"] = 1.0
    try:
        got["strain_cov_gap"] = strain_cov_gap(
            ref, read_table(out["strain"], "genome_ID"), hap_species)
    except (OSError, ValueError, KeyError):
        got["strain_cov_gap"] = 1.0
    return got


def write_profile(prof: Profile, out: dict[str, Path],
                  hap_species: dict[str, str]) -> None:
    """Write a profile as the three files the command line writes (the
    columns the comparison reads): the control put in the program's
    place."""
    with open(out["cls"], "w") as f:
        for i, s, n in zip(prof.ids, prof.species_of, prof.lens_of):
            if s:
                f.write(f"{i.decode()}\t60\t{s.decode()}\t{int(n)}\n")
    with open(out["species"], "w") as f:
        f.write("species_taxid\tpredicted_abundance\tpredicted_coverage\n")
        total = sum(prof.species_cov.values()) or 1.0
        for sp, c in prof.species_cov.items():
            f.write(f"{sp}\t{c / total}\t{c}\n")
    with open(out["strain"], "w") as f:
        f.write("species_taxid\tgenome_ID\tpredicted_coverage\n")
        for hap, c in prof.strain_cov.items():
            f.write(f"{hap_species[hap]}\t{hap}\t{c}\n")
