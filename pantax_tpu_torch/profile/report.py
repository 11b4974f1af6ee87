"""Species-coverage constraint and the strain abundance report without
pandas: counterpart of pantax_tpu/profile/report.py whose
ori_strain_abundance.txt and strain_abundance.txt are byte-identical to the
reference's pandas writer (left join on hap_id, NaN / None as empty fields,
stable descending sort)."""
from __future__ import annotations

import os

import numpy as np

from .species import SpeciesProfile, float_text, stable_desc_order, write_tsv

ORI_COLUMNS = [
    "species_taxid", "strain_taxid", "genome_ID",
    "predicted_coverage", "predicted_abundance", "path_base_cov",
    "unique_trio_fraction", "uniq_trio_cov_mean", "first_sol",
    "strain_cov_diff", "total_cov_diff",
]
_ROUNDED = [
    "predicted_coverage", "path_base_cov", "unique_trio_fraction",
    "uniq_trio_cov_mean", "first_sol", "strain_cov_diff", "total_cov_diff",
]
_TEXT_COLUMNS = ("species_taxid", "strain_taxid", "genome_ID")


def abundance_constraint(species_profile: SpeciesProfile, metrics) -> None:
    """Clamp strain coverages by the species coverage (the reference's
    abundance_constraint)."""
    strain_abs = []
    for m in metrics:
        if m.is_rescue and m.first_sol is not None and m.second_sol is not None:
            m.second_sol = min(m.first_sol, m.second_sol)
        strain_abs.append(m.second_sol if m.second_sol is not None else 0.0)
    species_abs = species_profile.coverage_of(metrics[0].otu)
    total = float(np.sum(strain_abs))
    denom = (total + species_abs) / 2.0
    total_cov_diff = abs(total - species_abs) / denom if denom else 0.0
    for m in metrics:
        m.total_cov_diff = total_cov_diff
    if strain_abs and max(strain_abs) > 1.05 * species_abs and total:
        factor = species_abs / total
        for m in metrics:
            if not m.is_rescue and m.second_sol is not None:
                m.second_sol = m.second_sol * factor


def _hap_id_of(file_stem: str) -> str:
    parts = file_stem.split("_")
    return "_".join(parts[:2]) if len(parts) >= 2 else file_stem


def _num(values) -> np.ndarray:
    return np.array([np.nan if v is None else v for v in values],
                    dtype=np.float64)


def _write(path, cols: dict, rows: np.ndarray) -> None:
    write_tsv(path, ORI_COLUMNS, [
        ["" if cols[c][i] is None else str(cols[c][i]) for i in rows]
        if c in _TEXT_COLUMNS else float_text(cols[c][rows])
        for c in ORI_COLUMNS
    ])


def abundance_est(cfg, metrics, genomes_info, out_dir) -> None:
    """Join metrics with genome metadata, filter, normalize, and write
    ``ori_strain_abundance.txt`` + ``strain_abundance.txt``."""
    meta = [(g.genome_id, g.strain_taxid, _hap_id_of(g.file_stem))
            for g in genomes_info]
    # left join on hap_id: left order kept, one row per matching meta row
    left, gid, sid = [], [], []
    for i, m in enumerate(metrics):
        hits = [(g, s) for g, s, h in meta if h == m.hap_id]
        for g, s in hits or [(None, None)]:
            left.append(i)
            gid.append(g)
            sid.append(s)
    left = np.asarray(left, dtype=np.int64)
    per_metric = {
        "unique_trio_fraction": _num([m.unique_trio_nodes_fraction for m in metrics]),
        "uniq_trio_cov_mean": _num([m.frequencies_mean for m in metrics]),
        "path_base_cov": _num([m.path_cov_ratio for m in metrics]),
        "first_sol": _num([m.first_sol for m in metrics]),
        "strain_cov_diff": _num([m.divergence for m in metrics]),
        "predicted_coverage": _num([m.second_sol for m in metrics]),
        "total_cov_diff": _num([m.total_cov_diff for m in metrics]),
    }
    cols = {k: v[left] for k, v in per_metric.items()}
    cols["species_taxid"] = [metrics[i].otu for i in left]
    cols["genome_ID"] = gid
    cols["strain_taxid"] = sid
    cov = cols["predicted_coverage"]
    cov_sum = np.where(np.isnan(cov), 0.0, cov).sum()
    cols["predicted_abundance"] = (cov / cov_sum if cov_sum
                                   else np.full(len(cov), np.nan))
    out = os.fspath(out_dir)
    _write(os.path.join(out, "ori_strain_abundance.txt"), cols,
           np.arange(len(left)))

    species = cols["species_taxid"]
    group_size = {}
    for s in species:
        group_size[s] = group_size.get(s, 0) + 1
    gsize = np.array([group_size[s] for s in species], dtype=np.int64)
    with np.errstate(invalid="ignore"):
        keep = (gsize > 1) | (cols["total_cov_diff"] <= cfg.single_cov_diff)
        keep &= (cov >= cfg.min_cov) & (cov != 0.0)
    rows = np.flatnonzero(keep)
    kept_cov = cov[rows]
    cov_sum = np.where(np.isnan(kept_cov), 0.0, kept_cov).sum()
    final = dict(cols)
    abund = np.full(len(cov), np.nan)
    if cov_sum:
        abund[rows] = kept_cov / cov_sum
    final["predicted_abundance"] = abund
    rows = rows[stable_desc_order(abund[rows])]
    if not cfg.full:
        for c in _ROUNDED:
            final[c] = np.round(final[c], 2)
    _write(os.path.join(out, "strain_abundance.txt"), final, rows)
