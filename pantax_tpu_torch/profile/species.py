"""Species-level profiling without pandas: counterpart of
pantax_tpu/profile/species.py (species_profiling, species_profiling_codes,
read_species_mean_len, SpeciesProfile.load) whose species_abundance.txt is byte-identical to the reference's pandas
writer (floats as numpy/pandas print them, NaN as an empty field, stable
descending sort)."""
from __future__ import annotations

import csv
from dataclasses import dataclass

import numpy as np

COLUMNS = ("species_taxid", "predicted_abundance", "predicted_coverage")


def float_text(values) -> list[str]:
    """Floats as pandas' to_csv prints a float64 column: numpy's shortest
    repr, NaN as ''."""
    arr = np.asarray(values, dtype=np.float64)
    text = arr.astype(str)
    text[np.isnan(arr)] = ""
    return text.tolist()


def stable_desc_order(values: np.ndarray) -> np.ndarray:
    """pandas sort_values(ascending=False, kind='stable') order: descending,
    ties in their original order, NaN last."""
    values = np.asarray(values, dtype=np.float64)
    idx = np.arange(len(values))
    nan = np.isnan(values)
    vals, vidx = values[~nan][::-1], idx[~nan][::-1]
    order = vidx[np.argsort(vals, kind="stable")][::-1]
    return np.concatenate([order, idx[nan]]).astype(np.int64)


def write_tsv(path, header, columns) -> None:
    """Header + rows of already-formatted fields, quoted as pandas (the csv
    module's minimal quoting) does."""
    with open(path, "w", newline="") as f:
        w = csv.writer(f, delimiter="\t", lineterminator="\n")
        w.writerow(header)
        w.writerows(zip(*columns))


@dataclass
class SpeciesProfile:
    """species_abundance.txt rows, sorted by abundance (descending)."""

    species_taxid: list
    predicted_abundance: np.ndarray  # float64
    predicted_coverage: np.ndarray   # float64

    def coverage_of(self, species: str) -> float:
        for name, cov in zip(self.species_taxid, self.predicted_coverage):
            if name == species:
                return float(cov)
        return 0.0

    def save(self, path) -> None:
        write_tsv(path, COLUMNS, (
            [str(s) for s in self.species_taxid],
            float_text(self.predicted_abundance),
            float_text(self.predicted_coverage),
        ))

    @classmethod
    def load(cls, path) -> "SpeciesProfile":
        """Read back a saved species_abundance.txt (the resume branch of
        profile_from_gaf); empty fields are NaN."""
        with open(path, newline="") as f:
            rows = list(csv.reader(f, delimiter="\t"))[1:]

        def num(col):
            return np.array([float(r[col]) if r[col] else np.nan
                             for r in rows], dtype=np.float64)

        return cls([r[0] for r in rows], num(1), num(2))


def species_profiling(species, read_len, mapq, species_mean_len: dict,
                      filtered: bool = True) -> SpeciesProfile:
    """species_profiling_codes over species labels, one per classified
    read; groups are in sorted label order (np.unique), as pandas' groupby
    gives the reference."""
    names, codes = np.unique(np.asarray(species, dtype=object),
                             return_inverse=True)
    return species_profiling_codes(codes.reshape(-1), names, read_len, mapq,
                                   species_mean_len, filtered)


def species_profiling_codes(codes, code_names, read_len, mapq,
                            species_mean_len: dict, filtered: bool = True
                            ) -> SpeciesProfile:
    """Per classified read: integer species code, read length and mapq.
    Groups keep first-occurrence order; the credibility filter keeps species
    with a mapq-60 read and more than a tenth of reads at mapq 3..60;
    coverage = bases / species mean genome length."""
    codes = np.asarray(codes, dtype=np.int64)
    C = len(code_names)
    n = len(codes)
    first = np.full(C, n, dtype=np.int64)
    if n:
        first[codes[::-1]] = np.arange(n - 1, -1, -1)
    kept_codes = np.flatnonzero(first < n)
    kept = kept_codes[np.argsort(first[kept_codes], kind="stable")]
    remap = np.full(max(C, 1), -1, dtype=np.int64)
    remap[kept] = np.arange(len(kept))
    g = remap[codes] if n else codes
    names = np.asarray(code_names, dtype=object)[kept]

    read_len = np.asarray(read_len, dtype=np.int64)
    mapq = np.asarray(mapq, dtype=np.int64)
    G = len(names)
    read_count = np.bincount(g, minlength=G)
    if len(np.unique(read_len[:1000])) == 1 and len(read_len):
        base_count = read_count * int(read_len[0])
    else:
        base_count = np.bincount(g, weights=read_len, minlength=G).astype(np.int64)
    if filtered:
        in_band = (mapq >= 3) & (mapq <= 60)
        less_multi = np.bincount(g[in_band], minlength=G)
        uniq_count = np.bincount(g[mapq == 60], minlength=G)
        keep = (uniq_count > 0) & (less_multi > read_count / 10.0)
        names, base_count = names[keep], base_count[keep]
    lens = np.array([species_mean_len.get(s, np.nan) for s in names],
                    dtype=np.float64)
    absolute = base_count / lens if len(names) else np.zeros(0)
    total = absolute.sum()
    abundance = absolute / total if total else np.zeros(len(names))
    order = stable_desc_order(abundance)
    return SpeciesProfile([names[i] for i in order], abundance[order],
                          absolute[order])


def read_species_mean_len(path) -> dict[str, float]:
    """species_genomes_stats.txt: (species_taxid, mean_len), no header."""
    out: dict[str, float] = {}
    with open(path) as f:
        for line in f:
            fields = line.split()
            if len(fields) >= 2:
                out[fields[0]] = float(fields[1])
    return out
