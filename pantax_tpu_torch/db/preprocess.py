"""Genome-database curation: stats, plasmid removal, dedup clustering,
representative selection, strain-taxid disambiguation.

Replaces the reference's preprocessing scripts (L1, SURVEY.md §2.3):
  scripts/staticsData.py        -> genome_stats
  scripts/genomes_process.py    -> filter_plasmids
  scripts/genomes_cluster.py    -> cluster_species_genomes (graph mode)
  scripts/hcls_select_rep.py    -> hierarchical_cluster (R hclust -> scipy)
  scripts/get_genomes_info.py   -> assign_strain_taxids
fastANI / the sylph fork are replaced by db/sketch.py containment ANI.

The port's copy of pantax_tpu/db/preprocess.py.
"""
from __future__ import annotations

import logging
from dataclasses import dataclass

import numpy as np

from ..io.fastx import iter_fastx
from ..io.metadata import GenomeInfo
from .sketch import Sketch, pairwise_ani, sketch_file

log = logging.getLogger(__name__)


# ---------------------------------------------------------------------------
# stats (staticsData.py parity)
# ---------------------------------------------------------------------------
@dataclass
class GenomeStats:
    path: str
    total_len: int
    num_scaffolds: int
    n50: int
    n90: int
    gc: float


def _nx(lens_sorted_desc: np.ndarray, total: int, frac: float) -> int:
    cum = np.cumsum(lens_sorted_desc)
    idx = int(np.searchsorted(cum, frac * total))
    return int(lens_sorted_desc[min(idx, len(lens_sorted_desc) - 1)])


def genome_stats(path) -> GenomeStats:
    lens = []
    gc = at = 0
    for _, seq in iter_fastx(path):
        lens.append(len(seq))
        arr = np.frombuffer(seq, dtype=np.uint8)
        gc += int(((arr == ord("G")) | (arr == ord("C"))).sum())
        at += int(((arr == ord("A")) | (arr == ord("T"))).sum())
    lens = np.sort(np.array(lens, dtype=np.int64))[::-1]
    total = int(lens.sum())
    return GenomeStats(
        path=str(path),
        total_len=total,
        num_scaffolds=len(lens),
        n50=_nx(lens, total, 0.5) if total else 0,
        n90=_nx(lens, total, 0.9) if total else 0,
        gc=gc / max(gc + at, 1),
    )


# ---------------------------------------------------------------------------
# plasmid removal (genomes_process.py:193-241)
# ---------------------------------------------------------------------------
def filter_plasmids(
    records: list[tuple[str, bytes]],
    min_scaffold_mb: float = 1.0,
    drop_plasmid_names: bool = True,
) -> list[tuple[str, bytes]]:
    """Keep scaffolds >= min_scaffold_mb megabases; optionally also drop
    records whose name contains 'plasmid'.  (The reference intends both
    filters but the name filter is shadowed by the length filter,
    genomes_process.py:216-217 — here both are applied.)"""
    min_len = int(min_scaffold_mb * 1_000_000)
    out = []
    for name, seq in records:
        if drop_plasmid_names and "plasmid" in name.lower():
            continue
        if len(seq) >= min_len:
            out.append((name, seq))
    return out


# ---------------------------------------------------------------------------
# strain-taxid disambiguation (get_genomes_info.py:42-52)
# ---------------------------------------------------------------------------
def assign_strain_taxids(infos: list[GenomeInfo]) -> list[GenomeInfo]:
    """Genomes sharing a strain_taxid get suffixes taxid.1, taxid.2, ..."""
    counts: dict[str, int] = {}
    for gi in infos:
        counts[gi.strain_taxid] = counts.get(gi.strain_taxid, 0) + 1
    seen: dict[str, int] = {}
    out = []
    for gi in infos:
        taxid = gi.strain_taxid
        if counts[taxid] > 1:
            seen[taxid] = seen.get(taxid, 0) + 1
            taxid = f"{taxid}.{seen[taxid]}"
        out.append(
            GenomeInfo(gi.genome_id, taxid, gi.species_taxid,
                       gi.organism_name, gi.path)
        )
    return out


# ---------------------------------------------------------------------------
# dedup clustering (genomes_cluster.py)
# ---------------------------------------------------------------------------
def _greedy_max_cliques(n: int, adj: np.ndarray) -> list[list[int]]:
    """Greedy maximal cliques seeded from every node, sorted by size desc."""
    cliques = []
    order = np.argsort(-adj.sum(axis=1))
    for seed in order:
        clique = [int(seed)]
        for v in order:
            v = int(v)
            if v != seed and all(adj[v, u] for u in clique):
                clique.append(v)
        cliques.append(sorted(clique))
    uniq = {tuple(c) for c in cliques}
    return sorted((list(c) for c in uniq), key=len, reverse=True)


def cluster_species_genomes(
    paths: list[str],
    stats: dict[str, GenomeStats],
    ref_genome: str | None = None,
    top_m: int = 100,
    max_n: int = 10,
    dup_ani: float = 99.9,
    strain_ani: float = 95.0,
    sketches: dict[str, Sketch] | None = None,
) -> tuple[list[str], dict[str, list[str]]]:
    """Graph-mode dedup for one species: (selected genomes, rep -> members).

    1. top_m genomes by scaffold N50 (reference genome always kept);
    2. pairwise containment ANI;
    3. connected components at ANI >= dup_ani; component representative =
       reference genome if present else best N50;
    4. largest greedy clique at ANI >= strain_ani among representatives
       (preferring cliques containing the reference genome);
    5. cap at max_n genomes.
    """
    ranked = sorted(paths, key=lambda p: -stats[p].n50)[:top_m]
    if ref_genome and ref_genome in paths and ref_genome not in ranked:
        ranked.append(ref_genome)
    if len(ranked) == 1:
        return ranked, {ranked[0]: []}

    if sketches is None:
        sketches = {p: sketch_file(p) for p in ranked}
    ani = pairwise_ani([sketches[p] for p in ranked])

    # connected components over >= dup_ani edges
    n = len(ranked)
    parent = list(range(n))

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for i in range(n):
        for j in range(i + 1, n):
            if ani[i, j] >= dup_ani:
                parent[find(i)] = find(j)
    comps: dict[int, list[int]] = {}
    for i in range(n):
        comps.setdefault(find(i), []).append(i)

    reps: list[int] = []
    rep_to_cluster: dict[str, list[str]] = {}
    for members in sorted(comps.values(), key=len, reverse=True):
        names = [ranked[i] for i in members]
        if ref_genome in names:
            rep = ref_genome
        else:
            rep = max(names, key=lambda p: stats[p].n50)
        reps.append(ranked.index(rep))
        rep_to_cluster[rep] = [p for p in names if p != rep]

    # largest clique among representatives at >= strain_ani
    adj = np.zeros((len(reps), len(reps)), dtype=bool)
    for a in range(len(reps)):
        for b in range(a + 1, len(reps)):
            if ani[reps[a], reps[b]] >= strain_ani:
                adj[a, b] = adj[b, a] = True
    cliques = _greedy_max_cliques(len(reps), adj)
    chosen = cliques[0]
    if ref_genome is not None:
        for c in cliques:
            if any(ranked[reps[i]] == ref_genome for i in c):
                chosen = c
                break
    selected = [ranked[reps[i]] for i in chosen]
    if max_n > 0:
        selected = selected[:max_n]
    return selected, {r: m for r, m in rep_to_cluster.items() if r in selected}


# ---------------------------------------------------------------------------
# hierarchical clustering (hcls_select_rep.py: R hclust -> scipy linkage)
# ---------------------------------------------------------------------------
def hierarchical_cluster(
    paths: list[str],
    cutoff: float = 0.1,
    sketches: dict[str, Sketch] | None = None,
) -> tuple[list[str], dict[str, list[str]]]:
    """Average-linkage clustering on the (100 - ANI) distance matrix, cut at
    ``cutoff``; each cluster's representative minimizes the mean intra-cluster
    distance (StrainScan-style select_rep, hcls_select_rep.py:126-232)."""
    from scipy.cluster.hierarchy import fcluster, linkage
    from scipy.spatial.distance import squareform

    if len(paths) == 1:
        return list(paths), {paths[0]: []}
    if sketches is None:
        sketches = {p: sketch_file(p) for p in paths}
    ani = pairwise_ani([sketches[p] for p in paths])
    dist = 100.0 - ani
    np.fill_diagonal(dist, 0.0)
    Z = linkage(squareform(dist, checks=False), method="average")
    labels = fcluster(Z, t=cutoff, criterion="distance")
    reps: list[str] = []
    rep_to_cluster: dict[str, list[str]] = {}
    for lbl in np.unique(labels):
        idxs = np.flatnonzero(labels == lbl)
        sub = dist[np.ix_(idxs, idxs)]
        rep_i = idxs[int(np.argmin(sub.mean(axis=1)))]
        rep = paths[rep_i]
        reps.append(rep)
        rep_to_cluster[rep] = [paths[i] for i in idxs if i != rep_i]
    return reps, rep_to_cluster


# ---------------------------------------------------------------------------
# metadata genome resolution (genomes_process.py:106-182,266-325: resolve
# local genome files + taxonomy from an NCBI assembly_summary or a GTDB
# metadata table — the pantax-rg "-r" / "--db gtdb" modes)
# ---------------------------------------------------------------------------
def _find_genome_file(genomes_dir, name: str) -> str | None:
    """<genomes_dir>/<name> or its .gz (genomes_process.py:130-136)."""
    import os

    p = os.path.join(os.fspath(genomes_dir), name)
    if os.path.exists(p):
        return p
    if os.path.exists(p + ".gz"):
        return p + ".gz"
    return None


def _norm_level(genome_assembly_lvl: str) -> str:
    if "complete" in genome_assembly_lvl.lower():
        return "Complete Genome"
    return genome_assembly_lvl


def resolve_genomes_ncbi(
    summary_file, genomes_dir,
    assembly_level: str = "complete",
    species_filter: list[str] | None = None,
):
    """Resolve genomes + taxonomy from an NCBI ``assembly_summary`` table.

    Keeps rows whose assembly_level (col 12) matches (or 'all'), whose
    genome file ``basename(ftp_path)_genomic.fna[.gz]`` exists under
    ``genomes_dir``, and (optionally) whose species_taxid (col 7) is in
    ``species_filter``.  Emits GenomeInfo rows with strain_taxid = taxid
    (col 6), species_taxid (col 7), organism_name (col 8)
    (genomes_process.py:151-180,305-318)."""
    import os

    from ..io.metadata import GenomeInfo

    lvl = _norm_level(assembly_level)
    wanted = set(species_filter) if species_filter else None
    infos: list[GenomeInfo] = []
    with open(summary_file) as f:
        for line in f:
            if line.startswith("#"):
                continue
            t = line.rstrip("\n").split("\t")
            if len(t) < 20:
                continue
            if lvl != "all" and t[11] != lvl:
                continue
            if wanted is not None and t[6] not in wanted:
                continue
            stem = os.path.basename(t[19])
            path = _find_genome_file(genomes_dir, stem + "_genomic.fna")
            if path is None:
                log.warning("%s_genomic.fna(.gz) not in %s", stem, genomes_dir)
                continue
            infos.append(GenomeInfo(
                genome_id=stem, strain_taxid=t[5], species_taxid=t[6],
                organism_name=t[7], path=path,
            ))
    return infos


def resolve_genomes_gtdb(
    metadata_file, genomes_dir,
    assembly_level: str = "complete",
    species_filter: list[str] | None = None,
):
    """Resolve genomes + taxonomy from a GTDB metadata table.

    Keeps rows whose ncbi_assembly_level (col 49) matches (or 'all') and
    whose genome file ``<accession>_<ncbi_assembly_name>_genomic.fna[.gz]``
    exists under ``genomes_dir``; ``species_filter`` matches the GTDB
    species name (s__... with spaces or underscores).  strain_taxid is a
    synthetic counter from 5000001 (GTDB has no NCBI strain taxids);
    species_taxid is the underscored GTDB species name
    (genomes_process.py:116-149,283-304 + the pantax-rg awk underscore
    normalization)."""
    from ..io.metadata import GenomeInfo

    lvl = _norm_level(assembly_level)
    wanted = (
        {s.replace(" ", "_") for s in species_filter}
        if species_filter else None
    )
    infos: list[GenomeInfo] = []
    count = 5_000_000
    with open(metadata_file) as f:
        next(f)
        for line in f:
            t = line.rstrip("\n").split("\t")
            if len(t) < 66:
                continue
            if lvl != "all" and t[48] != lvl:
                continue
            tax = t[19].strip().split(";")[-1]
            if not tax.startswith("s__"):
                continue
            species = tax[3:].replace(" ", "_")
            if wanted is not None and species not in wanted:
                continue
            accession = t[0].strip().split("_", 1)[1]
            name = f"{accession}_{t[49]}_genomic.fna"
            path = _find_genome_file(genomes_dir, name)
            if path is None:
                continue
            count += 1
            infos.append(GenomeInfo(
                genome_id=accession, strain_taxid=str(count),
                species_taxid=species, organism_name=t[65], path=path,
            ))
    return infos
