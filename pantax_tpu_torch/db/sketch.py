"""FracMinHash genome sketches and k-mer containment ANI.

Replaces both external ANI engines of the reference:
  - fastANI (all-vs-all genome ANI for dedup clustering,
    PanTax's scripts/genomes_cluster.py:150-166), and
  - the vendored sylph fork (read-sample containment screening for --fast,
    PanTax's src/construct.rs:22-63).

A sketch is the sorted set of mixed canonical k-mer hashes h with
h % 2^density_bits == 0 (same sampling family as the alignment seeds).
Containment C = |A ∩ B| / |A| estimates identity via ANI = C^(1/k)
(the Mash/sylph containment-ANI formula).

The port's copy of pantax_tpu/db/sketch.py.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..align.encode import encode_seq, kmer_hashes
from ..io.fastx import iter_fastx

DEFAULT_K = 31
DEFAULT_DENSITY_BITS = 7  # 1/128 of k-mers


@dataclass
class Sketch:
    hashes: np.ndarray  # sorted unique uint32
    k: int
    total_kmers: int

    def save(self, path) -> None:
        np.savez_compressed(path, hashes=self.hashes,
                            meta=np.array([self.k, self.total_kmers], np.int64))

    @classmethod
    def load(cls, path) -> "Sketch":
        with np.load(path) as z:
            return cls(z["hashes"], int(z["meta"][0]), int(z["meta"][1]))


def _sampled_hashes(codes: np.ndarray, k: int, density_bits: int) -> np.ndarray:
    try:
        from ..utils.native import kmer_hash_sample_native

        res = kmer_hash_sample_native(codes, k, density_bits)
        if res is not None:
            return res[0]
    except Exception:  # pragma: no cover - fallback path
        pass
    h, valid = kmer_hashes(codes, k)
    mask = np.uint32((1 << density_bits) - 1)
    return h[valid & ((h & mask) == 0)]


def sketch_seqs(
    seqs: list[bytes], k: int = DEFAULT_K, density_bits: int = DEFAULT_DENSITY_BITS
) -> Sketch:
    parts = []
    total = 0
    for seq in seqs:
        codes = encode_seq(seq)
        total += max(len(codes) - k + 1, 0)
        parts.append(_sampled_hashes(codes, k, density_bits))
    hashes = (
        np.unique(np.concatenate(parts)) if parts else np.zeros(0, np.uint32)
    )
    return Sketch(hashes=hashes, k=k, total_kmers=total)


def sketch_file(path, k: int = DEFAULT_K, density_bits: int = DEFAULT_DENSITY_BITS) -> Sketch:
    return sketch_seqs([seq for _, seq in iter_fastx(path)], k, density_bits)


def containment(query: Sketch, reference: Sketch) -> float:
    """|Q ∩ R| / |Q|."""
    if len(query.hashes) == 0:
        return 0.0
    inter = np.intersect1d(query.hashes, reference.hashes, assume_unique=True)
    return len(inter) / len(query.hashes)


def containment_ani(query: Sketch, reference: Sketch) -> float:
    """ANI%: 100 * C^(1/k); 0 when no overlap."""
    c = containment(query, reference)
    if c <= 0:
        return 0.0
    return 100.0 * c ** (1.0 / query.k)


def pairwise_ani(sketches: list[Sketch]) -> np.ndarray:
    """Symmetric ANI matrix using max over both containment directions
    (fastANI reports direction-dependent ANI; the reference takes the
    group-max per unordered pair, genomes_cluster.py:224-229)."""
    n = len(sketches)
    out = np.zeros((n, n))
    for i in range(n):
        out[i, i] = 100.0
        for j in range(i + 1, n):
            a = containment_ani(sketches[i], sketches[j])
            b = containment_ani(sketches[j], sketches[i])
            out[i, j] = out[j, i] = max(a, b)
    return out


def sketch_seqs_with_counts(
    seqs: list[bytes], k: int = DEFAULT_K, density_bits: int = DEFAULT_DENSITY_BITS
) -> tuple[np.ndarray, np.ndarray]:
    """(sorted unique hashes, multiplicities) over sampled k-mers."""
    parts = [_sampled_hashes(encode_seq(seq), k, density_bits) for seq in seqs]
    if not parts:
        return np.zeros(0, np.uint32), np.zeros(0, np.int64)
    allh = np.concatenate(parts)
    return np.unique(allh, return_counts=True)


def _poisson_lambda(mean_count: float) -> float:
    """Solve m = lambda / (1 - e^-lambda) for lambda (zero-truncated Poisson
    mean inversion, bisection)."""
    if mean_count <= 1.0:
        return max(mean_count - 1e-9, 1e-9)
    lo, hi = 1e-9, max(2.0 * mean_count, 4.0)
    for _ in range(60):
        mid = (lo + hi) / 2
        m = mid / (1 - np.exp(-mid))
        if m < mean_count:
            lo = mid
        else:
            hi = mid
    return (lo + hi) / 2


def coverage_adjusted_ani(
    genome: Sketch, read_hashes: np.ndarray, read_counts: np.ndarray
) -> float:
    """Containment ANI of a genome sketch against a read-sample sketch,
    corrected for incomplete read coverage (the sylph idea: estimate the
    per-k-mer depth lambda from duplicate multiplicities and divide the raw
    containment by the expected covered fraction 1 - e^-lambda)."""
    if len(genome.hashes) == 0 or len(read_hashes) == 0:
        return 0.0
    pos = np.searchsorted(read_hashes, genome.hashes)
    pos = np.clip(pos, 0, len(read_hashes) - 1)
    hit = read_hashes[pos] == genome.hashes
    c_raw = hit.mean()
    if c_raw <= 0:
        return 0.0
    mean_count = float(read_counts[pos[hit]].mean())
    lam = _poisson_lambda(mean_count)
    covered_frac = 1.0 - np.exp(-lam)
    c = min(c_raw / max(covered_frac, 1e-9), 1.0)
    return 100.0 * c ** (1.0 / genome.k)


def sketch_genomes(
    infos,
    base_dir: str,
    cache_dir=None,
    k: int = DEFAULT_K,
    density_bits: int = DEFAULT_DENSITY_BITS,
) -> dict[str, Sketch]:
    """Sketch every genome in a metadata list, with per-genome .npz caching
    (the pre-built sketch DB role of --syldb, cli.rs:70-72)."""
    import os

    out: dict[str, Sketch] = {}
    if cache_dir is not None:
        os.makedirs(cache_dir, exist_ok=True)
    for gi in infos:
        cache = (
            os.path.join(cache_dir, f"{gi.genome_id}.sketch.npz")
            if cache_dir else None
        )
        if cache and os.path.exists(cache):
            out[gi.genome_id] = Sketch.load(cache)
            continue
        sk = sketch_file(gi.resolved_path(base_dir), k, density_bits)
        if cache:
            sk.save(cache)
        out[gi.genome_id] = sk
    return out


def fast_query_filter(
    read_files: list,
    genome_sketches: dict[str, Sketch],
    min_ani: float = 99.0,
    max_reads: int = 200_000,
    k: int = DEFAULT_K,
    density_bits: int = DEFAULT_DENSITY_BITS,
) -> list[str]:
    """--fast mode: keep genomes whose sketch is contained in the read sample
    at >= min_ani (construct.rs:22-63 semantics, sylph containment query)."""
    import itertools

    seqs = []
    for rf in read_files:
        seqs.extend(
            seq for _, seq in itertools.islice(iter_fastx(rf), max_reads)
        )
    read_hashes, read_counts = sketch_seqs_with_counts(seqs, k, density_bits)
    kept = []
    for name, gs in genome_sketches.items():
        if coverage_adjusted_ani(gs, read_hashes, read_counts) >= min_ani:
            kept.append(name)
    return kept
