"""Profiling configuration — the framework's equivalent of the reference's
``ProfilingConfig`` (PanTax's src/types.rs:57-91) with defaults
from PanTax's src/main.rs:102-171 and cli.rs.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path


@dataclass
class ProfilingConfig:
    db: Path | None = None
    wd: Path = Path("pantax_tpu_tmp")
    # -a: species kept for strain profiling need abundance > this
    min_species_abundance: float = 1e-4
    # --fr: min fraction of a path's unique trio nodes that must be covered
    # (0.3 short reads / 0.5 long reads, main.rs:107-114)
    unique_trio_nodes_fraction: float = 0.3
    # --fc: max divergence between first solve and trio mean (main.rs:115-117)
    unique_trio_nodes_mean_count_f: float = 0.46
    # --sr: rescue threshold on unique_trio_fraction * path_cov_ratio
    single_cov_ratio: float = 0.85
    # --sd: drop single-strain species with total_cov_diff above this
    single_cov_diff: float = 0.2
    minimization_min_cov: float = 0.0
    min_cov: float = 0.0
    min_depth: float = 0.0
    species: bool = True
    strain: bool = True
    # mapq credibility filter on species profiling (--no_filter inverts)
    filtered: bool = True
    # MILP node subsampling (--sample / --sample_test, cli.rs:227-232)
    sample_nodes: int = 500_000
    sample_test: bool = False
    designated_species: list[str] | None = None
    # --smode: 0 keeps only non-pan species ranges, 1 only pan, else all
    mode: int = 2
    full: bool = True
    # 'admm' (JAX/TPU) or 'highs' (scipy host oracle)
    solver: str = "admm"
    # coverage engine: 'host' (NumPy), 'device' (jitted TPU path), or 'auto'
    # (device above auto_device_reads reads per species)
    coverage: str = "auto"
    auto_device_reads: int = 500_000
    # fused profile tail: 'host' (download na/ta/bc, NumPy filters + host
    # polish — exact float64), 'device' (keep them on device,
    # ops/profile_tail.py), or 'auto' (device when the avoided download is
    # large; see ops.fused._tail_mode)
    tail: str = "auto"
    # shift mode scales the trio-fraction threshold by the trio coverage mean
    # (defaults on iff the DB range table is empty, main.rs:118-124 quirk)
    shift: bool = False
    # read type: 'short' or 'long' — sets unique_trio_nodes_fraction default
    read_type: str = "short"

    @classmethod
    def for_read_type(cls, read_type: str, **kw) -> "ProfilingConfig":
        fr = 0.3 if read_type == "short" else 0.5
        kw.setdefault("unique_trio_nodes_fraction", fr)
        return cls(read_type=read_type, **kw)


@dataclass
class AlignConfig:
    """Aligner parameters (giraffe/GraphAligner replacement).

    k/density_bits must match the AlignIndex the aligner runs against
    (seeds are sampled where mix(hash) % 2^density_bits == 0 on both sides).
    """

    # sampled seeds per read strand.  16 measured IDENTICAL to 24 in aligned
    # fraction, placement, species accuracy AND the full mapq distribution on
    # both the example reads and the 102-strain scale DB (1% error, CPU A/B
    # 2026-08: the diagonal vote saturates well before 16 seeds), while the
    # seed-lookup gathers, the select one-hot and the O(S^2 C^2) vote all
    # shrink with S.  hits_per_seed=2 was TRIED AND REJECTED: -0.17% aligned,
    # mapq60 0.762 -> 0.745 at 102 strains (multiplicity evidence lost).
    max_seeds: int = 16
    # banded-DP half band.  4 (8 sublane rows = ONE tile, half the DP work)
    # measured identical to 8 on 150bp short reads at 1% subs + 1% indels
    # (102-strain CPU A/B: aligned/acc/mapq unchanged); LONG-read chunks
    # keep 8 via for_read_type("long") — indel drift across a 512bp chunk
    # plus rescue-window slack needs the wider band (align/long_read.py).
    hits_per_seed: int = 4      # index hits taken per seed
    max_candidates: int = 2     # extension candidates after strand-union voting
    extension_band: int = 4
    match: int = 1
    mismatch: int = -1
    gap_extend: int = -2        # linear gap cost
    min_score_frac: float = 0.6   # min score / read_len to report
    # long-read chunk sizes live in align.long_read.LONG_READ_PRESETS
    # one distinguishing SNP (score gap 2) ~ mapq 20; >= 3 SNPs saturate at 60
    mapq_scale: float = 10.0
    # paired-end fragment model (giraffe paired-mode analog,
    # alignment.rs:14-119): mates on opposite strands within frag_max text
    # distance earn pair_bonus in the joint candidate scoring; a consistent
    # weak mate is rescued at rescue_frac of the normal score threshold
    frag_max: int = 1200
    pair_bonus: int = 4
    rescue_frac: float = 0.45

    @classmethod
    def for_read_type(cls, read_type: str, **kw) -> "AlignConfig":
        """Read-type-tuned aligner config: long-read chunking keeps the
        wider DP band (see extension_band comment)."""
        if read_type == "long":
            kw.setdefault("extension_band", 8)
        return cls(**kw)


@dataclass
class PipelineConfig:
    profiling: ProfilingConfig = field(default_factory=ProfilingConfig)
    align: AlignConfig = field(default_factory=AlignConfig)
