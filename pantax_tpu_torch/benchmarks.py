"""Synthetic workloads for the port: the reference's community databases and
its short- and long-read simulators (pantax_tpu/benchmarks.py imports the
JAX Aligner at its top, so these are counterparts; tests hold them equal)."""
from __future__ import annotations

import os
import tempfile
from pathlib import Path

import numpy as np

from . import _host

_BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
_CODE2BASE = np.frombuffer(b"ACGTN", dtype=np.uint8)


def tiny_db(root: str | os.PathLike | None = None):
    """Deterministic 2-species / 2-strain database, the same genomes as the
    reference's ``__graft_entry__._tiny_db`` (built once under ``root``,
    default a directory in the temp dir)."""
    root = Path(root or os.path.join(tempfile.gettempdir(),
                                     "pantax_tpu_torch_tiny_db"))
    db_dir = root / "db"
    if not (db_dir / "species_range.txt").exists():
        rng = np.random.default_rng(42)
        root.mkdir(parents=True, exist_ok=True)
        infos = []
        for sp in ("101", "202"):
            ref = _BASES[rng.integers(0, 4, size=20000)]
            for strain in ("a", "b"):
                g = ref.copy()
                snps = rng.random(len(g)) < 0.01
                g[snps] = _BASES[rng.integers(0, 4, size=int(snps.sum()))]
                name = f"GCF_{sp}{strain}.1_x_genomic.fna"
                _host.write_fasta(root / name, [(f"c{sp}{strain}", g.tobytes())])
                infos.append(_host.GenomeInfo(
                    f"GCF_{sp}{strain}.1_x", f"{sp}.{strain}", sp,
                    "synthetic", name))
        _host.write_genomes_info(root / "genomes_info.txt", infos)
        _host.build_database(root / "genomes_info.txt", db_dir, base_dir=root)
    return _host.load_database(db_dir)


def scale_db(path, n_species: int = 10, strains_per: int = 3,
             genome_len: int = 1_000_000, snp_rate: float = 0.01,
             seed: int = 7):
    """Synthetic community database (cached at ``path``): n_species random
    reference genomes, strains_per strains each at snp_rate SNPs."""
    root = Path(path)
    if (root / "db" / "species_range.txt").exists():
        return _host.load_database(root / "db")
    root.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    infos = []
    for sp in range(n_species):
        ref = _BASES[rng.integers(0, 4, size=genome_len)]
        for st in range(strains_per):
            g = ref.copy()
            m = rng.random(genome_len) < snp_rate
            g[m] = _BASES[rng.integers(0, 4, size=int(m.sum()))]
            name = f"GCF_{900 + sp}{chr(97 + st)}.1_x_genomic.fna"
            _host.write_fasta(root / name, [(f"c{sp}{st}", g.tobytes())])
            infos.append(_host.GenomeInfo(
                f"GCF_{900 + sp}{chr(97 + st)}.1_x", f"{900 + sp}.{st + 1}",
                str(900 + sp), "synthetic", name))
    info_file = root / "genomes_info.txt"
    _host.write_genomes_info(info_file, infos)
    return _host.build_database(info_file, root / "db", base_dir=root)


def simulate_read_batch(index, n_reads: int, read_len: int, error_rate: float,
                        seed: int = 0, hap_weights=None,
                        indel_rate: float = 0.0005):
    """Reads sampled from the index text with substitutions and 1 bp indels,
    half reverse-complemented: (codes int8 [n, Lr+pad], lens, truth hap)."""
    rng = np.random.default_rng(seed)
    H = len(index.hap_names)
    if hap_weights is None:
        hap = rng.integers(0, H, size=n_reads)
    else:
        w = np.asarray(hap_weights, dtype=np.float64)
        hap = rng.choice(H, size=n_reads, p=w / w.sum())
    spans = np.diff(index.hap_offsets) - 1  # exclude separator
    margin = 32
    starts = (index.hap_offsets[hap] + rng.integers(
        0, np.maximum(spans[hap] - read_len - margin, 1))).astype(np.int64)
    L = ((read_len + 31) // 32) * 32
    cols = np.arange(read_len)
    codes = np.full((n_reads, L), 4, dtype=np.int8)
    if indel_rate > 0:
        ev = rng.random((n_reads, read_len))
        is_del = ev < indel_rate / 2
        is_ins = (ev >= indel_rate / 2) & (ev < indel_rate)
        shift = np.cumsum(is_del.astype(np.int64) - is_ins.astype(np.int64),
                          axis=1)
        take = np.clip(cols[None, :] + shift, 0, None)
        codes[:, :read_len] = index.text[starts[:, None] + take]
        codes[:, :read_len][is_ins] = rng.integers(
            0, 4, size=int(is_ins.sum()), dtype=np.int8)
    else:
        codes[:, :read_len] = index.text[starts[:, None] + cols[None, :]]
    if error_rate > 0:
        m = rng.random(codes[:, :read_len].shape) < error_rate
        codes[:, :read_len] = np.where(
            m, rng.integers(0, 4, size=m.shape, dtype=np.int8),
            codes[:, :read_len])
    flip = rng.random(n_reads) < 0.5
    rc = 3 - codes[flip][:, ::-1]
    rc = np.where(rc < 0, 4, rc)  # pad 4 -> -1 -> back to 4
    codes[flip] = np.roll(rc, read_len - L, axis=1)  # left-align
    lens = np.full(n_reads, read_len, dtype=np.int64)
    return codes, lens, hap


def simulate_long_reads(index, n_reads: int, read_len: int,
                        sub_rate: float = 0.004, ins_rate: float = 0.003,
                        del_rate: float = 0.003, seed: int = 0,
                        hap_weights=None):
    """HiFi/ONT-like long reads with substitutions and 1 bp indels, sampled
    from the index text, half reverse-complemented: ([(read_id, seq
    bytes)], truth hap per read)."""
    rng = np.random.default_rng(seed)
    H = len(index.hap_names)
    if hap_weights is None:
        hap = rng.integers(0, H, size=n_reads)
    else:
        w = np.asarray(hap_weights, dtype=np.float64)
        hap = rng.choice(H, size=n_reads, p=w / w.sum())
    spans = np.diff(index.hap_offsets) - 1
    margin = int(read_len * max(del_rate, 0.01) * 4) + 64
    starts = (index.hap_offsets[hap] + rng.integers(
        0, np.maximum(spans[hap] - read_len - margin, 1))).astype(np.int64)
    reads = []
    for i in range(n_reads):
        tmpl = index.text[starts[i]:starts[i] + read_len + margin]
        ev = rng.random(read_len)
        is_del = ev < del_rate
        is_ins = (ev >= del_rate) & (ev < del_rate + ins_rate)
        shift = np.cumsum(is_del.astype(np.int64) - is_ins.astype(np.int64))
        codes = tmpl[np.clip(np.arange(read_len) + shift, 0,
                             len(tmpl) - 1)].copy()
        codes[is_ins] = rng.integers(0, 4, size=int(is_ins.sum()),
                                     dtype=np.int8)
        sub = rng.random(read_len) < sub_rate
        codes[sub] = rng.integers(0, 4, size=int(sub.sum()), dtype=np.int8)
        seq = _CODE2BASE[np.clip(codes, 0, 4)].tobytes()
        if rng.random() < 0.5:
            seq = _host.revcomp(seq)
        reads.append((f"L{i}", seq))
    return reads, hap
