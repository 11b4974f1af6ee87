"""Synthetic workloads for the port: the reference's community databases
(tiny, scale, and the dup-graph community of tools/dup_bench.py) and its
short- and long-read simulators (pantax_tpu/benchmarks.py imports the
JAX Aligner at its top, so these are counterparts; tests hold them equal)."""
from __future__ import annotations

import os
import tempfile
from pathlib import Path

import numpy as np

from . import _host

_BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
_CODE2BASE = np.frombuffer(b"ACGTN", dtype=np.uint8)
_DUP_BLOCK = 64  # dup_db's node length (bp)
_DUP_SNP_RATE = 0.01  # dup_db's strain SNP rate


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


def _dup_species(root: Path, gfa_dir: Path, sp: int, rng, strains: int,
                 n_blocks: int, repeat_every: int) -> list:
    """One species of dup_db: its GFA (under ``gfa_dir``) and one FASTA per
    strain; returns the GenomeInfo rows.  Nodes are _DUP_BLOCK-bp blocks; a
    strain block with at least one SNP is a private node, an SNP-free one
    shares the species' reference node, and one repeat node shared by every
    haplotype recurs every ``repeat_every`` path steps."""
    block = _DUP_BLOCK
    repeat_seq = _BASES[rng.integers(0, 4, size=block)].tobytes()
    pos_is_rep = (np.arange(n_blocks) % repeat_every) == (repeat_every - 1)
    ref_blocks = {int(i): _BASES[rng.integers(0, 4, size=block)]
                  for i in np.flatnonzero(~pos_is_rep)}
    node_seqs: list[bytes] = [repeat_seq]
    rep_node = 0
    ref_node_of: dict[int, int] = {}
    paths, infos = {}, []
    for st in range(strains):
        var_node_of = {}
        for i in sorted(ref_blocks):
            m = rng.random(block) < _DUP_SNP_RATE
            if not m.any():
                if i not in ref_node_of:
                    ref_node_of[i] = len(node_seqs)
                    node_seqs.append(ref_blocks[i].tobytes())
                continue
            blk = ref_blocks[i].copy()
            blk[m] = _BASES[rng.integers(0, 4, size=int(m.sum()))]
            var_node_of[i] = len(node_seqs)
            node_seqs.append(blk.tobytes())
        path = [rep_node if pos_is_rep[i]
                else var_node_of.get(i, ref_node_of.get(i, rep_node))
                for i in range(n_blocks)]
        hap = f"GCF_{900 + sp}{chr(97 + st)}.1_x"
        paths[hap] = path
        fa = f"{hap}_genomic.fna"
        _host.write_fasta(root / fa, [(f"c{sp}{st}", b"".join(
            node_seqs[n] for n in path))])
        infos.append(_host.GenomeInfo(hap, f"{900 + sp}.{st + 1}",
                                      str(900 + sp), "synthetic-dup", fa))
    with open(gfa_dir / f"{900 + sp}.gfa", "wb") as f:
        f.write(b"H\tVN:Z:1.1\n")
        for ni, seq in enumerate(node_seqs):
            f.write(b"S\t%d\t%s\n" % (ni + 1, seq))
        for hap, path in paths.items():
            walk = b"".join(b">%d" % (n + 1) for n in path)
            f.write(b"W\t%s\t0\tmerged\t0\t%d\t%s\n"
                    % (hap.encode(), len(path) * block, walk))
    return infos


def dup_db(path, n_species: int = 10, strains: int = 3,
           n_blocks: int = 15625, repeat_every: int = 8, seed: int = 11):
    """Synthetic community whose haplotypes revisit a node (cached at
    ``path``): the graph shape of pggb-built pangenomes, which the fused
    path covers with the windowed scatter.  n_species x strains haplotypes
    of n_blocks 64 bp nodes (~1 Mb at the defaults), 1% strain SNPs, a
    shared repeat node every ``repeat_every`` steps; the GFAs are imported
    through build_database's ``gfa_dir``.  The counterpart of the
    reference's tools/dup_bench.py community (tests hold the files equal)."""
    root = Path(path)
    if (root / "db" / "species_range.txt").exists():
        return _host.load_database(root / "db")
    gfa_dir = root / "gfa"
    gfa_dir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    infos = []
    for sp in range(n_species):
        infos.extend(_dup_species(root, gfa_dir, sp, rng, strains, n_blocks,
                                  repeat_every))
    info_file = root / "genomes_info.txt"
    _host.write_genomes_info(info_file, infos)
    return _host.build_database(info_file, root / "db", base_dir=root,
                                gfa_dir=gfa_dir)


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
