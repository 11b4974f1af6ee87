"""Benchmark workloads of the port, the counterpart of
pantax_tpu/benchmarks.py: the synthetic community databases (tiny, scale,
and the dup-graph community of tools/dup_bench.py), the short- and
long-read simulators, and the runners that time them end to end on a
device and score their accuracy:

  run_alignment_benchmark      alignment rate, aligned fraction, species
                               accuracy
  run_e2e_benchmark            short reads through the fused pipeline to
                               the species and strain tables
  run_long_e2e_benchmark       long reads: chunked alignment, the fused
                               interval profile
  run_mixed_benchmark          99% short + 1% long reads back to back
  accuracy_benchmark           L1 strain-abundance error at 1:3:9 strain
                               weights through the GAF flow (short reads)
  long_read_accuracy_benchmark the same for long reads

Each runner takes ``device=``: None (the default) means the card
(device.require_cuda, which raises without one), so a runner never drifts
onto the CPU; the tests pass ``device=torch.device("cpu")``, where the
plain versions of the kernels run.  Stage clocks close after a
``torch.cuda.synchronize``: launches return before the card finishes.  The
returned dicts have the reference's keys.  Output directories default to
``<tempdir>/pantax_tpu_torch_*``, apart from the reference's.
"""
from __future__ import annotations

import csv
import os
import shutil
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from . import _host
from .device import card_unless

_BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
_CODE2BASE = np.frombuffer(b"ACGTN", dtype=np.uint8)
_DUP_BLOCK = 64  # dup_db's node length (bp)
_DUP_SNP_RATE = 0.01  # dup_db's strain SNP rate
_SIM_ROWS = 1 << 16  # simulate_read_batch's rows a block (~79 MB of float64)


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


def _row_blocks(n: int):
    """Slices of _SIM_ROWS rows covering ``n`` rows, in order."""
    return (slice(lo, min(lo + _SIM_ROWS, n)) for lo in range(0, n, _SIM_ROWS))


def simulate_read_batch(index, n_reads: int, read_len: int, error_rate: float,
                        seed: int = 0, hap_weights=None,
                        indel_rate: float = 0.0005):
    """Reads sampled from the index text with substitutions and 1 bp indels,
    half reverse-complemented: (codes int8 [n, Lr+pad], lens, truth hap).

    The reference's reads for a seed, bit for bit, built in row blocks: the
    float64 draws (one 64-bit draw each, so consecutive block calls give
    the one-shot stream) turn at once into codes, insert positions and a
    bool mask, so the host holds no [n, read_len] float64 or int64 array
    (at 9.9M reads each was ~12 GB)."""
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
    body = codes[:, :read_len]
    if indel_rate > 0:
        # flat positions in body, in the one-shot mask's order
        ins_at = [np.zeros(0, dtype=np.int64)]
        for sl in _row_blocks(n_reads):
            ev = rng.random((sl.stop - sl.start, read_len))
            is_del = ev < indel_rate / 2
            is_ins = (ev >= indel_rate / 2) & (ev < indel_rate)
            shift = np.cumsum(is_del.astype(np.int64) - is_ins.astype(np.int64),
                              axis=1)
            take = np.clip(cols[None, :] + shift, 0, None)
            body[sl] = index.text[starts[sl, None] + take]
            ins_at.append(np.flatnonzero(is_ins) + sl.start * read_len)
        ins_at = np.concatenate(ins_at)
        body[ins_at // read_len, ins_at % read_len] = rng.integers(
            0, 4, size=len(ins_at), dtype=np.int8)
    else:
        for sl in _row_blocks(n_reads):
            body[sl] = index.text[starts[sl, None] + cols[None, :]]
    if error_rate > 0:
        m = np.empty((n_reads, read_len), dtype=bool)
        for sl in _row_blocks(n_reads):
            m[sl] = rng.random((sl.stop - sl.start, read_len)) < error_rate
        # int8 draws are buffered: one call, as the reference makes it
        np.copyto(body, rng.integers(0, 4, size=m.shape, dtype=np.int8),
                  where=m)
        del m
    flip = rng.random(n_reads) < 0.5
    for sl in _row_blocks(n_reads):
        blk, f = codes[sl], flip[sl]
        rc = 3 - blk[f][:, ::-1]
        rc = np.where(rc < 0, 4, rc)  # pad 4 -> -1 -> back to 4
        blk[f] = np.roll(rc, read_len - L, axis=1)  # left-align
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


# ---------------------------------------------------------------------------
# runners
# ---------------------------------------------------------------------------
def _sync(dev: torch.device) -> None:
    """Wait for the device's queued work before a stage clock closes."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _out_dir(out_dir, name: str) -> str:
    return os.fspath(out_dir) if out_dir is not None else os.path.join(
        tempfile.gettempdir(), f"pantax_tpu_torch_{name}")


def _aligner(index, read_type: str, dev):
    """The Aligner for ``read_type`` as the command line builds it."""
    from .convert import aligner_from_reference

    return aligner_from_reference(
        index, _host.AlignConfig.for_read_type(read_type), dev)


def _count_strains(out_dir: str) -> int:
    with open(os.path.join(out_dir, "strain_abundance.txt")) as f:
        return max(sum(1 for _ in f) - 1, 0)


def run_alignment_benchmark(db, n_reads: int, batch: int,
                            error_rate: float = 0.01, *, device=None):
    """Alignment alone over simulated 150 bp reads: the steady rate (the
    batch size over the median interval between batch completions), the
    aligned fraction and the species accuracy of the aligned reads."""
    from .align.aligner import run_batches

    dev = card_unless(device)
    index = _host.build_align_index(db)
    aligner = _aligner(index, "short", dev)
    codes, lens, hap = simulate_read_batch(index, n_reads, 150, error_rate)
    # warm-up: the first launches and the pinned-memory pool, not timed
    aligner.align_codes(codes[:batch], lens[:batch])

    n_batches = n_reads // batch
    species_names = sorted(set(index.hap_species))
    sp_idx = {s: i for i, s in enumerate(species_names)}
    hap_sp = np.array([sp_idx[s] for s in index.hap_species])
    aligned = correct = 0
    marks = []

    def dispatch(b):
        sl = slice(b * batch, (b + 1) * batch)
        return aligner.query_packed(*aligner.upload(codes[sl], lens[sl]))

    def drain(b, res):
        # res was downloaded, which waited for the device: a completion
        nonlocal aligned, correct
        marks.append(time.time())
        aligned += int(res.aligned.sum())
        # the haplotype of the alignment against the truth's species
        pred_hap = np.searchsorted(index.hap_offsets, res.text_start,
                                   side="right") - 1
        pred_hap = np.clip(pred_hap, 0, len(hap_sp) - 1)
        sl = slice(b * batch, (b + 1) * batch)
        correct += int((res.aligned & (hap_sp[pred_hap] == hap_sp[hap[sl]])).sum())

    _sync(dev)
    t0 = time.time()
    run_batches(range(n_batches), dispatch, drain)
    _sync(dev)
    dt = time.time() - t0
    total = n_batches * batch
    gaps = np.diff(np.array(marks))
    steady = batch / float(np.median(gaps)) if len(gaps) >= 3 else total / dt
    return {
        "reads_per_s": steady,
        "aligned_frac": aligned / total,
        "species_acc": correct / max(aligned, 1),
        "wall_s": dt,
        "wall_reads_per_s": total / dt,
        "total_reads": total,
    }


def run_e2e_benchmark(db, n_reads: int, batch: int, error_rate: float = 0.01,
                      out_dir=None, *, device=None, stage_out=None):
    """Short reads end to end: align -> classify -> species profile ->
    strain profile -> abundance tables (the fused fastpath of
    ``pantax-gpu --fastpath``), with the alignment stage's rate beside the
    pipeline's.  One untimed pass over the same reads first (the kernel
    build, the first launches, the pinned-memory pool).  ``stage_out``
    receives the timed profile_fused call's stage dict."""
    from .ops.fused import build_fused_tables, profile_fused

    dev = card_unless(device)
    out_dir = _out_dir(out_dir, "e2e")
    index = _host.build_align_index(db)
    aligner = _aligner(index, "short", dev)
    cfg = _host.ProfilingConfig.for_read_type("short")
    codes, lens, _hap = simulate_read_batch(index, n_reads, 150, error_rate,
                                            seed=3)
    tables = build_fused_tables(db, index, dev, aligner.segment_lookup)
    shutil.rmtree(out_dir, ignore_errors=True)
    profile_fused(aligner, codes, lens, index, db, cfg, out_dir, batch,
                  tables=tables)

    shutil.rmtree(out_dir, ignore_errors=True)
    _sync(dev)
    t0 = time.time()
    stage = {} if stage_out is None else stage_out
    profile_fused(aligner, codes, lens, index, db, cfg, out_dir, batch,
                  tables=tables, stage_out=stage)
    _sync(dev)
    wall = time.time() - t0
    # align+coverage run as one fused pipeline (its clock closes on the
    # per-read download); "profile" is the rest
    t_align = stage.get("align_cover_s", wall)
    return {
        "e2e_reads_per_s": n_reads / wall,
        "align_reads_per_s": n_reads / t_align,
        "align_s": t_align,
        "profile_s": wall - t_align,
        "wall_s": wall,
        "total_reads": n_reads,
        "aligned_frac": stage.get("n_aligned", 0) / n_reads,
        "strains_detected": _count_strains(out_dir),
    }


def run_long_e2e_benchmark(db, n_long: int = 100_000, long_len: int = 8192,
                           read_type: str = "hifi", long_batch: int = 16384,
                           out_dir=None, *, device=None, stage_out=None):
    """Long reads end to end: chunked alignment and the best-alignment
    filter, then the fused interval profile (FusedPipeline.feed_intervals)
    to the species and strain tables.  Warmed first on the first 64 reads
    (untimed; its tables are removed).  ``stage_out`` receives the timed
    pass's align_long_reads and profile_from_fused_result stage dicts."""
    from .align.long_read import (
        LONG_READ_PRESETS, LONG_READ_SEED_STRIDE, align_long_reads,
    )
    from .ops.fused import (
        FusedPipeline, build_fused_tables, profile_from_fused_result,
    )

    dev = card_unless(device)
    out_dir = _out_dir(out_dir, "long_e2e")
    index = _host.build_align_index(db)
    aligner = _aligner(index, "long", dev)
    cfg = _host.ProfilingConfig.for_read_type("long")
    tables = build_fused_tables(db, index, dev, aligner.segment_lookup)
    chunk = LONG_READ_PRESETS[read_type]
    stride = LONG_READ_SEED_STRIDE[read_type]
    reads, _hap = simulate_long_reads(index, n_long, long_len, seed=9)

    def align(rs, stage=None):
        return align_long_reads(aligner, rs, chunk=chunk,
                                batch_size=long_batch, seed_stride=stride,
                                as_arrays=True, stage_out=stage)

    def profile(merged, stage=None):
        pipe = FusedPipeline(aligner, tables, long_batch)
        pipe.feed_intervals(merged.ts, merged.te, merged.mapq,
                            merged.read_len, ids=merged.read_ids)
        profile_from_fused_result(pipe.finish(), tables, index, db, cfg,
                                  out_dir, stage_out=stage)

    shutil.rmtree(out_dir, ignore_errors=True)
    profile(align(reads[:64]))
    shutil.rmtree(out_dir, ignore_errors=True)
    _sync(dev)
    t0 = time.time()
    merged = align(reads, stage_out)
    _sync(dev)
    t_align = time.time() - t0
    profile(merged, stage_out)
    _sync(dev)
    wall = time.time() - t0
    return {
        "total_reads": n_long,
        "total_bases": n_long * long_len,
        "wall_s": wall,
        "align_s": t_align,
        "profile_s": wall - t_align,
        "reads_per_s": n_long / wall,
        "bases_per_s": n_long * long_len / wall,
        "aligned_frac": len(merged.read_ids) / n_long,
        "strains_detected": _count_strains(out_dir),
    }


def run_mixed_benchmark(db, n_short: int = 9_900_000, n_long: int = 100_000,
                        batch: int = 65536, long_len: int = 8192,
                        read_type: str = "hifi", long_batch: int = 16384,
                        out_dir=None, *, device=None, stage_out=None):
    """Mixed reads (by default 9.9M 150 bp + 100,000 8 kb HiFi-like): the
    short reads through the fused pipeline to the species and strain
    tables, the long reads through chunked alignment and the best-alignment
    filter, timed back to back after a warm-up of both (first launches);
    the headline rate is all reads over the two stages' seconds.
    ``stage_out`` receives the timed profile_fused call's stage dict."""
    from .align.long_read import (
        LONG_READ_PRESETS, LONG_READ_SEED_STRIDE, align_long_reads,
    )
    from .io.gaf import filter_best_long_read_alignments
    from .ops.fused import build_fused_tables, profile_fused

    dev = card_unless(device)
    out_dir = _out_dir(out_dir, "mixed")
    index = _host.build_align_index(db)
    aligner = _aligner(index, "short", dev)
    aligner_long = _aligner(index, "long", dev)
    cfg = _host.ProfilingConfig.for_read_type("short")
    tables = build_fused_tables(db, index, dev, aligner.segment_lookup)
    codes, lens, _hap = simulate_read_batch(index, n_short, 150, 0.01, seed=5)
    long_reads, _lhap = simulate_long_reads(index, n_long, long_len, seed=9)
    chunk = LONG_READ_PRESETS[read_type]
    stride = LONG_READ_SEED_STRIDE[read_type]

    shutil.rmtree(out_dir, ignore_errors=True)
    profile_fused(aligner, codes[:2 * batch], lens[:2 * batch], index, db,
                  cfg, out_dir, batch, tables=tables)
    align_long_reads(aligner_long, long_reads[:1024], chunk=chunk,
                     batch_size=long_batch, seed_stride=stride)

    shutil.rmtree(out_dir, ignore_errors=True)
    stage = {} if stage_out is None else stage_out
    _sync(dev)
    t0 = time.time()
    profile_fused(aligner, codes, lens, index, db, cfg, out_dir, batch,
                  tables=tables, stage_out=stage)
    _sync(dev)
    short_s = time.time() - t0
    t1 = time.time()
    gaf = filter_best_long_read_alignments(align_long_reads(
        aligner_long, long_reads, chunk=chunk, batch_size=long_batch,
        seed_stride=stride))
    _sync(dev)
    long_s = time.time() - t1
    total = n_short + n_long
    return {
        "total_reads": total,
        "reads_per_s": total / (short_s + long_s),
        "short_reads_per_s": n_short / short_s,
        "long_reads_per_s": n_long / long_s,
        "short_s": short_s,
        "long_s": long_s,
        "short_aligned_frac": stage.get("n_aligned", 0) / n_short,
        "long_aligned_frac": len(gaf) / n_long,
        "strains_detected": _count_strains(out_dir),
    }


def _staggered_weights(index) -> np.ndarray:
    """1:3:9 weights over the haplotypes in index order."""
    return np.array([1.0 * (3 ** (i % 3)) for i in range(len(index.hap_names))])


def accuracy_benchmark(db, n_reads: int = 262144, batch: int = 16384,
                       error_rate: float = 0.01, seed: int = 11,
                       out_dir=None, *, device=None):
    """Strain-abundance accuracy end to end: staggered 1:3:9 strain weights
    per species, alignment to GAF records (ids R<index>), the per-species
    GAF flow to the tables, and the L1 error against the weights
    (_strain_l1's dict)."""
    from .align.aligner import run_batches
    from .pipeline import profile_from_gaf

    dev = card_unless(device)
    out_dir = _out_dir(out_dir, "acc")
    index = _host.build_align_index(db)
    aligner = _aligner(index, "short", dev)
    weights = _staggered_weights(index)
    codes, lens, _hap = simulate_read_batch(
        index, n_reads, 150, error_rate, seed=seed, hap_weights=weights)
    gaf = []

    def dispatch(lo):
        sl = slice(lo, lo + batch)
        return aligner.query_packed(*aligner.upload(codes[sl], lens[sl]))

    def drain(lo, res):
        hi = min(lo + batch, n_reads)
        gaf.extend(aligner.emit_gaf([f"R{i}" for i in range(lo, hi)],
                                    lens[lo:hi], res))

    run_batches(range(0, n_reads, batch), dispatch, drain)
    profile_from_gaf(gaf, db, _host.ProfilingConfig.for_read_type("short"),
                     out_dir, force=True, device=dev)
    return _strain_l1(db, index, weights, out_dir)


def _strain_l1(db, index, weights, out_dir):
    """L1 strain-abundance error of a finished run's strain_abundance.txt
    against the haplotype weights (every genome has about the same length,
    so the true abundance is the normalised weight)."""
    with open(os.path.join(out_dir, "strain_abundance.txt"), newline="") as f:
        rows = list(csv.reader(f, delimiter="\t"))
    head, rows = rows[0], rows[1:]
    gid, ab = head.index("genome_ID"), head.index("predicted_abundance")
    name_to_hidx = {n: i for i, n in enumerate(index.hap_names)}
    truth = {gi.genome_id: weights[name_to_hidx[gi.hap_id]]
             for gi in _host.read_genomes_info(db.genomes_info_file)}
    tot = sum(truth.values())
    truth = {k: v / tot for k, v in truth.items()}
    pred = {r[gid]: float(r[ab]) if r[ab] else np.nan for r in rows}
    l1 = sum(abs(pred.get(g, 0.0) - t) for g, t in truth.items())
    l1 += sum(p for g, p in pred.items() if g not in truth)
    return {
        "l1_error": l1,
        "detected": len(rows),
        "total": len(truth),
        "pred": pred,
        "truth": truth,
    }


def long_read_accuracy_benchmark(db, n_reads: int = 16384,
                                 read_len: int = 8192, batch: int = 2048,
                                 seed: int = 13, read_type: str = "hifi",
                                 out_dir=None, *, device=None):
    """Long-read strain accuracy end to end: staggered 1:3:9 weights,
    indel-bearing HiFi-like reads, chunked alignment and the best-alignment
    filter, the per-species GAF flow, and the L1 error against the weights,
    with the alignment's seconds and rate."""
    from .align.long_read import (
        LONG_READ_PRESETS, LONG_READ_SEED_STRIDE, align_long_reads,
    )
    from .io.gaf import filter_best_long_read_alignments
    from .pipeline import profile_from_gaf

    dev = card_unless(device)
    out_dir = _out_dir(out_dir, "lr_acc")
    index = _host.build_align_index(db)
    aligner = _aligner(index, "long", dev)
    weights = _staggered_weights(index)
    reads, _hap = simulate_long_reads(index, n_reads, read_len, seed=seed,
                                      hap_weights=weights)
    _sync(dev)
    t0 = time.time()
    gaf = filter_best_long_read_alignments(align_long_reads(
        aligner, reads, chunk=LONG_READ_PRESETS[read_type], batch_size=batch,
        seed_stride=LONG_READ_SEED_STRIDE[read_type]))
    _sync(dev)
    align_s = time.time() - t0
    profile_from_gaf(gaf, db, _host.ProfilingConfig.for_read_type("long"),
                     out_dir, force=True, device=dev)
    out = _strain_l1(db, index, weights, out_dir)
    out["aligned_frac"] = len(gaf) / n_reads
    out["align_s"] = align_s
    out["reads_per_s"] = n_reads / align_s
    return out
