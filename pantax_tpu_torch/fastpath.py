"""Array-native profiling, PyTorch port of pantax_tpu/fastpath.py: alignment
arrays -> abundance tables without GAF text round-trips.

The GAF file stays the interop/resume artifact (pipeline.profile_from_gaf),
but per-read string building caps throughput.  This path keeps everything
as arrays: text intervals from the aligner are projected onto graph nodes
with searchsorted, classification and read grouping are numpy, and the
per-species engine receives PackedReads directly.
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass

import numpy as np

from . import _host
from .align.aligner import run_batches, unpack_paired_rows
from .profile.engine import prepare_packed, select_species, solve_species
from .profile.report import abundance_est
from .profile.species import read_species_mean_len, species_profiling


@dataclass
class AlignmentArrays:
    """Batch-concatenated aligner outputs (aligned reads only)."""

    read_ids: list[str]
    ts: np.ndarray        # int64 text start
    te: np.ndarray        # int64 text end (exclusive)
    mapq: np.ndarray      # int64
    read_len: np.ndarray  # int64


def _pad_batch(codes, lens, lo: int, hi: int, batch: int):
    """Rows [lo, hi) as one ``batch``-row batch (empty reads appended)."""
    b_codes, b_lens = codes[lo:hi], lens[lo:hi]
    if hi - lo < batch:
        b_codes = np.vstack([b_codes, np.full(
            (batch - (hi - lo), codes.shape[1]), 4, np.int8)])
        b_lens = np.concatenate([b_lens, np.zeros(batch - (hi - lo),
                                                  b_lens.dtype)])
    return b_codes, b_lens


def _arrays(parts, lens) -> AlignmentArrays:
    """AlignmentArrays from per-batch (lo, aligned mask, ts, te, mapq) of
    the aligned rows; read ids R<row index>."""
    ids, ts, te, mq, rl = [], [], [], [], []
    for lo, keep, a, b, q in parts:
        idxs = np.flatnonzero(keep) + lo
        ids.extend(f"R{i}" for i in idxs)
        ts.append(a)
        te.append(b)
        mq.append(q)
        rl.append(lens[idxs])

    def cat(xs):
        return (np.concatenate(xs).astype(np.int64) if xs
                else np.zeros(0, np.int64))

    return AlignmentArrays(read_ids=ids, ts=cat(ts), te=cat(te), mapq=cat(mq),
                           read_len=cat(rl))


def _keep_aligned(parts, lo: int, m: int, res) -> None:
    keep = res.aligned[:m]
    parts.append((lo, keep, res.text_start[:m][keep], res.text_end[:m][keep],
                  res.mapq[:m][keep]))


def collect_alignment_arrays(aligner, codes, lens, batch: int,
                             stage_out: dict | None = None) -> AlignmentArrays:
    """Align a codes matrix in ``batch``-row batches on the aligner's
    device, keeping the aligned reads' results as arrays.  ``stage_out``
    receives the number of batches."""
    n = len(lens)
    parts = []

    def query(lo):
        return aligner.query_packed(*aligner.upload(
            *_pad_batch(codes, lens, lo, min(lo + batch, n), batch)))

    def drain(lo, res):
        _keep_aligned(parts, lo, min(lo + batch, n) - lo, res)

    n_batches = run_batches(range(0, n, batch), query, drain)
    if stage_out is not None:
        stage_out["n_batches"] = n_batches
    return _arrays(parts, lens)


def collect_paired_alignment_arrays(aligner, codes1, lens1, codes2, lens2,
                                    batch: int, stage_out: dict | None = None
                                    ) -> tuple[AlignmentArrays, AlignmentArrays]:
    """Paired-mate variant of collect_alignment_arrays: joint fragment-model
    batches, one AlignmentArrays per mate (read ids R<i> index the pair)."""
    n = len(lens1)
    parts1, parts2 = [], []

    def query(lo):
        hi = min(lo + batch, n)
        return aligner.query_paired_packed(
            *aligner.upload(*_pad_batch(codes1, lens1, lo, hi, batch)),
            *aligner.upload(*_pad_batch(codes2, lens2, lo, hi, batch)))

    def drain(lo, res):
        m = min(lo + batch, n) - lo
        _keep_aligned(parts1, lo, m, res[0])
        _keep_aligned(parts2, lo, m, res[1])

    n_batches = run_batches(range(0, n, batch), query, drain,
                            unpack_paired_rows)
    if stage_out is not None:
        stage_out["n_batches"] = n_batches
    return _arrays(parts1, lens1), _arrays(parts2, lens2)


def profile_from_alignments(arrays: AlignmentArrays, index, db, cfg,
                            out_dir: str | os.PathLike, *, device, mesh=None,
                            stage_out: dict | None = None) -> None:
    """Full species + strain profiling from alignment arrays (no GAF text);
    the strain stage's device coverage and PAO run on ``device`` (the
    coverage rows sharded over ``mesh`` when one is given).
    ``stage_out`` receives classify_s, species_s, coverage_s, pao_s and
    report_s (host-clock seconds)."""
    stage = stage_out if stage_out is not None else {}
    t0 = time.perf_counter()
    out = os.fspath(out_dir)
    os.makedirs(out, exist_ok=True)
    ranges = _host.load_species_range(db.range_file)

    # project text intervals onto node index spans
    i0 = np.searchsorted(index.tstart, arrays.ts, side="right") - 1
    i1 = np.searchsorted(index.tstart, np.maximum(arrays.te - 1, arrays.ts),
                         side="right") - 1
    n = len(i0)

    # classification: every alignment lies within one linearized haplotype,
    # so species = the haplotype's species (equivalent to the min/max-node
    # range walk, rcls.rs:210-235)
    range_of_species = {r.species: j for j, r in enumerate(ranges)}
    hap_range = np.array(
        [range_of_species.get(s, -1) for s in index.hap_species], dtype=np.int64
    )
    hap_idx = np.searchsorted(index.hap_offsets, arrays.ts, side="right") - 1
    hap_idx = np.clip(hap_idx, 0, len(hap_range) - 1)
    ridx = hap_range[hap_idx] if n else np.zeros(0, dtype=np.int64)
    species = np.array(
        [ranges[i].species if i >= 0 else "U" for i in ridx], dtype=object
    )
    with open(os.path.join(out, "reads_classification.tsv"), "w") as f:
        f.write("\n".join(
            f"{rid}\t{q}\t{sp}\t{rl}" for rid, q, sp, rl in zip(
                arrays.read_ids, arrays.mapq, species, arrays.read_len
            )
        ))
        if n:
            f.write("\n")
    t1 = time.perf_counter()
    stage["classify_s"] = t1 - t0

    keep = ridx >= 0
    profile = species_profiling(
        species[keep], arrays.read_len[keep], arrays.mapq[keep],
        read_species_mean_len(db.stats_file), filtered=cfg.filtered,
    )
    profile.save(os.path.join(out, "species_abundance.txt"))
    stage["species_s"] = time.perf_counter() - t1
    if not cfg.strain:
        return
    rsel_of = {id(r): j for j, r in enumerate(ranges)}

    def work(r):
        sel = keep & (ridx == rsel_of[id(r)])
        if not sel.any():
            return None
        s_i0, s_i1 = i0[sel], i1[sel]
        span = s_i1 - s_i0 + 1
        R, L = len(s_i0), int(span.max())
        cols = np.arange(L)
        take = np.clip(s_i0[:, None] + cols[None, :], 0, len(index.tnode) - 1)
        valid = cols[None, :] < span[:, None]
        nodes = np.full((R, L), -1, dtype=np.int64)
        nodes[valid] = (index.tnode[take] - r.start)[valid]
        read_start = (arrays.ts[sel] - index.tstart[s_i0]).astype(np.int64)
        packed = _host.PackedReads(
            nodes=nodes, lengths=span.astype(np.int64), read_start=read_start,
            read_end=read_start + (arrays.te[sel] - arrays.ts[sel]),
        )
        return prepare_packed(cfg, r.species, db.load_graph(r.species),
                              packed, device=device, mesh=mesh)

    metrics = solve_species(cfg, profile, work,
                            select_species(cfg, ranges, profile),
                            device=device, stage_out=stage)
    t2 = time.perf_counter()
    abundance_est(cfg, metrics, _host.read_genomes_info(db.genomes_info_file),
                  out)
    stage["report_s"] = time.perf_counter() - t2

