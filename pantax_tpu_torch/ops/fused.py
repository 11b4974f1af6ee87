"""Fused align -> classify -> coverage pipeline and the short-read profiling
entry point, PyTorch port of pantax_tpu/ops/fused.py.

Per read batch, one pass on the device: the aligner query, the haplotype
classification, and the coverage scatter into the accumulators.  Two
formulations, chosen per DB as the reference chooses them:

- the range decomposition (``classify_scatter_ranges``, K6 on the card):
  ~12 scatter-adds per read, segment-space depth diffs folded into the
  node / base / trio accumulators once at finish (``expand_ranges``); exact
  on DBs whose haplotypes never revisit a node within one read's span;
- the windowed scatter (``classify_scatter``, K11 on the card): each read's
  first ``L_cap`` segments as a node-path row (``coverage_scatter``'s
  allocation, with the first-occurrence dedup where a haplotype revisits a
  node).  Reads that span more segments are counted and left out of the
  device scatter; their contributions come from the host oracle
  (``host_residual_updates``) at finish.

Both live in ops/scatter.py, with their plain torch versions; each scatter
a fused step or an interval batch dispatches is tallied in
``extend.LAUNCHES`` ("scatter_range_dispatch", "scatter_window_dispatch"),
so a run can hold the kernels' launches to it.

Paired feeds run the joint mate query and scatter both mates
(``feed_paired``); interval feeds (the long-read flow's merged per-read
alignments) take the range scatter on dup-free haplotypes, the windowed
scatter for short spans on haplotypes that revisit a node, and the host
residual beyond (``feed_intervals``).  Then the coverage finalize runs and
the profile tail (species stage, strain filters, two-stage PAO, report)
writes the tables: the host tail over downloaded arrays, or the device tail
(ops/profile_tail.py) over the arrays where they lie.

On a device mesh the aligner's query runs per row block on the mesh's
devices and hands the rows back to the primary (align/aligner.py); the
fused tables, the accumulators and the scatter stay on the primary.  A
multi-process run sums the raw accumulators across processes before the
finalize (``finish(process_reduce=)``).

Accumulator layout: every scatter target carries one extra sink slot that
takes the reference's out-of-range "drop" indices (torch's index_add_
raises on them) and is sliced off.  Node-base and trio sums are integers:
they accumulate in int64, exactly and in any order, and become float32 at
the finalize, which checks they stay below 2^24 (where float32 is exact,
so the result equals the reference's float32 sums).
"""
from __future__ import annotations

import csv
import os
import time
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from .. import _host
from .coverage_device import _add, build_padded_tables, coverage_finalize
from .extend import LAUNCHES
from .query import SegmentLookup, segment_lookup
from .scatter import (  # noqa: F401 (locate_segment: the reference's name)
    classify_scatter, classify_scatter_ranges, locate_segment,
    scatter_records,
)


# ---------------------------------------------------------------------------
# host-side tables (numpy counterparts of the reference's, array-equal)
# ---------------------------------------------------------------------------
def build_pos_lookup(tstart: np.ndarray, text_len: int):
    """(pos_lo int32 [nb+1], win_shift, steps) for locate_segment: the
    host's segment_lookup (ops/query.py)."""
    seg = segment_lookup(torch.from_numpy(np.asarray(tstart, np.int64)),
                         text_len)
    return seg.pos_lo.numpy(), seg.win_shift, seg.steps


def _window_has_dup_nodes(index, W: int = 64) -> bool:
    """True iff some haplotype visits the same node twice within any window
    of W consecutive segments."""
    tnode = np.asarray(index.tnode)
    if len(tnode) < 2:
        return False
    hap = np.searchsorted(index.hap_offsets, index.tstart, side="right") - 1
    for k in range(1, min(W, len(tnode))):
        if ((tnode[:-k] == tnode[k:]) & (hap[:-k] == hap[k:])).any():
            return True
    return False


def node_span_bound(index, read_pad: int, band: int = 16) -> int:
    """Static bound on how many text segments one alignment can span."""
    tstart = np.asarray(index.tstart, dtype=np.int64)
    if len(tstart) < 2:
        return 1
    W = read_pad + band + 2
    i = np.arange(len(tstart) - 1)
    te = tstart[i + 1] - 1 + W
    return int((np.searchsorted(tstart, te, side="left") - i).max()) + 1


def overflow_fraction(index, read_pad: int, K: int, band: int = 16) -> float:
    """Fraction of text start positions whose alignment would span more
    than K segments (classify_scatter's overflow predicate at L_cap=K):
    position p in segment i overflows iff p + W - 1 >= tstart[i + K]."""
    tstart = np.asarray(index.tstart, dtype=np.int64)
    M = len(tstart)
    if M <= K:
        return 0.0
    W = read_pad + band + 2
    i = np.arange(M - K)
    lo = np.maximum(tstart[i], tstart[i + K] - W + 1)
    hi = np.concatenate([tstart[1:], [index.text_len]])[i]
    return float(np.maximum(hi - lo, 0).sum()) / max(index.text_len, 1)


def auto_node_window(index, read_pad: int, band: int = 16) -> int:
    """The windowed scatter's node window: the smallest power-of-two K whose
    overflow rate (at the read length, band 0) stays under 1/256 of the
    text, else the worst-case span bound rounded up to a power of two and
    clamped to [4, 64].  Overflowing reads take the exact host residual."""
    exact = max(4, min(1 << int(np.ceil(np.log2(
        node_span_bound(index, read_pad, band)))), 64))
    for K in (4, 8, 16, 32):
        if K >= exact:
            break
        if overflow_fraction(index, read_pad, K, band=0) <= 1.0 / 256:
            return K
    return exact


def _build_trio_seg(index, species, hap_range) -> np.ndarray:
    """trio_seg[i]: the global unique-trio index matched by the 3-window of
    consecutive text segments (i, i+1, i+2) of one haplotype, or -1."""
    tn = np.asarray(index.tnode, dtype=np.int64)
    M = len(tn)
    trio_seg = np.full(M, -1, dtype=np.int32)
    if M < 3:
        return trio_seg
    seg_hap = np.searchsorted(index.hap_offsets, index.tstart, side="right") - 1
    seg_hap = np.clip(seg_hap, 0, len(hap_range) - 1)
    same_hap = seg_hap[:-2] == seg_hap[2:]
    win_range = hap_range[seg_hap[:-2]]
    wa, wb, wc = tn[:-2] - 1, tn[1:-1] - 1, tn[2:] - 1
    for sp in species:
        sel = np.flatnonzero(same_hap & (win_range == sp.ridx))
        if not len(sel) or sp.trio_index.num_unique == 0:
            continue
        wins = np.stack([wa[sel] - sp.off, wb[sel] - sp.off, wc[sel] - sp.off],
                        axis=1)
        m = sp.trio_index.match(wins)
        trio_seg[sel] = np.where(m >= 0, m + sp.trio_lo, -1).astype(np.int32)
    return trio_seg


@dataclass
class FusedSpecies:
    range_: object          # SpeciesRange
    ridx: int               # index into the species-range table
    off: int                # global 0-based node offset (range.start - 1)
    num_nodes: int
    trio_lo: int            # slice of the global trio table
    trio_hi: int
    paths: dict             # name -> node array (local)
    nodes_len: np.ndarray
    trio_index: object      # TrioIndex


class FusedTables(nn.Module):
    """Global classification and coverage tables (buffers) plus per-species
    metadata for the profile tail.  Given the text's segment starts and
    nodes (``tstart``, ``tnode``), it also holds K6's records,
    ``seg_rec`` (ops/scatter.py's scatter_records); else that is None and
    only the CPU's plain range scatter takes the tables."""

    def __init__(self, *, species, ranges, hap_offsets, hap_range, pos_lo,
                 nodes_len, base_offset, trio_len, trio_seg, has_dups: bool,
                 hap_dup, win_shift: int, pos_steps: int, N_pad: int,
                 TB_pad: int, U_pad: int, device, tstart=None, tnode=None):
        super().__init__()
        self.species = species
        self.ranges = ranges
        self.has_dups = has_dups
        # host bool [H]: haplotype path visits some node twice
        self.hap_dup = np.asarray(hap_dup, dtype=bool)
        self.win_shift = win_shift
        self.pos_steps = pos_steps
        self.N_pad, self.TB_pad, self.U_pad = N_pad, TB_pad, U_pad
        dev = torch.device(device)
        for name, arr in (("hap_offsets", hap_offsets),
                          ("hap_range", hap_range), ("pos_lo", pos_lo),
                          ("nodes_len", nodes_len),
                          ("base_offset", base_offset),
                          ("trio_len", trio_len), ("trio_seg", trio_seg)):
            t = arr if isinstance(arr, torch.Tensor) else torch.from_numpy(
                np.array(arr, dtype=np.int32))
            self.register_buffer(name, t.to(dev, torch.int32))
        self.register_buffer("seg_rec", None if tstart is None else
                             scatter_records(self, torch.from_numpy(
                                 np.asarray(tstart, np.int32)),
                                 torch.from_numpy(np.asarray(tnode, np.int32))))

    @property
    def device(self) -> torch.device:
        return self.nodes_len.device


def build_fused_tables(db, index, device,
                       lookup: SegmentLookup | None = None) -> FusedTables:
    """Global coverage/classification tables + per-species metadata.
    ``lookup``, the bucket table of the index's segment starts that an
    Aligner of this index holds on ``device`` (Aligner.segment_lookup), is
    shared in place of a table of their own."""
    ranges = _host.load_species_range(db.range_file)
    N = max(r.end for r in ranges)
    nodes_len = np.ones(N, dtype=np.int64)
    trio_len, species = [], []
    t_off = 0
    for rj, r in enumerate(ranges):
        g = db.load_graph(r.species)
        off = r.start - 1
        nodes_len[off:off + g.num_nodes] = g.nodes_len
        paths = g.paths_dict()
        ti = _host.build_trio_index(g.nodes_len, paths)
        u = ti.num_unique
        if u:
            trio_len.append(np.asarray(ti.trio_len))
        species.append(FusedSpecies(
            range_=r, ridx=rj, off=off, num_nodes=g.num_nodes,
            trio_lo=t_off, trio_hi=t_off + u, paths=paths,
            nodes_len=g.nodes_len, trio_index=ti,
        ))
        t_off += u
    tl = np.concatenate(trio_len) if trio_len else np.zeros(0, np.int64)
    t = build_padded_tables(nodes_len, tl)
    range_of_species = {r.species: j for j, r in enumerate(ranges)}
    hap_range = np.array([range_of_species.get(s, -1) for s in index.hap_species],
                         dtype=np.int32)
    if lookup is None:
        lookup = segment_lookup(torch.from_numpy(
            np.asarray(index.tstart, np.int64)), index.text_len)
    pos_lo, win_shift, steps = lookup
    # a haplotype that visits some node twice: the range decomposition would
    # count bases the reference credits only at the first occurrence
    hap_dup = np.zeros(len(index.hap_species), dtype=bool)
    seg_hap = np.clip(np.searchsorted(index.hap_offsets, index.tstart,
                                      side="right") - 1, 0, len(hap_dup) - 1)
    tn = np.asarray(index.tnode, dtype=np.int64)
    for h in range(len(hap_dup)):
        nodes_h = tn[seg_hap == h]
        hap_dup[h] = len(np.unique(nodes_h)) != len(nodes_h)
    return FusedTables(
        species=species, ranges=ranges,
        hap_offsets=index.hap_offsets.astype(np.int32), hap_range=hap_range,
        pos_lo=pos_lo, nodes_len=t.nodes_len, base_offset=t.base_offset,
        trio_len=t.trio_len,
        trio_seg=_build_trio_seg(index, species, hap_range),
        has_dups=_window_has_dup_nodes(index), hap_dup=hap_dup,
        win_shift=win_shift,
        pos_steps=steps, N_pad=t.N_pad, TB_pad=t.TB_pad, U_pad=t.U_pad,
        device=device, tstart=index.tstart, tnode=index.tnode,
    )


# ---------------------------------------------------------------------------
# device step: the classify + scatter (K6, K11: ops/scatter.py) and the fold
# ---------------------------------------------------------------------------
def expand_ranges(acc, tables: FusedTables, tnode) -> None:
    """Fold the segment-space depth diffs into the node / base-diff / trio
    accumulators in place: depth[i] full copies of segment i's node and
    depth_t[w] full sums of trio window w.  One pass over all M segments."""
    acc_bases, acc_diff, acc_trio, acc_sn, acc_st = acc
    t = tables
    M = tnode.shape[0]
    n = tnode - 1
    nlen = t.nodes_len[n]
    depth_n = torch.cumsum(acc_sn[:M], dim=0).to(torch.int32)
    _add(acc_bases, n, depth_n.to(torch.int64) * nlen)
    bo = t.base_offset[n]
    live = depth_n != 0
    TB = t.TB_pad
    _add(acc_diff, torch.where(live, bo, TB), depth_n)
    _add(acc_diff, torch.where(live, bo + nlen, TB), -depth_n)
    depth_t = torch.cumsum(acc_st[:M], dim=0).to(torch.int32)
    ar = torch.arange(M, device=tnode.device)
    i1c = (ar + 1).clamp(max=M - 1)
    i2c = (ar + 2).clamp(max=M - 1)
    w3 = nlen + t.nodes_len[tnode[i1c] - 1] + t.nodes_len[tnode[i2c] - 1]
    t_idx = torch.where((depth_t != 0) & (t.trio_seg >= 0), t.trio_seg, t.U_pad)
    _add(acc_trio, t_idx, depth_t.to(torch.int64) * w3)


def narrow_per_read_nov(ts, te, mapq, aligned, ridx):
    """Per-read columns in the reference's narrow types: ts int32, span
    int16, mapq int8, aligned bool, ridx int16."""
    return (ts.to(torch.int32), (te - ts).to(torch.int16),
            mapq.to(torch.int8), aligned, ridx.to(torch.int16))


def _scatter_step(ts, te, mapq, aligned, aligner, tables: FusedTables, acc,
                  L_cap: int | None):
    """The scatter half of a fused step: the range scatter (``L_cap`` None)
    or the windowed scatter at ``L_cap``; returns (narrow_per_read_nov's
    five per-read columns, the overflow mask or None)."""
    if L_cap is None:
        LAUNCHES["scatter_range_dispatch"] += 1
        ridx, overflow = classify_scatter_ranges(
            ts, te, aligned, tables, aligner.tstart, aligner.tnode,
            acc), None
    else:
        LAUNCHES["scatter_window_dispatch"] += 1
        ridx, overflow = classify_scatter(ts, te, aligned, tables,
                                          aligner.tstart, aligner.tnode, acc,
                                          L_cap)
    return narrow_per_read_nov(ts, te, mapq, aligned, ridx), overflow


def fused_step(aligner, tables: FusedTables, codes, read_len, acc,
               L_cap: int | None = None):
    """One batch: aligner query + scatter into ``acc`` (in place), by the
    range decomposition or (``L_cap`` given) the windowed scatter; returns
    (the five per-read columns, the overflow mask or None)."""
    ts, te, _score, _matches, mapq, _strand, aligned = aligner.query(
        codes, read_len)
    return _scatter_step(ts, te, mapq, aligned, aligner, tables, acc, L_cap)


def fused_step_paired(aligner, tables: FusedTables, codes1, len1, codes2,
                      len2, acc, L_cap: int | None = None):
    """One paired batch: the joint mate query + the scatter of the [2B]
    mate intervals (mate 1 then mate 2) into ``acc`` (in place), as
    fused_step; returns the five [2B] per-read columns and the [2B]
    overflow mask or None."""
    ts, te, _score, _matches, mapq, _strand, aligned = \
        aligner.query_paired_columns(codes1, len1, codes2, len2)
    return _scatter_step(ts, te, mapq, aligned, aligner, tables, acc, L_cap)


# ---------------------------------------------------------------------------
# host residual: the coverage of reads the windowed scatter left out (more
# segments than its window, or long spans on haplotypes that revisit a
# node), from the host oracle the device scatter is held to
# ---------------------------------------------------------------------------
def host_residual_updates(index, tables: FusedTables, ts, te, ridx):
    """Global-space coverage addends of classified intervals: per species,
    the intervals projected onto their node paths and the host oracle's
    raw addends (profile/coverage.py raw_contributions), shifted by the
    species' node / base / trio offsets.  Returns int64 (node idx, bases,
    diff lo, diff hi, trio idx, trio value)."""
    tstart = np.asarray(index.tstart, dtype=np.int64)
    tnode = np.asarray(index.tnode, dtype=np.int64)
    ts = np.asarray(ts, dtype=np.int64)
    ridx = np.asarray(ridx, dtype=np.int64)
    # clamp each interval to the haplotype that classified it (by ts): a
    # mismatching tail past the separator would otherwise project onto
    # another species' segments
    hap = np.clip(np.searchsorted(index.hap_offsets, ts, side="right") - 1,
                  0, len(index.hap_offsets) - 2)
    te = np.minimum(np.asarray(te, dtype=np.int64),
                    index.hap_offsets[hap + 1] - 1)
    te = np.maximum(te, ts + 1)
    parts = []
    for rj in np.unique(ridx):
        sp = tables.species[int(rj)]
        sel = ridx == rj
        s_ts, s_te = ts[sel], te[sel]
        i0 = np.searchsorted(tstart, s_ts, side="right") - 1
        i1 = np.searchsorted(tstart, np.maximum(s_te - 1, s_ts),
                             side="right") - 1
        span = i1 - i0 + 1
        cols = np.arange(int(span.max()))
        take = np.clip(i0[:, None] + cols[None, :], 0, len(tnode) - 1)
        valid = cols[None, :] < span[:, None]
        nodes = np.where(valid, tnode[take] - sp.range_.start, -1)
        rs = s_ts - tstart[i0]
        n_idx, n_val, lo, hi, t_idx, t_val = _host.raw_contributions(
            _host.PackedReads(nodes=nodes, lengths=span, read_start=rs,
                              read_end=rs + (s_te - s_ts)),
            np.asarray(sp.nodes_len, dtype=np.int64), sp.trio_index)
        b0 = int(tables.base_offset[sp.off])
        parts.append((n_idx + sp.off, n_val, lo + b0, hi + b0,
                      t_idx + sp.trio_lo, t_val))
    if not parts:
        return (np.zeros(0, np.int64),) * 6
    return tuple(np.concatenate(p).astype(np.int64) for p in zip(*parts))


def apply_residual(acc, updates) -> None:
    """Add host_residual_updates' addends into acc[:3] in place."""
    acc_b, acc_d, acc_t = acc[:3]
    bidx, bval, dlo, dhi, tidx, tval = (
        torch.from_numpy(a).to(acc_b.device) for a in updates)
    _add(acc_b, bidx, bval)
    _add(acc_d, dlo, torch.ones_like(dlo))
    _add(acc_d, dhi, -torch.ones_like(dhi))
    _add(acc_t, tidx, tval)


# ---------------------------------------------------------------------------
# pipeline and profiling entry points
# ---------------------------------------------------------------------------
@dataclass
class FusedResult:
    """FusedPipeline.finish() output: the three dense coverage arrays on the
    device (node_abundance f32 [N_pad], trio_abundance f32 [U_pad],
    node_base_cov int32 [N_pad]), the per-read host columns, and the number
    of codes-fed reads that overflowed the windowed scatter's node window
    (their coverage is in the arrays, from the host residual)."""

    na_d: torch.Tensor
    ta_d: torch.Tensor
    bc_d: torch.Tensor
    reads: dict
    n_overflow: int = 0

    def host(self):
        """(na float64, ta float64, bc int32) numpy, as the host tail reads
        them."""
        return (self.na_d.cpu().numpy().astype(np.float64),
                self.ta_d.cpu().numpy().astype(np.float64),
                self.bc_d.cpu().numpy())


class FusedPipeline:
    """Incremental fused align+coverage: feed() read chunks or
    feed_paired() mate pairs (cut into fixed ``batch`` dispatches) and
    feed_intervals() pre-aligned intervals, then finish() once.  The
    accumulators stay on the device between feeds.

    The first codes feed picks the coverage formulation as the reference
    does: the range scatter where it is exact, else the windowed scatter
    at ``L_cap`` (auto_node_window unless given).  An explicit ``L_cap``
    forces the windowed scatter.  Every read's text interval is kept, so
    finish() also returns ts / te (the CLI's resume artifact writes
    them)."""

    _L_INT = 8  # the windowed scatter's window for interval feeds

    def __init__(self, aligner, tables: FusedTables, batch: int,
                 L_cap: int | None = None):
        self.aligner = aligner
        self.tables = tables
        self.batch = batch
        self.L_cap = L_cap
        self.use_ranges: bool | None = False if L_cap is not None else None
        self.n_batches = 0
        self.n_interval_batches = 0
        # interval rows by sub-path: range scatter, windowed scatter, host
        self.interval_rows = {"range": 0, "window": 0, "residual": 0}
        dev = aligner.device
        M = aligner.tnode.shape[0]
        z = torch.zeros
        self.acc = (
            z(tables.N_pad + 1, dtype=torch.int64, device=dev),
            z(tables.TB_pad + 1, dtype=torch.int32, device=dev),
            z(tables.U_pad + 1, dtype=torch.int64, device=dev),
            z(M + 1, dtype=torch.int32, device=dev),
            z(M + 1, dtype=torch.int32, device=dev),
        )
        self._per_read = []  # (n_valid, ids | None, lens, (mapq, aligned, ridx))
        # per windowed dispatch: [count, done event, (overflow, ts, span,
        # ridx) or None]; _ov_seen counts the dispatches whose count is in
        self._ov = []
        self._ov_seen = 0
        self._int_reads = None  # interval feeds' host columns, per feed
        self._int_ids = None

    def _decide_ranges(self, read_pad: int) -> bool:
        """The range scatter needs dup-free windows over one read's whole
        segment span (the reference's _decide_ranges, without its A/B
        environment override)."""
        tables, index = self.tables, self.aligner.index
        if tables.has_dups:
            return False
        bound = node_span_bound(index, read_pad,
                                self.aligner.cfg.extension_band)
        return bound <= 64 or not _window_has_dup_nodes(index, W=bound)

    def _choose_path(self, read_pad: int) -> None:
        """Fix the formulation (and the window) at the first codes feed;
        ``read_pad`` is the width of the host codes."""
        if self.use_ranges is None:
            self.use_ranges = self._decide_ranges(read_pad)
        if not self.use_ranges and self.L_cap is None:
            self.L_cap = auto_node_window(self.aligner.index, read_pad,
                                          self.aligner.cfg.extension_band)

    def _upload_slice(self, codes, lens, lo: int, hi: int):
        """Rows [lo, hi) as one ``batch``-row dispatch on the device (the
        last batch padded with empty reads)."""
        B = self.batch
        b_codes, b_lens = codes[lo:hi], lens[lo:hi]
        if hi - lo < B:
            b_codes = np.vstack([b_codes, np.full(
                (B - (hi - lo), codes.shape[1]), 4, np.int8)])
            b_lens = np.concatenate(
                [b_lens, np.zeros(B - (hi - lo), b_lens.dtype)])
        return self.aligner.upload(b_codes, b_lens)

    def _dispatch(self, step, *batch):
        """One codes dispatch through ``step`` (fused_step or
        fused_step_paired) in the chosen formulation; returns the per-read
        (mapq, aligned, ridx, ts, span) columns; a windowed dispatch also
        hands ts / span to _hold_overflow."""
        (ts, span, *core), overflow = step(
            self.aligner, self.tables, *batch, self.acc,
            None if self.use_ranges else self.L_cap)
        if overflow is not None:
            self._hold_overflow(overflow, ts, span, core[2])
        self.n_batches += 1
        return core + [ts, span]

    def _hold_overflow(self, overflow, ts, span, ridx) -> None:
        """Keep a windowed dispatch's overflow mask and ts / span (~7 bytes
        a read on the device) for the host residual at finish.  The
        dispatch's overflow count comes back without stalling the stream;
        once it is in and is 0, the dispatch's rows are dropped, so only
        dispatches that overflow hold their rows until finish."""
        n = overflow.sum()
        done = None
        if n.is_cuda:
            n = n.to("cpu", non_blocking=True)
            done = torch.cuda.Event()
            done.record()
        self._ov.append([n, done, (overflow, ts, span, ridx)])
        while self._ov_seen < len(self._ov):
            rec = self._ov[self._ov_seen]
            if rec[1] is not None and not rec[1].query():
                break
            if not int(rec[0]):
                rec[2] = None
            self._ov_seen += 1

    def feed(self, codes, lens, ids=None) -> None:
        self._choose_path(codes.shape[1])
        B = self.batch
        for lo in range(0, len(lens), B):
            hi = min(lo + B, len(lens))
            core = self._dispatch(fused_step,
                                  *self._upload_slice(codes, lens, lo, hi))
            self._per_read.append((hi - lo, ids[lo:hi] if ids is not None
                                   else None, np.asarray(lens[lo:hi]), core))

    def feed_paired(self, codes1, lens1, codes2, lens2, ids1=None,
                    ids2=None) -> None:
        """Joint fragment-model feed: each ``batch`` of mate pairs goes
        through one paired query (pair scoring, rescue, pair mapq) and one
        scatter of both mates.  Per-read rows come out as a mate-1 block
        and then a mate-2 block per batch."""
        n = len(lens1)
        if len(lens2) != n:
            raise ValueError("paired feed requires equal mate counts")
        self._choose_path(max(codes1.shape[1], codes2.shape[1]))
        B = self.batch
        for lo in range(0, n, B):
            hi = min(lo + B, n)
            core = self._dispatch(
                fused_step_paired,
                *self._upload_slice(codes1, lens1, lo, hi),
                *self._upload_slice(codes2, lens2, lo, hi))
            for half, ids, lens in ((slice(0, B), ids1, lens1),
                                    (slice(B, 2 * B), ids2, lens2)):
                self._per_read.append((
                    hi - lo, ids[lo:hi] if ids is not None else None,
                    np.asarray(lens[lo:hi]), [c[half] for c in core]))

    def _interval_batches(self, ts, te, sel):
        """The rows ``sel`` of host intervals as ``batch``-row device
        dispatches (ts, te, live)."""
        aligner, B = self.aligner, self.batch
        rows = np.flatnonzero(sel)
        for lo in range(0, len(rows), B):
            r = rows[lo:lo + B]
            c_ts = np.zeros(B, np.int32)
            c_te = np.zeros(B, np.int32)
            c_live = np.zeros(B, bool)
            c_ts[:len(r)] = ts[r]
            c_te[:len(r)] = te[r]
            c_live[:len(r)] = True
            self.n_interval_batches += 1
            yield (aligner.put(c_ts, np.int32), aligner.put(c_te, np.int32),
                   aligner.put(c_live, bool))

    def feed_intervals(self, ts, te, mapq, read_len, ids=None,
                       aligned=None) -> None:
        """Feed pre-aligned text intervals (the long-read flow's merged
        per-read alignments) instead of read codes.  Per-read columns
        (mapq / ridx / read_len) are computed on the host.  The rows are
        split on the host: on dup-free haplotypes, the range scatter for
        any span; on haplotypes that revisit a node, the windowed scatter
        for spans of at most ``_L_INT`` segments and the exact host
        residual beyond."""
        aligner, tables = self.aligner, self.tables
        index = aligner.index
        ts = np.asarray(ts, dtype=np.int64)
        te = np.asarray(te, dtype=np.int64)
        mapq = np.asarray(mapq, dtype=np.int64)
        read_len = np.asarray(read_len, dtype=np.int64)
        al = (np.ones(len(ts), dtype=bool) if aligned is None
              else np.asarray(aligned, dtype=bool))

        hap_range = tables.hap_range.cpu().numpy()
        hap = np.clip(np.searchsorted(index.hap_offsets, ts, side="right") - 1,
                      0, len(hap_range) - 1)
        ridx = np.where(al, hap_range[hap], -1).astype(np.int64)
        tstart = np.asarray(index.tstart, dtype=np.int64)
        span = (np.searchsorted(tstart, np.maximum(te - 1, ts), side="right")
                - np.searchsorted(tstart, ts, side="right") + 1)
        ok = al & (ridx >= 0) & (te > ts)
        dup = tables.hap_dup[hap]
        long_ok = ok & ~dup
        short = ok & dup & (span <= self._L_INT)
        resid = ok & dup & (span > self._L_INT)

        cols = {"mapq": mapq, "aligned": al, "ridx": ridx,
                "read_len": read_len, "ts": ts, "te": te}
        if self._int_reads is None:
            self._int_reads = {k: [] for k in cols}
            self._int_ids = [] if ids is not None else None
        for k, v in cols.items():
            self._int_reads[k].append(v)
        if ids is not None and self._int_ids is not None:
            self._int_ids.extend(ids)

        if resid.any():
            apply_residual(self.acc, host_residual_updates(
                index, tables, ts[resid], te[resid], ridx[resid]))
        for c_ts, c_te, c_live in self._interval_batches(ts, te, short):
            LAUNCHES["scatter_window_dispatch"] += 1
            classify_scatter(c_ts, c_te, c_live, tables, aligner.tstart,
                             aligner.tnode, self.acc, self._L_INT)
        # the reference's _interval_range_step: the range scatter without
        # the query (the per-read columns are host-computed)
        for c_ts, c_te, c_live in self._interval_batches(ts, te, long_ok):
            LAUNCHES["scatter_range_dispatch"] += 1
            classify_scatter_ranges(c_ts, c_te, c_live, tables,
                                    aligner.tstart, aligner.tnode, self.acc)
        for k, sel in (("range", long_ok), ("window", short),
                       ("residual", resid)):
            self.interval_rows[k] += int(sel.sum())

    def _apply_overflow_residual(self) -> int:
        """Add the host residual of the reads the windowed dispatches left
        out (more segments than the window) and return how many there
        were, classified or not (the reference's overflow count)."""
        for _, done, _ in self._ov:
            if done is not None:
                done.synchronize()
        n_overflow = sum(int(n) for n, _, _ in self._ov)
        held = [rows for n, _, rows in self._ov if int(n)]
        self._ov, self._ov_seen = [], 0
        if not held:
            return 0
        ov, ts, span, ridx = (torch.cat(c) for c in zip(*held))
        rows = ov.nonzero().squeeze(1)
        ts = ts[rows].cpu().numpy().astype(np.int64)
        te = ts + span[rows].cpu().numpy()
        ridx = ridx[rows].cpu().numpy().astype(np.int64)
        keep = ridx >= 0
        apply_residual(self.acc, host_residual_updates(
            self.aligner.index, self.tables, ts[keep], te[keep], ridx[keep]))
        return n_overflow

    def finish(self, process_reduce=None) -> FusedResult:
        """The merged coverage and every fed read's host columns.

        ``process_reduce`` (multi-process runs): a callable summing the
        three raw accumulators across processes
        (parallel.distributed.cross_process_sum), applied after this
        process's overflow residual and expand_ranges and before the
        finalize, so every process finalizes the merged coverage (the
        reference's order)."""
        t = self.tables
        n_overflow = self._apply_overflow_residual()
        expand_ranges(self.acc, t, self.aligner.tnode)
        acc_b, acc_d, acc_t = self.acc[:3]
        if process_reduce is not None:
            acc_b, acc_d, acc_t = process_reduce((acc_b, acc_d, acc_t))
        na, ta, bc = coverage_finalize(
            acc_b[:t.N_pad], acc_d, acc_t[:t.U_pad], t.nodes_len,
            t.base_offset, t.trio_len,
        )
        names = ("mapq", "aligned", "ridx", "read_len", "ts", "te")
        reads = {k: np.zeros(0, np.int64) for k in names}
        ids_all = None
        if self._per_read:
            if self._per_read[0][1] is not None:
                ids_all = [i for _, ids, _, _ in self._per_read for i in ids]
            for name, j in (("mapq", 0), ("aligned", 1), ("ridx", 2),
                            ("ts", 3), ("span", 4)):
                reads[name] = np.concatenate([
                    c[j][:m].cpu().numpy()
                    for m, _, _, c in self._per_read
                ])
            reads["te"] = reads["ts"] + reads.pop("span")
            reads["read_len"] = np.concatenate(
                [lens for _, _, lens, _ in self._per_read])
            self._per_read = []
        if self._int_reads is not None:
            # interval-fed rows (host-computed columns) follow codes rows
            for k in names:
                parts = self._int_reads[k]
                reads[k] = np.concatenate(
                    [reads[k]] + parts if len(reads[k]) else parts)
            if self._int_ids is not None:
                ids_all = (ids_all or []) + self._int_ids
            self._int_reads = self._int_ids = None
        reads["ids"] = ids_all
        return FusedResult(na, ta, bc, reads, n_overflow)


def fused_alignment_coverage(aligner, codes, lens, tables: FusedTables,
                             batch: int, L_cap: int | None = None
                             ) -> FusedResult:
    """One-shot convenience wrapper over FusedPipeline: feed, then finish."""
    pipe = FusedPipeline(aligner, tables, batch, L_cap)
    pipe.feed(codes, lens)
    return pipe.finish()


def profile_fused(aligner, codes, lens, index, db, cfg, out_dir, batch: int,
                  tables: FusedTables | None = None,
                  stage_out: dict | None = None) -> bool:
    """One-shot fused species + strain profiling over a codes matrix.
    ``stage_out`` receives align_cover_s, the read and batch counts and
    profile_from_fused_result's stage seconds."""
    if tables is None:
        tables = build_fused_tables(db, index, aligner.device,
                                    aligner.segment_lookup)
    t0 = time.time()
    pipe = FusedPipeline(aligner, tables, batch)
    pipe.feed(codes, lens)
    result = pipe.finish()  # the per-read download synchronises the device
    if stage_out is not None:
        stage_out["align_cover_s"] = time.time() - t0
        stage_out["n_aligned"] = int(result.reads["aligned"].sum())
        stage_out["n_batches"] = pipe.n_batches
        stage_out["n_overflow"] = result.n_overflow
        stage_out["L_cap"] = None if pipe.use_ranges else pipe.L_cap
    return profile_from_fused_result(result, tables, index, db, cfg, out_dir,
                                     stage_out)


def _write_classification_tsv(out_path, keep_rows, ids, ridx, mapq, read_len,
                              sp_names) -> None:
    """reads_classification.tsv (id, mapq, species, read_len; no header),
    byte-identical to the reference's writers: tab-separated, fields quoted
    only where they hold a tab, quote or newline."""
    u_col = np.where(ridx >= 0, ridx, len(sp_names) - 1)
    species = [str(s) for s in sp_names]
    if ids is not None:
        id_col = [ids[i] for i in keep_rows]
    else:
        id_col = [f"R{i}" for i in keep_rows.tolist()]
    with open(out_path, "w", newline="") as f:
        csv.writer(f, delimiter="\t", lineterminator="\n").writerows(
            zip(id_col, mapq.tolist(), [species[u] for u in u_col.tolist()],
                read_len.tolist())
        )


def _lap(stage_out: dict | None, name: str, t0: float) -> float:
    """Record the seconds since ``t0`` as ``stage_out[name]``; returns now."""
    t = time.perf_counter()
    if stage_out is not None:
        stage_out[name] = t - t0
    return t


def profile_from_fused_result(result: FusedResult, tables: FusedTables,
                              index, db, cfg, out_dir,
                              stage_out: dict | None = None) -> bool:
    """Write the species + strain tables and reads_classification.tsv from a
    FusedPipeline.finish() result.  ``stage_out`` receives the stage
    seconds: species_s, strain_s (filters and PAO), report_s and
    classify_tsv_s."""
    reads = result.reads
    keep_rows = np.flatnonzero(reads["aligned"])
    out = os.fspath(out_dir)
    os.makedirs(out, exist_ok=True)
    ridx = reads["ridx"][keep_rows]
    mapq = reads["mapq"][keep_rows]
    read_len = reads["read_len"][keep_rows]
    sp_names = np.array([r.species for r in tables.ranges] + ["U"],
                        dtype=object)
    ok = _profile_fused_tail(tables, db, cfg, out,
                             (ridx, mapq, read_len, sp_names, result),
                             stage_out)
    t0 = time.perf_counter()
    _write_classification_tsv(os.path.join(out, "reads_classification.tsv"),
                              keep_rows, reads["ids"], ridx, mapq, read_len,
                              sp_names)
    _lap(stage_out, "classify_tsv_s", t0)
    return ok


def _tail_mode(tables: FusedTables, cfg) -> str:
    """The reference's tail choice: 'auto' keeps na/ta/bc on the device when
    their download would be large (>= 4 MB)."""
    mode = getattr(cfg, "tail", "auto")
    if mode in ("host", "device"):
        return mode
    return "device" if tables.N_pad * 8 + tables.U_pad * 4 >= 4 << 20 else "host"


def _ensure_tail_tables(tables: FusedTables):
    """The device tail's TailTables, built once per FusedTables."""
    from .profile_tail import build_tail_tables

    tt = getattr(tables, "_tail_tables", None)
    if tt is None:
        tt = tables._tail_tables = build_tail_tables(tables)
    return tt


def _device_tail_solve(tables: FusedTables, cfg, active, result,
                       stats_pre) -> list:
    """Strain filters and two-stage PAO over the device-resident na/ta/bc
    (ops/profile_tail.py): the stats launched by dispatch_tail_stats
    (``stats_pre``) collected, the first filter on the host, batched device
    solves.  Species whose valid-node count exceeds the node-sampling cap
    take the host solve (the sampling's RNG needs host rows).  Returns the
    OtuStates in ``active`` order."""
    from ..profile.engine import finish_two_stage, prepare_two_stage
    from .profile_tail import (
        collect_tail_stats, first_filter_from_stats, solve_two_stage_device,
    )

    if not active:
        return []
    tt = _ensure_tail_tables(tables)
    stats = collect_tail_stats(stats_pre)
    cap = 500 if cfg.sample_test else cfg.sample_nodes
    out_states, jobs, states, host_jobs = [], [], [], []
    for sp in active:
        si = sp.ridx
        names = sorted(sp.paths)
        state = _host.OtuState(otu=sp.range_.species,
                               hap_metrics=[_host.HapMetrics() for _ in names])
        first_filter_from_stats(state, si, tt, stats, names, cfg)
        out_states.append(state)
        if not state.possible_paths_idx:
            continue
        g_lo = int(tt.sp_hap_lo[si])
        for h in state.possible_paths_idx:
            pl = np.float32(tt.path_len[g_lo + h])
            pc = np.float32(stats.path_cov[g_lo + h])
            # the float32 division of the host matvec path (both sums are
            # exact integers)
            state.hap_metrics[h].path_cov_ratio = float(pc / pl) if pl > 0 else 0.0
        if cap and stats.sp_valid[si] > cap:
            host_jobs.append((sp, state))
        else:
            jobs.append((si, list(state.possible_paths_idx),
                         1.05 * float(stats.sp_max[si])))
            states.append(state)
    if jobs:
        solve_two_stage_device(tt, result.na_d, jobs, states, cfg, stats.sp_max)
    if host_jobs:
        hj = []
        for sp, state in host_jobs:
            sl = slice(sp.off, sp.off + sp.num_nodes)
            hj.append(prepare_two_stage(
                state, sp.num_nodes, sp.paths,
                result.na_d[sl].cpu().numpy().astype(np.float64),
                result.bc_d[sl].cpu().numpy(), sp.nodes_len, cfg))
        finish_two_stage(hj, cfg, device=tables.device)
    return out_states


def _profile_fused_tail(tables: FusedTables, db, cfg, out, profile_input,
                        stage_out: dict | None = None) -> bool:
    """Species stage, strain filters, two-stage PAO and report, over the
    host tail or the device tail (``_tail_mode``)."""
    from ..profile.engine import (
        finish_two_stage, first_filter_job, select_species,
    )
    from ..profile.report import abundance_constraint, abundance_est
    from ..profile.species import read_species_mean_len, species_profiling_codes

    ridx, mapq, read_len, sp_names, result = profile_input
    keep = ridx >= 0
    t0 = time.perf_counter()
    device_tail = cfg.strain and _tail_mode(tables, cfg) == "device"
    stats_pre = None
    if device_tail:
        # launched before the species stage, which it overlaps on a GPU
        from .profile_tail import dispatch_tail_stats

        stats_pre = dispatch_tail_stats(_ensure_tail_tables(tables),
                                        result.na_d, result.ta_d, result.bc_d,
                                        cfg.min_depth)
    profile = species_profiling_codes(
        ridx[keep], sp_names[:-1], read_len[keep], mapq[keep],
        read_species_mean_len(db.stats_file), filtered=cfg.filtered,
    )
    profile.save(os.path.join(out, "species_abundance.txt"))
    t0 = _lap(stage_out, "species_s", t0)
    if not cfg.strain:
        return True

    kept = {id(r) for r in select_species(
        cfg, [sp.range_ for sp in tables.species], profile)}
    selected = [sp for sp in tables.species if id(sp.range_) in kept]
    # species with zero classified reads are skipped entirely
    counts = np.bincount(ridx[keep].astype(np.int64),
                         minlength=len(tables.ranges))
    active = [sp for sp in selected if counts[sp.ridx]]

    if device_tail:
        states = _device_tail_solve(tables, cfg, active, result, stats_pre)
    else:
        node_abund, trio_abund, node_base_cov = result.host()
        prepared = []
        for sp in active:
            na = node_abund[sp.off:sp.off + sp.num_nodes]
            ta = trio_abund[sp.trio_lo:sp.trio_hi]
            bc = node_base_cov[sp.off:sp.off + sp.num_nodes]
            # FusedSpecies carries the graph's num_nodes and nodes_len
            prepared.append(first_filter_job(cfg, sp.range_.species, sp,
                                             sp.paths, sp.trio_index,
                                             (na, ta, bc)))
        finish_two_stage([j for _, j in prepared if j is not None], cfg,
                         device=tables.device)
        states = [state for state, _ in prepared]
    t0 = _lap(stage_out, "strain_s", t0)
    metrics = []
    for state in states:
        abundance_constraint(profile, state.hap_metrics)
        metrics.extend(state.hap_metrics)
    abundance_est(cfg, metrics, _host.read_genomes_info(db.genomes_info_file),
                  out)
    _lap(stage_out, "report_s", t0)
    return True
