"""Node / trio-node / per-base coverage from aligned reads on the host, the
port's copy of pantax_tpu/profile/coverage.py: the per-species flow's host
coverage (``node_abundances_packed`` over ``pack_reads``' rows; the
reference's ``node_abundances`` is the two in one call), and
``raw_contributions``, the fused
pipeline's host residual for reads that overflow the node window.

Parity: PanTax's src/profile.rs:742-1026 (get_node_abundances):

  Per read, aligned bases are distributed over its node path:
    - single-node path: the node gets (read_end - read_start) bases; the
      per-base interval [read_start, read_end) is marked covered (skipped when
      read_end exceeds the node or the span is negative);
    - multi-node path: the first node gets (len - read_start) bases starting at
      read_start, intermediate nodes their full length, the last node gets
      (read_end - read_start) - seen (clamped >= 0) starting at 0;
    - a node repeated within one read only receives bases at its first
      occurrence (the per-base marks still apply every time);
  Each 3-window of the read's node path that matches a unique trio (forward or
  reversed) adds the sum of the window nodes' per-read base contributions to
  that trio's count.

  Outputs: node_abundance[i] = bases_i / len_i, trio_abundance, and
  node_base_cov[i] = number of distinct covered bases of node i.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..graph.trio import TrioIndex
from .records import ReadRecord


@dataclass
class PackedReads:
    """Padded per-read node paths (local 0-based node ids; -1 padding)."""

    nodes: np.ndarray       # int64 [R, L] local node ids, -1 pad
    lengths: np.ndarray     # int64 [R] actual path lengths
    read_start: np.ndarray  # int64 [R]
    read_end: np.ndarray    # int64 [R]


def pack_reads(reads: list[ReadRecord], range_start: int) -> PackedReads:
    """Convert records (global 1-based node ids) to padded local-id arrays.

    Local id = global - range_start (optimize_otu: start = range.start - 1 then
    node - 1 - start, profile.rs:2886,790-793).
    """
    R = len(reads)
    L = max((len(r.nodes) for r in reads), default=1)
    nodes = np.full((R, max(L, 1)), -1, dtype=np.int64)
    lengths = np.zeros(R, dtype=np.int64)
    starts = np.zeros(R, dtype=np.int64)
    ends = np.zeros(R, dtype=np.int64)
    for i, r in enumerate(reads):
        n = len(r.nodes)
        nodes[i, :n] = r.nodes - range_start
        lengths[i] = n
        starts[i] = r.read_start
        ends[i] = r.read_end
    return PackedReads(nodes=nodes, lengths=lengths, read_start=starts, read_end=ends)


def _first_occurrence_and_broadcast(
    node_ids: np.ndarray, valid: np.ndarray, alloc: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """For each (read, position): whether it is the first occurrence of its
    node within the read, and the first-occurrence allocation of that node
    broadcast to every occurrence.  Sort-based, O(R·L log L)."""
    R, L = node_ids.shape
    rows = np.repeat(np.arange(R, dtype=np.int64), L)
    cols = np.tile(np.arange(L, dtype=np.int64), R)
    nod = node_ids.ravel()
    # invalid slots get a sentinel node so they form their own groups
    nod = np.where(valid.ravel(), nod, -1)
    order = np.lexsort((cols, nod, rows))
    r_s, n_s = rows[order], nod[order]
    group_start = np.ones(R * L, dtype=bool)
    group_start[1:] = (r_s[1:] != r_s[:-1]) | (n_s[1:] != n_s[:-1])
    # first occurrence in original layout
    first_occ = np.zeros(R * L, dtype=bool)
    first_occ[order] = group_start
    first_occ = first_occ.reshape(R, L) & valid
    # broadcast the group's first allocation to all members
    alloc_sorted = alloc.ravel()[order]
    group_ids = np.cumsum(group_start) - 1
    first_vals = alloc_sorted[group_start]
    bcast_sorted = first_vals[group_ids]
    bcast = np.empty(R * L, dtype=alloc.dtype)
    bcast[order] = bcast_sorted
    bcast = bcast.reshape(R, L)
    bcast = np.where(valid, bcast, 0)
    return first_occ, bcast


def _per_read_node_alloc(
    packed: PackedReads, nodes_len: np.ndarray
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Vectorized base allocation per (read, position).

    Returns (alloc, start_idx, first_occurrence, per_pos_val, valid), all [R, L]:
      alloc: bases allotted to the node at this path position;
      start_idx: offset within the node where the covered interval begins;
      first_occurrence: position is the first occurrence of its node in the read;
      per_pos_val: the read's total allocation to this position's node
        (first-occurrence value broadcast to duplicates);
      valid: position < path length (and read not dropped).
    """
    R, L = packed.nodes.shape
    pos = np.arange(L)[None, :]
    valid = pos < packed.lengths[:, None]
    node_ids = np.where(valid, packed.nodes, 0)
    nlen = nodes_len[node_ids]

    is_first_pos = pos == 0
    is_last_pos = pos == (packed.lengths - 1)[:, None]
    target_len = (packed.read_end - packed.read_start)[:, None]

    single = packed.lengths[:, None] == 1
    first_alloc = nlen - packed.read_start[:, None]
    alloc_nolast = np.where(is_first_pos, first_alloc, nlen)
    alloc_tmp = np.where(valid, alloc_nolast, 0)
    seen_before = np.cumsum(alloc_tmp, axis=1) - alloc_tmp
    last_alloc = np.maximum(target_len - seen_before, 0)
    alloc = np.where(is_last_pos, last_alloc, alloc_nolast)
    alloc = np.where(single, target_len, alloc)
    start_idx = np.where(is_first_pos | single, packed.read_start[:, None], 0)

    # single-node reads with negative span are dropped entirely
    # (profile.rs:820-830)
    dropped = single[:, 0] & (target_len[:, 0] < 0)
    valid = valid & ~dropped[:, None]
    alloc = np.where(valid, alloc, 0)

    first_occ, per_pos_val = _first_occurrence_and_broadcast(node_ids, valid, alloc)
    return alloc, start_idx, first_occ, per_pos_val, valid


def raw_contributions(
    packed: PackedReads,
    nodes_len: np.ndarray,
    trio_index: TrioIndex,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Sparse per-(read, position) coverage contributions in LOCAL space,
    before any reduction: (node_idx, bases_val, diff_lo, diff_hi, trio_idx,
    trio_val).  These are the exact addends node_abundances_packed (and the
    device _coverage_scatter) sums — exposed so the fused pipeline's
    L_cap-overflow residual path shares one implementation."""
    alloc, start_idx, first_occ, per_pos_val, valid = _per_read_node_alloc(
        packed, nodes_len
    )
    node_ids = np.where(valid, packed.nodes, 0)
    N = len(nodes_len)

    base_offset = np.zeros(N + 1, dtype=np.int64)
    np.cumsum(nodes_len, out=base_offset[1:])
    nlen = nodes_len[node_ids]
    lo_in = np.clip(start_idx, 0, nlen)
    hi_in = np.clip(start_idx + alloc, lo_in, nlen)
    iv_lo = base_offset[node_ids] + lo_in
    iv_hi = base_offset[node_ids] + hi_in
    # single-node reads mark [read_start, read_end) only when within bounds
    # (profile.rs:833-846)
    single = (packed.lengths == 1)[:, None] & valid
    in_bounds = (packed.read_start < packed.read_end)[:, None] & (
        packed.read_end[:, None] <= nlen
    )
    keep = valid & (~single | in_bounds)

    trio_idx = np.zeros(0, dtype=np.int64)
    trio_val = np.zeros(0, dtype=np.int64)
    R, L = node_ids.shape
    if L >= 3 and trio_index.num_unique > 0:
        w_valid = ((np.arange(L - 2)[None, :] + 2) < packed.lengths[:, None]) & (
            packed.lengths >= 3
        )[:, None]
        wins = np.stack(
            [node_ids[:, :-2], node_ids[:, 1:-1], node_ids[:, 2:]], axis=2
        )
        win_sum = per_pos_val[:, :-2] + per_pos_val[:, 1:-1] + per_pos_val[:, 2:]
        flat_wins = wins[w_valid]
        flat_sums = win_sum[w_valid]
        match = trio_index.match(flat_wins)
        hit = match >= 0
        trio_idx = match[hit]
        trio_val = flat_sums[hit]
    return (
        node_ids[first_occ].ravel(),
        alloc[first_occ].ravel(),
        iv_lo[keep],
        iv_hi[keep],
        trio_idx,
        trio_val,
    )


def node_abundances_packed(
    packed: PackedReads,
    nodes_len: np.ndarray,
    trio_index: TrioIndex,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(node_abundance, trio_node_abundance, node_base_cov) of padded read
    rows, float64 / float64 / int64."""
    N = len(nodes_len)
    node_idx, bases_val, lo, hi, trio_idx, trio_val = raw_contributions(
        packed, nodes_len, trio_index
    )

    # --- bases per node: only first occurrences contribute -----------------
    bases_per_node = np.bincount(
        node_idx, weights=bases_val.astype(np.float64), minlength=N
    )

    # --- exact per-base coverage via diff-array over the flat base space ---
    base_offset = np.zeros(N + 1, dtype=np.int64)
    np.cumsum(nodes_len, out=base_offset[1:])
    total_bases = int(base_offset[-1])
    node_base_cov = np.zeros(N, dtype=np.int64)
    if total_bases:
        diff = np.zeros(total_bases + 1, dtype=np.int64)
        np.add.at(diff, lo, 1)
        np.add.at(diff, hi, -1)
        covered = np.cumsum(diff[:-1]) > 0
        # per-node covered count via prefix sums (np.add.reduceat is an order
        # of magnitude slower here)
        cum = np.zeros(total_bases + 1, dtype=np.int64)
        np.cumsum(covered, out=cum[1:])
        node_base_cov = cum[base_offset[1:]] - cum[base_offset[:-1]]
        node_base_cov[nodes_len == 0] = 0

    # --- trio windows ------------------------------------------------------
    trio_bases = np.zeros(len(trio_index.trio_len), dtype=np.int64)
    if len(trio_idx):
        np.add.at(trio_bases, trio_idx, trio_val)

    node_abundance = bases_per_node / np.maximum(nodes_len, 1)
    trio_abundance = trio_bases / np.maximum(trio_index.trio_len, 1)
    return node_abundance, trio_abundance, node_base_cov
