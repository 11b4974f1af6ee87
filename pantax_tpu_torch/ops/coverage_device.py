"""Padded global coverage tables, the windowed coverage scatter and the
coverage finalize, PyTorch port of pantax_tpu/ops/coverage_device.py (the
parts the fused path uses: build_padded_tables :443, _coverage_scatter :110
and _coverage_finalize :303)."""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

# float32 holds every integer below 2^24 exactly; the accumulators sum
# integers, so their float32 image equals the reference's only below it
F32_EXACT = 1 << 24


def _pow2(n: int, lo: int = 256) -> int:
    m = lo
    while m < n:
        m *= 2
    return m


@dataclass
class PaddedCoverageTables:
    """Power-of-two padded node/base/trio tables.  Pad nodes have length 1
    and are never referenced by reads; pad trios have length 1."""

    nodes_len: np.ndarray    # int32 [N_pad]
    base_offset: np.ndarray  # int32 [N_pad + 1]
    trio_len: np.ndarray     # int32 [U_pad]
    N: int
    U: int
    N_pad: int
    TB_pad: int
    U_pad: int


def build_padded_tables(nodes_len, trio_len) -> PaddedCoverageTables:
    """Pad the global node and trio tables to power-of-two shapes (the same
    shapes the reference's build_padded_tables gives)."""
    nodes_len = np.asarray(nodes_len)
    N, U = len(nodes_len), len(trio_len)
    N_pad = _pow2(N + 1)
    nodes_len_p = np.ones(N_pad, dtype=np.int32)
    nodes_len_p[:N] = nodes_len
    base_offset = np.zeros(N_pad + 1, dtype=np.int32)
    np.cumsum(nodes_len_p, out=base_offset[1:])
    U_pad = _pow2(U, lo=64)
    trio_len_p = np.ones(U_pad, dtype=np.int32)
    trio_len_p[:U] = trio_len
    return PaddedCoverageTables(
        nodes_len=nodes_len_p, base_offset=base_offset, trio_len=trio_len_p,
        N=N, U=U, N_pad=N_pad, TB_pad=_pow2(int(base_offset[-1])),
        U_pad=U_pad,
    )


def _add(acc, idx, val) -> None:
    acc.index_add_(0, idx.reshape(-1).to(torch.int64),
                   val.reshape(-1).to(acc.dtype))


def coverage_scatter(nodes, lengths, read_start, read_end, nodes_len,
                     base_offset, acc, *, has_dups: bool,
                     trio_match=None) -> None:
    """Add the coverage of padded node-path rows to ``acc`` = (bases int64
    [N + 1], diff int32 [TB + 1], trio int64 [U + 1]) in place: the
    reference's first / middle / last base allocation, bases credited at a
    node's first occurrence within a row only, the per-base interval
    difference array, and each matched 3-window's allocation sum.

    ``nodes`` int [R, L] holds global 0-based node ids (-1 pad), ``lengths``
    the path length of each row (0 drops the row), ``read_start`` /
    ``read_end`` the offsets into the first node.  ``has_dups=False``
    promises that no node repeats within a row (every occurrence is then a
    first occurrence).  ``trio_match`` int [R, L - 2] is each window's
    unique-trio index or -1; without it no trio window is counted (the
    hash lookup of arbitrary node paths belongs to the GAF flow, ROADMAP
    M11).  The last slot of bases and trio is the sink of dropped entries;
    diff's last entry is the sentinel the finalize excludes."""
    acc_b, acc_d, acc_t = acc
    if has_dups and nodes.shape[1] > 64:
        raise NotImplementedError(
            "first-occurrence dedup over rows wider than 64 nodes (the sort "
            "and carry-scan formulation) is the GAF flow's: ROADMAP M11")
    i64 = torch.int64
    R, L = nodes.shape
    lengths, read_start, read_end = (a.to(i64) for a in
                                     (lengths, read_start, read_end))
    pos = torch.arange(L, device=nodes.device)[None, :]
    valid = pos < lengths[:, None]
    node_ids = torch.where(valid, nodes.to(i64), 0)
    nlen = nodes_len[node_ids].to(i64)

    is_first = pos == 0
    is_last = pos == (lengths - 1)[:, None]
    target = (read_end - read_start)[:, None]
    single = lengths[:, None] == 1
    alloc_nolast = torch.where(is_first, nlen - read_start[:, None], nlen)
    alloc_tmp = torch.where(valid, alloc_nolast, 0)
    seen_before = torch.cumsum(alloc_tmp, dim=1) - alloc_tmp
    alloc = torch.where(is_last, (target - seen_before).clamp(min=0),
                        alloc_nolast)
    alloc = torch.where(single, target, alloc)
    start_idx = torch.where(is_first | single, read_start[:, None], 0)
    dropped = single[:, 0] & (target[:, 0] < 0)
    valid = valid & ~dropped[:, None]
    alloc = torch.where(valid, alloc, 0)

    if has_dups:
        # k_first[r, j]: the first position of row r holding node[r, j].  The
        # first occurrence's allocation is gathered, in integers, where the
        # reference multiplies a float32 one-hot by it
        nid = torch.where(valid, node_ids, -1)
        eq = ((nid[:, None, :] == nid[:, :, None])
              & valid[:, None, :] & valid[:, :, None])  # [R, k, j]
        k_first = torch.where(eq, pos[:, :, None], L).amin(dim=1)
        first_occ = valid & (k_first == pos)
        per_pos_val = torch.where(
            valid, alloc.gather(1, k_first.clamp(max=L - 1)), 0)
    else:
        first_occ = valid
        per_pos_val = alloc

    _add(acc_b, torch.where(first_occ, node_ids, acc_b.shape[0] - 1),
         torch.where(first_occ, alloc, 0))

    lo_in = torch.minimum(start_idx.clamp(min=0), nlen)
    hi_in = torch.minimum(torch.maximum(start_idx + alloc, lo_in), nlen)
    bo = base_offset[node_ids].to(i64)
    in_bounds = ((read_start < read_end)[:, None]
                 & (read_end[:, None] <= nlen))
    keep = valid & (~single | in_bounds)
    TB = acc_d.shape[0] - 1
    d_lo = torch.where(keep, bo + lo_in, TB)
    d_hi = torch.where(keep, bo + hi_in, TB)
    _add(acc_d, d_lo, torch.ones_like(d_lo))
    _add(acc_d, d_hi, -torch.ones_like(d_hi))

    if trio_match is not None and L >= 3:
        w_valid = ((pos[:, :L - 2] + 2) < lengths[:, None]) & (
            lengths >= 3)[:, None]
        win_sum = per_pos_val[:, :-2] + per_pos_val[:, 1:-1] + per_pos_val[:, 2:]
        hit = w_valid & (trio_match >= 0)
        _add(acc_t, torch.where(hit, trio_match.to(i64), acc_t.shape[0] - 1),
             win_sum)


def coverage_finalize(bases_per_node, diff, trio_bases, nodes_len,
                      base_offset, trio_len):
    """Accumulated sums -> (node_abundance f32 [N], trio_abundance f32 [U],
    node_base_cov int32 [N]).  ``diff`` is the per-base difference array
    [TB + 1] (last entry the sentinel sink); ``bases_per_node`` and
    ``trio_bases`` are exact integer sums, converted to float32 here."""
    for name, acc in (("bases_per_node", bases_per_node),
                      ("trio_bases", trio_bases)):
        if acc.numel() and int(acc.abs().max()) >= F32_EXACT:
            raise ValueError(
                f"{name} holds a sum >= 2^24: float32 coverage would round"
            )
    covered = (torch.cumsum(diff[:-1], dim=0) > 0).to(torch.int64)
    prefix = torch.zeros(covered.shape[0] + 1, dtype=torch.int64,
                         device=diff.device)
    prefix[1:] = torch.cumsum(covered, dim=0)
    bo = base_offset.to(torch.int64)
    node_base_cov = (prefix[bo[1:]] - prefix[bo[:-1]]).to(torch.int32)
    f32 = torch.float32
    node_abundance = bases_per_node.to(f32) / nodes_len.clamp(min=1).to(f32)
    trio_abundance = trio_bases.to(f32) / trio_len.to(f32).clamp(min=1.0)
    return node_abundance, trio_abundance, node_base_cov
