"""Device coverage, PyTorch port of pantax_tpu/ops/coverage_device.py:
power-of-two padded graph tables with the unique trios' hash table
(build_padded_tables :443, build_hash_lookup :38, _mix3 :30), the coverage
scatter of padded node-path rows (_coverage_scatter :110) with both
first-occurrence dedups (switched at MASK_DEDUP_MAX_L, not the reference's
64) and both trio lookups, the coverage finalize
(_coverage_finalize :303), and the per-species coverage program of the GAF
flow (node_abundances_device :480, without a mesh).

Hashes are uint32 in the reference.  Torch's uint32 lacks most kernels, so
they are carried in int64 and masked to 32 bits after each multiply
(align.aligner._mul32)."""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..align.aligner import _M32, _mul32

# float32 holds every integer below 2^24 exactly; the accumulators sum
# integers, so their float32 image equals the reference's only below it
F32_EXACT = 1 << 24
# rows of at most this many nodes take the mask form of the first-occurrence
# dedup ([R, L, L]), wider ones the sort form.  On an H100 the mask form is
# faster at 4 and 16 nodes, the two tie at 32, and at 64 the sort form is
# faster with 2.5x less memory (scripts/time_coverage.py); the reference
# switches at 64
MASK_DEDUP_MAX_L = 16


def _pow2(n: int, lo: int = 256) -> int:
    m = lo
    while m < n:
        m *= 2
    return m


def mix3(a, b, c):
    """32-bit hash of a canonical (a, b, c) node triple; int64 tensors of
    non-negative ids in, int64 holding the uint32 hash out."""
    h = _mul32(a & _M32, 0x9E3779B1)
    h = _mul32(h ^ (b & _M32), 0x85EBCA6B)
    h = _mul32(h ^ (c & _M32), 0xC2B2AE35)
    return h ^ (h >> 16)


def build_hash_lookup(hash_sorted: np.ndarray, n_real: int):
    """(bucket_lo int32 [nb+1], bits, steps, probes) for hash_bisect_left:
    the table's entries bucketed by the top ``bits`` of the uniform hash,
    ``steps`` bisection rounds inside the fullest bucket, and ``probes``
    the longest run of equal hashes among the n_real live entries (the
    sentinel pad run is excluded: sentinels never match a probe's node
    check), so the linear probe depth is exact."""
    hs = np.asarray(hash_sorted, dtype=np.uint64)[:n_real]  # exclude sentinel
    bits = int(np.clip(int(np.ceil(np.log2(max(n_real, 2)))) + 2, 8, 22))
    nb = 1 << bits
    bounds = np.arange(nb + 1, dtype=np.uint64) << np.uint64(32 - bits)
    lo = np.searchsorted(hs, bounds, side="left").astype(np.int32)
    occ = int(np.diff(lo).max()) if nb else 0
    steps = int(np.ceil(np.log2(occ + 1))) + 1 if occ > 0 else 0
    if n_real > 1:
        brk = np.flatnonzero(np.diff(hs[:n_real]) != 0)  # longest equal run
        edges = np.concatenate([[-1], brk, [n_real - 1]])
        best = int(np.diff(edges).max())
    else:
        best = 1
    return lo, bits, steps, max(best, 1)


def hash_bisect_left(table, bucket_lo, bits: int, steps: int, h):
    """searchsorted(table, h, side='left') by bisection inside h's bucket
    (table ascending uint32 held in int64, h likewise)."""
    U = table.shape[0]
    b = h >> (32 - bits)
    lo = bucket_lo[b]
    hi = bucket_lo[b + 1]
    for _ in range(steps):
        mid = (lo + hi) >> 1
        go = table[mid.clamp(0, U - 1)] < h
        open_ = lo < hi
        lo = torch.where(open_ & go, mid + 1, lo)
        hi = torch.where(open_ & ~go, mid, hi)
    return lo


def trio_hash_table(trio_nodes: np.ndarray):
    """The unique trios in hash order: (hash uint32 [U], order int32 [U] ->
    trio index, canonical triples int32 [U, 3]) — the trio half of the
    reference's DeviceGraphCoverageTables.build (:92)."""
    tn = np.asarray(trio_nodes, dtype=np.int64).reshape(-1, 3)
    t = torch.from_numpy(tn)
    h = mix3(t[:, 0], t[:, 1], t[:, 2]).numpy().astype(np.uint32)
    order = np.argsort(h, kind="stable").astype(np.int32)
    return h[order], order, tn[order].astype(np.int32)


@dataclass
class TrioLookup:
    """The padded unique-trio hash table on a device, for coverage_scatter's
    trio lookup when no per-window ``trio_match`` is given: hashes (int64
    holding uint32, sentinel 0xFFFFFFFF), trio index and canonical triple
    (-1 rows in the pad) per entry in hash order, the bucket table and its
    static bisection and probe depths."""

    hash: torch.Tensor    # int64 [U_pad]
    order: torch.Tensor   # int64 [U_pad]
    abc: torch.Tensor     # int64 [U_pad, 3]
    bucket: torch.Tensor  # int64 [nb + 1]
    bits: int
    steps: int
    probes: int


@dataclass
class PaddedCoverageTables:
    """Power-of-two padded node/base/trio tables.  Pad nodes have length 1
    and are never referenced by reads; pad trios have length 1 (and, with
    the hash table, a sentinel hash and no triple)."""

    nodes_len: np.ndarray    # int32 [N_pad]
    base_offset: np.ndarray  # int32 [N_pad + 1]
    trio_len: np.ndarray     # int32 [U_pad]
    N: int
    U: int
    N_pad: int
    TB_pad: int
    U_pad: int
    # (hash uint32, order int32, abc int32 [U_pad, 3], bucket int32, bits,
    # steps, probes) when build_padded_tables was given the trios
    trio_hash: tuple | None = None

    def trio_lookup(self, device) -> TrioLookup:
        """The trio hash table as int64 tensors on ``device``."""
        *arrays, bits, steps, probes = self.trio_hash
        return TrioLookup(*(torch.from_numpy(a.astype(np.int64)).to(device)
                            for a in arrays), bits, steps, probes)


def build_padded_tables(nodes_len, trio_len,
                        trio_nodes=None) -> PaddedCoverageTables:
    """Pad the node and trio tables to power-of-two shapes (the same shapes
    the reference's build_padded_tables gives); with ``trio_nodes``, also
    the unique trios' padded hash table for the trio lookup."""
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
    trio_hash = None
    if trio_nodes is not None:
        h, order, abc = trio_hash_table(trio_nodes)
        h_p = np.full(U_pad, np.iinfo(np.uint32).max, dtype=np.uint32)
        h_p[:U] = h
        order_p = np.zeros(U_pad, dtype=np.int32)
        order_p[:U] = order
        abc_p = np.full((U_pad, 3), -1, dtype=np.int32)
        abc_p[:U] = abc
        trio_hash = (h_p, order_p, abc_p, *build_hash_lookup(h_p, U))
    return PaddedCoverageTables(
        nodes_len=nodes_len_p, base_offset=base_offset, trio_len=trio_len_p,
        N=N, U=U, N_pad=N_pad, TB_pad=_pow2(int(base_offset[-1])),
        U_pad=U_pad, trio_hash=trio_hash,
    )


def _add(acc, idx, val) -> None:
    acc.index_add_(0, idx.reshape(-1).to(torch.int64),
                   val.reshape(-1).to(acc.dtype))


def coverage_scatter(nodes, lengths, read_start, read_end, nodes_len,
                     base_offset, acc, *, has_dups: bool,
                     trio_match=None, trio_lookup: TrioLookup | None = None
                     ) -> None:
    """Add the coverage of padded node-path rows to ``acc`` = (bases int64
    [N + 1], diff int32 [TB + 1], trio int64 [U + 1]) in place: the
    reference's first / middle / last base allocation, bases credited at a
    node's first occurrence within a row only, the per-base interval
    difference array, and each matched 3-window's allocation sum.

    ``nodes`` int [R, L] holds global 0-based node ids (-1 pad), ``lengths``
    the path length of each row (0 drops the row), ``read_start`` /
    ``read_end`` the offsets into the first node.  ``has_dups=False``
    promises that no node repeats within a row (every occurrence is then a
    first occurrence); otherwise rows of at most MASK_DEDUP_MAX_L nodes
    take the mask form of the dedup and wider ones the sort form (the
    reference switches at 64; both forms give its sums at every width).
    ``trio_match`` int [R, L - 2] is each window's unique-trio index or -1
    (the fused path's precomputed matches); else ``trio_lookup`` finds each
    window's trio in the hash table; with neither no trio window is
    counted.  The last slot of bases and trio is the sink of dropped
    entries; diff's last entry is the sentinel the finalize excludes."""
    acc_b, acc_d, acc_t = acc
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

    if has_dups and L <= MASK_DEDUP_MAX_L:
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
    elif has_dups:
        # sort each row's (node id, position) keys: unique within a row, so
        # each node's positions come out ascending (pads sort last) and the
        # sorted keys carry the permutation.  A group's start is its first
        # occurrence, and the latest start at or before each sorted slot (a
        # running max of start positions) carries its allocation
        shift = max(L - 1, 1).bit_length()
        key = (torch.where(valid, node_ids, torch.iinfo(torch.int32).max)
               << shift) | pos
        key = torch.sort(key, dim=1).values
        order = key & ((1 << shift) - 1)
        node_sorted = key >> shift
        is_start = torch.ones_like(valid)
        is_start[:, 1:] = node_sorted[:, 1:] != node_sorted[:, :-1]
        start_at = torch.where(is_start, pos, 0).cummax(dim=1).values
        bcast_sorted = alloc.gather(1, order).gather(1, start_at)
        first_occ = torch.zeros_like(valid).scatter_(1, order, is_start) & valid
        per_pos_val = torch.where(
            valid, torch.zeros_like(alloc).scatter_(1, order, bcast_sorted), 0)
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

    if (trio_match is not None or trio_lookup is not None) and L >= 3:
        w_valid = ((pos[:, :L - 2] + 2) < lengths[:, None]) & (
            lengths >= 3)[:, None]
        win_sum = per_pos_val[:, :-2] + per_pos_val[:, 1:-1] + per_pos_val[:, 2:]
        if trio_match is None:
            trio_match = lookup_trios(node_ids, trio_lookup)
        hit = w_valid & (trio_match >= 0)
        _add(acc_t, torch.where(hit, trio_match.to(i64), acc_t.shape[0] - 1),
             win_sum)


def lookup_trios(node_ids, t: TrioLookup):
    """Each 3-window of ``node_ids`` [R, L] (int64) canonicalized, hashed,
    located by bucketed bisection and verified by a linear probe over the
    equal-hash run: its unique-trio index, or -1.  [R, L - 2] int64."""
    R, L = node_ids.shape
    wa, wb, wc = node_ids[:, :-2], node_ids[:, 1:-1], node_ids[:, 2:]
    flip = wa > wc
    ca = torch.where(flip, wc, wa).reshape(-1)
    cc = torch.where(flip, wa, wc).reshape(-1)
    wb = wb.reshape(-1)
    idx0 = hash_bisect_left(t.hash, t.bucket, t.bits, t.steps,
                            mix3(ca, wb, cc))
    U = t.hash.shape[0]
    match = torch.full_like(idx0, -1)
    for probe in range(t.probes):  # the first hit wins
        cand = (idx0 + probe).clamp(0, U - 1)
        abc = t.abc[cand]
        hit = ((abc[:, 0] == ca) & (abc[:, 1] == wb) & (abc[:, 2] == cc)
               & (match < 0))
        match = torch.where(hit, t.order[cand], match)
    return match.reshape(R, L - 2)


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


def node_abundances_device(packed, nodes_len, trio_index, *, device):
    """One species' (node_abundance, trio_abundance, node_base_cov) from
    PackedReads on ``device``: the rows padded to power-of-two shapes, one
    coverage_scatter with the first-occurrence dedup and the trio hash
    lookup, one coverage_finalize.  Returns host numpy (float64 from the
    float32 finalize, float64, int32), bit-identical to the reference's."""
    t = build_padded_tables(nodes_len, trio_index.trio_len,
                            trio_index.trio_nodes)
    dev = torch.device(device)
    R, L = packed.nodes.shape
    R_pad, L_pad = _pow2(R), _pow2(max(L, 4), lo=4)

    def put(a):
        return torch.from_numpy(a).to(dev)

    def padded(col, shape, fill):
        a = np.full(shape, fill, dtype=np.int32)
        a[tuple(slice(0, n) for n in col.shape)] = col
        return put(a)

    rows = [padded(packed.nodes, (R_pad, L_pad), -1)] + [
        padded(col, (R_pad,), 0)
        for col in (packed.lengths, packed.read_start, packed.read_end)]
    nodes_len_d, base_offset_d = put(t.nodes_len), put(t.base_offset)
    acc = (torch.zeros(t.N_pad + 1, dtype=torch.int64, device=dev),
           torch.zeros(t.TB_pad + 1, dtype=torch.int32, device=dev),
           torch.zeros(t.U_pad + 1, dtype=torch.int64, device=dev))
    coverage_scatter(*rows, nodes_len_d, base_offset_d, acc,
                     has_dups=True, trio_lookup=t.trio_lookup(dev))
    na, ta, bc = coverage_finalize(acc[0][:t.N_pad], acc[1], acc[2][:t.U_pad],
                                   nodes_len_d, base_offset_d,
                                   put(t.trio_len))
    return (na[:t.N].cpu().numpy().astype(np.float64),
            ta[:t.U].cpu().numpy().astype(np.float64),
            bc[:t.N].cpu().numpy())
