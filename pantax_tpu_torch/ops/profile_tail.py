"""Device-resident strain-profiling tail, PyTorch port of
pantax_tpu/ops/profile_tail.py.

The fused pipeline ends with three dense arrays on the device (node
abundance, trio abundance, per-node covered bases).  The host tail
(ops/fused.py) downloads them, runs the strain filters in float64 numpy and
uploads every species' PAO matrix.  This tail keeps them on the device:

  1. ``dispatch_tail_stats`` reduces them to per-strain / per-species
     scalars (trio counts and zscore-filtered trio means, path base
     coverage, species nonzero mean, max and valid-node count), the only
     download (K9 on the card, one launch, ops/tail_kernels.py);
  2. ``first_filter_from_stats`` runs the first filter's branch logic on the
     host over those scalars, line for line with
     profile/filters.first_filter_paths;
  3. ``DeviceTailSolver`` builds each species' 0/1 path matrix on the device
     from static path tables (``TailTables``, built once per database), runs
     the batched ADMM of profile/pao.py (K8 on the card, one launch a
     chunk), and polishes on the device with a
     coordinate median in exact float32 elementwise sums (K10b on the card,
     one launch a bucket).  Only the [S, p] solutions come back.

The stats run in float32, as the reference's do, so they differ from the
host tail's float64 filters only in reduction rounding; the host tail stays
the exact path.  Matrix products run with TF32 off.
"""
from __future__ import annotations

import logging
from collections import deque
from dataclasses import dataclass

import numpy as np
import torch

from .. import _host
from ..profile.pao import _admm_chunk_batch, _bucket, _p_pad
from .extend import LAUNCHES
from .tail_kernels import polish_cuda, tail_stats_cuda

log = logging.getLogger("pantax_tpu_torch")


# ---------------------------------------------------------------------------
# static tables
# ---------------------------------------------------------------------------
@dataclass
class TailTables:
    """Static tables of the tail stats and the device PAO (built once per
    database, beside FusedTables)."""

    # device tensors, int32
    trio_hap: torch.Tensor       # [U_pad] owning global hap, G = pad
    path_node: torch.Tensor      # [Pn] global node ids grouped by hap
    path_hap: torch.Tensor       # [Pn] owning global hap (sorted)
    node_species: torch.Tensor   # [N_pad] species index, S = pad (sorted)
    # K9's slices (owner_tables): the real trios sorted by owner (stable),
    # each hap's slice of them, of path_node, and each species' nodes
    trio_order: torch.Tensor     # [U] trio indices, pads left out
    hap_trio_off: torch.Tensor   # [G + 1]
    hap_path_off: torch.Tensor   # [G + 1] hap_node_off on the device
    sp_node_span: torch.Tensor   # [2 S] sp_off, then sp_off + sp_nvert
    # host metadata
    hap_node_off: np.ndarray     # int64 [G + 1] slice of path_node per hap
    trio_count: np.ndarray       # int64 [G] unique trios owned per hap
    path_len: np.ndarray         # float64 [G] sum of node lengths over path
    hap_species: np.ndarray      # int32 [G] species index of each hap
    hap_local: np.ndarray        # int32 [G] hap index within its species
    sp_hap_lo: np.ndarray        # int64 [S + 1] hap slice per species
    sp_all_same: np.ndarray      # bool [S] all paths identical
    sp_m_size: np.ndarray        # int64 [S] hap_matrix.size per species
    sp_nvert: np.ndarray         # int64 [S]
    sp_off: np.ndarray           # int64 [S] global node offset
    G: int
    S: int


ORDER_FIELDS = ("trio_order", "hap_trio_off", "hap_path_off", "sp_node_span")


def owner_tables(trio_hap: np.ndarray, hap_node_off: np.ndarray,
                 sp_off: np.ndarray, sp_nvert: np.ndarray, G: int,
                 device) -> dict:
    """K9's slices, ORDER_FIELDS, as int32 tensors on ``device``: trio
    owners vary within a species, so the trios owned by a hap (owner < G;
    pads, owner G, left out) sorted by owner, stably, and each hap's
    offsets into them; hap_node_off; each species' node slice
    [sp_off, sp_off + sp_nvert), its starts then its ends."""
    trio_hap = np.asarray(trio_hap)
    order = np.argsort(trio_hap, kind="stable")
    hap_trio_off = np.searchsorted(trio_hap[order], np.arange(G + 1))
    sp_off = np.asarray(sp_off)
    arrays = (order[:hap_trio_off[G]], hap_trio_off, hap_node_off,
              np.concatenate([sp_off, sp_off + np.asarray(sp_nvert)]))
    return {name: torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32))
            .to(device) for name, a in zip(ORDER_FIELDS, arrays)}


def build_tail_tables(tables) -> TailTables:
    """TailTables of an ops.fused.FusedTables (its species carry paths, trio
    indices and global offsets), on the tables' device."""
    species = tables.species
    S = len(species)
    trio_hap = np.zeros(tables.U_pad, dtype=np.int32)
    path_node_parts: list[np.ndarray] = []
    trio_count: list[int] = []
    path_len: list[float] = []
    hap_species: list[int] = []
    hap_local: list[int] = []
    sp_hap_lo = np.zeros(S + 1, dtype=np.int64)
    sp_all_same = np.zeros(S, dtype=bool)
    sp_m_size = np.zeros(S, dtype=np.int64)
    sp_nvert = np.zeros(S, dtype=np.int64)
    sp_off = np.zeros(S, dtype=np.int64)
    g = 0
    for si, sp in enumerate(species):
        names = sorted(sp.paths)
        hm = np.asarray(sp.trio_index.hap_matrix)
        # each unique trio is owned by exactly one hap: the argmax of its
        # 0/1 row
        if hm.size:
            owner = np.argmax(hm, axis=1).astype(np.int64)
            trio_hap[sp.trio_lo:sp.trio_hi] = (g + owner).astype(np.int32)
        for h, name in enumerate(names):
            p = np.asarray(sp.paths[name], dtype=np.int64)
            path_node_parts.append((p + sp.off).astype(np.int32))
            trio_count.append(int((hm[:, h] > 0).sum()) if hm.size else 0)
            # float32 accumulation, as the host tail's matvec
            path_len.append(float(np.asarray(sp.nodes_len, dtype=np.float32)[p]
                                  .sum(dtype=np.float32)))
            hap_species.append(si)
            hap_local.append(h)
        path_list = [np.asarray(sp.paths[n]) for n in names]
        sp_all_same[si] = all(np.array_equal(path_list[0], q)
                              for q in path_list[1:])
        sp_m_size[si] = hm.size
        sp_nvert[si] = sp.num_nodes
        sp_off[si] = sp.off
        g += len(names)
        sp_hap_lo[si + 1] = g
    G = g
    # pad trios point at hap G, the dropped segment
    pad_mask = np.ones(tables.U_pad, dtype=bool)
    for sp in species:
        pad_mask[sp.trio_lo:sp.trio_hi] = False
    trio_hap[pad_mask] = G

    lens = [len(p) for p in path_node_parts]
    path_node = (np.concatenate(path_node_parts) if path_node_parts
                 else np.zeros(0, np.int32))
    hap_node_off = np.zeros(G + 1, dtype=np.int64)
    np.cumsum(lens, out=hap_node_off[1:])
    path_hap = np.repeat(np.arange(G, dtype=np.int32), lens)
    node_species = np.full(tables.N_pad, S, dtype=np.int32)
    for si, sp in enumerate(species):
        node_species[sp.off:sp.off + sp.num_nodes] = si

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(
            tables.device)

    return TailTables(
        trio_hap=put(trio_hap), path_node=put(path_node),
        path_hap=put(path_hap), node_species=put(node_species),
        **owner_tables(trio_hap, hap_node_off, sp_off, sp_nvert, G,
                       tables.device),
        hap_node_off=hap_node_off,
        trio_count=np.asarray(trio_count, dtype=np.int64),
        path_len=np.asarray(path_len, dtype=np.float64),
        hap_species=np.asarray(hap_species, dtype=np.int32),
        hap_local=np.asarray(hap_local, dtype=np.int32),
        sp_hap_lo=sp_hap_lo, sp_all_same=sp_all_same, sp_m_size=sp_m_size,
        sp_nvert=sp_nvert, sp_off=sp_off, G=G, S=S,
    )


# ---------------------------------------------------------------------------
# stats
# ---------------------------------------------------------------------------
def _seg_sum(vals, seg, n: int):
    """segment_sum over segments [0, n); index n (the pad) is dropped.  The
    sums take index_put_'s accumulation, which adds in one order every run
    (sorted on a card, serial on the CPU): index_add_'s float atomics on a
    card add in a run-dependent order, and two runs on one coverage then
    printed other strain tables."""
    out = torch.zeros(n + 1, dtype=vals.dtype, device=vals.device)
    out.index_put_((seg.to(torch.int64),), vals, accumulate=True)
    return out[:n]


def tail_stats_plain(na, ta, bc, trio_hap, path_node, path_hap, node_species,
                     min_depth: float, *, G: int, S: int):
    """Plain torch version of K9: per-hap nonzero trio count and
    zscore(3)-filtered nonzero trio mean, per-hap path base coverage, and
    per-species nonzero count / sum of the min_depth-clamped node abundance,
    max node abundance and valid-node count.  Float64 na and ta take the
    float sums and the steps between them in float64 (the exact sums K9's
    large cases are held to)."""
    f32 = torch.float32
    hap = trio_hap.clamp(0, max(G - 1, 0)).to(torch.int64)
    nz = (ta > 0.0).to(f32)
    c1 = _seg_sum(nz, trio_hap, G)
    s1 = _seg_sum(ta * nz, trio_hap, G)
    mu = s1 / torch.clamp(c1, min=1.0)
    dev = (ta - mu[hap]) * nz
    s2 = _seg_sum(dev * dev, trio_hap, G)
    sigma = torch.sqrt(s2 / torch.clamp(c1, min=1.0))
    # zscore_filter keeps |x - mu| / sigma < 3 strictly; sigma == 0 keeps
    # nothing (mean 0)
    kept = (nz > 0) & ((ta - mu[hap]).abs() < 3.0 * sigma[hap])
    k_cnt = _seg_sum(kept.to(f32), trio_hap, G)
    k_sum = _seg_sum(ta * kept, trio_hap, G)
    freq_mean = torch.where((sigma > 0.0) & (k_cnt > 0.0),
                            k_sum / torch.clamp(k_cnt, min=1.0), 0.0)

    # covered bases are integers: summed exactly, then float32
    path_cov = _seg_sum(bc[path_node.to(torch.int64)].to(torch.int64),
                        path_hap, G).to(f32)

    md = torch.tensor(min_depth, dtype=f32)
    na_opt = torch.where(na > md, na, 0.0)
    nz_n = (na_opt > 0.0).to(f32)
    sp_nz_cnt = _seg_sum(nz_n, node_species, S)
    sp_nz_sum = _seg_sum(na_opt * nz_n, node_species, S)
    sp_max = torch.full((S + 1,), -float("inf"), dtype=na.dtype,
                        device=na.device)
    sp_max.scatter_reduce_(0, node_species.to(torch.int64), na, "amax",
                           include_self=False)
    sp_valid = _seg_sum((na > 0.0).to(f32), node_species, S)
    return (c1, freq_mean, path_cov, sp_nz_cnt, sp_nz_sum, sp_max[:S],
            sp_valid)


@dataclass
class TailStats:
    c1: np.ndarray          # [G] nonzero unique-trio count
    freq_mean: np.ndarray   # [G] zscore-filtered nonzero trio-abundance mean
    path_cov: np.ndarray    # [G] covered bases summed over the hap's path
    sp_nz_mean: np.ndarray  # [S] mean of nonzero min_depth-clamped abundance
    sp_max: np.ndarray      # [S] max node abundance (-> ub)
    sp_valid: np.ndarray    # [S] count of nodes with abundance > 0


def dispatch_tail_stats(tt: TailTables, na, ta, bc, min_depth: float):
    """Launch the stats reductions, the reference's ``_tail_stats``: (c1,
    freq_mean, path_cov, sp_nz_cnt, sp_nz_sum, sp_max, sp_valid) as [G] /
    [S] float32.  The plain version where na lies on the CPU; on the card
    K9 (ops/tail_kernels.py), one launch, which reads tt's owner order
    (ORDER_FIELDS) in place of trio_hap, path_hap and node_species.
    Asynchronous on a CUDA device, so it overlaps host work until
    collect_tail_stats."""
    LAUNCHES["tail_stats_dispatch"] += 1
    if na.device.type == "cpu":
        LAUNCHES["tail_stats_plain"] += 1
        return tail_stats_plain(na, ta, bc, tt.trio_hap, tt.path_node,
                                tt.path_hap, tt.node_species, min_depth,
                                G=tt.G, S=tt.S)
    return tail_stats_cuda(na, ta, bc, tt.path_node,
                           tuple(getattr(tt, f) for f in ORDER_FIELDS),
                           min_depth, G=tt.G, S=tt.S)


def collect_tail_stats(out) -> TailStats:
    c1, freq_mean, path_cov, nz_cnt, nz_sum, sp_max, sp_valid = (
        a.cpu().numpy().astype(np.float64) for a in out)
    return TailStats(
        c1=c1, freq_mean=freq_mean, path_cov=path_cov,
        sp_nz_mean=np.where(nz_cnt > 0, nz_sum / np.maximum(nz_cnt, 1), 0.0),
        sp_max=sp_max, sp_valid=sp_valid,
    )


def compute_tail_stats(tt: TailTables, na, ta, bc, min_depth: float) -> TailStats:
    return collect_tail_stats(dispatch_tail_stats(tt, na, ta, bc, min_depth))


# ---------------------------------------------------------------------------
# first filter over the stats (host branch logic)
# ---------------------------------------------------------------------------
def first_filter_from_stats(state, si: int, tt: TailTables, stats: TailStats,
                            names: list[str], cfg) -> None:
    """profile/filters.first_filter_paths evaluated from the reduced stats:
    the same branches and the same rounding.  With exact (float64) stats it
    is bit-identical to first_filter_paths."""
    g_lo = int(tt.sp_hap_lo[si])
    orign_n_haps = len(names)
    m_size = int(tt.sp_m_size[si])
    for i, hap_id in enumerate(names):
        state.hap_metrics[i].otu = state.otu
        state.hap_metrics[i].hap_id = hap_id
    state.orign_n_haps = orign_n_haps
    state.hap2trio_nodes_m_size = m_size

    if orign_n_haps != 1 and m_size != 0:
        for h in range(orign_n_haps):
            g = g_lo + h
            trio_count = int(tt.trio_count[g])
            if trio_count == 0:
                continue
            fraction = float(stats.c1[g]) / trio_count
            state.hap_metrics[h].unique_trio_nodes_fraction = _host.round2(
                fraction)
            freq_mean = float(stats.freq_mean[g])
            if cfg.shift:
                if freq_mean >= 1.0:
                    shift_frac = cfg.unique_trio_nodes_fraction + (
                        0.8 - cfg.unique_trio_nodes_fraction
                    ) * freq_mean / 100.0
                    shift_frac = min(shift_frac, 0.8)
                else:
                    shift_frac = cfg.unique_trio_nodes_fraction * freq_mean
                if fraction < shift_frac:
                    continue
                state.hap_metrics[h].frequencies_mean = freq_mean
            else:
                if fraction < cfg.unique_trio_nodes_fraction:
                    continue
                state.hap_metrics[h].frequencies_mean = freq_mean
            state.possible_paths_idx.append(h)
    elif orign_n_haps != 1 and m_size == 0:
        if bool(tt.sp_all_same[si]):
            state.same_path_flag = True
            state.hap_metrics[0].frequencies_mean = _host.round2(
                float(stats.sp_nz_mean[si]))
            state.possible_paths_idx.append(0)
        else:
            state.possible_paths_idx = list(range(orign_n_haps))
    else:
        state.hap_metrics[0].frequencies_mean = _host.round2(
            float(stats.sp_nz_mean[si]))
        state.possible_paths_idx.append(0)


# ---------------------------------------------------------------------------
# device PAO: A built on the device, batched ADMM, device polish
# ---------------------------------------------------------------------------
def _full_f32_matmul() -> None:
    """TF32 (about three decimal digits) would move the ADMM iterate by
    more than its tolerance: the tail's products run in full float32."""
    torch.backends.cuda.matmul.allow_tf32 = False


def build_A_b(na, path_node, node_off, nvert, g_off, g_len, *, n_pad: int,
              p_pad: int, Lp: int):
    """[S, n_pad, p_pad] row-masked 0/1 coefficient matrices, [S, n_pad] b
    and the valid-row mask.  Rows are the species' node slice; rows with
    abundance 0 are zeroed in A and b, which is the host's row selection
    (a zero row adds |0 - 0| to the L1 objective for any x)."""
    S = node_off.shape[0]
    N = na.shape[0]
    dev = na.device
    ar = torch.arange(n_pad, dtype=torch.int32, device=dev)
    rows = node_off[:, None] + ar[None, :]
    in_range = ar[None, :] < nvert[:, None]
    b_raw = na[rows.clamp(0, N - 1)] * in_range
    valid = b_raw > 0.0

    Pn = path_node.shape[0]
    ln = torch.arange(Lp, dtype=torch.int32, device=dev)
    idx = g_off[:, :, None] + ln[None, None, :]              # [S, p_pad, Lp]
    live = ln[None, None, :] < g_len[:, :, None]
    node_g = path_node[idx.clamp(0, max(Pn - 1, 0))]
    row_local = node_g - node_off[:, None, None]
    in_slice = live & (row_local >= 0) & (row_local < n_pad)
    row_local = torch.where(in_slice, row_local, n_pad)      # parked row
    A = torch.zeros((S, n_pad + 1, p_pad), dtype=torch.float32, device=dev)
    s_idx = torch.arange(S, device=dev)[:, None, None]
    j_idx = torch.arange(p_pad, device=dev)[None, :, None]
    # duplicate path visits still set 1 (the host assigns, too)
    A[s_idx, row_local.to(torch.int64), j_idx] = 1.0
    A = A[:, :n_pad, :] * valid[:, :, None].to(torch.float32)
    b = torch.where(valid, b_raw, 0.0)
    return A, b, valid


def prepare_batch(na, path_node, node_off, nvert, g_off, g_len, scale, *,
                  n_pad: int, p_pad: int, Lp: int):
    """(A, b / scale, L) with L the batched Cholesky factor of A^T A + I."""
    _full_f32_matmul()
    A, b, _valid = build_A_b(na, path_node, node_off, nvert, g_off, g_len,
                             n_pad=n_pad, p_pad=p_pad, Lp=Lp)
    eye = torch.eye(p_pad, dtype=A.dtype, device=A.device)
    L = torch.linalg.cholesky(A.mT @ A + eye)
    return A, b / scale[:, None], L


def exact_residual(A, x):
    """A @ x as an unrolled elementwise sum: A is 0/1, so every product is
    exact and the sum's order is fixed (no matmul)."""
    p = A.shape[-1]
    r = A[..., 0] * x[..., 0:1]
    for j in range(1, p):
        r = r + A[..., j] * x[..., j:j + 1]
    return r


def polish_batch(A, b, x, ub, sweeps: int = 8):
    """Batched coordinate-median polish: exact L1 coordinate descent within
    the box [0, ub].  The plain version where A lies on the CPU; on the
    card K10b (ops/tail_kernels.py), one launch, x bit for bit (up to the
    sign of a zero)."""
    if A.device.type == "cpu":
        LAUNCHES["polish_plain"] += 1
        return polish_batch_plain(A, b, x, ub, sweeps)
    return polish_cuda(A, b, x, ub, sweeps)


def polish_batch_plain(A, b, x, ub, sweeps: int = 8, moved=None):
    """Plain torch version of K10b: a binary column's optimal step is the
    ((cnt-1)//2)-th order statistic of the negated residuals at its live
    rows, clipped to the box.  All math is elementwise float32.  Given a
    list ``moved``, appends for each sweep a bool [S]: whether any column's
    step of the instance was not 0 (K10b stops an instance after its first
    sweep without one)."""
    p = A.shape[-1]
    r = exact_residual(A, x) - b
    big = 3.4e38  # sorts after every live row
    x = x.clone()
    for _ in range(sweeps):
        still = torch.ones(x.shape[0], dtype=torch.bool, device=x.device)
        for j in range(p):
            col = A[:, :, j]
            m = col > 0.0
            cnt = m.sum(dim=1)
            srt = torch.sort(torch.where(m, -r, big), dim=1).values
            k = ((cnt - 1) // 2).clamp(min=0)
            tstar = torch.gather(srt, 1, k[:, None])[:, 0]
            t = torch.minimum(torch.maximum(tstar, -x[:, j]), ub[:, j] - x[:, j])
            t = torch.where(cnt > 0, t, 0.0)
            x[:, j] = x[:, j] + t
            r = r + col * t[:, None]
            if moved is not None:
                still &= t == 0
        if moved is not None:
            moved.append(~still)
    return x


def _pow2(n: int, lo: int = 64) -> int:
    m = lo
    while m < n:
        m *= 2
    return m


class DeviceTailSolver:
    """Two-stage PAO over device-resident abundances.

    Jobs are grouped into (n_pad, p_pad, Lp) buckets; each bucket keeps its
    A / b / Cholesky factor on the device between the first and the second
    solve.  Solutions are clipped, polished on the device, and downloaded as
    [S, p] blocks."""

    def __init__(self, tt: TailTables, na, jobs, sp_max: np.ndarray):
        """``jobs``: list of (si, possible local hap indices, ub);
        ``sp_max``: TailStats.sp_max, the ADMM's normalisation scale (the
        host's max(b), the species' max node abundance)."""
        self.tt = tt
        self.jobs = jobs
        self.sp_max = sp_max
        self.buckets: dict[tuple, list] = {}
        for ji, (si, possible, ub) in enumerate(jobs):
            g_lo = int(tt.sp_hap_lo[si])
            gs = [g_lo + h for h in possible]
            lens = [int(tt.hap_node_off[g + 1] - tt.hap_node_off[g]) for g in gs]
            key = (_bucket(max(int(tt.sp_nvert[si]), 1)), _p_pad(len(gs)),
                   _pow2(max(max(lens, default=1), 1)))
            self.buckets.setdefault(key, []).append((ji, si, gs, lens, ub))
        self._na = na
        self._prepared: dict[tuple, dict] = {}

    def _prepare(self) -> None:
        tt = self.tt
        dev = self._na.device
        for key, rows in self.buckets.items():
            n_pad, p_pad, Lp = key
            S = len(rows)
            node_off = np.zeros(S, dtype=np.int32)
            nvert = np.zeros(S, dtype=np.int32)
            g_off = np.zeros((S, p_pad), dtype=np.int32)
            g_len = np.zeros((S, p_pad), dtype=np.int32)
            scale = np.ones(S, dtype=np.float32)
            ub_nrm = np.zeros((S, p_pad), dtype=np.float32)
            for s, (_ji, si, gs, lens, ub) in enumerate(rows):
                node_off[s] = int(tt.sp_off[si])
                nvert[s] = int(tt.sp_nvert[si])
                for j, (g, ln) in enumerate(zip(gs, lens)):
                    g_off[s, j] = int(tt.hap_node_off[g])
                    g_len[s, j] = ln
                sc = float(self.sp_max[si])
                scale[s] = sc if sc > 0 else 1.0
                ub_nrm[s, :len(gs)] = ub / scale[s]
            A, b, L = prepare_batch(
                self._na, tt.path_node, *(torch.from_numpy(a).to(dev) for a in
                                          (node_off, nvert, g_off, g_len, scale)),
                n_pad=n_pad, p_pad=p_pad, Lp=Lp)
            self._prepared[key] = {"A": A, "b": b, "L": L, "scale": scale,
                                   "ub": ub_nrm, "rows": rows}

    def solve(self, ub_vec_of=None, iters: int = 1500, chunk: int = 250,
              tol: float = 1e-5, only_jobs: set | None = None
              ) -> list[np.ndarray | None]:
        """One batched solve pass; returns per-job x arrays [p] (None for
        jobs in skipped buckets).  ``ub_vec_of(ji, p) -> [p] ub vector or
        None`` sets per-path bounds (the second solve pins dropped paths
        with ub 0); ``only_jobs`` skips the buckets that hold none of the
        listed job indices."""
        if not self._prepared:
            self._prepare()
        _full_f32_matmul()
        dev = self._na.device
        results: list[np.ndarray | None] = [None] * len(self.jobs)
        runs = []
        for prep in self._prepared.values():
            rows = prep["rows"]
            if only_jobs is not None and not any(r[0] in only_jobs for r in rows):
                continue
            ub = prep["ub"]
            if ub_vec_of is not None:
                ub = ub.copy()
                for s, (ji, _si, gs, _lens, _ub) in enumerate(rows):
                    v = ub_vec_of(ji, len(gs))
                    if v is not None:
                        ub[s, :len(gs)] = v / prep["scale"][s]
            S, n_pad, p_pad = prep["A"].shape
            x0 = torch.zeros((S, p_pad), dtype=torch.float32, device=dev)
            z0 = torch.zeros((S, n_pad), dtype=torch.float32, device=dev)
            runs.append({"prep": prep, "ub": torch.from_numpy(ub).to(dev),
                         "state": (x0, z0, x0, z0, x0),
                         "left": max(iters // chunk, 1), "prev": None})

        def step(r):
            LAUNCHES["admm_chunk_dispatch"] += 1
            r["state"], r["res"] = _admm_chunk_batch(
                r["prep"]["A"], r["prep"]["b"], r["ub"], 1.0, r["state"],
                r["prep"]["L"], chunk, binary=True)  # build_A_b's 0/1 A
            r["left"] -= 1

        # round-robin over buckets: every bucket keeps a chunk in flight
        # while one bucket's residual is read; each bucket's chunk sequence
        # and stop decisions are those of a sequential loop
        q = deque(runs)
        for r in runs:
            step(r)
        while q:
            r = q.popleft()
            res = float(r["res"].max())
            # stop on tol, or on a low plateau (the float32 residual floors
            # around 2-3e-4); a plateau at a high residual keeps iterating
            plateau = (r["prev"] is not None and res > 0.9 * r["prev"]
                       and res < 100 * tol)
            r["prev"] = res
            if res < tol or plateau:
                continue
            if r["left"] > 0:
                step(r)
                q.append(r)
            else:
                log.warning(
                    "device ADMM bucket stopped at its %d-iteration cap with "
                    "residual %.3g (tolerance %.1g); the device polish takes "
                    "over", iters, res, tol)
        for r in runs:
            prep = r["prep"]
            x = torch.minimum(torch.clamp(r["state"][2], min=0.0), r["ub"])
            LAUNCHES["polish_dispatch"] += 1
            X = polish_batch(prep["A"], prep["b"], x, r["ub"]).cpu().numpy()
            for s, (ji, _si, gs, _lens, _ub) in enumerate(prep["rows"]):
                results[ji] = (X[s, :len(gs)].astype(np.float64)
                               * float(prep["scale"][s]))
        return results


def solve_two_stage_device(tt: TailTables, na, jobs, states, cfg,
                           sp_max: np.ndarray) -> None:
    """The device counterpart of profile/engine.finish_two_stage: batched
    first solves, the host second filter, then batched second solves with
    the dropped paths pinned to 0.  ``jobs[i] = (si, possible local hap
    indices, ub)`` goes with ``states[i]``."""
    solver = DeviceTailSolver(tt, na, jobs, sp_max)
    firsts = solver.solve()
    for (_si, possible, _ub), state, x in zip(jobs, states, firsts):
        for j, h in enumerate(possible):
            state.hap_metrics[h].first_sol = float(x[j])
        _host.second_filter_paths(state, cfg)

    second = {i for i, st in enumerate(states) if st.second_opt}
    if not second:
        return

    def ub_vec_of(ji: int, p: int):
        if ji not in second:
            return None  # bounds unchanged; the result is discarded
        _si, possible, ub = jobs[ji]
        keep = states[ji].second_possible_paths_idx
        return np.array([ub if h in keep else 0.0 for h in possible])

    seconds = solver.solve(ub_vec_of=ub_vec_of, only_jobs=second)
    for ji in sorted(second):
        _si, possible, _ub = jobs[ji]
        st = states[ji]
        for j, h in enumerate(possible):
            if h in st.second_possible_paths_idx:
                st.hap_metrics[h].second_sol = float(seconds[ji][j])
