"""The query's seed stage: K3, per read from the unpacked forward codes to
the K extension candidates (diagonal, votes, strand).

The JAX package computes this stage inside its one jitted query function
(pantax_tpu/align/aligner.py: ``_kmer_hashes_j`` :226, ``_select_seeds``
:246, ``_lookup_hits`` :269, ``_vote_diagonals`` :340 and the strand union
of ``_all_candidates`` :537-549), which XLA fuses into device code.  Two
versions here:

- the CUDA kernel, ``csrc/seed_stage.cu``, built with nvcc for sm_90a at
  first use into the git-ignored build directory (ops/extend.py's
  ``compile_kernels``) and bound with ctypes.  One warp per read at 32
  registers: rolling uint32 hashes, each sampled position's hash kept in
  shared memory and ranked by a warp scan (no seed hashed twice), one
  lane per seed for the lookup (CHD or bucketed bisection), the valid
  hits compacted in slot order and voted on both strands by a shared-
  memory broadcast with a borrow-and-carry band test, warp-max rounds
  for top_k and the strand union.  Its bound (chip_smoke.seed_bound) is
  instruction issue: 16 instructions a k-mer position inside read_len and
  2.5 a pair of valid hits on each strand;
- ``seed_candidates_plain``, the plain torch stage (``kmer_hashes`` ->
  ``select_seeds`` -> ``lookup_hits`` -> ``vote_diagonals`` on each strand
  -> the union).  Torch's uint32 lacks most kernels, so its hashes are
  carried in int64 and masked to 32 bits after each multiply (``_mul32``).

``seed_candidates`` takes the plain version only for CPU tensors.  On a
CUDA tensor it launches the kernel or raises; nothing falls back.  Every
output is an integer, and the two versions agree bit for bit.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .extend import LAUNCHES, compile_kernels

_M32 = 0xFFFFFFFF
_CHD_GOLD = 0x9E3779B9  # displacement salt (build/device must agree)
_HASH_BASE = 0x9E3779B1
BIG = 2**30  # the diagonal of an invalid hit

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "seed_stage.cu"
# the kernel's limits (csrc/seed_stage.cu): read width, seeds x hits, top_k
MAX_WIDTH, MAX_SLOTS, MAX_TOP_K = 8192, 256, 8


# ---------------------------------------------------------------------------
# plain torch
# ---------------------------------------------------------------------------
def _mul32(h, c: int):
    """(h * c) mod 2^32 for h in [0, 2^32) held in int64, without int64
    overflow: split the constant into 16-bit halves."""
    lo = h * (c & 0xFFFF)
    hi = ((h * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _mix32(h):
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def kmer_hashes(codes, k: int):
    """codes int8 [B, L] -> (mixed canonical hash, int64 holding uint32
    [B, n], valid bool [B, n])."""
    B, L = codes.shape
    n = L - k + 1
    c = codes.to(torch.int64)
    pows = [1]
    for _ in range(1, k):
        pows.append((pows[-1] * _HASH_BASE) & _M32)
    hf = torch.zeros((B, n), dtype=torch.int64, device=codes.device)
    hr = torch.zeros_like(hf)
    invalid = torch.zeros((B, n), dtype=torch.bool, device=codes.device)
    for i in range(k):
        ci = c[:, i:i + n]
        hf = (hf + ci * pows[k - 1 - i]) & _M32
        hr = (hr + (3 - ci) * pows[i]) & _M32
        invalid |= ci == 4
    return _mix32(torch.minimum(hf, hr)), ~invalid


def select_seeds(hashes, valid, density_bits: int, s_max: int):
    """The first s_max sampled positions per read (-1 padded), their hashes
    and validity.  Each sampled position's rank is unique in its row, so a
    scatter places it; unsampled positions write -1 / 0 to a sink column."""
    mask = valid & ((hashes & ((1 << density_bits) - 1)) == 0)
    B, n = mask.shape
    rank = torch.cumsum(mask.to(torch.int32), dim=1)
    keep = mask & (rank <= s_max)
    slot = torch.where(keep, rank - 1, s_max).to(torch.int64)
    pos = torch.arange(n, dtype=torch.int32, device=mask.device).expand(B, n)
    sel_pos = torch.full((B, s_max + 1), -1, dtype=torch.int32,
                         device=mask.device)
    sel_pos.scatter_(1, slot, torch.where(keep, pos, -1))
    sel_hash = torch.zeros((B, s_max + 1), dtype=torch.int64,
                           device=mask.device)
    sel_hash.scatter_(1, slot, torch.where(keep, hashes, 0))
    sel_pos, sel_hash = sel_pos[:, :s_max], sel_hash[:, :s_max]
    return sel_pos, sel_hash, sel_pos >= 0


def lookup_hits(run_table, seed_pos, bucket_lo, bucket_bits: int, steps: int,
                sel_hash, sel_valid, hits_per_seed: int):
    """Text positions of each read seed, [B, S, C] int32, and their validity:
    the CHD slot table (steps < 0) or bucketed bisection (steps >= 0)."""
    D = run_table.shape[0]
    b = sel_hash >> (32 - bucket_bits)
    c = torch.arange(hits_per_seed, device=sel_hash.device)
    if steps < 0:
        if run_table.shape[-1] != 2 + hits_per_seed:
            raise ValueError("CHD table width does not match hits_per_seed")
        d = bucket_lo[b].to(torch.int64) & _M32
        slot = _mix32(sel_hash ^ _mul32(d, _CHD_GOLD)) & (D - 1)
        row = run_table[slot]
        key = row[..., 0].to(torch.int64) & _M32
        ok = (key == sel_hash) & sel_valid
        rlen = torch.where(ok, row[..., 1], 0)
        return row[..., 2:], ok[..., None] & (c < rlen[..., None])
    S_len = seed_pos.shape[0]
    lo = bucket_lo[b]
    hi = bucket_lo[b + 1]
    lo_s, hi_s = lo, hi
    keys_col = run_table[:, 0].to(torch.int64) & _M32
    for _ in range(steps):
        mid = (lo_s + hi_s) >> 1
        key_mid = keys_col[mid.clamp(0, D - 1)]
        go_right = (key_mid < sel_hash) & (lo_s < hi_s)
        lo_s = torch.where(go_right, mid + 1, lo_s)
        hi_s = torch.where(go_right, hi_s, torch.maximum(mid, lo_s))
    row = run_table[lo_s.clamp(0, D - 1)]
    key_j = row[..., 0].to(torch.int64) & _M32
    found = (key_j == sel_hash) & (lo_s < hi) & sel_valid
    idx = row[..., 1][..., None] + c
    pos = seed_pos[idx.clamp(0, S_len - 1)]
    return pos, found[..., None] & (c < row[..., 2][..., None])


def vote_diagonals(diags, valid, band: int, top_k: int):
    """Top-k candidate diagonals per read by vote count within +-band
    (pairwise counts, then argmax with kill-within-band)."""
    d = torch.where(valid, diags, BIG)
    close = ((d[:, :, None] - d[:, None, :]).abs() <= band)
    close &= valid[:, None, :] & valid[:, :, None]
    counts = close.sum(dim=2, dtype=torch.int32)
    del close
    cand_d, cand_v = [], []
    for _ in range(top_k):
        best = torch.argmax(counts, dim=1, keepdim=True)  # first index on ties
        bd = torch.gather(d, 1, best)
        cand_d.append(bd[:, 0])
        cand_v.append(torch.gather(counts, 1, best)[:, 0])
        counts = torch.where((d - bd).abs() <= band, 0, counts)
    return torch.stack(cand_d, dim=1), torch.stack(cand_v, dim=1)


def seed_candidates_plain(codes_fwd, read_len, run_table, seed_pos, bucket_lo,
                          cfg_static):
    """Plain torch version of K3: (cand_diag int32 [B, K], cand_votes int32
    [B, K], strand int8 [B, K]).  Seeds are hashed and looked up once, on
    the forward strand; a hit's reverse-strand diagonal is t - (l - k - p)."""
    k, density_bits, bucket_bits, steps, s_max, hits, top_k, pad = \
        cfg_static[:8]
    B = codes_fwd.shape[0]
    hashes, valid = kmer_hashes(codes_fwd, k)
    sel_pos, sel_hash, sel_valid = select_seeds(hashes, valid, density_bits,
                                                s_max)
    del hashes, valid
    hit_pos, hit_valid = lookup_hits(run_table, seed_pos, bucket_lo,
                                     bucket_bits, steps, sel_hash, sel_valid,
                                     hits)
    p = sel_pos[..., None]
    d_fwd = (hit_pos - p).reshape(B, -1)
    d_rev = (hit_pos - (read_len[:, None, None] - k - p)).reshape(B, -1)
    hv = hit_valid.reshape(B, -1)
    cd_f, cv_f = vote_diagonals(d_fwd, hv, band=pad, top_k=top_k)
    cd_r, cv_r = vote_diagonals(d_rev, hv, band=pad, top_k=top_k)

    # strand union: the top_k best-voted candidates across both strands;
    # ties favour the forward slots
    K = top_k
    diag_u = torch.cat([cd_f, cd_r], dim=1)
    vote_u = torch.cat([cv_f, cv_r], dim=1)
    cols2k = torch.arange(2 * K, device=diag_u.device)
    sel_cols = []
    v = vote_u
    for _ in range(K):
        b = torch.argmax(v, dim=1)
        sel_cols.append(b)
        v = torch.where(cols2k == b[:, None], -1, v)
    sel = torch.stack(sel_cols, dim=1)
    return (torch.gather(diag_u, 1, sel), torch.gather(vote_u, 1, sel),
            (sel >= K).to(torch.int8))


# ---------------------------------------------------------------------------
# the CUDA kernel
# ---------------------------------------------------------------------------
def build_seed_kernel(src: Path | str | None = None) -> ctypes.CDLL:
    """Compile csrc/seed_stage.cu (or ``src``, a source with the same C
    entry point; once per source content) and load it."""
    lib = compile_kernels(src if src is not None else _SRC)
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.seed_stage_launch.restype = i32
    lib.seed_stage_launch.argtypes = [
        vp, i32, i32, vp, vp, i32, i32, vp, i32, vp,
        i32, i32, i32, i32, i32, i32, i32, i32, vp, vp, vp, vp,
    ]
    return lib


def launch_k3(lib, codes_fwd, read_len, run_table, seed_pos, bucket_lo,
              cfg_static):
    """Check K3's arguments and launch ``lib``'s seed_stage_launch on the
    current stream (no synchronise, no count).  Returns (cand_diag int32
    [B, K], cand_votes int32 [B, K], strand int8 [B, K])."""
    k, density_bits, bucket_bits, steps, s_max, hits, top_k, pad = \
        cfg_static[:8]
    dev = codes_fwd.device
    for name, t, dtype, ndim in (("codes_fwd", codes_fwd, torch.int8, 2),
                                 ("read_len", read_len, torch.int32, 1),
                                 ("run_table", run_table, torch.int32, 2),
                                 ("seed_pos", seed_pos, torch.int32, 1),
                                 ("bucket_lo", bucket_lo, torch.int32, 1)):
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{name} must be on one CUDA device with "
                             f"codes_fwd (got {t.device})")
        if t.dtype != dtype or t.dim() != ndim:
            raise ValueError(f"{name} must be {dtype} with {ndim} dims")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    B, L = codes_fwd.shape
    D, row_w = run_table.shape
    if read_len.shape[0] != B:
        raise ValueError("codes_fwd and read_len disagree on B")
    if not 1 <= k <= L <= MAX_WIDTH:
        raise ValueError(f"K3 takes k >= 1 and reads of k..{MAX_WIDTH} "
                         f"columns (got width {L}, k {k})")
    if not (1 <= hits and 1 <= s_max and s_max * hits <= MAX_SLOTS
            and 1 <= top_k <= MAX_TOP_K and 0 <= pad
            and 0 <= density_bits < 32 and 0 <= bucket_bits <= 32):
        raise ValueError(
            f"K3 takes s_max * hits <= {MAX_SLOTS}, top_k 1..{MAX_TOP_K}, "
            f"density bits 0..31 and bucket bits 0..32 (got s_max {s_max}, "
            f"hits {hits}, top_k {top_k}, pad {pad}, density bits "
            f"{density_bits}, bucket bits {bucket_bits})")
    n_buckets = 1 << bucket_bits
    if D < 1:
        raise ValueError("the seed table has no rows")
    if steps < 0:
        if row_w != 2 + hits:
            raise ValueError("CHD table width does not match hits_per_seed")
        if bucket_lo.shape[0] < n_buckets:
            raise ValueError(f"CHD displacements: {bucket_lo.shape[0]} < "
                             f"2^{bucket_bits}")
    else:
        if row_w < 3 or seed_pos.shape[0] < 1:
            raise ValueError("bisection takes a [D, 3] run table and seed "
                             "positions")
        if bucket_lo.shape[0] < n_buckets + 1:
            raise ValueError(f"bucket bounds: {bucket_lo.shape[0]} < "
                             f"2^{bucket_bits} + 1")
    outs = (torch.empty((B, top_k), dtype=torch.int32, device=dev),
            torch.empty((B, top_k), dtype=torch.int32, device=dev),
            torch.empty((B, top_k), dtype=torch.int8, device=dev))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.seed_stage_launch(
            codes_fwd.data_ptr(), B, L, read_len.data_ptr(),
            run_table.data_ptr(), D, row_w, seed_pos.data_ptr(),
            seed_pos.shape[0], bucket_lo.data_ptr(), k, density_bits,
            bucket_bits, steps, s_max, hits, top_k, pad,
            *(o.data_ptr() for o in outs), stream)
    if rc != 0:
        raise RuntimeError(f"seed_stage_launch failed: CUDA error {rc}")
    return outs


def seed_candidates_cuda(codes_fwd, read_len, run_table, seed_pos, bucket_lo,
                         cfg_static):
    """Launch K3 on the current stream (no synchronise)."""
    outs = launch_k3(build_seed_kernel(), codes_fwd, read_len, run_table,
                     seed_pos, bucket_lo, cfg_static)
    LAUNCHES["seed_stage"] += 1
    return outs


def seed_candidates(codes_fwd, read_len, run_table, seed_pos, bucket_lo,
                    cfg_static):
    """The K best candidate diagonals per read over both strands:
    (cand_diag int32 [B, K], cand_votes int32 [B, K], strand int8 [B, K]),
    ``codes_fwd`` int8 [B, L] (columns at or past read_len hold 4) and the
    Aligner's seed tables; ``cfg_static`` is Aligner.static()."""
    if codes_fwd.device.type == "cpu":
        LAUNCHES["seed_stage_plain"] += 1
        return seed_candidates_plain(codes_fwd, read_len, run_table,
                                     seed_pos, bucket_lo, cfg_static)
    return seed_candidates_cuda(codes_fwd, read_len, run_table, seed_pos,
                                bucket_lo, cfg_static)
