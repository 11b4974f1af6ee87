"""The query's prologue and epilogue around K3 and K1: K4 and K5.

The JAX package computes these inside its jitted query functions
(pantax_tpu/align/aligner.py), which XLA fuses into device code:
``_unpack_reads_j`` (:149), ``_rev_codes_j`` (:203) and the strand select
of ``_all_candidates`` (:557-559) and ``_extend_batch`` (:630-632) before
the DP; the candidates' tail of ``_all_candidates`` (:567-577), the
epilogues of ``_query_batch`` (:593-610) and ``_query_batch_paired``
(:720-777) and ``_pack_result_rows`` (:649) after it.  Four entry points,
each with two versions here:

- ``query_prologue`` (K4a): the read batch unpacked, columns at or past
  read_len set to 4, the width rounded up to 4; for the paired query both
  mates' rows in one buffer, padded with 4 to the wider, with their
  read_len beside them;
- ``query_rows`` (K4b): the K candidates' read rows, the read itself on
  strand 0 and its left-aligned reverse complement on strand 1, padded
  with 4 to the caller's width (a multiple of 16 for K1, which loads them
  16 bytes at a time), with the repeated read_len and the window starts
  clipped into the text;
- ``query_pick`` (K5): the node projection of each candidate, the best
  and the location-deduped second best, the score threshold and mapq: the
  per-read 7 columns, or the packed [4, B] rows.  On the card it searches
  the bucket table of the segment starts (``segment_lookup``, built once
  per Aligner) in place of all of them;
- ``query_pick_paired`` (K5p): the mate pairs' joint pick (fragment
  bonus, pair mapq, rescue, each mate's own mapq): the 7 columns of the
  2B reads (mate 1's B, then mate 2's), or the packed [8, B] rows.

The CUDA kernels, ``csrc/query_io.cu``, are built with nvcc for sm_90a at
first use into the git-ignored build directory (ops/extend.py's
``compile_kernels``) and bound with ctypes, beside the plain torch
versions (``*_plain``).  Each entry point takes
the plain version only for CPU tensors.  On a CUDA tensor it launches the
kernel or raises; nothing falls back.  Every output is an integer (the
thresholds are float32 products truncated to int32 in both), and the two
versions agree bit for bit.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from .extend import LAUNCHES, NEG, compile_kernels
from .seed import MAX_TOP_K

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "query_io.cu"


# ---------------------------------------------------------------------------
# plain torch
# ---------------------------------------------------------------------------
def unpack_reads(codes, read_len):
    """int8 codes [B, L] -> [B, L4]: width rounded up to a multiple of 4 and
    every column at or past read_len set to 4, as the reference's read wire
    (pack_codes / pack_codes2 + _unpack_reads_j) delivers them."""
    B, L = codes.shape
    if L % 4:
        codes = torch.nn.functional.pad(codes, (0, 4 - L % 4), value=4)
    cols = torch.arange(codes.shape[1], device=codes.device)
    return torch.where(cols < read_len[:, None], codes, 4).to(torch.int8)


def rev_codes(codes, lens):
    """Left-aligned reverse complement of right-padded codes (a gather)."""
    B, Lr = codes.shape
    cols = torch.arange(Lr, device=codes.device)
    src = (lens.to(torch.int64)[:, None] - 1 - cols).clamp(0, Lr - 1)
    rev = torch.gather(codes, 1, src)
    ok = (cols < lens[:, None]) & (rev < 4)
    return torch.where(ok, 3 - rev, 4).to(torch.int8)


def query_prologue_plain(codes1, len1, codes2=None, len2=None):
    """Plain torch version of K4a: (codes_fwd int8 [R, Lw], read_len int32
    [R]).  One matrix: unpack_reads, its read_len as given.  Two (the mate
    pairs): both unpacked, padded with 4 to the wider, mate 1's rows then
    mate 2's, and both read_len concatenated."""
    f1 = unpack_reads(codes1, len1)
    if codes2 is None:
        return f1, len1
    f2 = unpack_reads(codes2, len2)
    Lw = max(f1.shape[1], f2.shape[1])
    return (torch.cat([torch.nn.functional.pad(f, (0, Lw - f.shape[1]),
                                               value=4) for f in (f1, f2)]),
            torch.cat([len1, len2]))


def query_rows_plain(codes_fwd, read_len, strand, diag, pad: int, w_hi: int,
                     width: int):
    """Plain torch version of K4b: (rows int8 [R K, width], len_rep int32
    [R K], w0 int32 [R K]).  Row r K + k is codes_fwd[r] where strand[r, k]
    != 1, else its reverse complement (rev_codes), padded with 4 to
    ``width``; w0 = clip(diag - pad, 0, w_hi).  ``strand`` and ``diag`` are
    [R, K] or [R] (K = 1, the extension's); len_rep is read_len itself
    where K is 1."""
    R, Lc = codes_fwd.shape
    K = 1 if strand.dim() == 1 else strand.shape[1]
    st = strand.reshape(R, K)
    rows = torch.where((st == 1)[:, :, None],
                       rev_codes(codes_fwd, read_len)[:, None, :],
                       codes_fwd[:, None, :]).reshape(R * K, Lc)
    if width > Lc:
        rows = torch.nn.functional.pad(rows, (0, width - Lc), value=4)
    len_rep = read_len if K == 1 else read_len.repeat_interleave(K)
    w0 = (diag - pad).clamp(0, w_hi).reshape(-1)
    return rows.contiguous(), len_rep, w0.contiguous()


def frac_of(frac: float, read_len):
    """int32(float32(frac) * read_len): the float32 product truncated to
    int32, as XLA computes the reference's score thresholds."""
    f32 = torch.float32
    return (torch.tensor(frac, dtype=f32) * read_len.to(f32)).to(torch.int32)


def gap_mapq(best, second, mapq_scale: float):
    """mapq from the best and second-best score: 60 without a second,
    else clip(int32(float32(scale) * (best - second)), 0, 60)."""
    gap_q = torch.tensor(mapq_scale, dtype=torch.float32) * (best - second).to(
        torch.float32)
    return torch.where(second <= NEG // 2, 60,
                       gap_q.to(torch.int32).clamp(0, 60)).to(torch.int32)


def project(ts, tstart, tnode):
    """(node, offset) of text positions ts: the segment
    searchsorted(tstart, ts, right) - 1, clipped into the segments."""
    i0 = torch.searchsorted(tstart, ts, right=True) - 1
    i0 = i0.clamp(0, tnode.shape[0] - 1)
    return tnode[i0], ts - tstart[i0]


class SegmentLookup(NamedTuple):
    """The bucket table of the segment starts that K5's projection (and
    K6's, ops/scatter.py) searches: pos_lo int32 [nb + 1], pos_lo[b] the
    count of starts at or before b << win_shift, on the segments' device;
    ``steps`` the bisection steps that its fullest bucket takes."""

    pos_lo: torch.Tensor
    win_shift: int
    steps: int

    @property
    def device(self) -> torch.device:
        return self.pos_lo.device

    def to(self, device) -> "SegmentLookup":
        return self._replace(pos_lo=self.pos_lo.to(device))


def segment_lookup(tstart, text_len: int) -> SegmentLookup:
    """The bucket table of sorted segment starts [M] in [0, text_len),
    built where tstart lies: 2^b buckets of 2^win_shift positions over the
    text's power-of-two span, b = ceil(log2 M) + 2 clipped into [8, 22],
    and torch.searchsorted of their bounds (the reference's
    build_pos_lookup).  K5 takes a ts before 0 as before every start and
    one past the last bucket as past every start, so the starts must lie
    in the text."""
    M = tstart.shape[0]
    if M < 1 or int(tstart[0]) < 0 or int(tstart[-1]) >= text_len or (
            M > 1 and bool((tstart[1:] < tstart[:-1]).any())):
        raise ValueError(f"segment starts must be sorted in [0, {text_len})")
    b = int(np.clip(int(np.ceil(np.log2(max(M, 2)))) + 2, 8, 22))
    t_bits = int(np.ceil(np.log2(max(text_len, 2))))
    win_shift = max(t_bits - b, 0)
    nb = 1 << max(t_bits - win_shift, 1)
    bounds = torch.arange(nb + 1, dtype=torch.int64,
                          device=tstart.device) << win_shift
    pos_lo = torch.searchsorted(tstart.to(torch.int64), bounds,
                                right=True).to(torch.int32)
    occ = int((pos_lo[1:] - pos_lo[:-1]).max())
    return SegmentLookup(pos_lo, win_shift, occ.bit_length())


def pack_result_rows(res7):
    """The 7-tuple query result as one int32 [4, B]: text_start, text_end,
    (score << 16 | matches), (mapq << 2 | strand << 1 | aligned); scores are
    clipped to int16 (only the NEG sentinel clips)."""
    ts, te, score, matches, mapq, strand, aligned = res7
    i32 = torch.int32
    hi = (score.clamp(-32768, 32767).to(i32) * 65536) | (matches.to(i32) & 0xFFFF)
    flags = (mapq.to(i32) << 2) | (strand.to(i32) << 1) | aligned.to(i32)
    return torch.stack([ts.to(i32), te.to(i32), hi, flags])


def _candidates(score, start_off, end_off, matches, w0, cand_votes, strand,
                tstart, tnode):
    """The [B, K] candidates of K1's flat outputs: (scores, ts, te,
    matches, strand, node, off), as the reference's _all_candidates
    returns them."""
    B, K = cand_votes.shape
    scores = torch.where(cand_votes > 0, score.reshape(B, K), NEG)
    ts = (w0 + start_off).reshape(B, K)
    te = (w0 + end_off).reshape(B, K)
    node, off = project(ts, tstart, tnode)
    return scores, ts, te, matches.reshape(B, K), strand, node, off


def query_pick_plain(score, start_off, end_off, matches, w0, cand_votes,
                     strand, tstart, tnode, lookup, read_len,
                     mapq_scale: float, min_score_frac: float,
                     packed: bool = False):
    """Plain torch version of K5: the per-read (ts, te, score, matches,
    mapq, strand, aligned), int32 x5, int8, bool [B], or (``packed``)
    pack_result_rows of them.  ``lookup``, the bucket table of tstart
    that the kernel searches, goes unused: this version searches all of
    tstart."""
    scores, ts, te, matches, strand, node, off = _candidates(
        score, start_off, end_off, matches, w0, cand_votes, strand, tstart,
        tnode)
    best = torch.argmax(scores, dim=1, keepdim=True)

    def take(a):
        return torch.gather(a, 1, best)[:, 0]

    s1 = take(scores)
    same_loc = (node == take(node)[:, None]) & (off == take(off)[:, None])
    s2 = torch.where(same_loc, NEG, scores).amax(dim=1)
    aligned = s1 >= frac_of(min_score_frac, read_len)
    mapq = gap_mapq(s1, s2, mapq_scale)
    res = (take(ts), take(te), s1, take(matches),
           torch.where(aligned, mapq, 0), take(strand), aligned)
    return pack_result_rows(res) if packed else res


def query_pick_paired_plain(score, start_off, end_off, matches, w0,
                            cand_votes, strand, tstart, tnode, lookup,
                            read_len, mapq_scale: float, min_score_frac: float,
                            frag_max: int, pair_bonus: int,
                            rescue_frac: float, packed: bool = False):
    """Plain torch version of K5p over the candidates of 2B reads (mate 1's
    B rows, then mate 2's): a candidate pair on opposite strands within
    ``frag_max`` earns ``pair_bonus``; the best pair (first index over the
    flattened K*K axis) places both mates; a weak mate of a consistent
    fragment is kept at ``rescue_frac``.  Returns the 7 columns [2B] (mate
    1's rows, then mate 2's), or (``packed``) the [8, B] rows, mate 1's
    four then mate 2's."""
    scores, ts, te, matches, strand, node, off = _candidates(
        score, start_off, end_off, matches, w0, cand_votes, strand, tstart,
        tnode)
    B = scores.shape[0] // 2
    K = scores.shape[1]
    len1, len2 = read_len[:B], read_len[B:]
    s1, s2 = scores[:B], scores[B:]
    ts1, ts2 = ts[:B], ts[B:]
    n1, n2 = node[:B], node[B:]
    o1, o2 = off[:B], off[B:]
    ok = ((strand[:B, :, None] != strand[B:, None, :])
          & ((ts1[:, :, None] - ts2[:, None, :]).abs() <= frag_max)
          & (s1 > NEG // 2)[:, :, None] & (s2 > NEG // 2)[:, None, :])
    pairf = (s1[:, :, None] + s2[:, None, :]
             + ok.to(torch.int32) * pair_bonus).reshape(B, K * K)
    best = torch.argmax(pairf, dim=1, keepdim=True)  # first index on ties
    bi, bj = best // K, best % K

    def t1(a):
        return torch.gather(a[:B], 1, bi)[:, 0]

    def t2(a):
        return torch.gather(a[B:], 1, bj)[:, 0]

    p_best = torch.gather(pairf, 1, best)[:, 0]
    ok_best = torch.gather(ok.reshape(B, K * K), 1, best)[:, 0]

    # joint second best: the best pair whose mates are not both at the
    # chosen graph locations
    same1 = (n1 == t1(node)[:, None]) & (o1 == t1(off)[:, None])
    same2 = (n2 == t2(node)[:, None]) & (o2 == t2(off)[:, None])
    same_pair = (same1[:, :, None] & same2[:, None, :]).reshape(B, K * K)
    p_second = torch.where(same_pair, NEG, pairf).amax(dim=1)
    pair_mapq = gap_mapq(p_best, p_second, mapq_scale)

    s1b, s2b = t1(scores), t2(scores)
    al1 = s1b >= frac_of(min_score_frac, len1)
    al2 = s2b >= frac_of(min_score_frac, len2)
    # fragment rescue: a consistent weak mate is kept when its partner
    # clears the normal threshold on its own
    aligned1 = al1 | (ok_best & al2 & (s1b >= frac_of(rescue_frac, len1)))
    aligned2 = al2 | (ok_best & al1 & (s2b >= frac_of(rescue_frac, len2)))
    # per-mate mapq: the joint gap for a consistent fragment, else the
    # mate's own single-end gap
    own1 = gap_mapq(s1b, torch.where(same1, NEG, s1).amax(dim=1), mapq_scale)
    own2 = gap_mapq(s2b, torch.where(same2, NEG, s2).amax(dim=1), mapq_scale)
    mapq1 = torch.where(ok_best, pair_mapq, own1)
    mapq2 = torch.where(ok_best, pair_mapq, own2)
    r1 = (t1(ts), t1(te), s1b, t1(matches), torch.where(aligned1, mapq1, 0),
          t1(strand), aligned1)
    r2 = (t2(ts), t2(te), s2b, t2(matches), torch.where(aligned2, mapq2, 0),
          t2(strand), aligned2)
    if packed:
        return torch.cat([pack_result_rows(r1), pack_result_rows(r2)])
    return tuple(torch.cat([a, b]) for a, b in zip(r1, r2))


# ---------------------------------------------------------------------------
# the CUDA kernels
# ---------------------------------------------------------------------------
def build_query_kernels(src: Path | str | None = None) -> ctypes.CDLL:
    """Compile csrc/query_io.cu (or ``src``, a source with the same C entry
    points; once per source content) and load it."""
    lib = compile_kernels(src if src is not None else _SRC)
    vp, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.query_prologue_launch.restype = i32
    lib.query_prologue_launch.argtypes = [
        vp, i32, i32, vp, vp, i32, i32, vp, i32, vp, vp, vp]
    lib.query_rows_launch.restype = i32
    lib.query_rows_launch.argtypes = [
        vp, i32, i32, vp, vp, i32, i32, vp, i32, i32, i32, vp, vp, vp, vp]
    pick = [vp] * 9 + [i32, vp, i32, i32, vp, i32, i32, f32, f32]
    lib.query_pick_launch.restype = i32
    lib.query_pick_launch.argtypes = pick + [vp] * 9
    lib.query_pick_paired_launch.restype = i32
    lib.query_pick_paired_launch.argtypes = pick + [f32, i32, i32] + [vp] * 9
    return lib


def _check(dev, *tensors):
    """Each (name, tensor, dtype, ndim) on ``dev``, a CUDA device, with its
    dtype and rank, and contiguous; raise ValueError otherwise."""
    for name, t, dtype, ndim in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{name} must be on one CUDA device (got "
                             f"{t.device}, want {dev})")
        if t.dtype != dtype or t.dim() != ndim:
            raise ValueError(f"{name} must be {dtype} with {ndim} dims (got "
                             f"{t.dtype}, {t.dim()})")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _call(lib, fn_name: str, dev, *args) -> None:
    """``fn_name`` of ``lib`` on the current stream of ``dev`` (no
    synchronise); raise on the CUDA error it returns."""
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(lib, fn_name)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{fn_name} failed: CUDA error {rc}")


def _ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def launch_k4a(lib, codes1, len1, codes2=None, len2=None):
    """Check K4a's arguments and launch ``lib``'s query_prologue_launch on
    the current stream (no synchronise, no count); returns (codes_fwd,
    read_len) as query_prologue_plain."""
    dev = codes1.device
    mats = [("codes1", codes1, len1)]
    if codes2 is not None:
        mats.append(("codes2", codes2, len2))
    for name, c, n in mats:
        _check(dev, (name, c, torch.int8, 2),
               (f"read_len of {name}", n, torch.int32, 1))
        if n.shape[0] != c.shape[0]:
            raise ValueError(f"{name} and its read_len disagree on B")
    Lw = max((c.shape[1] + 3) // 4 * 4 for _, c, _ in mats)
    B1 = codes1.shape[0]
    B2 = 0 if codes2 is None else codes2.shape[0]
    out = torch.empty((B1 + B2, Lw), dtype=torch.int8, device=dev)
    lens = len1 if codes2 is None else torch.empty(
        B1 + B2, dtype=torch.int32, device=dev)
    _call(lib, "query_prologue_launch", dev, codes1.data_ptr(), B1,
          codes1.shape[1], len1.data_ptr(), _ptr(codes2), B2,
          0 if codes2 is None else codes2.shape[1], _ptr(len2), Lw,
          out.data_ptr(), None if codes2 is None else lens.data_ptr())
    return out, lens


def launch_k4b(lib, codes_fwd, read_len, strand, diag, pad: int, w_hi: int,
               width: int):
    """Check K4b's arguments and launch ``lib``'s query_rows_launch on the
    current stream (no synchronise, no count); returns (rows, len_rep, w0)
    as query_rows_plain.  ``strand`` int8 [R, K] with ``diag`` int32 [R,
    K] (the query), or int32 [R] with int32 [R] (the extension).  The codes
    are K4a's rows: a multiple of 4 wide, starting on a 4-byte boundary.
    The rows are a fresh buffer (16-byte aligned), ``width`` wide, a
    multiple of 4."""
    dev = codes_fwd.device
    R, Lc = codes_fwd.shape
    if strand.dim() == 2:
        K, st_dtype = strand.shape[1], torch.int8
    else:
        K, st_dtype = 1, torch.int32
    _check(dev, ("codes_fwd", codes_fwd, torch.int8, 2),
           ("read_len", read_len, torch.int32, 1),
           ("strand", strand, st_dtype, strand.dim()),
           ("diag", diag, torch.int32, strand.dim()))
    if (read_len.shape[0] != R or strand.shape[0] != R
            or diag.shape != strand.shape):
        raise ValueError("codes_fwd, read_len, strand and diag disagree")
    if not 1 <= K <= MAX_TOP_K or Lc < 1 or width < Lc:
        raise ValueError(f"K4b takes K 1..{MAX_TOP_K}, rows of at least one "
                         f"column and width >= {Lc} (got K {K}, width "
                         f"{width})")
    if Lc % 4 or width % 4 or codes_fwd.data_ptr() % 4:
        raise ValueError(f"K4b takes K4a's rows, a multiple of 4 wide on "
                         f"4-byte boundaries, into rows a multiple of 4 "
                         f"wide (got {Lc} columns, width {width})")
    N = R * K
    rows = torch.empty((N, width), dtype=torch.int8, device=dev)
    len_rep = read_len if K == 1 else torch.empty(N, dtype=torch.int32,
                                                  device=dev)
    w0 = torch.empty(N, dtype=torch.int32, device=dev)
    _call(lib, "query_rows_launch", dev, codes_fwd.data_ptr(), R, Lc,
          read_len.data_ptr(), strand.data_ptr(), strand.element_size(), K,
          diag.data_ptr(), pad, w_hi, width, rows.data_ptr(),
          None if K == 1 else len_rep.data_ptr(), w0.data_ptr())
    return rows, len_rep, w0


def _pick_outputs(n: int, dev, packed: bool, paired: bool = False):
    """The pick's outputs for ``n`` reads: the 7 columns [n], or the packed
    int32 rows, 4 a read ([4, n], or [8, n / 2] for n / 2 pairs)."""
    if packed:
        return torch.empty((8, n // 2) if paired else (4, n),
                           dtype=torch.int32, device=dev)
    i32 = torch.int32
    return tuple(torch.empty(n, dtype=dt, device=dev) for dt in
                 (i32, i32, i32, i32, i32, torch.int8, torch.bool))


def _pick_args(score, start_off, end_off, matches, w0, cand_votes, strand,
               tstart, tnode, lookup, read_len, reads: int) -> tuple:
    """Check the pick's inputs (K1's four [R K] outputs, w0, the [R, K]
    votes and strands, the segment tables and their bucket table,
    read_len [R], R = ``reads``) and return (device, K, the C arguments up
    to read_len)."""
    dev = score.device
    R, K = cand_votes.shape
    _check(dev, *((name, t, torch.int32, 1) for name, t in (
               ("score", score), ("start_off", start_off),
               ("end_off", end_off), ("matches", matches), ("w0", w0),
               ("tstart", tstart), ("tnode", tnode),
               ("read_len", read_len))),
           ("cand_votes", cand_votes, torch.int32, 2),
           ("strand", strand, torch.int8, 2))
    if R != reads or read_len.shape[0] != R or strand.shape != (R, K):
        raise ValueError("the candidates, strands and read_len disagree")
    if any(t.shape[0] != R * K for t in (score, start_off, end_off, matches,
                                          w0)):
        raise ValueError("K1's outputs and w0 must hold R K candidates")
    if not 1 <= K <= MAX_TOP_K:
        raise ValueError(f"K5 takes 1..{MAX_TOP_K} candidates a read (got {K})")
    M = tstart.shape[0]
    if M < 1 or tnode.shape[0] != M:
        raise ValueError("tstart and tnode must hold the same segments")
    _check(dev, ("pos_lo", lookup.pos_lo, torch.int32, 1))
    nb = lookup.pos_lo.shape[0] - 1
    if nb < 1 or nb & (nb - 1):
        raise ValueError(f"pos_lo must hold 2^k + 1 bounds (got {nb + 1})")
    return dev, K, (score.data_ptr(), start_off.data_ptr(),
                    end_off.data_ptr(), matches.data_ptr(), w0.data_ptr(),
                    cand_votes.data_ptr(), strand.data_ptr(),
                    tstart.data_ptr(), tnode.data_ptr(), M,
                    lookup.pos_lo.data_ptr(), nb + 1, lookup.win_shift,
                    read_len.data_ptr())


def _out_ptrs(out, packed: bool) -> list:
    return [None] * 7 + [out.data_ptr()] if packed else [
        t.data_ptr() for t in out] + [None]


def _f32(x: float) -> float:
    """x as the float32 the plain version multiplies by (exact in a
    ctypes c_float)."""
    return float(np.float32(x))


def launch_k5(lib, score, start_off, end_off, matches, w0, cand_votes,
              strand, tstart, tnode, lookup, read_len, mapq_scale: float,
              min_score_frac: float, packed: bool = False):
    """Check K5's arguments and launch ``lib``'s query_pick_launch on the
    current stream (no synchronise, no count); returns what
    query_pick_plain returns.  ``lookup`` is the bucket table of tstart
    (segment_lookup)."""
    B = read_len.shape[0]
    dev, K, args = _pick_args(score, start_off, end_off, matches, w0,
                              cand_votes, strand, tstart, tnode, lookup,
                              read_len, B)
    out = _pick_outputs(B, dev, packed)
    _call(lib, "query_pick_launch", dev, *args, B, K, _f32(mapq_scale),
          _f32(min_score_frac), *_out_ptrs(out, packed))
    return out


def launch_k5p(lib, score, start_off, end_off, matches, w0, cand_votes,
               strand, tstart, tnode, lookup, read_len, mapq_scale: float,
               min_score_frac: float, frag_max: int, pair_bonus: int,
               rescue_frac: float, packed: bool = False):
    """Check K5p's arguments and launch ``lib``'s query_pick_paired_launch
    on the current stream (no synchronise, no count); returns what
    query_pick_paired_plain returns."""
    R = read_len.shape[0]
    if R % 2:
        raise ValueError(f"K5p takes 2B reads, mate 1's then mate 2's (got {R})")
    dev, K, args = _pick_args(score, start_off, end_off, matches, w0,
                              cand_votes, strand, tstart, tnode, lookup,
                              read_len, R)
    out = _pick_outputs(R, dev, packed, paired=True)
    _call(lib, "query_pick_paired_launch", dev, *args, R // 2, K,
          _f32(mapq_scale), _f32(min_score_frac), _f32(rescue_frac),
          int(frag_max), int(pair_bonus), *_out_ptrs(out, packed))
    return out


# ---------------------------------------------------------------------------
# the entry points: the plain version on the CPU, the kernel on the card
# ---------------------------------------------------------------------------
def query_prologue(codes1, len1, codes2=None, len2=None):
    """K4a: (codes_fwd int8 [R, Lw], read_len int32 [R]) of one read batch
    (R = B, Lw its width rounded up to 4) or of mate pairs (R = 2B, mate
    1's rows then mate 2's, Lw the wider of the two)."""
    if codes1.device.type == "cpu":
        LAUNCHES["query_prologue_plain"] += 1
        return query_prologue_plain(codes1, len1, codes2, len2)
    out = launch_k4a(build_query_kernels(), codes1, len1, codes2, len2)
    LAUNCHES["query_prologue"] += 1
    return out


def query_rows(codes_fwd, read_len, strand, diag, pad: int, w_hi: int,
               width: int):
    """K4b: (rows int8 [R K, width], len_rep int32 [R K], w0 int32 [R K]):
    each candidate's read row on its strand, padded with 4 to ``width``,
    its read_len and its window start clip(diag - pad, 0, w_hi)."""
    if codes_fwd.device.type == "cpu":
        LAUNCHES["query_rows_plain"] += 1
        return query_rows_plain(codes_fwd, read_len, strand, diag, pad, w_hi,
                                width)
    out = launch_k4b(build_query_kernels(), codes_fwd, read_len, strand,
                     diag, pad, w_hi, width)
    LAUNCHES["query_rows"] += 1
    return out


def query_pick(score, start_off, end_off, matches, w0, cand_votes, strand,
               tstart, tnode, lookup, read_len, mapq_scale: float,
               min_score_frac: float, packed: bool = False):
    """K5: the single-end pick of B reads' K candidates (K1's flat outputs,
    their window starts, K3's votes and strands) over the segments and
    their bucket table (segment_lookup): the 7 per-read columns, or
    (``packed``) the [4, B] rows."""
    args = (score, start_off, end_off, matches, w0, cand_votes, strand,
            tstart, tnode, lookup, read_len, mapq_scale, min_score_frac,
            packed)
    if score.device.type == "cpu":
        LAUNCHES["query_pick_plain"] += 1
        return query_pick_plain(*args)
    out = launch_k5(build_query_kernels(), *args)
    LAUNCHES["query_pick"] += 1
    return out


def query_pick_paired(score, start_off, end_off, matches, w0, cand_votes,
                      strand, tstart, tnode, lookup, read_len,
                      mapq_scale: float, min_score_frac: float,
                      frag_max: int, pair_bonus: int, rescue_frac: float,
                      packed: bool = False):
    """K5p: the joint pick of B mate pairs from the candidates of their 2B
    reads: the 7 columns [2B] (mate 1's rows, then mate 2's), or
    (``packed``) the [8, B] rows."""
    args = (score, start_off, end_off, matches, w0, cand_votes, strand,
            tstart, tnode, lookup, read_len, mapq_scale, min_score_frac,
            frag_max, pair_bonus, rescue_frac, packed)
    if score.device.type == "cpu":
        LAUNCHES["query_pick_paired_plain"] += 1
        return query_pick_paired_plain(*args)
    out = launch_k5p(build_query_kernels(), *args)
    LAUNCHES["query_pick_paired"] += 1
    return out
