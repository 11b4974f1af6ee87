"""The fused step's classify + scatter: K6, the range decomposition, and
K11, the windowed scatter with the first-occurrence dedup.

The JAX package computes both inside its jitted fused steps, which XLA
turns into device code: ``_classify_scatter_ranges`` (pantax_tpu/ops/
fused.py:236, with ``locate_segment`` :81; also the body of
``_interval_range_step_impl`` :620) and ``_classify_scatter`` (:170) with
the fused branch of ``_coverage_scatter`` (pantax_tpu/ops/
coverage_device.py:110: per-segment trio matches).  Two versions here:

- the CUDA kernels, ``csrc/classify_scatter.cu``, built with nvcc for
  sm_90a at first use into the git-ignored build directory (ops/extend.py's
  ``compile_kernels``) and bound with ctypes.  K6 runs two lanes per
  read, one for each end segment: each lane finds its segment by reading
  the records of its bucket at once (``scatter_records``: a segment's
  start, node, trio matches, haplotype range and its node's length and
  offset in 32 bytes), so that no haplotype search runs before them and
  no load waits on the node.  K11
  runs a tile of 4-32 lanes per read (the row in registers, one position a
  lane): the haplotype search, the in-bucket segment search and the row's
  gathers.  Both add with integer atomics, for live rows only;
  dropped entries add nothing (the plain version's sink slots stay as they
  are), and a pair of adds that cancels (+1 and -1 at one index, a zero
  addend) is skipped.
  Integer sums do not depend on the order of the adds, so the accumulators
  equal the plain version's bit for bit, the sink slots aside;
- ``classify_scatter_ranges_plain`` and ``classify_scatter_plain``, the
  plain torch versions (``locate_segment``'s bisection, index_add_ into
  each accumulator's sink slot for the dropped entries, and
  ops/coverage_device.py's ``coverage_scatter`` for the windowed rows).

``classify_scatter_ranges`` and ``classify_scatter`` take the plain version
only for CPU tensors.  On a CUDA tensor they launch the kernel or raise;
nothing falls back.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .coverage_device import _add, coverage_scatter
from .extend import LAUNCHES, compile_kernels

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "classify_scatter.cu"
# K6's C entry point, with its records
_K6_ENTRY = "classify_scatter_ranges_records_launch"
# K11's widest node window (csrc/classify_scatter.cu; auto_node_window's
# largest is 64)
MAX_L_CAP = 64
# a segment record's ridx where a haplotype offset cuts the segment's
# positions (csrc/classify_scatter.cu's kSearchHap)
SEARCH_HAP = -2**31


# ---------------------------------------------------------------------------
# plain torch
# ---------------------------------------------------------------------------
def locate_segment(tstart, pos_lo, win_shift: int, steps: int, ts):
    """searchsorted(tstart, ts, side='right') - 1 by a static-depth
    in-bucket bisection (the reference's locate_segment)."""
    M = tstart.shape[0]
    b = (ts >> win_shift).to(torch.int64)
    lo_s, hi_s = pos_lo[b], pos_lo[b + 1]
    for _ in range(steps):
        mid = (lo_s + hi_s) >> 1
        key = tstart[mid.clamp(0, M - 1)]
        go_right = (key <= ts) & (lo_s < hi_s)
        lo_s = torch.where(go_right, mid + 1, lo_s)
        hi_s = torch.where(go_right, hi_s, torch.maximum(mid, lo_s))
    return (lo_s - 1).clamp(0, M - 1)


def classify_scatter_ranges_plain(ts, te, aligned, tables, tstart, tnode,
                                  acc) -> torch.Tensor:
    """Plain torch version of K6: classify aligned intervals by haplotype
    and add their coverage to ``acc`` = (bases, diff, trio, seg_node_depth,
    seg_trio_depth) in place; returns ridx.  Per read: bases and per-base
    diffs of the first and last segments directly, middle segments and trio
    windows as segment-space depth diffs (folded by expand_ranges), and the
    two end-window trio corrections."""
    acc_bases, acc_diff, acc_trio, acc_sn, acc_st = acc
    t = tables
    h = (torch.searchsorted(t.hap_offsets, ts, right=True) - 1).clamp(
        0, t.hap_range.shape[0] - 1)
    ridx = torch.where(aligned, t.hap_range[h], -1)
    live = aligned & (ridx >= 0) & (te > ts)

    i0 = locate_segment(tstart, t.pos_lo, t.win_shift, t.pos_steps, ts)
    i1 = locate_segment(tstart, t.pos_lo, t.win_shift, t.pos_steps,
                        torch.maximum(te - 1, ts))
    span = i1 - i0 + 1
    multi = live & (span >= 2)
    trio3 = live & (span >= 3)

    n0 = tnode[i0] - 1
    n1 = tnode[i1] - 1
    rs = ts - tstart[i0]
    rem = te - tstart[i1]
    nlen0 = t.nodes_len[n0]
    nlen1 = t.nodes_len[n1]
    tgt = te - ts

    N = t.N_pad  # sink slot
    first_val = torch.where(multi, nlen0 - rs, tgt)
    _add(acc_bases, torch.cat([torch.where(live, n0, N),
                               torch.where(multi, n1, N)]),
         torch.cat([first_val, rem]))

    TB = t.TB_pad  # the diff array's last entry, excluded by the finalize
    bo0, bo1 = t.base_offset[n0], t.base_offset[n1]
    first_hi = torch.where(multi, nlen0, rs + tgt)
    d_lo = torch.cat([torch.where(live, bo0 + rs, TB),
                      torch.where(multi, bo1, TB)])
    d_hi = torch.cat([torch.where(live, bo0 + first_hi, TB),
                      torch.where(multi, bo1 + rem, TB)])
    _add(acc_diff, d_lo, torch.ones_like(d_lo))
    _add(acc_diff, d_hi, -torch.ones_like(d_hi))

    S = acc_sn.shape[0] - 1  # sink slot
    one = torch.ones_like(i0)
    _add(acc_sn, torch.where(multi, i0 + 1, S), one)
    _add(acc_sn, torch.where(multi, i1, S), -one)
    _add(acc_st, torch.where(trio3, i0, S), one)
    _add(acc_st, torch.where(trio3, i1 - 1, S), -one)

    U = t.U_pad  # sink slot
    m0 = t.trio_seg[i0]
    m1 = t.trio_seg[(i1 - 2).clamp(min=0)]
    _add(acc_trio, torch.cat([torch.where(trio3 & (m0 >= 0), m0, U),
                              torch.where(trio3 & (m1 >= 0), m1, U)]),
         torch.cat([-rs, -(nlen1 - rem)]))
    return ridx


def classify_scatter_plain(ts, te, aligned, tables, tstart, tnode, acc,
                           L_cap: int):
    """Plain torch version of K11: classify aligned intervals by haplotype,
    cut each read's first ``L_cap`` segments into a node-path row and add
    its coverage to acc[:3] in place (coverage_scatter, with the
    per-segment trio matches of ``tables.trio_seg``).  A read that spans
    more than ``L_cap`` segments is left out; returns (ridx, overflow),
    overflow the aligned reads left out."""
    t = tables
    M = tstart.shape[0]
    h = (torch.searchsorted(t.hap_offsets, ts, right=True) - 1).clamp(
        0, t.hap_range.shape[0] - 1)
    ridx = torch.where(aligned, t.hap_range[h], -1)

    i0 = locate_segment(tstart, t.pos_lo, t.win_shift, t.pos_steps, ts)
    nxt = i0[:, None] + torch.arange(1, L_cap + 1, device=ts.device)[None, :]
    starts_win = torch.where(nxt < M, tstart[nxt.clamp(max=M - 1)],
                             torch.iinfo(torch.int32).max)
    te1 = torch.maximum(te - 1, ts)
    n_more = (starts_win <= te1[:, None]).sum(dim=1)
    overflow = aligned & (n_more >= L_cap)
    span = (n_more + 1).clamp(1, L_cap)

    keep = aligned & (ridx >= 0) & ~overflow
    cols = torch.arange(L_cap, device=ts.device)[None, :]
    take = (i0[:, None] + cols).clamp(max=M - 1)
    nodes = torch.where((cols < span[:, None]) & keep[:, None],
                        tnode[take] - 1, -1)
    read_start = torch.where(keep, ts - tstart[i0], 0)
    # windows are consecutive segments of one haplotype: one gather of the
    # per-segment trio table replaces the trio lookup
    trio_match = t.trio_seg[take[:, :L_cap - 2]] if L_cap >= 3 else None
    coverage_scatter(nodes, torch.where(keep, span, 0), read_start,
                     torch.where(keep, read_start + (te - ts), 0),
                     t.nodes_len, t.base_offset, acc[:3],
                     has_dups=t.has_dups, trio_match=trio_match)
    return ridx, overflow


def scatter_records(tables, tstart, tnode) -> torch.Tensor:
    """K6's records, int32 [M, 8] on the tables' device: for each segment
    i, (tstart, tnode, trio_seg[i], trio_seg[i - 2] (-1 for i < 2), ridx,
    nodes_len and base_offset of its node, 0), 32 bytes.  ridx is
    hap_range at the haplotype (searchsorted over hap_offsets, as the plain
    version finds it) of every position that locate_segment puts in the
    segment (from its start to the next segment's, and past the text's
    ends for the first and last), or SEARCH_HAP where those positions lie
    in two haplotypes."""
    t = tables
    dev = t.hap_range.device
    start = tstart.to(dev, torch.int64)
    node = tnode.to(dev, torch.int64)  # 1-based
    lim = torch.iinfo(torch.int32)
    first = torch.cat([torch.tensor([lim.min], device=dev), start[1:]])
    last = torch.cat([start[1:] - 1, torch.tensor([lim.max], device=dev)])
    offsets = t.hap_offsets.to(torch.int64)

    def hap(x):
        return (torch.searchsorted(offsets, x, right=True) - 1).clamp(
            0, t.hap_range.shape[0] - 1)

    h0, h1 = hap(first), hap(last)
    ridx = torch.where(h0 == h1, t.hap_range[h0], SEARCH_HAP)
    trio = t.trio_seg.to(torch.int64)
    before = torch.cat([torch.full((2,), -1, device=dev), trio])[:len(trio)]
    return torch.stack([start, node, trio, before, ridx.to(torch.int64),
                        t.nodes_len[node - 1].to(torch.int64),
                        t.base_offset[node - 1].to(torch.int64),
                        torch.zeros_like(start)],
                       dim=1).to(torch.int32).contiguous()


# ---------------------------------------------------------------------------
# the CUDA kernels
# ---------------------------------------------------------------------------
def build_scatter_kernels(src: Path | str | None = None) -> ctypes.CDLL:
    """Compile csrc/classify_scatter.cu (or ``src``, a source with the same
    C entry points, such as an earlier commit's; once per source content)
    and load it."""
    lib = compile_kernels(src if src is not None else _SRC)
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    common = [vp, vp, vp, i32, vp, i32, vp, i32, vp, i32, i32, i32, vp, vp,
              i32, vp, vp, vp]
    # K6 takes its records (seg_rec) after trio_seg; sources before the
    # records have the entry without them
    for name, records in ((_K6_ENTRY, 1), ("classify_scatter_ranges_launch",
                                           0)):
        if hasattr(lib, name):
            getattr(lib, name).restype = i32
            getattr(lib, name).argtypes = common + [vp] * (records + 7)
    lib.classify_scatter_launch.restype = i32
    lib.classify_scatter_launch.argtypes = common + [i32, i32] + [vp] * 6
    return lib


def _check_args(ts, te, aligned, tables, tstart, tnode, acc, n_acc: int):
    """The checks both kernels' wrappers make: every tensor on one CUDA
    device with its dtype, rank and contiguity; the first ``n_acc``
    accumulators of the lengths the plain version gives them (each with its
    sink slot).  Returns (device, B, M)."""
    t = tables
    dev = ts.device
    M = tstart.shape[0]
    if len(acc) < n_acc:
        raise ValueError(f"the scatter takes {n_acc} accumulators, got "
                         f"{len(acc)}")
    named = [("ts", ts, torch.int32), ("te", te, torch.int32),
             ("aligned", aligned, torch.bool), ("tstart", tstart, torch.int32),
             ("tnode", tnode, torch.int32)]
    named += [(name, getattr(t, name), torch.int32) for name in (
        "hap_offsets", "hap_range", "pos_lo", "nodes_len", "base_offset",
        "trio_seg")]
    lengths = (t.N_pad + 1, t.TB_pad + 1, t.U_pad + 1, M + 1, M + 1)
    dtypes = (torch.int64, torch.int32, torch.int64, torch.int32, torch.int32)
    named += [(f"acc[{i}]", a, dt)
              for i, (a, dt) in enumerate(zip(acc[:n_acc], dtypes))]
    for name, x, dtype in named:
        if x.device != dev or dev.type != "cuda":
            raise ValueError(f"{name} must be on one CUDA device with ts "
                             f"(got {x.device})")
        if x.dtype != dtype or x.dim() != 1:
            raise ValueError(f"{name} must be {dtype} with 1 dim")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    B = ts.shape[0]
    if te.shape[0] != B or aligned.shape[0] != B:
        raise ValueError("ts, te and aligned disagree on B")
    if M < 1 or tnode.shape[0] != M or t.trio_seg.shape[0] != M:
        raise ValueError("tstart, tnode and trio_seg disagree on M (>= 1)")
    if t.hap_range.shape[0] < 1 or t.hap_offsets.shape[0] < 1:
        raise ValueError("the haplotype tables are empty")
    if t.pos_lo.shape[0] < 2:
        raise ValueError("pos_lo holds fewer than 2 bounds")
    if (t.nodes_len.shape[0] != t.N_pad
            or t.base_offset.shape[0] != t.N_pad + 1):
        raise ValueError("nodes_len / base_offset do not hold N_pad / "
                         "N_pad + 1 entries")
    for i, (a, n) in enumerate(zip(acc[:n_acc], lengths)):
        if a.shape[0] != n:
            raise ValueError(f"acc[{i}] holds {a.shape[0]} entries, not {n}")
    return dev, B, M


def _check_records(tables, M: int, dev) -> None:
    """K6's records (``tables.seg_rec``, scatter_records) on ``dev``: int32
    [M, 8], contiguous, on a 32-byte boundary."""
    x = getattr(tables, "seg_rec", None)
    if x is None:
        raise ValueError("the tables hold no seg_rec (scatter_records; "
                         "build_fused_tables makes it)")
    if x.device != dev:
        raise ValueError(f"seg_rec must be on {dev} (got {x.device})")
    if x.dtype != torch.int32 or tuple(x.shape) != (M, 8):
        raise ValueError(f"seg_rec must be int32 [{M}, 8], not {x.dtype} "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous() or x.data_ptr() % 32:
        raise ValueError("seg_rec must be contiguous on a 32-byte boundary")


def _launch(fn, dev, ts, te, aligned, tables, tstart, tnode, M: int, *rest):
    """Call the C entry point ``fn`` with the per-read columns, the tables
    and ``rest`` on the current stream (no synchronise); raise on the CUDA
    error it returns."""
    t = tables
    with torch.cuda.device(dev):
        rc = fn(ts.data_ptr(), te.data_ptr(), aligned.data_ptr(),
                ts.shape[0], t.hap_offsets.data_ptr(), t.hap_offsets.shape[0],
                t.hap_range.data_ptr(), t.hap_range.shape[0],
                t.pos_lo.data_ptr(), t.pos_lo.shape[0], int(t.win_shift),
                int(t.pos_steps), tstart.data_ptr(), tnode.data_ptr(), M,
                t.nodes_len.data_ptr(), t.base_offset.data_ptr(),
                t.trio_seg.data_ptr(), *rest,
                torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{fn.__name__} failed: CUDA error {rc}")


def launch_k6(lib, ts, te, aligned, tables, tstart, tnode,
              acc) -> torch.Tensor:
    """Check K6's arguments, then launch ``lib``'s K6 on the current
    stream (no synchronise, no count): with the tables' records where the
    build takes them, else an earlier source's entry without them.  Returns
    ridx int32 [B]."""
    dev, B, M = _check_args(ts, te, aligned, tables, tstart, tnode, acc, 5)
    records = ()
    if hasattr(lib, _K6_ENTRY):
        _check_records(tables, M, dev)
        fn = getattr(lib, _K6_ENTRY)
        records = (tables.seg_rec.data_ptr(),)
    else:  # an earlier source's K6, without the records
        fn = lib.classify_scatter_ranges_launch
    ridx = torch.empty(B, dtype=torch.int32, device=dev)
    if B:  # a launch of no blocks is an error
        _launch(fn, dev, ts, te, aligned, tables, tstart, tnode, M, *records,
                *(a.data_ptr() for a in acc[:5]), ridx.data_ptr())
    return ridx


def _check_window(L_cap: int) -> None:
    if not 1 <= L_cap <= MAX_L_CAP:
        raise ValueError(f"K11 takes a node window of 1..{MAX_L_CAP} "
                         f"segments (got {L_cap})")


def launch_k11(lib, ts, te, aligned, tables, tstart, tnode, acc,
               L_cap: int):
    """Check K11's arguments, then launch ``lib``'s classify_scatter_launch
    on the current stream (no synchronise, no count).  Of ``acc`` K11 adds
    to the first three (the range scatter's segment-depth pair may
    follow).  Returns (ridx int32 [B], overflow bool [B])."""
    _check_window(L_cap)
    dev, B, M = _check_args(ts, te, aligned, tables, tstart, tnode, acc, 3)
    ridx = torch.empty(B, dtype=torch.int32, device=dev)
    overflow = torch.empty(B, dtype=torch.bool, device=dev)
    if B:
        _launch(lib.classify_scatter_launch, dev, ts, te, aligned, tables,
                tstart, tnode, M, int(L_cap), int(bool(tables.has_dups)),
                *(a.data_ptr() for a in acc[:3]), ridx.data_ptr(),
                overflow.data_ptr())
    return ridx, overflow


def classify_scatter_ranges_cuda(ts, te, aligned, tables, tstart, tnode,
                                 acc) -> torch.Tensor:
    """Check K6's arguments (before building anything) and launch the
    current source's K6 on the current stream, no synchronise (launch_k6,
    counted).  Returns ridx int32 [B]."""
    dev, _, M = _check_args(ts, te, aligned, tables, tstart, tnode, acc, 5)
    _check_records(tables, M, dev)
    ridx = launch_k6(build_scatter_kernels(), ts, te, aligned, tables,
                     tstart, tnode, acc)
    if ts.shape[0]:
        LAUNCHES["classify_scatter_ranges"] += 1
    return ridx


def classify_scatter_cuda(ts, te, aligned, tables, tstart, tnode, acc,
                          L_cap: int):
    """Check K11's arguments (before building anything) and launch the
    current source's K11 on the current stream, no synchronise
    (launch_k11, counted).  Returns (ridx int32 [B], overflow bool [B])."""
    _check_window(L_cap)
    _check_args(ts, te, aligned, tables, tstart, tnode, acc, 3)
    out = launch_k11(build_scatter_kernels(), ts, te, aligned, tables,
                     tstart, tnode, acc, L_cap)
    if ts.shape[0]:
        LAUNCHES["classify_scatter"] += 1
    return out


def classify_scatter_ranges(ts, te, aligned, tables, tstart, tnode,
                            acc) -> torch.Tensor:
    """The range decomposition's classify + scatter of aligned text
    intervals ``ts`` / ``te`` (int32 [B] on the card) into ``acc`` = (bases
    int64 [N_pad + 1], diff int32 [TB_pad + 1], trio int64 [U_pad + 1],
    seg_node_depth int32 [M + 1], seg_trio_depth int32 [M + 1]) in place;
    returns ridx int32 [B]."""
    if ts.device.type == "cpu":
        LAUNCHES["classify_scatter_ranges_plain"] += 1
        return classify_scatter_ranges_plain(ts, te, aligned, tables, tstart,
                                             tnode, acc)
    return classify_scatter_ranges_cuda(ts, te, aligned, tables, tstart,
                                        tnode, acc)


def classify_scatter(ts, te, aligned, tables, tstart, tnode, acc,
                     L_cap: int):
    """The windowed classify + scatter at a node window of ``L_cap``
    segments into acc[:3] in place; returns (ridx int32 [B], overflow bool
    [B])."""
    if ts.device.type == "cpu":
        LAUNCHES["classify_scatter_plain"] += 1
        return classify_scatter_plain(ts, te, aligned, tables, tstart, tnode,
                                      acc, L_cap)
    return classify_scatter_cuda(ts, te, aligned, tables, tstart, tnode, acc,
                                 L_cap)
