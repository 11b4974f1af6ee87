"""K9 and K10b: the device tail's strain stats and coordinate-median polish.

The JAX package runs both as jitted device programs that XLA compiles:
``_tail_stats`` (pantax_tpu/ops/profile_tail.py:167), the segment sums the
strain filters read, and ``_polish_batch`` (:391), 8 sweeps of a
coordinate median over a bucket of solutions.  Two versions of each here:

- the CUDA kernels, ``csrc/profile_tail.cu``, built with nvcc for sm_90a at
  first use into the git-ignored build directory (ops/extend.py's
  ``compile_kernels``) and bound with ctypes.  K9 is one launch a
  ``dispatch_tail_stats``: a thread block cluster a hap and a species
  (``stats_plan``), a hap's owner-sorted trio values gathered once into
  registers through its three passes, its path gathered under them, the
  passes' sums exchanged across the cluster, every float sum in a fixed
  order.  K10b is one launch a bucket a solve: a thread block cluster an
  instance (``polish_plan``), A read once into live bits, each column's
  median an exact radix select (one cluster round for the first digit,
  one to push the candidates of its bin, the rest in each CTA alone), an
  instance stopped after a sweep that moves nothing;
- the plain torch versions, ops/profile_tail.py's ``tail_stats_plain`` and
  ``polish_batch_plain``.

ops/profile_tail.py's ``dispatch_tail_stats`` and ``polish_batch`` take
the plain versions only where the tensors lie on the CPU, and these
wrappers otherwise: on a CUDA tensor they launch the kernel or raise;
nothing falls back.  K10b gives the plain polish's x bit for bit (up to
the sign of a zero; it takes A to be 0/1, as the device tail builds it,
and gives NaN x to an instance whose A holds another value); K9 gives its
counts, path_cov and max exactly and its float sums to float32 rounding
(it sums in double, in one order every launch).
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from pathlib import Path

import torch

from .extend import LAUNCHES, compile_kernels

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "profile_tail.cu"
POLISH_THREADS = 1024   # a K10b CTA's threads
MAX_CLUSTER = 8         # CTAs a K10b cluster (portable)
CLUSTER_ROWS = 8192     # K10b adds a CTA to the cluster for each this many rows
MAX_SMEM = 232_448      # a block's shared memory on sm_90
DIGIT_BINS = 2048       # the first radix digit's bins (11 bits)
REG_ROWS = 8            # rows a K10b thread holds in registers at most
MAX_CAP = 16384         # candidate keys a K10b CTA holds at most
MIN_CAP = 4096          # r on chip only where this many candidates still fit
RANK_SELECT = 256       # candidates K10b ranks at once
STATS_THREADS = 512     # a K9 CTA's threads
STATS_REGS = (4, 8, 16)  # the trio values a K9 thread may hold in registers
SMS = 132               # the H100's SMs, which K9's grid fills


@dataclass(frozen=True)
class StatsPlan:
    """How K9 runs: ``cluster`` CTAs of STATS_THREADS threads a hap and a
    species, ``regs`` trio values a thread in registers (the trios past
    regs x STATS_THREADS x cluster of a hap are gathered from L2 in each
    pass)."""

    cluster: int
    regs: int


def stats_plan(G: int, S: int, trios: int) -> StatsPlan:
    """K9's plan for G haps, S species and ``trios`` owned trios
    (csrc/profile_tail.cu's tail_stats_plan_launch checks it again): the
    smallest power of two up to MAX_CLUSTER whose (G + S) x cluster CTAs
    fill the SMS, doubled while a hap of the mean size would not fit the
    registers (STATS_REGS' largest a thread); the fewest STATS_REGS that
    hold a hap of twice the mean (haps vary: the smoke DB's largest
    overflows 8 a thread at 4 CTAs, which its mean fits).  A function of
    the shapes only, so the order of every sum, and the bits, follow from
    them.  Raises ValueError on G or S below 1 or trios below 0."""
    if G < 1 or S < 1 or trios < 0:
        raise ValueError(f"K9 takes G >= 1, S >= 1 and trios >= 0 (got {G},"
                         f" {S}, {trios})")
    cluster = 1
    while cluster < MAX_CLUSTER and (G + S) * cluster < SMS:
        cluster *= 2
    per_hap = -(-trios // G)
    while (cluster < MAX_CLUSTER
           and per_hap > STATS_REGS[-1] * STATS_THREADS * cluster):
        cluster *= 2
    regs = next((r for r in STATS_REGS
                 if r * STATS_THREADS * cluster >= 2 * per_hap),
                STATS_REGS[-1])
    return StatsPlan(cluster, regs)


@dataclass(frozen=True)
class PolishPlan:
    """How K10b runs one bucket: ``cluster`` CTAs of POLISH_THREADS threads
    an instance, ``rows`` = n_pad / cluster rows a CTA, ``reg_rows`` of
    them a thread in registers (0: in memory); ``bits_on_chip``: the rows'
    live bits on chip, ``on_chip``: their residuals too (else in a global
    scratch of ``scratch`` floats); ``cap`` candidate keys a CTA;
    ``smem_bytes`` of dynamic shared memory a CTA."""

    cluster: int
    rows: int
    reg_rows: int
    on_chip: bool
    bits_on_chip: bool
    cap: int
    smem_bytes: int
    scratch: int


def polish_reg_rows(rows: int, p_pad: int) -> int:
    """Rows a K10b thread holds in registers (csrc/profile_tail.cu's
    polish_reg_rows): all of a CTA's 4096 or 8192 rows, a column a bit, at
    p_pad up to 32; else 0 (r and the live bits in memory)."""
    return (rows // POLISH_THREADS if p_pad <= 32 and rows in (
        4 * POLISH_THREADS, REG_ROWS * POLISH_THREADS) else 0)


def polish_smem_bytes(rows: int, p_pad: int, on_chip: bool,
                      bits_on_chip: bool, cap: int) -> int:
    """A K10b CTA's dynamic shared memory (csrc/profile_tail.cu's
    polish_fixed_words and polish_layout): the exchanges' three barriers
    (eight words), the histogram twice, the cluster's sums by 32 bins
    twice (a slot a rank) and the CTA's own, the selection's words, the warps' counts, the
    last RANK_SELECT candidates, four words a column (live count, k, x,
    ub) and two flags; the live bits, a word a column per 32 rows, and the
    rows' r, where on chip and not in registers; the candidates."""
    mem = not polish_reg_rows(rows, p_pad)
    return 4 * (2 * DIGIT_BINS + (2 * MAX_CLUSTER + 1) * (DIGIT_BINS // 32)
                + 8 + 32 + RANK_SELECT + 4 * p_pad + 2 + 8
                + (p_pad * (rows // 32) if bits_on_chip and mem else 0)
                + (rows if on_chip and mem else 0) + cap)


def polish_plan(S: int, n_pad: int, p_pad: int) -> PolishPlan:
    """K10b's plan for S instances of n_pad rows and p_pad columns: the
    largest power of two up to MAX_CLUSTER and n_pad / CLUSTER_ROWS that
    cuts n_pad into whole blocks of POLISH_THREADS rows (1 CTA at 4096 and
    8192 rows, 8 from 65536); a CTA's rows in registers where
    polish_reg_rows says so; else the live bits in shared memory where
    MIN_CAP candidates still fit beside them, the residuals too where they
    also fit; the candidates in the room left, at most MAX_CAP and n_pad.
    Raises ValueError where no plan fits: n_pad not a positive multiple of
    POLISH_THREADS, or a CTA's words past shared memory."""
    if S < 1 or p_pad < 1:
        raise ValueError(f"K10b takes S >= 1 and p_pad >= 1 (got {S}, "
                         f"{p_pad})")
    if n_pad < POLISH_THREADS or n_pad % POLISH_THREADS:
        raise ValueError(f"K10b takes n_pad a positive multiple of "
                         f"{POLISH_THREADS} (got {n_pad})")
    cluster = 1
    while (2 * cluster <= min(MAX_CLUSTER, n_pad // CLUSTER_ROWS)
           and n_pad % (2 * cluster * POLISH_THREADS) == 0):
        cluster *= 2
    rows = n_pad // cluster
    reg = polish_reg_rows(rows, p_pad)
    fixed = polish_smem_bytes(rows, p_pad, False, False, 0)
    bits = 0 if reg else 4 * p_pad * (rows // 32)
    bits_on_chip = fixed + bits + 4 * MIN_CAP <= MAX_SMEM
    on_chip = bits_on_chip and (
        reg > 0 or fixed + bits + 4 * (rows + MIN_CAP) <= MAX_SMEM)
    used = polish_smem_bytes(rows, p_pad, on_chip, bits_on_chip, 0)
    cap = min(MAX_CAP, n_pad, (MAX_SMEM - used) // 4)
    if cap < 0:
        raise ValueError(f"K10b: {used} bytes of shared memory a CTA at "
                         f"n_pad {n_pad}, p_pad {p_pad} (at most {MAX_SMEM})")
    scratch = (0 if on_chip else S * n_pad
               + (0 if bits_on_chip else S * p_pad * (n_pad // 32)))
    return PolishPlan(cluster, rows, reg, on_chip, bits_on_chip, cap,
                      used + 4 * cap, scratch)


def build_tail_kernels(src: Path | str | None = None) -> ctypes.CDLL:
    """Compile csrc/profile_tail.cu (or ``src``, a source with the same C
    entry points, such as an earlier commit's; once per source content)
    and load it."""
    lib = compile_kernels(src or _SRC)
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    head = [vp] * 8 + [ctypes.c_float, i32, i32]
    lib.tail_stats_launch.restype = i32
    lib.tail_stats_launch.argtypes = head + [vp, vp]
    if hasattr(lib, "tail_stats_plan_launch"):  # not in earlier sources
        lib.tail_stats_plan_launch.restype = i32
        lib.tail_stats_plan_launch.argtypes = head + [i32, i32, vp, vp]
    lib.polish_launch.restype = i32
    lib.polish_launch.argtypes = [vp] * 4 + [i32] * 6 + [vp] * 3
    return lib


def _check(named) -> torch.device:
    """Every (name, tensor, dtype, shape) on one CUDA device, of its dtype
    and shape (None: any 1-D), contiguous; returns the device."""
    dev = named[0][1].device
    for name, t, dtype, shape in named:
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"{name} must be on one CUDA device with "
                             f"{named[0][0]} (got {t.device})")
        if t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype} (got {t.dtype})")
        if (t.dim() != 1 if shape is None else tuple(t.shape) != shape):
            want = "1-D" if shape is None else list(shape)
            raise ValueError(f"{name} must be {want} (got {list(t.shape)})")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return dev


def launch_k9(na, ta, bc, path_node, order, min_depth: float, *, G: int,
              S: int, lib=None):
    """Check K9's arguments (before building anything) and launch
    tail_stats_plan_launch of ``lib`` (default: build_tail_kernels()) at
    stats_plan's plan on the current stream (no synchronise, no count); a
    build of an earlier source without that entry through its
    tail_stats_launch.  ``order`` is TailTables' (trio_order, hap_trio_off,
    hap_path_off, sp_node_span).  Returns tail_stats_plain's seven float32
    outputs, views of one fresh buffer."""
    trio_order, hap_trio_off, hap_path_off, sp_node_span = order
    if G < 1 or S < 1:
        raise ValueError(f"K9 takes G >= 1 haps and S >= 1 species (got "
                         f"{G}, {S})")
    i32, f32 = torch.int32, torch.float32
    dev = _check((("na", na, f32, None), ("ta", ta, f32, None),
                  ("bc", bc, i32, tuple(na.shape)),
                  ("path_node", path_node, i32, None),
                  ("trio_order", trio_order, i32, None),
                  ("hap_trio_off", hap_trio_off, i32, (G + 1,)),
                  ("hap_path_off", hap_path_off, i32, (G + 1,)),
                  ("sp_node_span", sp_node_span, i32, (2 * S,))))
    plan = stats_plan(G, S, trio_order.numel())
    lib = lib or build_tail_kernels()
    out = torch.empty(3 * G + 4 * S, dtype=f32, device=dev)
    head = (na.data_ptr(), ta.data_ptr(), bc.data_ptr(),
            trio_order.data_ptr(), hap_trio_off.data_ptr(),
            path_node.data_ptr(), hap_path_off.data_ptr(),
            sp_node_span.data_ptr(), float(min_depth), G, S)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if hasattr(lib, "tail_stats_plan_launch"):
            rc = lib.tail_stats_plan_launch(*head, plan.cluster, plan.regs,
                                            out.data_ptr(), stream)
        else:
            rc = lib.tail_stats_launch(*head, out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"tail_stats_launch failed: CUDA error {rc}")
    return (out[:G], out[G:2 * G], out[2 * G:3 * G],
            *out[3 * G:].split(S))


def tail_stats_cuda(na, ta, bc, path_node, order, min_depth: float, *,
                    G: int, S: int):
    """K9 on the current stream, no synchronise (launch_k9, counted)."""
    out = launch_k9(na, ta, bc, path_node, order, min_depth, G=G, S=S)
    LAUNCHES["tail_stats"] += 1
    return out


def launch_k10b(A, b, x, ub, sweeps: int = 8, lib=None):
    """Check K10b's arguments (before building anything) and launch
    polish_launch of ``lib`` (default: build_tail_kernels()) on the
    current stream (no synchronise, no count).  Returns a fresh x [S, p]."""
    if A.dim() != 3:
        raise ValueError(f"A must be [S, n, p] (got {tuple(A.shape)})")
    S, n, p = A.shape
    if sweeps < 0:
        raise ValueError(f"K10b takes sweeps >= 0 (got {sweeps})")
    f32 = torch.float32
    dev = _check((("A", A, f32, (S, n, p)), ("b", b, f32, (S, n)),
                  ("x", x, f32, (S, p)), ("ub", ub, f32, (S, p))))
    plan = polish_plan(S, n, p)
    lib = lib or build_tail_kernels()
    out = torch.empty((S, p), dtype=f32, device=dev)
    r = (torch.empty(plan.scratch, dtype=f32, device=dev) if plan.scratch
         else None)
    with torch.cuda.device(dev):
        rc = lib.polish_launch(
            A.data_ptr(), b.data_ptr(), x.data_ptr(), ub.data_ptr(), S, n, p,
            int(sweeps), plan.cluster, int(plan.on_chip),
            None if r is None else r.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"polish_launch failed: CUDA error {rc}")
    return out


def polish_cuda(A, b, x, ub, sweeps: int = 8):
    """K10b on the current stream, no synchronise (launch_k10b, counted)."""
    out = launch_k10b(A, b, x, ub, sweeps)
    LAUNCHES["polish"] += 1
    return out
