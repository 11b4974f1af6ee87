"""K9 and K10b: the device tail's strain stats and coordinate-median polish.

The JAX package runs both as jitted device programs that XLA compiles:
``_tail_stats`` (pantax_tpu/ops/profile_tail.py:167), the segment sums the
strain filters read, and ``_polish_batch`` (:391), 8 sweeps of a
coordinate median over a bucket of solutions.  Two versions of each here:

- the CUDA kernels, ``csrc/profile_tail.cu``, built with nvcc for sm_90a at
  first use into the git-ignored build directory (ops/extend.py's
  ``compile_kernels``) and bound with ctypes.  K9 is one launch a
  ``dispatch_tail_stats``: a CTA a hap over its owner-sorted trios and its
  path, a CTA a species over its node slice, every float sum in a fixed
  order.  K10b is one launch a bucket a solve: a thread block cluster an
  instance (``polish_plan``), each column's median an exact radix select;
- the plain torch versions, ops/profile_tail.py's ``tail_stats_plain`` and
  ``polish_batch_plain``.

ops/profile_tail.py's ``tail_stats`` and ``polish_batch`` take the plain
versions only where the tensors lie on the CPU, and these wrappers
otherwise: on a CUDA tensor they launch the kernel or raise; nothing falls
back.  K10b gives the plain polish's x bit for bit (up to the sign of a
zero); K9 gives its counts, path_cov and max exactly and its float sums to
float32 rounding (it sums in double, in one order every launch).
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
BINS = 256              # a radix pass's digits


@dataclass(frozen=True)
class PolishPlan:
    """How K10b runs one bucket: ``cluster`` CTAs of POLISH_THREADS threads
    an instance, ``rows`` = n_pad / cluster rows a CTA; ``on_chip``: the
    rows' residuals in shared memory (else a global scratch);
    ``smem_bytes`` of dynamic shared memory a CTA."""

    cluster: int
    rows: int
    on_chip: bool
    smem_bytes: int


def polish_smem_bytes(rows: int, p_pad: int, on_chip: bool) -> int:
    """A K10b CTA's dynamic shared memory (csrc/profile_tail.cu's
    polish_smem_bytes): two histograms, a column's live bits, x and ub,
    the bins' warp totals and the selection, and the rows' r on chip."""
    return (4 * (2 * BINS + rows // 32 + 2 * p_pad + BINS // 32 + 4)
            + (4 * rows if on_chip else 0))


def polish_plan(S: int, n_pad: int, p_pad: int) -> PolishPlan:
    """K10b's plan for S instances of n_pad rows and p_pad columns: the
    largest power of two up to MAX_CLUSTER and n_pad / CLUSTER_ROWS that
    cuts n_pad into whole blocks of POLISH_THREADS rows (1 CTA at 4096 and
    8192 rows, 8 from 65536); the residuals on chip where they fit.
    Raises ValueError where no plan fits: n_pad not a positive multiple of
    POLISH_THREADS, or a CTA's live bits and x past shared memory."""
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
    on_chip = polish_smem_bytes(rows, p_pad, True) <= MAX_SMEM
    smem = polish_smem_bytes(rows, p_pad, on_chip)
    if smem > MAX_SMEM:
        raise ValueError(f"K10b: {smem} bytes of shared memory a CTA at "
                         f"n_pad {n_pad}, p_pad {p_pad} (at most {MAX_SMEM})")
    return PolishPlan(cluster, rows, on_chip, smem)


def build_tail_kernels(src: Path | str | None = None) -> ctypes.CDLL:
    """Compile csrc/profile_tail.cu (or ``src``, a source with the same C
    entry points, such as an earlier commit's; once per source content)
    and load it."""
    lib = compile_kernels(src or _SRC)
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.tail_stats_launch.restype = i32
    lib.tail_stats_launch.argtypes = (
        [vp] * 8 + [ctypes.c_float, i32, i32, vp, vp])
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
    tail_stats_launch of ``lib`` (default: build_tail_kernels()) on the
    current stream (no synchronise, no count).  ``order`` is TailTables'
    (trio_order, hap_trio_off, hap_path_off, sp_node_span).  Returns
    tail_stats_plain's seven float32 outputs, views of one fresh buffer."""
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
    lib = lib or build_tail_kernels()
    out = torch.empty(3 * G + 4 * S, dtype=f32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.tail_stats_launch(
            na.data_ptr(), ta.data_ptr(), bc.data_ptr(),
            trio_order.data_ptr(), hap_trio_off.data_ptr(),
            path_node.data_ptr(), hap_path_off.data_ptr(),
            sp_node_span.data_ptr(), float(min_depth), G, S, out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
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
    r = (None if plan.on_chip
         else torch.empty((S, n), dtype=f32, device=dev))
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
