"""K8: the strain solve's batched ADMM chunk.

The JAX package runs a chunk of its ADMM as one device program:
``_admm_chunk_batch`` (pantax_tpu/profile/pao.py:133), a jitted vmap of
``_admm_chunk_impl`` (:111) over ``_admm_scan``'s steps (:60-80).  Two
versions here:

- the CUDA kernel, ``csrc/admm_chunk.cu``, built with nvcc for sm_90a at
  first use into the git-ignored build directory (ops/extend.py's
  ``compile_kernels``) and bound with ctypes.  One launch runs every step
  of the chunk for every instance: one thread block cluster an instance,
  the instance's rows cut among the cluster's threads (``launch_plan``).
  Where the caller says A is 0/1 (every A the port's solvers build), the
  bits plan holds each row's entries as bits in registers, in a cluster
  sized to the bucket (BITS_CLUSTER); otherwise the float plan holds A in
  shared memory or streams it, in a cluster of CLUSTER CTAs;
- the plain torch version, profile/pao.py's ``_admm_chunk_batch_plain``
  (a Python loop of torch operations a step).

profile/pao.py's ``_admm_chunk_batch`` takes the plain version only where
every tensor lies on the CPU, and ``admm_chunk_cuda`` otherwise: on a CUDA
tensor it launches the kernel or raises; nothing falls back.  The kernel
sums in another order than the plain version (a fixed one: two launches
give the same bits), so the two agree to float32 rounding, not bit for
bit.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from pathlib import Path

import torch

from .extend import LAUNCHES, compile_kernels

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "admm_chunk.cu"
CLUSTER = 8           # CTAs a cluster of the float plan, one an instance
MAX_THREADS = 1024
MAX_SMEM = 232_448    # a block's shared memory on sm_90
L_SHARED_MAX = 128    # p_pad up to which L sits in shared memory
ON_CHIP_ROWS = (1, 2, 4, 8)  # rows a thread that the on-chip kernels take
BITS_WIDTHS = (4, 8, 16, 32, 64)  # the bits plan's compile-time widths
# The bits plan's CTAs an instance, by n_pad: (at p_pad 4, at p_pad 8-64),
# each min(1024, n_pad / CTAs) threads of at most 8 rows (4 or 8 past
# p_pad 4): the fastest size the bucket takes.  ms of a 250-step chunk
# of one instance by 1 / 2 / 4 / 8 CTAs (scripts/time_extend.py --kernel
# k8; NVIDIA H100 80GB HBM3, 700 W):
#   n_pad   p_pad 4                          p_pad 32
#   4096    0.3281 / 0.2759 / 0.2742 / 0.2322   1.4056 / - / - / -
#   8192    0.4086 / 0.3469 / 0.2902 / 0.3366   2.0045 / 1.4209 / - / -
#   16384   - / 0.4311 / 0.3617 / 0.3513        - / 2.0187 / 1.4374 / -
#   32768   - / - / 0.4437 / 0.4215             - / - / 2.0340 / 1.4984
#   65536   - / - / - / 0.5087                  - / - / - / 2.0957
BITS_CLUSTER = {4096: (8, 1), 8192: (4, 2), 16384: (8, 4), 32768: (8, 8),
                65536: (8, 8)}


@dataclass(frozen=True)
class AdmmPlan:
    """How K8 runs one bucket: ``cluster`` CTAs of ``threads`` threads an
    instance, ``rows_per_thread`` rows a thread (cluster * threads *
    rows_per_thread == n_pad); ``bits``: the rows' 0/1 entries as bits in
    registers (always on chip); else the float plan, the rows' A and b in
    shared memory and z, uz in registers (``on_chip``) or read from global
    memory every step; ``smem_bytes`` of dynamic shared memory a CTA (the
    C entry counts it again)."""

    cluster: int
    threads: int
    rows_per_thread: int
    on_chip: bool
    smem_bytes: int
    bits: bool = False


def smem_bytes(threads: int, rows_per_thread: int, p_pad: int,
               on_chip: bool) -> int:
    """A CTA's dynamic shared memory (csrc/admm_chunk.cu's smem_floats):
    on chip the slice's A and b; the p-vectors; the CTA sums (two
    buffers); the warps' sums of 4 columns (two buffers); the residual
    maxima; L up to L_SHARED_MAX."""
    rows = threads * rows_per_thread
    floats = ((rows * (p_pad + 1) if on_chip else 0) + 9 * p_pad
              + 8 * (threads // 32) + 33
              + (p_pad * p_pad if p_pad <= L_SHARED_MAX else 0))
    return 4 * floats


def bits_width(p_pad: int) -> int:
    """The bits plan's compile-time width for p_pad (the columns past
    p_pad are zero)."""
    return next(w for w in BITS_WIDTHS if p_pad <= w)


def bits_smem_bytes(threads: int, rows_per_thread: int, width: int) -> int:
    """A CTA's dynamic shared memory in the bits plan (csrc/admm_chunk.cu's
    bits_smem_floats): the slots' two barriers; the CTA sums' slots of 8
    ranks (two buffers); L (4 x 4 at width 4, else by columns and by
    rows); the tables of x's sums over 4 columns' subsets (each warp's at
    width 4, else the CTA's); x, 1 / L_jj, ub and w at entry; the rows'
    b, c, v and bits past width 4; the warps' column sums; the residual
    maxima."""
    warps = threads // 32
    rows = threads * rows_per_thread
    words = threads * (-(-rows_per_thread * width // 32))
    floats = (4 + 2 * 8 * width + (2 * width * width if width > 4 else 16)
              + (warps * 16 if width == 4 else 4 * width) + 4 * width
              + (3 * rows + words if width > 4 else 0) + 33 * width + 33)
    return 4 * floats


def launch_plan(S: int, n_pad: int, p_pad: int,
                binary: bool = False) -> AdmmPlan:
    """K8's plan for S instances of n_pad rows and p_pad columns.  Where
    the caller says A is 0/1 (``binary``), p_pad is at most 64 and n_pad a
    BITS_CLUSTER bucket: the bits plan, BITS_CLUSTER's CTAs an instance of
    min(1024, n_pad / cluster) threads.  Otherwise the float plan: CLUSTER
    CTAs an instance of min(1024, n_pad / CLUSTER) threads, so a CTA holds
    n_pad / CLUSTER rows; on chip where that is 1, 2, 4 or 8 rows a thread
    and the slice's A and b fit in shared memory, else streamed.  Raises
    ValueError where no plan fits: n_pad not of the solvers' buckets, or
    p_pad past P_PAD_MAX (a species' candidate paths, padded to 4: the
    CTA keeps 9 vectors of p_pad in shared memory)."""
    if S < 1:
        raise ValueError(f"K8 takes S >= 1 instances (got {S})")
    if p_pad < 4 or p_pad % 4:
        raise ValueError(f"K8 takes p_pad a positive multiple of 4 (got "
                         f"{p_pad})")
    if binary and p_pad <= BITS_WIDTHS[-1] and n_pad in BITS_CLUSTER:
        cluster = BITS_CLUSTER[n_pad][p_pad > 4]
        threads = min(MAX_THREADS, n_pad // cluster)
        rpt = n_pad // (cluster * threads)
        return AdmmPlan(cluster, threads, rpt, True,
                        bits_smem_bytes(threads, rpt, bits_width(p_pad)),
                        bits=True)
    threads = min(MAX_THREADS, n_pad // CLUSTER)
    if threads < 32 or threads % 32 or n_pad % (CLUSTER * threads):
        raise ValueError(
            f"K8 takes n_pad a multiple of {CLUSTER * 32} up to "
            f"{CLUSTER * MAX_THREADS}, and of {CLUSTER * MAX_THREADS} past "
            f"it (got {n_pad})")
    rpt = n_pad // (CLUSTER * threads)
    on_chip = (rpt in ON_CHIP_ROWS
               and smem_bytes(threads, rpt, p_pad, True) <= MAX_SMEM)
    smem = smem_bytes(threads, rpt, p_pad, on_chip)
    if smem > MAX_SMEM:
        raise ValueError(f"K8 takes p_pad up to {P_PAD_MAX} candidate paths "
                         f"a species (got {p_pad}: {smem} bytes of shared "
                         f"memory a CTA, at most {MAX_SMEM})")
    return AdmmPlan(CLUSTER, threads, rpt, on_chip, smem)


# the widest p_pad that any plan fits (streamed, 1024 threads)
P_PAD_MAX = 4 * ((MAX_SMEM // 4 - 8 * (MAX_THREADS // 32) - 33) // 36)


def build_admm_kernel() -> ctypes.CDLL:
    """Compile csrc/admm_chunk.cu (once per source content) and load it."""
    lib = compile_kernels(_SRC)
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.admm_chunk_plan_launch.restype = i32
    lib.admm_chunk_plan_launch.argtypes = (
        [vp] * 8 + [i64] * 3 + [i32] * 4 + [ctypes.c_float] + [i32] * 5
        + [vp] * 7)
    return lib


def _check_args(A, b, ub, state, L, iters: int, binary: bool):
    """Every tensor float32 on A's CUDA device with the shapes of one
    bucket; all but L contiguous, A on a 16-byte boundary.  Returns the
    plan."""
    if A.dim() != 3:
        raise ValueError(f"A must be [S, n, p] (got {tuple(A.shape)})")
    S, n, p = A.shape
    x, z, w, uz, uw = state
    dev = A.device
    named = (("A", A, (S, n, p)), ("b", b, (S, n)), ("ub", ub, (S, p)),
             ("x", x, (S, p)), ("z", z, (S, n)), ("w", w, (S, p)),
             ("uz", uz, (S, n)), ("uw", uw, (S, p)), ("L", L, (S, p, p)))
    for name, t, shape in named:
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"{name} must be on one CUDA device with A "
                             f"(got {t.device})")
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 (got {t.dtype})")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {list(shape)} (got "
                             f"{list(t.shape)})")
        if name != "L" and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if A.data_ptr() % 16:
        raise ValueError("A must start on a 16-byte boundary")
    if iters < 1:
        raise ValueError(f"K8 takes iters >= 1 (got {iters})")
    return launch_plan(S, n, p, binary)


def launch_k8(A, b, ub, rho: float, state, L, iters: int,
              binary: bool = False):
    """Check K8's arguments (before building anything), build K8 and
    launch it on the current stream (no synchronise, no count): the bits
    plan where ``binary`` (the caller knows A is 0/1) and the bucket fits
    it, else the float plan.  The outputs are fresh tensors (callers pass
    aliased state: one zero tensor as x, w and uw).  Returns ((x, z, w,
    uz, uw), res [S])."""
    plan = _check_args(A, b, ub, state, L, iters, binary)
    lib = build_admm_kernel()
    S, n, p = A.shape
    _x, z, w, uz, uw = state
    outs = tuple(torch.empty_like(t) for t in state)
    res = torch.empty(S, dtype=torch.float32, device=A.device)
    thresh = 1.0 / (max(n, 1) * rho)  # as the plain version
    with torch.cuda.device(A.device):
        rc = lib.admm_chunk_plan_launch(
            A.data_ptr(), b.data_ptr(), ub.data_ptr(), z.data_ptr(),
            w.data_ptr(), uz.data_ptr(), uw.data_ptr(), L.data_ptr(),
            *L.stride(), S, n, p, int(iters), thresh, plan.cluster,
            plan.threads, plan.rows_per_thread, int(plan.on_chip),
            int(plan.bits), *(t.data_ptr() for t in outs), res.data_ptr(),
            torch.cuda.current_stream(A.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"admm_chunk_plan_launch failed: CUDA error {rc}")
    return outs, res


def admm_chunk_cuda(A, b, ub, rho: float, state, L, iters: int,
                    binary: bool = False):
    """K8 on the current stream, no synchronise (launch_k8, counted)."""
    out = launch_k8(A, b, ub, rho, state, L, iters, binary)
    LAUNCHES["admm_chunk"] += 1
    return out
