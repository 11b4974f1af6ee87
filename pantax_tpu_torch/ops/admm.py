"""K8: the strain solve's batched ADMM chunk.

The JAX package runs a chunk of its ADMM as one device program:
``_admm_chunk_batch`` (pantax_tpu/profile/pao.py:133), a jitted vmap of
``_admm_chunk_impl`` (:111) over ``_admm_scan``'s steps (:60-80).  Two
versions here:

- the CUDA kernel, ``csrc/admm_chunk.cu``, built with nvcc for sm_90a at
  first use into the git-ignored build directory (ops/extend.py's
  ``compile_kernels``) and bound with ctypes.  One launch runs every step
  of the chunk for every instance: one thread block cluster of CLUSTER
  CTAs an instance, the instance's rows cut among the cluster's threads
  and held on chip across the steps where they fit (``launch_plan``);
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
CLUSTER = 8           # CTAs a cluster, one cluster an instance
MAX_THREADS = 1024
MAX_SMEM = 232_448    # a block's shared memory on sm_90
L_SHARED_MAX = 128    # p_pad up to which L sits in shared memory
ON_CHIP_ROWS = (1, 2, 4, 8)  # rows a thread that the on-chip kernels take


@dataclass(frozen=True)
class AdmmPlan:
    """How K8 runs one bucket: ``cluster`` CTAs of ``threads`` threads an
    instance, ``rows_per_thread`` rows a thread (cluster * threads *
    rows_per_thread == n_pad), the rows' A and b in shared memory and z, uz
    in registers (``on_chip``) or read from global memory every step,
    ``smem_bytes`` of dynamic shared memory a CTA (L's p_pad^2 floats in it
    up to L_SHARED_MAX; the C entry counts it again from the rest)."""

    cluster: int
    threads: int
    rows_per_thread: int
    on_chip: bool
    smem_bytes: int


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


def launch_plan(S: int, n_pad: int, p_pad: int) -> AdmmPlan:
    """K8's plan for S instances of n_pad rows and p_pad columns: CLUSTER
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
    lib.admm_chunk_launch.restype = i32
    lib.admm_chunk_launch.argtypes = (
        [vp] * 8 + [i64] * 3 + [i32] * 4 + [ctypes.c_float] + [i32] * 3
        + [vp] * 7)
    return lib


def _check_args(A, b, ub, state, L, iters: int):
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
    return launch_plan(S, n, p)


def launch_k8(A, b, ub, rho: float, state, L, iters: int):
    """Check K8's arguments (before building anything), build K8 and
    launch it on the current stream (no synchronise, no count).  The
    outputs are fresh tensors (callers pass aliased state: one zero tensor
    as x, w and uw).  Returns ((x, z, w, uz, uw), res [S])."""
    plan = _check_args(A, b, ub, state, L, iters)
    lib = build_admm_kernel()
    S, n, p = A.shape
    _x, z, w, uz, uw = state
    outs = tuple(torch.empty_like(t) for t in state)
    res = torch.empty(S, dtype=torch.float32, device=A.device)
    thresh = 1.0 / (max(n, 1) * rho)  # as the plain version
    with torch.cuda.device(A.device):
        rc = lib.admm_chunk_launch(
            A.data_ptr(), b.data_ptr(), ub.data_ptr(), z.data_ptr(),
            w.data_ptr(), uz.data_ptr(), uw.data_ptr(), L.data_ptr(),
            *L.stride(), S, n, p, int(iters), thresh, plan.threads,
            plan.rows_per_thread, int(plan.on_chip),
            *(t.data_ptr() for t in outs), res.data_ptr(),
            torch.cuda.current_stream(A.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"admm_chunk_launch failed: CUDA error {rc}")
    return outs, res


def admm_chunk_cuda(A, b, ub, rho: float, state, L, iters: int):
    """K8 on the current stream, no synchronise (launch_k8, counted)."""
    out = launch_k8(A, b, ub, rho, state, L, iters)
    LAUNCHES["admm_chunk"] += 1
    return out
