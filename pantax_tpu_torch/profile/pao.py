"""Path Abundance Optimization, PyTorch port of pantax_tpu/profile/pao.py.

Per species: min (1/n) ||A x - b||_1 subject to 0 <= x <= ub, with A the
binary node-membership matrix of the candidate strain paths.  Solved by the
reference's two-block ADMM (Cholesky of AtA + I once, then x-, z- and
w-steps with over-relaxation), batched over species of one padded bucket
shape, stopped on the residual after each chunk of iterations, then
polished on the host into an exact LP vertex.  HiGHS (scipy) is the exact
oracle.

The ADMM runs in float32.  Matrix products are kept in full float32: TF32
(about three decimal digits) would move the iterate by more than the
solver's 1e-5 stopping tolerance, so the solve sets
``torch.backends.cuda.matmul.allow_tf32 = False``.  A chunk of ADMM steps
(``_admm_chunk_batch``) is K8 on the card (ops/admm.py, one launch a
chunk) and ``_admm_chunk_batch_plain`` on the CPU.
"""
from __future__ import annotations

import logging
from dataclasses import dataclass

import numpy as np
import torch

from ..ops import admm
from ..ops.extend import LAUNCHES

log = logging.getLogger("pantax_tpu_torch")

_QUANTUM = 4096  # smallest padded node count of an ADMM bucket


@dataclass
class PaoResult:
    x: np.ndarray          # [p] per-path coverage depth
    objective: float       # (1/n) * sum |Ax - b| over the selected nodes


def sample_valid_nodes(valid_nodes: np.ndarray, sample_nodes: int,
                       sample_test: bool) -> np.ndarray:
    cap = 500 if sample_test else sample_nodes
    if cap and len(valid_nodes) > cap:
        rng = np.random.default_rng(42)
        return np.sort(rng.choice(valid_nodes, size=cap, replace=False))
    return valid_nodes


def _bucket(n: int, quantum: int = _QUANTUM) -> int:
    """Round up to a power-of-two multiple of ``quantum``: zero-padded rows
    add |0 - 0| to the objective, so species of different sizes share one
    batched solve."""
    m = quantum
    while m < n:
        m *= 2
    return m


def _p_pad(p: int) -> int:
    return max(4, -(-p // 4) * 4)


def _admm_factor(A):
    """Cholesky factor of AtA + I, batched: A float32 [S, n, p]."""
    p = A.shape[-1]
    eye = torch.eye(p, dtype=A.dtype, device=A.device)
    return torch.linalg.cholesky(A.mT @ A + eye)


def _admm_chunk_batch(A, b, ub, rho: float, state, L, iters: int,
                      binary: bool = False):
    """Advance S independent ADMM instances by ``iters`` steps; returns the
    new state and each instance's residual max(|Ax-b-z|, |x-w|,
    |w - w_entry|).  A [S, n, p], b [S, n], ub [S, p] (0 pins a path), L
    [S, p, p] the Cholesky factor of A^T A + I; ``binary``: the caller
    knows every entry of A is 0 or 1.  The plain version where every
    tensor lies on the CPU; otherwise K8, one launch
    (ops/admm.admm_chunk_cuda: its bits plan where ``binary``), which
    raises on anything but one CUDA device's float32 tensors of one
    bucket."""
    if all(t.device.type == "cpu" for t in (A, b, ub, *state, L)):
        LAUNCHES["admm_chunk_plain"] += 1
        return _admm_chunk_batch_plain(A, b, ub, rho, state, L, iters,
                                       binary)
    return admm.admm_chunk_cuda(A, b, ub, rho, state, L, iters, binary)


def _admm_chunk_batch_plain(A, b, ub, rho: float, state, L, iters: int,
                            binary: bool = False):
    """Plain torch version of K8: _admm_chunk_batch as a Python loop of
    torch operations a step (``binary`` is K8's plan choice: ignored)."""
    n = A.shape[1]
    thresh = 1.0 / (max(n, 1) * rho)
    alpha = 1.6  # over-relaxation
    x, z, w, uz, uw = state
    w_entry = w
    At = A.mT
    for _ in range(iters):
        rhs = (At @ (b + z - uz)[..., None])[..., 0] + (w - uw)
        x = torch.cholesky_solve(rhs[..., None], L)[..., 0]
        Ax = (A @ x[..., None])[..., 0]
        Ax_r = alpha * Ax + (1 - alpha) * (z + b)
        x_r = alpha * x + (1 - alpha) * w
        z_new = Ax_r - b + uz
        z = torch.sign(z_new) * torch.clamp(z_new.abs() - thresh, min=0.0)
        w = torch.minimum(torch.clamp(x_r + uw, min=0.0), ub)
        uz = uz + Ax_r - b - z
        uw = uw + x_r - w
    Ax = (A @ x[..., None])[..., 0]
    r_z = (Ax - b - z).abs().amax(dim=1)
    r_w = (x - w).abs().amax(dim=1)
    d_w = (w - w_entry).abs().amax(dim=1)
    return (x, z, w, uz, uw), torch.maximum(torch.maximum(r_z, r_w), d_w)


def _zero_one(A_st: np.ndarray) -> bool:
    """Whether every entry of the host stack is 0 or 1 (K8's bits plan):
    the host tail's node-membership rows are, a caller's own A need not
    be."""
    return bool(((A_st == 0) | (A_st == 1)).all())


def _admm_solve_stack(A_st, b_st, ub_st, device, iters: int, chunk: int,
                      tol: float) -> np.ndarray:
    """Run the batched ADMM to the residual tolerance (or the iteration
    cap); returns the w iterate, float64 [S, p_pad]."""
    torch.backends.cuda.matmul.allow_tf32 = False
    binary = _zero_one(A_st)
    A = torch.as_tensor(A_st).to(device).to(torch.float32)
    b = torch.as_tensor(b_st).to(device)
    ub = torch.as_tensor(ub_st).to(device)
    L = _admm_factor(A)
    S, n, p = A.shape
    x0 = torch.zeros((S, p), dtype=torch.float32, device=device)
    z0 = torch.zeros((S, n), dtype=torch.float32, device=device)
    state = (x0, z0, x0, z0, x0)
    for _ in range(max(iters // chunk, 1)):
        LAUNCHES["admm_chunk_dispatch"] += 1
        state, res = _admm_chunk_batch(A, b, ub, 1.0, state, L, chunk,
                                       binary)
        worst = float(res.max())
        if worst < tol:
            break
    else:
        log.warning("ADMM stopped at its %d-iteration cap with residual %.3g "
                    "(tolerance %.1g); the host polish takes over", iters,
                    worst, tol)
    return state[2].cpu().numpy().astype(np.float64)


def _polish(A: np.ndarray, b: np.ndarray, x: np.ndarray, ub,
            sweeps: int = 8) -> np.ndarray:
    """Coordinate-wise exact minimization of ||Ax - b||_1 within the box
    (weighted median of the breakpoints per coordinate)."""
    n, p = A.shape
    if n == 0 or p == 0:
        return x
    ub = np.broadcast_to(np.asarray(ub, dtype=np.float64), x.shape)
    r = A @ x - b
    cols_nz = [A[:, j] != 0 for j in range(p)]
    cols_binary = [bool((A[:, j][nz] == 1.0).all())
                   for j, nz in enumerate(cols_nz)]
    for _ in range(sweeps):
        moved = 0.0
        for j in range(p):
            col = A[:, j]
            nz = cols_nz[j]
            if not nz.any():
                continue
            if cols_binary[j]:
                breaks = -r[nz]
                k = (len(breaks) - 1) // 2
                t_star = np.partition(breaks, k)[k]
            else:
                breaks = -(r[nz] / col[nz])
                w = np.abs(col[nz])
                order = np.argsort(breaks)
                cw = np.cumsum(w[order])
                t_star = breaks[order][int(np.searchsorted(cw, cw[-1] / 2.0))]
            t = float(np.clip(t_star, -x[j], ub[j] - x[j]))
            if t != 0.0:
                x[j] += t
                r += col * t
                moved += abs(t)
        if moved < 1e-12:
            break
    return x


def _solve_admm(A: np.ndarray, b: np.ndarray, ub: float, device,
                iters: int = 1500, chunk: int = 250,
                tol: float = 1e-5) -> PaoResult:
    """One instance through the batched ADMM, then the host polish."""
    n, p = A.shape
    n_pad, p_pad = _bucket(max(n, 1)), _p_pad(p)
    A_pad = np.zeros((1, n_pad, p_pad), dtype=np.float32)
    A_pad[0, :n, :p] = A
    scale = float(np.max(b)) if len(b) and np.max(b) > 0 else 1.0
    b_pad = np.zeros((1, n_pad), dtype=np.float32)
    b_pad[0, :n] = b / scale
    ub_pad = np.full((1, p_pad), ub / scale, dtype=np.float32)
    X = _admm_solve_stack(A_pad, b_pad, ub_pad, device, iters, chunk, tol)
    x = np.clip(X[0, :p], 0.0, ub / scale) * scale
    x = _polish(A.astype(np.float64), b.astype(np.float64), x, ub)
    return PaoResult(x=x, objective=float(np.abs(A @ x - b).sum() / max(len(b), 1)))


def _solve_highs(A: np.ndarray, b: np.ndarray, ub: float) -> PaoResult:
    from scipy.optimize import linprog
    from scipy.sparse import csr_matrix, eye, hstack, vstack

    n, p = A.shape
    if n == 0:
        return PaoResult(x=np.zeros(p), objective=0.0)
    As = csr_matrix(A)
    In = eye(n, format="csr")
    G = vstack([hstack([As, -In], format="csr"),
                hstack([-As, -In], format="csr")], format="csr")
    h = np.concatenate([b, -b])
    c = np.concatenate([np.zeros(p), np.full(n, 1.0 / n)])
    bounds = [(0.0, ub)] * p + [(0.0, None)] * n
    res = linprog(c, A_ub=G, b_ub=h, bounds=bounds, method="highs")
    if not res.success:
        raise RuntimeError(f"PAO LP failed: {res.message}")
    x = res.x[:p]
    return PaoResult(x=x, objective=float(np.abs(A @ x - b).sum() / n))


def solve_pao(A: np.ndarray, b: np.ndarray, ub: float, solver: str = "admm",
              fixed_zero: np.ndarray | None = None, *, device) -> PaoResult:
    """min (1/n)||A x - b||_1, 0 <= x <= ub, optionally pinning a subset of
    paths to zero (the reference's second solve)."""
    A = np.asarray(A, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    p = A.shape[1]
    if fixed_zero is not None and fixed_zero.any():
        free = ~fixed_zero
        sub = solve_pao(A[:, free], b, ub, solver=solver, device=device)
        x = np.zeros(p)
        x[free] = sub.x
        return PaoResult(x=x, objective=sub.objective)
    if p == 0:
        return PaoResult(x=np.zeros(0),
                         objective=float(np.abs(b).sum() / max(len(b), 1)))
    if solver == "highs":
        return _solve_highs(A, b, ub)
    if solver == "admm":
        return _solve_admm(A, b, ub, device)
    raise ValueError(f"unknown PAO solver {solver!r}")


def solve_pao_batch(instances, solver: str = "admm", *, device,
                    iters: int = 1500, chunk: int = 250,
                    tol: float = 1e-5) -> list[PaoResult]:
    """Solve independent instances ``(A, b, ub, fixed_zero | None)``.  ADMM
    instances of one padded bucket shape solve together (paths pinned by a
    per-path ub of 0); HiGHS, empty and singleton-bucket instances go
    through solve_pao.  Results come back in input order."""
    results: list[PaoResult | None] = [None] * len(instances)
    prepped: list[tuple | None] = [None] * len(instances)
    groups: dict[tuple[int, int], list[int]] = {}
    for i, (A, b, ub, fz) in enumerate(instances):
        A = np.asarray(A, dtype=np.float64)
        b = np.asarray(b, dtype=np.float64)
        n, p = A.shape
        if solver != "admm" or n == 0 or p == 0:
            results[i] = solve_pao(A, b, ub, solver=solver, fixed_zero=fz,
                                   device=device)
            continue
        prepped[i] = (A, b, float(ub), fz)
        groups.setdefault((_bucket(n), _p_pad(p)), []).append(i)

    for (n_pad, p_pad), idxs in groups.items():
        if len(idxs) == 1:
            A, b, ub, fz = prepped[idxs[0]]
            results[idxs[0]] = solve_pao(A, b, ub, solver="admm",
                                         fixed_zero=fz, device=device)
            continue
        S = len(idxs)
        A_st = np.zeros((S, n_pad, p_pad), dtype=np.float32)
        b_st = np.zeros((S, n_pad), dtype=np.float32)
        ub_st = np.zeros((S, p_pad), dtype=np.float32)
        scales = np.ones(S, dtype=np.float64)
        for s, i in enumerate(idxs):
            A, b, ub, fz = prepped[i]
            n, p = A.shape
            A_st[s, :n, :p] = A
            scale = float(np.max(b)) if len(b) and np.max(b) > 0 else 1.0
            scales[s] = scale
            b_st[s, :n] = b / scale
            ubv = np.full(p, ub / scale, dtype=np.float32)
            if fz is not None:
                ubv[np.asarray(fz, dtype=bool)] = 0.0
            ub_st[s, :p] = ubv
        X = _admm_solve_stack(A_st, b_st, ub_st, device, iters, chunk, tol)
        for s, i in enumerate(idxs):
            A, b, ub, fz = prepped[i]
            p = A.shape[1]
            ubv = np.full(p, ub, dtype=np.float64)
            if fz is not None:
                ubv[np.asarray(fz, dtype=bool)] = 0.0
            x = _polish(A, b, np.clip(X[s, :p] * scales[s], 0.0, ubv), ubv)
            results[i] = PaoResult(
                x=x, objective=float(np.abs(A @ x - b).sum() / max(len(b), 1)))
    return results
