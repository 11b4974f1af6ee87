"""Two-stage strain solve, PyTorch port of the fused-path half of
pantax_tpu/profile/engine.py (_coeff_matrix, prepare_two_stage,
finish_two_stage); the strain filters are the reference's own host code."""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .. import _host
from .pao import sample_valid_nodes, solve_pao_batch


def _coeff_matrix(paths: dict, possible_idx: list[int], nvert: int) -> np.ndarray:
    """Binary node-membership matrix [nvert, len(possible_idx)]."""
    names = sorted(paths)
    A = np.zeros((nvert, len(possible_idx)), dtype=np.float32)
    for j, path_i in enumerate(possible_idx):
        A[paths[names[path_i]], j] = 1.0
    return A


@dataclass
class OtuSolveJob:
    """A species' prepared PAO instance, awaiting the two-stage solve."""

    state: object  # OtuState
    A: np.ndarray
    b: np.ndarray
    ub: float


def prepare_two_stage(state, nvert: int, paths: dict, node_abundance_vec,
                      node_base_cov, node_len, cfg) -> OtuSolveJob:
    """Coefficient matrix, per-path base-coverage ratios, node subsampling:
    everything up to the first PAO solve."""
    possible = state.possible_paths_idx
    max_val = float(np.max(node_abundance_vec)) if len(node_abundance_vec) else 0.0
    coeff = _coeff_matrix(paths, possible, nvert)
    path_cov = node_base_cov.astype(np.float32) @ coeff
    path_len = node_len.astype(np.float32) @ coeff
    with np.errstate(divide="ignore", invalid="ignore"):
        path_ratio = np.where(path_len > 0, path_cov / path_len, 0.0)
    for j, path_i in enumerate(possible):
        state.hap_metrics[path_i].path_cov_ratio = float(path_ratio[j])
    valid_nodes = np.flatnonzero(node_abundance_vec > 0.0)
    rows = sample_valid_nodes(valid_nodes, cfg.sample_nodes, cfg.sample_test)
    return OtuSolveJob(state=state, A=coeff[rows], b=node_abundance_vec[rows],
                       ub=1.05 * max_val)


def finish_two_stage(jobs: list[OtuSolveJob], cfg, *, device) -> None:
    """First solves (batched), the divergence filter, then the second
    solves with the dropped paths pinned to zero."""
    firsts = solve_pao_batch([(j.A, j.b, j.ub, None) for j in jobs],
                             cfg.solver, device=device)
    for job, first in zip(jobs, firsts):
        state = job.state
        for j, path_i in enumerate(state.possible_paths_idx):
            state.hap_metrics[path_i].first_sol = float(first.x[j])
        _host.second_filter_paths(state, cfg)

    second_jobs = [job for job in jobs if job.state.second_opt]
    if not second_jobs:
        return
    pins = [
        np.array([path_i not in job.state.second_possible_paths_idx
                  for path_i in job.state.possible_paths_idx])
        for job in second_jobs
    ]
    seconds = solve_pao_batch(
        [(j.A, j.b, j.ub, pin) for j, pin in zip(second_jobs, pins)],
        cfg.solver, device=device,
    )
    for job, second in zip(second_jobs, seconds):
        state = job.state
        for j, path_i in enumerate(state.possible_paths_idx):
            if path_i in state.second_possible_paths_idx:
                state.hap_metrics[path_i].second_sol = float(second.x[j])
