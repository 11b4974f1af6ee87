"""Per-species strain profiling engine, PyTorch port of
pantax_tpu/profile/engine.py: coverage -> first filter -> two-stage PAO
(optimize_otu, prepare_otu / prepare_packed, strain_profiling for the
per-species flow; prepare_two_stage and finish_two_stage, which the fused
path shares).  The strain filters are the port's copy of the reference's
host code.

Parity: PanTax's src/profile.rs — optimize_otu profile.rs:2884-3026,
strain_profiling profile.rs:3291-3323.
"""
from __future__ import annotations

import logging
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np

from .. import _host
from ..ops.coverage_device import node_abundances_device
from .coverage import node_abundances_packed, pack_reads
from .pao import sample_valid_nodes, solve_pao_batch
from .report import abundance_constraint

log = logging.getLogger(__name__)


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


def use_device_coverage(cfg, n_reads: int) -> bool:
    """cfg.coverage 'device', or 'auto' at auto_device_reads reads of one
    species or more."""
    return cfg.coverage == "device" or (
        cfg.coverage == "auto" and n_reads >= cfg.auto_device_reads)


def first_filter_job(cfg, otu: str, graph, paths: dict, trio_index,
                     coverage):
    """The first filter and the solve preparation of one species from its
    (node_abundance, trio_abundance, node_base_cov): (OtuState,
    OtuSolveJob | None)."""
    node_abund, trio_abund, node_base_cov = coverage
    node_abund_opt = np.where(node_abund > cfg.min_depth, node_abund, 0.0)
    state = _host.OtuState(otu=otu,
                           hap_metrics=[_host.HapMetrics() for _ in paths])
    _host.first_filter_paths(state, paths, trio_index.hap_matrix, trio_abund,
                             node_abund_opt, cfg)
    job = None
    if state.possible_paths_idx:
        job = prepare_two_stage(state, graph.num_nodes, paths, node_abund,
                                node_base_cov, graph.nodes_len, cfg)
    return state, job


def prepare_packed(cfg, otu: str, graph, packed, *, device):
    """Coverage of one species' packed reads (on ``device`` when
    use_device_coverage, else the host's float64 oracle), first filter and
    solve preparation: (OtuState, OtuSolveJob | None); the PAO solves run
    in finish_two_stage."""
    paths = graph.paths_dict()
    trio_index = _host.build_trio_index(graph.nodes_len, paths)
    if use_device_coverage(cfg, len(packed.lengths)):
        coverage = node_abundances_device(packed, graph.nodes_len, trio_index,
                                          device=device)
    else:
        coverage = node_abundances_packed(packed, graph.nodes_len, trio_index)
    return first_filter_job(cfg, otu, graph, paths, trio_index, coverage)


def prepare_otu(cfg, otu: str, graph, range_start: int, range_end: int,
                reads: list, *, device):
    """prepare_packed over one species' ReadRecords."""
    nvert = range_end - (range_start - 1)
    if nvert != graph.num_nodes:
        log.warning("%s: species range size %d != graph nodes %d", otu,
                    nvert, graph.num_nodes)
    return prepare_packed(cfg, otu, graph, pack_reads(reads, range_start),
                          device=device)


def optimize_otu(cfg, otu: str, graph, range_start: int, range_end: int,
                 reads: list, *, device) -> list:
    state, job = prepare_otu(cfg, otu, graph, range_start, range_end, reads,
                             device=device)
    if job is not None:
        finish_two_stage([job], cfg, device=device)
    return state.hap_metrics


def select_species(cfg, species_ranges, species_profile) -> list:
    """Ranges kept for strain profiling: filtered by --smode / is_pan and
    the designated species, then those whose predicted abundance exceeds
    min_species_abundance (load_species_range, profile.rs:547-656)."""
    abundant = dict(zip(species_profile.species_taxid,
                        species_profile.predicted_abundance.tolist()))
    selected = []
    for r in species_ranges:
        if cfg.mode == 0 and r.is_pan != 0:
            continue
        if cfg.mode == 1 and r.is_pan != 1:
            continue
        if cfg.designated_species and r.species not in cfg.designated_species:
            continue
        if abundant.get(r.species, 0.0) <= cfg.min_species_abundance:
            continue
        selected.append(r)
    return selected


def solve_species(cfg, species_profile, work, items, *, device,
                  stage_out: dict | None = None) -> list:
    """``work(item) -> (OtuState, OtuSolveJob | None) | None`` over
    ``items`` (a thread pool overlaps one species' host work with another's
    device waits), then every species' PAO solves batched, then the
    species-coverage constraint; HapMetrics in ``items`` order.
    ``stage_out`` receives coverage_s (the work of every item) and pao_s
    (the solves and the constraint), host-clock seconds."""
    t0 = time.perf_counter()
    if len(items) > 1:
        with ThreadPoolExecutor(min(8, len(items))) as ex:
            prepared = list(ex.map(work, items))
    else:
        prepared = [work(it) for it in items]
    t1 = time.perf_counter()
    finish_two_stage([p[1] for p in prepared if p and p[1] is not None], cfg,
                     device=device)
    results = []
    for p in prepared:
        if p:
            abundance_constraint(species_profile, p[0].hap_metrics)
            results.extend(p[0].hap_metrics)
    if stage_out is not None:
        stage_out.update(coverage_s=t1 - t0, pao_s=time.perf_counter() - t1)
    return results


def strain_profiling(cfg, species_ranges, species_profile, reads_by_species,
                     load_graph, *, device, stage_out: dict | None = None
                     ) -> list:
    """optimize_otu per abundant species (select_species) with the
    species-coverage constraint.  ``load_graph(taxid) -> SpeciesGraph``;
    ``stage_out`` as solve_species'."""
    def work(r):
        reads = reads_by_species.get(r.species)
        if not reads:
            return None
        return prepare_otu(cfg, r.species, load_graph(r.species), r.start,
                           r.end, reads, device=device)

    return solve_species(cfg, species_profile, work,
                         select_species(cfg, species_ranges, species_profile),
                         device=device, stage_out=stage_out)
