"""Strain candidate filters around the PAO solves.

Parity: PanTax's src/profile.rs —
  zscore_filter          profile.rs:1028-1051
  first_filter_paths     profile.rs:1080-1227
  second_filter_paths    profile.rs:1229-1285
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..config import ProfilingConfig


@dataclass
class HapMetrics:
    otu: str | None = None
    hap_id: str | None = None
    unique_trio_nodes_fraction: float | None = None
    frequencies_mean: float | None = None
    path_cov_ratio: float | None = None
    first_sol: float | None = None
    divergence: float | None = None
    second_sol: float | None = None
    is_rescue: bool | None = None
    total_cov_diff: float | None = None


@dataclass
class OtuState:
    """Per-species optimization state (GurobiOptVar parity, profile.rs:1053-1063)."""

    otu: str
    hap_metrics: list[HapMetrics]
    possible_paths_idx: list[int] = field(default_factory=list)
    second_possible_paths_idx: list[int] = field(default_factory=list)
    orign_n_haps: int = 0
    hap2trio_nodes_m_size: int = 0
    same_path_flag: bool = False
    second_opt: bool = False


def zscore_filter(data: np.ndarray, threshold: float = 3.0) -> np.ndarray:
    data = np.asarray(data, dtype=np.float64)
    if data.size == 0:
        return data
    if np.isnan(data).any():
        raise ValueError("Input data contains NaN values.")
    mean = data.mean()
    std = np.sqrt(((data - mean) ** 2).mean())
    if std == 0.0:
        return np.zeros(0)
    return data[np.abs((data - mean) / std) < threshold]


def _round2(x: float) -> float:
    return round(x * 100.0) / 100.0


def _nonzero_mean_after_zscore(non_zero: np.ndarray) -> float:
    kept = zscore_filter(non_zero, 3.0)
    return float(kept.mean()) if kept.size else 0.0


def first_filter_paths(
    state: OtuState,
    paths: dict[str, np.ndarray],
    hap2trio_nodes_m: np.ndarray,
    trio_node_abundances: np.ndarray,
    node_abundance_vec: np.ndarray,
    cfg: ProfilingConfig,
) -> None:
    names = sorted(paths)
    for i, hap_id in enumerate(names):
        state.hap_metrics[i].otu = state.otu
        state.hap_metrics[i].hap_id = hap_id

    orign_n_haps = len(paths)
    m_size = int(hap2trio_nodes_m.size)
    state.orign_n_haps = orign_n_haps
    state.hap2trio_nodes_m_size = m_size

    if orign_n_haps != 1 and m_size != 0:
        for hap_idx in range(orign_n_haps):
            trio_mask = hap2trio_nodes_m[:, hap_idx] > 0
            trio_count = int(trio_mask.sum())
            if trio_count == 0:
                continue
            abund = np.asarray(trio_node_abundances)[trio_mask]
            non_zero = abund[abund > 0.0]
            fraction = len(non_zero) / trio_count
            state.hap_metrics[hap_idx].unique_trio_nodes_fraction = _round2(fraction)

            if cfg.shift:
                freq_mean = _nonzero_mean_after_zscore(non_zero)
                if freq_mean >= 1.0:
                    shift_frac = cfg.unique_trio_nodes_fraction + (
                        0.8 - cfg.unique_trio_nodes_fraction
                    ) * freq_mean / 100.0
                    shift_frac = min(shift_frac, 0.8)
                else:
                    shift_frac = cfg.unique_trio_nodes_fraction * freq_mean
                if fraction < shift_frac:
                    continue
                state.hap_metrics[hap_idx].frequencies_mean = freq_mean
            else:
                if fraction < cfg.unique_trio_nodes_fraction:
                    continue
                state.hap_metrics[hap_idx].frequencies_mean = (
                    _nonzero_mean_after_zscore(non_zero)
                )
            state.possible_paths_idx.append(hap_idx)
    elif orign_n_haps != 1 and m_size == 0:
        path_list = [paths[n] for n in names]
        all_same = all(np.array_equal(path_list[0], p) for p in path_list[1:])
        if all_same:
            state.same_path_flag = True
            non_zero = np.asarray(node_abundance_vec)
            non_zero = non_zero[non_zero > 0.0]
            freq_mean = float(non_zero.mean()) if non_zero.size else 0.0
            state.hap_metrics[0].frequencies_mean = _round2(freq_mean)
            state.possible_paths_idx.append(0)
        else:
            state.possible_paths_idx = list(range(orign_n_haps))
    else:  # orign_n_haps == 1
        non_zero = np.asarray(node_abundance_vec)
        non_zero = non_zero[non_zero > 0.0]
        freq_mean = float(non_zero.mean()) if non_zero.size else 0.0
        state.hap_metrics[0].frequencies_mean = _round2(freq_mean)
        state.possible_paths_idx.append(0)


def second_filter_paths(state: OtuState, cfg: ProfilingConfig) -> None:
    keep: list[int] = []
    if state.orign_n_haps != 1 and state.hap2trio_nodes_m_size > 0:
        state.second_opt = True
        for idx in state.possible_paths_idx:
            m = state.hap_metrics[idx]
            freq_mean = m.frequencies_mean or 0.0
            if freq_mean == 0.0:
                continue
            sol = m.first_sol
            f = abs(sol - freq_mean) / (sol + freq_mean)
            f_rounded = _round2(f)
            m.divergence = f_rounded
            if f_rounded > cfg.unique_trio_nodes_mean_count_f:
                if f_rounded <= 0.6:
                    single_cov_ratio = (
                        (m.unique_trio_nodes_fraction or 0.0)
                        * (m.path_cov_ratio or 0.0)
                    )
                    if single_cov_ratio < cfg.single_cov_ratio or sol == 0.0:
                        continue
                    m.is_rescue = True
                    keep.append(idx)
                else:
                    continue
            elif f_rounded <= cfg.unique_trio_nodes_mean_count_f and sol != 0.0:
                keep.append(idx)
        state.second_possible_paths_idx = keep
    elif (
        state.orign_n_haps != 1
        and state.hap2trio_nodes_m_size == 0
        and state.same_path_flag
    ) or state.orign_n_haps == 1:
        m = state.hap_metrics[0]
        freq_mean = m.frequencies_mean
        if freq_mean is not None and freq_mean > 0.0:
            sol = m.first_sol
            f = abs(sol - freq_mean) / (sol + freq_mean)
            m.divergence = _round2(f)
            m.second_sol = sol
    elif (
        state.orign_n_haps != 1
        and state.hap2trio_nodes_m_size == 0
        and not state.same_path_flag
    ):
        for idx in state.possible_paths_idx:
            state.hap_metrics[idx].second_sol = state.hap_metrics[idx].first_sol
