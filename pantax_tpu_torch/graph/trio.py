"""Trio-node index: all 3-node windows of haplotype paths, their lengths, and
the haplotype × unique-trio presence matrix.

Parity: PanTax's src/profile.rs:658-740 (trio_nodes_info):
  - a window (a, b, c) is canonicalized to (c, b, a) when a > c;
  - a trio is *unique* when it occurs exactly once across all haplotype paths
    (occurrences within the same path each count);
  - trio length = sum of the three node lengths;
  - the presence matrix has one row per unique trio, one column per haplotype
    (sorted order).

Unlike the reference (hash-set iteration order), trio indices here are
deterministic: lexicographic order of the canonical (a, b, c) triple.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


def _canonicalize(windows: np.ndarray) -> np.ndarray:
    """Reverse windows whose first node id exceeds their last (profile.rs:672-678)."""
    if windows.size == 0:
        return windows.reshape(0, 3)
    flip = windows[:, 0] > windows[:, 2]
    out = windows.copy()
    out[flip] = windows[flip][:, ::-1]
    return out


def path_windows(path: np.ndarray) -> np.ndarray:
    """All consecutive 3-windows of a path, shape [max(len-2, 0), 3]."""
    if len(path) < 3:
        return np.zeros((0, 3), dtype=np.int64)
    return np.stack([path[:-2], path[1:-1], path[2:]], axis=1)


@dataclass
class TrioIndex:
    trio_nodes: np.ndarray   # int64 [U, 3] canonical, lexicographically sorted
    trio_len: np.ndarray     # int64 [U]
    hap_matrix: np.ndarray   # uint8 [U, P] (unique trio -> owning haplotype)

    @property
    def num_unique(self) -> int:
        return len(self.trio_nodes)

    @property
    def num_paths(self) -> int:
        return self.hap_matrix.shape[1]

    def match(self, windows: np.ndarray) -> np.ndarray:
        """Map each (possibly non-canonical) window to its unique-trio index,
        or -1. Matches forward then reversed orientation
        (profile.rs:895-918: get(t) or get(reversed(t)))."""
        if windows.size == 0:
            return np.zeros(0, dtype=np.int64)
        canon = _canonicalize(np.asarray(windows, dtype=np.int64))
        U = len(self.trio_nodes)
        if U == 0:
            return np.full(len(canon), -1, dtype=np.int64)
        # lexicographic searchsorted over sorted trio_nodes rows
        idx = np.searchsorted(
            _row_key(self.trio_nodes), _row_key(canon)
        )
        idx = np.clip(idx, 0, U - 1)
        hit = (self.trio_nodes[idx] == canon).all(axis=1)
        return np.where(hit, idx, -1)


def _row_key(rows: np.ndarray) -> np.ndarray:
    """Order-preserving scalar key for (a, b, c) rows.

    Uses float128-free composite ordering: rows are compared lexicographically
    by packing into a structured array sortable view.
    """
    rows = np.ascontiguousarray(rows.astype(np.int64))
    # big-endian bytes concatenated give lexicographic byte order for
    # non-negative ints
    be = rows.astype(">i8").view(np.uint8).reshape(len(rows), -1)
    return be.view([("k", "V24")]).ravel()


def build_trio_index(nodes_len: np.ndarray, paths: dict[str, np.ndarray]) -> TrioIndex:
    names = sorted(paths)
    windows_per_path = [path_windows(np.asarray(paths[n], dtype=np.int64)) for n in names]
    total = sum(len(w) for w in windows_per_path)
    if total == 0:
        return TrioIndex(
            trio_nodes=np.zeros((0, 3), dtype=np.int64),
            trio_len=np.zeros(0, dtype=np.int64),
            hap_matrix=np.zeros((0, len(names)), dtype=np.uint8),
        )
    all_windows = np.concatenate([w for w in windows_per_path if len(w)], axis=0)
    win_path = np.concatenate(
        [np.full(len(w), i, dtype=np.int64) for i, w in enumerate(windows_per_path) if len(w)]
    )
    canon = _canonicalize(all_windows)
    uniq_rows, inverse, counts = np.unique(
        canon, axis=0, return_inverse=True, return_counts=True
    )
    unique_sel = counts == 1
    new_idx = np.cumsum(unique_sel) - 1  # old unique-row idx -> compact idx
    trio_nodes = uniq_rows[unique_sel]
    trio_len = nodes_len[trio_nodes].sum(axis=1).astype(np.int64)
    hap_matrix = np.zeros((len(trio_nodes), len(names)), dtype=np.uint8)
    w_is_unique = unique_sel[inverse]
    hap_matrix[new_idx[inverse[w_is_unique]], win_path[w_is_unique]] = 1
    return TrioIndex(trio_nodes=trio_nodes, trio_len=trio_len, hap_matrix=hap_matrix)
