"""Read classification, the port's copy of pantax_tpu/profile/rcls.py:
assign each aligned read to a species by which species_range contains its
alignment path's [min, max] node-id interval.

Parity: PanTax's src/rcls.rs:210-235 (process_single_read):
  - min/max over all node ids in the path;
  - the read is assigned to the FIRST range (file order) with
    min >= start and max <= end, else "U";
  - empty paths get min = max = -1 → "U".

Vectorized: ranges are disjoint ascending intervals in file order, so the
containment test is a searchsorted over range starts (kept stable against the
reference by re-checking bounds).
"""
from __future__ import annotations

import numpy as np

from ..graph.core import SpeciesRange

UNCLASSIFIED = "U"


def classify_min_max(
    mins: np.ndarray, maxs: np.ndarray, ranges: list[SpeciesRange]
) -> np.ndarray:
    """Return index into `ranges` per read, or -1 for unclassified."""
    starts = np.array([r.start for r in ranges], dtype=np.int64)
    ends = np.array([r.end for r in ranges], dtype=np.int64)
    order = np.argsort(starts, kind="stable")
    s_sorted = starts[order]
    e_sorted = ends[order]
    pos = np.searchsorted(s_sorted, mins, side="right") - 1
    pos_clip = np.clip(pos, 0, len(ranges) - 1)
    ok = (
        (pos >= 0)
        & (mins >= s_sorted[pos_clip])
        & (maxs <= e_sorted[pos_clip])
        & (mins >= 0)
    )
    return np.where(ok, order[pos_clip], -1)


def classify_reads(
    node_paths: list[np.ndarray], ranges: list[SpeciesRange]
) -> list[str]:
    """Species label per node path ('U' = unclassified)."""
    mins = np.array(
        [int(p.min()) if len(p) else -1 for p in node_paths], dtype=np.int64
    )
    maxs = np.array(
        [int(p.max()) if len(p) else -1 for p in node_paths], dtype=np.int64
    )
    idx = classify_min_max(mins, maxs, ranges)
    return [ranges[i].species if i >= 0 else UNCLASSIFIED for i in idx]
