"""Array-native alignment output, the port's counterpart of
pantax_tpu/fastpath.py:31 ``AlignmentArrays``.

The reference module cannot be imported without pandas (it imports
profile.report and profile.species at its top); the rest of it is the
per-species GAF flow, ROADMAP M11.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class AlignmentArrays:
    """Batch-concatenated aligner outputs (aligned reads only)."""

    read_ids: list[str]
    ts: np.ndarray        # int64 text start
    te: np.ndarray        # int64 text end (exclusive)
    mapq: np.ndarray      # int64
    read_len: np.ndarray  # int64
