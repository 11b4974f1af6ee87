"""Padded global coverage tables and the coverage finalize, PyTorch port of
pantax_tpu/ops/coverage_device.py (the parts the range-decomposition path
uses: build_padded_tables :443 and _coverage_finalize :303)."""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

# float32 holds every integer below 2^24 exactly; the accumulators sum
# integers, so their float32 image equals the reference's only below it
F32_EXACT = 1 << 24


def _pow2(n: int, lo: int = 256) -> int:
    m = lo
    while m < n:
        m *= 2
    return m


@dataclass
class PaddedCoverageTables:
    """Power-of-two padded node/base/trio tables.  Pad nodes have length 1
    and are never referenced by reads; pad trios have length 1."""

    nodes_len: np.ndarray    # int32 [N_pad]
    base_offset: np.ndarray  # int32 [N_pad + 1]
    trio_len: np.ndarray     # int32 [U_pad]
    N: int
    U: int
    N_pad: int
    TB_pad: int
    U_pad: int


def build_padded_tables(nodes_len, trio_len) -> PaddedCoverageTables:
    """Pad the global node and trio tables to power-of-two shapes (the same
    shapes the reference's build_padded_tables gives)."""
    nodes_len = np.asarray(nodes_len)
    N, U = len(nodes_len), len(trio_len)
    N_pad = _pow2(N + 1)
    nodes_len_p = np.ones(N_pad, dtype=np.int32)
    nodes_len_p[:N] = nodes_len
    base_offset = np.zeros(N_pad + 1, dtype=np.int32)
    np.cumsum(nodes_len_p, out=base_offset[1:])
    U_pad = _pow2(U, lo=64)
    trio_len_p = np.ones(U_pad, dtype=np.int32)
    trio_len_p[:U] = trio_len
    return PaddedCoverageTables(
        nodes_len=nodes_len_p, base_offset=base_offset, trio_len=trio_len_p,
        N=N, U=U, N_pad=N_pad, TB_pad=_pow2(int(base_offset[-1])),
        U_pad=U_pad,
    )


def coverage_finalize(bases_per_node, diff, trio_bases, nodes_len,
                      base_offset, trio_len):
    """Accumulated sums -> (node_abundance f32 [N], trio_abundance f32 [U],
    node_base_cov int32 [N]).  ``diff`` is the per-base difference array
    [TB + 1] (last entry the sentinel sink); ``bases_per_node`` and
    ``trio_bases`` are exact integer sums, converted to float32 here."""
    for name, acc in (("bases_per_node", bases_per_node),
                      ("trio_bases", trio_bases)):
        if acc.numel() and int(acc.abs().max()) >= F32_EXACT:
            raise ValueError(
                f"{name} holds a sum >= 2^24: float32 coverage would round"
            )
    covered = (torch.cumsum(diff[:-1], dim=0) > 0).to(torch.int64)
    prefix = torch.zeros(covered.shape[0] + 1, dtype=torch.int64,
                         device=diff.device)
    prefix[1:] = torch.cumsum(covered, dim=0)
    bo = base_offset.to(torch.int64)
    node_base_cov = (prefix[bo[1:]] - prefix[bo[:-1]]).to(torch.int32)
    f32 = torch.float32
    node_abundance = bases_per_node.to(f32) / nodes_len.clamp(min=1).to(f32)
    trio_abundance = trio_bases.to(f32) / trio_len.to(f32).clamp(min=1.0)
    return node_abundance, trio_abundance, node_base_cov
