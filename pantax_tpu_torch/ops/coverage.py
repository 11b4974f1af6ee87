"""Interval node coverage, PyTorch port of pantax_tpu/ops/coverage.py
(``interval_node_coverage`` :18, ROADMAP K12).  Plain torch with
``index_add_``; no production path of either package calls it."""
from __future__ import annotations

import torch


def interval_node_coverage(tstart, tnode, tlen, ts, te, aligned,
                           num_nodes: int, max_span: int):
    """Distribute each text interval [ts, te) over the path nodes it covers.

    tstart / tnode / tlen: the index's projection arrays (int32 [P]);
    ts / te: int32 [B] alignment text intervals; aligned: bool [B].  Each
    of the ``max_span`` segments from the one holding ts on gets
    max(min(seg_end, te) - max(seg_start, ts), 0) bases.  Returns float32
    [num_nodes] bases per global node (1-based node ids at id - 1), the
    reference's segment_sum: integer sums, exact below 2^24."""
    P = tstart.shape[0]
    i0 = (torch.searchsorted(tstart, ts, right=True) - 1).clamp(0, P - 1)
    span = (i0[:, None] + torch.arange(max_span, device=ts.device)[None, :]
            ).clamp(0, P - 1)
    node_start = tstart[span]
    lo = torch.maximum(node_start, ts[:, None])
    hi = torch.minimum(node_start + tlen[span], te[:, None])
    bases = (hi - lo).clamp(min=0).to(torch.float32)
    bases = torch.where(aligned[:, None], bases, 0.0)
    # ids outside [0, num_nodes) go to a sink slot (segment_sum drops them)
    ids = (tnode[span] - 1).reshape(-1).to(torch.int64)
    ids = torch.where((ids >= 0) & (ids < num_nodes), ids, num_nodes)
    out = torch.zeros(num_nodes + 1, dtype=torch.float32, device=ts.device)
    return out.index_add_(0, ids, bases.reshape(-1))[:num_nodes]
