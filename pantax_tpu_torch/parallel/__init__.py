"""Multi-device and multi-process execution: the counterpart of
pantax_tpu/parallel/__init__.py.

A mesh, passed as ``mesh=`` to the aligner and to the per-species device
coverage (``pantax-gpu --mesh`` builds one with auto_mesh), makes them
shard their rows over its devices (see ``mesh.py``); a call without
``mesh=`` runs on its one device.  Multi-process runs (``--distributed``)
shard the reads over processes and merge the coverage accumulators
through ``torch.distributed`` (``distributed.py``).
"""
from __future__ import annotations

import torch

from .mesh import make_local_mesh, make_mesh


def auto_mesh(spec: str, device):
    """Resolve a --mesh flag value on ``device``: "auto" meshes over every
    local card when more than one is visible (else none; the CPU has no
    cards), "off" and "1" mean none, an integer N builds N devices (N local
    cards on CUDA, raising ValueError when fewer are visible; N replicas on
    the CPU).  Returns the mesh, or None for one device."""
    d = torch.device(device)
    if spec == "off":
        n = 1
    elif spec == "auto":
        n = torch.cuda.device_count() if d.type == "cuda" else 1
    else:
        n = int(spec)
    return make_local_mesh(n, d) if n > 1 else None


__all__ = ["auto_mesh", "make_local_mesh", "make_mesh"]
