"""Device meshes of the port: the counterpart of pantax_tpu/parallel/mesh.py.

A mesh is an ordered tuple of ``torch.device``s; its first device is the
primary.  The product path shards each read batch into contiguous row
blocks, one per mesh device (``Aligner`` and ``node_abundances_device``
take ``mesh=``): the index tables are held on every device, each block's
query (and its K1 / K2 launch) runs on its device, and the rows come back
to the primary in their order.  The fused tables and the coverage
accumulators stay on the primary, where the scatter runs over the
gathered rows.  Every coverage addend is an integer, so a run on N
devices is bit-identical to one.

Devices may repeat: ``make_mesh(["cuda:0", "cuda:0"])`` runs the split and
the merge for real on one card, and N CPU replicas do so on the CPU.
"""
from __future__ import annotations

import torch


def _norm(device) -> torch.device:
    """torch.device with an explicit index on CUDA (cuda -> cuda:0)."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", 0)
    return d


def make_mesh(devices) -> tuple[torch.device, ...]:
    """The mesh over ``devices`` in their order, repeats included."""
    mesh = tuple(_norm(d) for d in devices)
    if not mesh:
        raise ValueError("a mesh needs at least one device")
    return mesh


def make_local_mesh(n: int, device) -> tuple[torch.device, ...]:
    """A mesh of ``n`` devices of ``device``'s kind: on the CPU n replicas
    of the CPU, on CUDA n local cards starting at ``device``'s index (the
    reference's make_local_mesh)."""
    d = _norm(device)
    if d.type != "cuda":
        return make_mesh([d] * n)
    have = torch.cuda.device_count()
    if have < n:
        raise ValueError(f"need {n} local devices, have {have}")
    return make_mesh([torch.device("cuda", (d.index + i) % have)
                      for i in range(n)])


def check_primary(mesh, device) -> None:
    """Raise unless ``mesh`` is None or its primary is ``device``."""
    if mesh is not None and mesh[0] != _norm(device):
        raise ValueError(f"the mesh's primary device {mesh[0]} is not "
                         f"{_norm(device)}")


def row_blocks(n_rows: int, mesh) -> list[tuple[torch.device, slice]]:
    """Contiguous row blocks of an ``n_rows`` batch, one per mesh device;
    [] when the rows do not divide by the mesh size (the caller then runs
    the batch unsharded on the primary)."""
    n = len(mesh)
    if n_rows % n:
        return []
    step = n_rows // n
    return [(d, slice(i * step, (i + 1) * step)) for i, d in enumerate(mesh)]
