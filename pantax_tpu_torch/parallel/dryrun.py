"""Mesh dry run of the port: the counterpart of the reference's
``__graft_entry__.dryrun_multichip``.

    dryrun_multichip(3, "cpu", root)

runs the product path (the fused pipeline: aligner query -> classify ->
coverage scatter, then the device profile tail and the report) on tiny_db
over a mesh of N replicas of one device and on that device alone, and
asserts that the coverage arrays, the per-read columns and the four output
files are identical, and that with ``L_cap=1`` (every aligned read through
the host residual) the mesh run's coverage equals the windowed one's.
"""
from __future__ import annotations

import filecmp
import os
import shutil

import numpy as np
import torch

from .. import _host
from ..benchmarks import simulate_read_batch, tiny_db
from ..convert import aligner_from_reference
from ..ops.fused import (
    FusedPipeline, build_fused_tables, profile_from_fused_result,
)
from .mesh import make_mesh

OUT_FILES = ("species_abundance.txt", "strain_abundance.txt",
             "ori_strain_abundance.txt", "reads_classification.tsv")


def dryrun_multichip(n: int, device, root) -> dict:
    """The dry run on ``n`` replicas of ``device``, its DB and outputs
    under ``root``; raises AssertionError on a difference and returns a
    summary (reads aligned, overflowing reads at L_cap=1, coverage sum,
    the strains reported)."""
    db = tiny_db(os.path.join(root, "tiny"))
    index = _host.build_align_index(db)
    B = 256 * n
    codes, lens, _ = simulate_read_batch(index, 2048, 128, 0.01, seed=1)
    cfg = _host.ProfilingConfig.for_read_type("short")
    cfg.tail = "device"  # the device-resident tail is the product path
    out_root = os.path.join(root, "dryrun")
    shutil.rmtree(out_root, ignore_errors=True)

    def run(mesh, tag, L_cap=None):
        aligner = aligner_from_reference(index, _host.AlignConfig(), device,
                                         mesh=mesh)
        tables = build_fused_tables(db, index, device,
                                    aligner.segment_lookup)
        pipe = FusedPipeline(aligner, tables, B, L_cap=L_cap)
        pipe.feed(codes, lens)
        result = pipe.finish()
        out = os.path.join(out_root, tag)
        profile_from_fused_result(result, tables, index, db, cfg, out)
        return result, out

    res_n, out_n = run(make_mesh([device] * n), f"mesh{n}")
    res_1, out_1 = run(None, "one")
    # every aligned read through the host residual, on the mesh: the same
    # coverage as the mesh's range scatter
    ov_n, _ = run(make_mesh([device] * n), f"ovf{n}", L_cap=1)
    assert ov_n.n_overflow > 0, "L_cap=1 should overflow the dry run's reads"
    for name in ("na_d", "ta_d", "bc_d"):
        assert torch.equal(getattr(ov_n, name), getattr(res_n, name)), (
            f"{name}: mesh overflow-residual run != mesh windowed run")

    aligned = res_n.reads["aligned"]
    assert aligned.any(), "the dry run aligned no read"
    for name in ("na_d", "ta_d", "bc_d"):
        assert torch.equal(getattr(res_n, name), getattr(res_1, name)), (
            f"{name}: {n}-device != 1-device")
    for k in ("mapq", "aligned", "ridx", "read_len", "ts", "te"):
        assert np.array_equal(res_n.reads[k], res_1.reads[k]), k
    for name in OUT_FILES:
        assert filecmp.cmp(os.path.join(out_n, name),
                           os.path.join(out_1, name), shallow=False), (
            f"{name}: {n}-device != 1-device")
    with open(os.path.join(out_n, "strain_abundance.txt")) as f:
        strains = [line.split("\t")[2] for line in f][1:]
    return {"aligned": int(aligned.sum()), "reads": len(lens),
            "n_overflow": int(ov_n.n_overflow),
            "coverage_sum": float(res_n.na_d.sum()), "strains": strains}

