#!/usr/bin/env python3
"""Smoke run of the PyTorch port (pantax_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero):

1. require a CUDA device; print the card's name and power limit;
2. build the banded-DP kernel (K1, csrc/banded_extend.cu) with nvcc;
3. hold K1 against its plain torch version on the card, bit for bit on all
   four outputs, at the main path's shape (131072 candidates, 160-base
   reads, pad 4) over the smoke DB's text and at a pad-8 random case, and
   time both;
4. run the port on the tiny 2-species DB on the CPU (plain versions) and on
   the GPU (kernel): packed query rows and na/ta/bc must be identical;
5. drive the main path: profile_fused over scale_db at its defaults (10
   species x 3 strains x 1 Mb), 1M simulated 150 bp reads, batch 65536,
   host tail, ADMM; K1 must be launched once per batch and the plain DP
   never; all 10 species and 30 strains must be reported.

The line before last is a JSON record of the kernels; the last line is
{"ok": true, "device": {...}}.  Databases and the kernel build go under
build/ (git-ignored).
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import time

import numpy as np
import torch

from pantax_tpu_torch import _host
from pantax_tpu_torch.benchmarks import scale_db, simulate_read_batch, tiny_db
from pantax_tpu_torch.convert import aligner_from_reference
from pantax_tpu_torch.device import require_cuda
from pantax_tpu_torch.ops import extend
from pantax_tpu_torch.ops.fused import (
    FusedPipeline, build_fused_tables, profile_fused,
)

KERNEL = {
    "name": "banded_extend",
    "route": "cuda",
    "source": "pantax_tpu_torch/csrc/banded_extend.cu",
    "replaces": "pantax_tpu/ops/extend_pallas.py:171",
}
MATCH, MISMATCH, GAP = 1, -1, -2
N_READS, BATCH = 1_000_000, 65536


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def dp_case(text: np.ndarray, N: int, Lr: int, pad: int, seed: int):
    """Candidates in the style of the reference's test_extend_pallas: reads
    cut from the text near w0 + pad with 5% substitutions, ragged lengths,
    plus rows with read_len 0 and 1."""
    rng = np.random.default_rng(seed)
    T = len(text) - 1024  # keep clear of the sentinel tail
    w0 = rng.integers(0, T - (Lr + 2 * pad) - 8, size=N).astype(np.int32)
    start = w0 + pad + rng.integers(-4, 5, size=N)
    reads = text[np.clip(start[:, None] + np.arange(Lr), 0, len(text) - 1)]
    noise = rng.random((N, Lr)) < 0.05
    reads = np.where(noise, rng.integers(0, 4, size=(N, Lr)), reads).astype(np.int8)
    lens = rng.integers(Lr // 2, Lr + 1, size=N).astype(np.int32)
    lens[:2] = (0, 1)
    reads[np.arange(Lr)[None, :] >= lens[:, None]] = 4
    return w0, reads, lens


def cuda_ms(fn, iters: int) -> float:
    fn()  # warm-up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def check_kernel(text_np: np.ndarray, dev, N: int, Lr: int, pad: int,
                 seed: int, timed: bool):
    text = torch.tensor(text_np).to(dev)
    args = [torch.from_numpy(a).to(dev)
            for a in dp_case(text_np, N, Lr, pad, seed)]
    ker = extend.banded_extend_cuda(text, *args, pad, MATCH, MISMATCH, GAP)
    plain = extend.banded_extend_plain(text, *args, pad, MATCH, MISMATCH, GAP)
    torch.cuda.synchronize()
    err = max(int((k - p).abs().max()) for k, p in zip(ker, plain))
    for k, p, name in zip(ker, plain, ("score", "start", "end", "matches")):
        if not torch.equal(k, p):
            raise AssertionError(f"K1 != plain on {name} at N={N} Lr={Lr} pad={pad}")
    print(f"K1 == plain at N={N} Lr={Lr} pad={pad} (4 outputs bit-identical)")
    if not timed:
        return err, None, None
    ms = cuda_ms(lambda: extend.banded_extend_cuda(
        text, *args, pad, MATCH, MISMATCH, GAP), 50)
    plain_ms = cuda_ms(lambda: extend.banded_extend_plain(
        text, *args, pad, MATCH, MISMATCH, GAP), 3)
    print(f"K1 {ms:.4f} ms, plain torch {plain_ms:.3f} ms at N={N} Lr={Lr} pad={pad}")
    return err, ms, plain_ms


def cross_device_check(build: str, dev) -> None:
    """The port on CPU (plain versions) and on the GPU (kernel) agree."""
    db = tiny_db(os.path.join(build, "tiny_db"))
    index = _host.build_align_index(db)
    cfg = _host.AlignConfig()
    codes, lens, _ = simulate_read_batch(index, 4096, 150, 0.01, seed=3)
    res = []
    for d in ("cpu", dev):
        aligner = aligner_from_reference(index, cfg, d)
        rows = aligner.query_packed(*aligner.upload(codes, lens)).cpu()
        pipe = FusedPipeline(aligner, build_fused_tables(db, index, d), 1024)
        pipe.feed(codes, lens)
        r = pipe.finish()
        res.append((rows, r.na_d.cpu(), r.ta_d.cpu(), r.bc_d.cpu(), r.reads))
    (rows_c, na_c, ta_c, bc_c, reads_c), (rows_g, na_g, ta_g, bc_g, reads_g) = res
    for name, a, b in (("rows", rows_c, rows_g), ("na", na_c, na_g),
                       ("ta", ta_c, ta_g), ("bc", bc_c, bc_g)):
        if not torch.equal(a, b):
            raise AssertionError(f"tiny DB: CPU and CUDA {name} differ")
    for k in ("mapq", "aligned", "ridx", "read_len"):
        if not np.array_equal(reads_c[k], reads_g[k]):
            raise AssertionError(f"tiny DB: CPU and CUDA per-read {k} differ")
    if not bool(reads_g["aligned"].mean() > 0.9):
        raise AssertionError("tiny DB: fewer than 90% of reads aligned")
    print(f"tiny DB: CPU == CUDA on {len(lens)} reads (rows, na/ta/bc, per-read)")


def read_table(path):
    lines = open(path).read().splitlines()
    head = lines[0].split("\t")
    return [dict(zip(head, ln.split("\t"))) for ln in lines[1:]]


def main_path(build: str, dev):
    t0 = time.time()
    db = scale_db(os.path.join(build, "scale_db"))
    index = _host.build_align_index(db)
    print(f"DB build (or cache load) + index: {time.time() - t0:.2f} s, "
          f"text {index.text_len} bases, {len(index.hap_names)} haplotypes")
    cfg_align = _host.AlignConfig()
    aligner = aligner_from_reference(index, cfg_align, dev)
    tables = build_fused_tables(db, index, dev)
    codes, lens, hap = simulate_read_batch(index, N_READS, 150, 0.01, seed=3)

    # K1 at the main path's shape, over this DB's text
    err1, ms, plain_ms = check_kernel(index.text, dev, 2 * BATCH, 160, 4,
                                      seed=1, timed=True)

    cfg = _host.ProfilingConfig.for_read_type("short")
    cfg.tail = "host"
    cfg.solver = "admm"
    out = os.path.join(build, "smoke_out")
    shutil.rmtree(out, ignore_errors=True)
    stage = {}
    extend.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    profile_fused(aligner, codes, lens, index, db, cfg, out, BATCH,
                  tables=tables, stage_out=stage)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = dict(extend.LAUNCHES)

    align_s = stage["align_cover_s"]
    print(f"align+cover {align_s:.3f} s, profile {wall - align_s:.3f} s, "
          f"e2e {wall:.3f} s for {N_READS} reads "
          f"({N_READS / wall:.0f} reads/s e2e)")
    aligned_frac = stage["n_aligned"] / N_READS
    # species accuracy: reads_classification.tsv rows are R<read index>
    truth_species = np.asarray(index.hap_species, dtype=object)[hap]
    n_ok = n_cls = 0
    with open(os.path.join(out, "reads_classification.tsv")) as f:
        for line in f:
            rid, _mapq, sp, _len = line.rstrip("\n").split("\t")
            n_cls += 1
            n_ok += truth_species[int(rid[1:])] == sp
    species = read_table(os.path.join(out, "species_abundance.txt"))
    strains = read_table(os.path.join(out, "strain_abundance.txt"))
    print(f"aligned fraction {aligned_frac:.4f}, species accuracy "
          f"{n_ok / max(n_cls, 1):.4f} over {n_cls} classified reads, "
          f"{len(species)} species rows, {len(strains)} strain rows")
    print(f"K1 launches {launches['banded_extend']} for {stage['n_batches']} "
          f"batches; plain DP runs {launches['banded_extend_plain']}")

    if launches["banded_extend"] != stage["n_batches"]:
        raise AssertionError("K1 was not launched exactly once per batch")
    if launches["banded_extend_plain"] != 0:
        raise AssertionError("the plain DP ran on the CUDA main path")
    if len(species) != 10 or len(strains) != 30:
        raise AssertionError(f"expected 10 species and 30 strains, got "
                             f"{len(species)} and {len(strains)}")
    ab = np.array([float(r["predicted_abundance"]) for r in strains])
    if not (np.isfinite(ab).all() and abs(ab.sum() - 1.0) < 1e-6):
        raise AssertionError("strain abundances are not finite or do not sum to 1")
    if aligned_frac < 0.95 or n_ok / max(n_cls, 1) < 0.99:
        raise AssertionError("aligned fraction or species accuracy too low")
    return launches["banded_extend"], err1, ms, plain_ms


def main() -> None:
    dev = require_cuda()
    print(card_line())
    build = str(extend.build_dir())
    t0 = time.time()
    extend.build_kernels()
    print(f"K1 build {time.time() - t0:.2f} s")
    ptxas = [ln for ln in extend.BUILD_LOG.splitlines() if "registers" in ln]
    for ln in ptxas:
        print("  ptxas:", ln.strip())

    rng = np.random.default_rng(0)
    text8 = np.concatenate([rng.integers(0, 4, size=8192).astype(np.int8),
                            np.full(1024, 4, np.int8)])
    err2, _, _ = check_kernel(text8, dev, 4096, 96, 8, seed=2, timed=False)
    cross_device_check(build, dev)
    launches, err1, ms, plain_ms = main_path(build, dev)

    print(json.dumps({"kernels": [dict(
        KERNEL, launches=launches, max_abs_err=max(err1, err2), ms=ms,
        plain_ms=plain_ms,
    )]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
