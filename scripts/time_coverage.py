#!/usr/bin/env python3
"""Time the port's device coverage scatter (ops/coverage_device.py) on one
GPU at the shapes its two callers give it, on rows that revisit nodes (so
the first-occurrence dedup runs):

- ``windowed``: the fused path's windowed scatter on the dup-graph DB,
  65536 reads a batch at a 4-segment window, trio matches given;
- ``species_L<w>``: node_abundances_device of one species in the
  per-species flow, 99,894 reads (the short GAF cell's largest species) of
  w nodes, the trios found by hash: w = 11 (150 bp reads), 32, 64 and 130
  (the dup DB's 8 kb long reads).

    PYTHONPATH=. python scripts/time_coverage.py

For each case it prints one JSON line: the package directory that ran,
the case, rows x width, the scatter's time per call (CUDA events), the
whole node_abundances_device call (host tables, upload, scatter, finalize,
download; host clock) and the peak device memory of one scatter.  Point
PYTHONPATH at another checkout to time its code on the same card in the
same call.  Needs a CUDA device.
"""
from __future__ import annotations

import json
import os
import subprocess
import time
from types import SimpleNamespace

import numpy as np
import torch

import pantax_tpu_torch
from pantax_tpu_torch import _host
from pantax_tpu_torch.device import require_cuda
from pantax_tpu_torch.ops import coverage_device as cov

N_SPECIES_READS = 99_894
WINDOW_BATCH, WINDOW_L = 65536, 4
N_NODES, NODE_LEN, REPEAT_EVERY, N_HAPS = 47_698, 64, 8, 3


def haplotype_paths(rng) -> dict:
    """N_HAPS paths over the node ids, each skipping a tenth of them and
    revisiting node 0 every REPEAT_EVERY steps (as the dup DB does)."""
    paths = {}
    for h in range(N_HAPS):
        ids = np.flatnonzero(rng.random(N_NODES - 1) > 0.1) + 1
        steps = np.insert(ids, np.arange(0, len(ids), REPEAT_EVERY), 0)
        paths[f"hap{h}"] = steps.astype(np.int64)
    return paths


def walk_rows(rng, paths: dict, R: int, L: int):
    """R reads of L nodes along the haplotype paths: (nodes int32 [R, L],
    read_start, read_end)."""
    names = sorted(paths)
    hap = rng.integers(0, len(names), size=R)
    nodes = np.empty((R, L), np.int32)
    for h, name in enumerate(names):
        sel = np.flatnonzero(hap == h)
        p = paths[name]
        start = rng.integers(0, len(p) - L, size=len(sel))
        nodes[sel] = p[start[:, None] + np.arange(L)]
    rs = rng.integers(0, NODE_LEN, size=R)
    re = rng.integers(1, NODE_LEN + 1, size=R)
    return nodes, rs, re


def cuda_ms(fn, iters: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def peak_mib(fn) -> float:
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 2**20


def report(case: str, R: int, L: int, scatter, call=None) -> None:
    rec = {"package": os.path.dirname(pantax_tpu_torch.__file__),
           "case": case, "rows": R, "width": L,
           "scatter_ms": cuda_ms(scatter), "peak_mib": peak_mib(scatter)}
    if call is not None:
        call()
        t0 = time.perf_counter()
        for _ in range(5):
            call()
        rec["call_ms"] = (time.perf_counter() - t0) / 5 * 1e3
    print(json.dumps(rec), flush=True)


def main() -> None:
    dev = require_cuda()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip())
    rng = np.random.default_rng(0)
    paths = haplotype_paths(rng)
    nodes_len = np.full(N_NODES, NODE_LEN, np.int64)
    trio = _host.build_trio_index(nodes_len, paths)

    def put(a, dtype=np.int32):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype)).to(dev)

    t = cov.build_padded_tables(nodes_len, trio.trio_len, trio.trio_nodes)
    nl_d, bo_d = put(t.nodes_len), put(t.base_offset)

    def accs():
        return (torch.zeros(t.N_pad + 1, dtype=torch.int64, device=dev),
                torch.zeros(t.TB_pad + 1, dtype=torch.int32, device=dev),
                torch.zeros(t.U_pad + 1, dtype=torch.int64, device=dev))

    # the windowed scatter: given trio matches, a 4-segment window
    nodes, rs, re = walk_rows(rng, paths, WINDOW_BATCH, WINDOW_L)
    rows = (put(nodes), put(np.full(WINDOW_BATCH, WINDOW_L)), put(rs),
            put(re + 2 * NODE_LEN))
    match = put(rng.integers(-1, trio.num_unique,
                             size=(WINDOW_BATCH, WINDOW_L - 2)))
    acc = accs()
    report("windowed", WINDOW_BATCH, WINDOW_L, lambda: cov.coverage_scatter(
        *rows, nl_d, bo_d, acc, has_dups=True, trio_match=match))

    # one species of the per-species flow: the hash trio lookup
    lookup = t.trio_lookup(dev)
    for L in (11, 32, 64, 130):
        nodes, rs, re = walk_rows(rng, paths, N_SPECIES_READS, L)
        lens = np.full(N_SPECIES_READS, L)
        packed = _host.PackedReads(nodes=nodes.astype(np.int64), lengths=lens,
                                   read_start=rs,
                                   read_end=re + (L - 1) * NODE_LEN)
        R_pad, L_pad = cov._pow2(N_SPECIES_READS), cov._pow2(L, lo=4)
        pad_nodes = np.full((R_pad, L_pad), -1, np.int32)
        pad_nodes[:N_SPECIES_READS, :L] = nodes
        rows = [put(pad_nodes)] + [
            put(np.pad(a, (0, R_pad - N_SPECIES_READS)))
            for a in (lens, rs, packed.read_end)]
        acc = accs()
        report(f"species_L{L}", N_SPECIES_READS, L,
               lambda: cov.coverage_scatter(*rows, nl_d, bo_d, acc,
                                            has_dups=True,
                                            trio_lookup=lookup),
               lambda: cov.node_abundances_device(
                   packed, nodes_len, SimpleNamespace(
                       trio_len=trio.trio_len, trio_nodes=trio.trio_nodes),
                   device=dev))


if __name__ == "__main__":
    main()
