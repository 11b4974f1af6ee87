#!/usr/bin/env python3
"""Where a batch of the short-read fused feed spends its time on one GPU:
device time by kernel and by torch op, the device's idle share, and the
host's wall time a batch split into upload, Python dispatch and the
per-read bookkeeping.

    PYTHONPATH=. python scripts/feed_split.py [--db-dir build/scale_db]
        [--batch 65536] [--batches 2] [--trace-dir build/feed_trace]

Over scale_db at its defaults (built there, or loaded from its cache) and
150 bp reads simulated as chip_smoke.py's phase 5 makes them (seed 3, 1%
substitutions): a FusedPipeline at ``--batch`` reads a dispatch takes one
batch to warm up, then ``--batches`` batches with the host's clock on the
upload (``Aligner.upload``) and the query + scatter dispatch (the ops.fused
module's ``fused_step``, wrapped for the run), then ``--batches`` more
inside ``utils.logging.device_trace`` (torch.profiler; the trace's kernels
summed by name: the hand kernels K1, K2, K3, K4a, K4b, K5, K5p, K6 and
K11 by their own, every other kernel by the outermost torch op that
launched it, copies and sets by kind).  The idle share is one less the
union of the device's busy spans over the traced window (the feed's first
host op to its last device op).  The last line is ``feed split: {json}``:
the card's name and power limit, every time per batch in ms.

It uses only the port's public API, so it runs on any tree of the port:
``PYTHONPATH=<tree> python scripts/feed_split.py`` reads that tree's code
(an earlier commit unpacked with ``git archive`` under ``build/``), with
``--db-dir`` shared so both read one database.  chip_smoke.py's phase 5
prints the same line through ``feed_split``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

# the hand kernels by a piece of their symbol names, the longer first
KERNEL_LABELS = (("banded_extend_windows", "K2"), ("banded_extend", "K1"),
                 ("seed_stage", "K3"), ("classify_scatter_ranges", "K6"),
                 ("classify_scatter", "K11"), ("query_prologue", "K4a"),
                 ("query_rows", "K4b"), ("query_pick_paired", "K5p"),
                 ("query_pick", "K5"))
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _label(ev, launcher: dict) -> str:
    name = ev.get("name", "")
    for piece, label in KERNEL_LABELS:
        if piece in name:
            return label
    if ev.get("cat") == "gpu_memcpy":
        return "memcpy " + (name.split()[1] if len(name.split()) > 1 else "")
    if ev.get("cat") == "gpu_memset":
        return "memset"
    return launcher.get(ev.get("args", {}).get("correlation"), "other kernel")


def _launchers(events) -> dict:
    """correlation id -> the outermost torch op around the runtime call
    that launched it (on the calling thread)."""
    ops = {}
    for e in events:
        if e.get("cat") == "cpu_op" and e.get("ph") == "X":
            ops.setdefault((e["pid"], e["tid"]), []).append(
                (e["ts"], e["ts"] + e.get("dur", 0), e["name"]))
    out = {}
    for e in events:
        if e.get("cat") not in ("cuda_runtime", "cuda_driver"):
            continue
        corr = e.get("args", {}).get("correlation")
        around = [op for op in ops.get((e["pid"], e["tid"]), ())
                  if op[0] <= e["ts"] <= op[1]]
        if corr is not None and around:
            out[corr] = max(around, key=lambda op: op[1] - op[0])[2]
    return out


def trace_split(path: str, n_batches: int) -> dict:
    """Device ms by label, busy ms, window ms (per batch) and the idle
    share of a device_trace's trace.json."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if isinstance(e, dict) and e.get("ph") == "X"]
    dev = [e for e in events if e.get("cat") in DEVICE_CATS]
    if not dev:
        return {"error": "no device events in the trace"}
    launcher = _launchers(events)
    by = {}
    for e in dev:
        lab = _label(e, launcher)
        by[lab] = by.get(lab, 0.0) + e.get("dur", 0) / 1e3
    spans = sorted((e["ts"], e["ts"] + e.get("dur", 0)) for e in dev)
    busy, cur = 0.0, None
    for lo, hi in spans:
        if cur is None or lo > cur[1]:
            if cur is not None:
                busy += cur[1] - cur[0]
            cur = [lo, hi]
        else:
            cur[1] = max(cur[1], hi)
    busy += cur[1] - cur[0]
    feed_ops = [e for e in events if e.get("cat") == "cpu_op"]
    start = min(e["ts"] for e in (feed_ops or dev))
    window = spans[-1][1] - start
    return {
        "device_ms_by_op": {k: v / n_batches for k, v in
                            sorted(by.items(), key=lambda kv: -kv[1])},
        "device_ops": len(dev) / n_batches,
        "device_busy_ms": busy / 1e3 / n_batches,
        "window_ms": window / 1e3 / n_batches,
        "idle_share": 1.0 - busy / window if window > 0 else None,
    }


def feed_split(aligner, tables, codes, lens, batch: int, n_batches: int = 2,
               trace_dir: str = "feed_trace") -> dict:
    """The split over ``codes`` / ``lens``: one warm-up batch, then
    ``n_batches`` host-timed and ``n_batches`` traced (1 + 2 n_batches
    batches of the rows in order)."""
    from pantax_tpu_torch.ops import fused
    from pantax_tpu_torch.utils.logging import device_trace

    need = (1 + 2 * n_batches) * batch
    if len(lens) < need:
        raise ValueError(f"feed_split needs {need} reads, got {len(lens)}")
    pipe = fused.FusedPipeline(aligner, tables, batch)
    pipe.feed(codes[:batch], lens[:batch])
    torch.cuda.synchronize()

    spent = {"upload": 0.0, "dispatch": 0.0}

    def timed(key, fn):
        def call(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                spent[key] += time.perf_counter() - t0
        return call

    step, upload = fused.fused_step, aligner.upload
    fused.fused_step = timed("dispatch", step)
    aligner.upload = timed("upload", upload)
    try:
        lo, hi = batch, (1 + n_batches) * batch
        t0 = time.perf_counter()
        pipe.feed(codes[lo:hi], lens[lo:hi])
        host = time.perf_counter() - t0
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        fused.fused_step = step
        del aligner.upload
    lo, hi = hi, hi + n_batches * batch
    with device_trace(trace_dir):
        pipe.feed(codes[lo:hi], lens[lo:hi])
        torch.cuda.synchronize()
    per = 1e3 / n_batches
    out = {"batch": batch, "batches": n_batches,
           "host_ms": {"wall": wall * per, "feed": host * per,
                       "upload": spent["upload"] * per,
                       "dispatch": spent["dispatch"] * per,
                       "bookkeeping": (host - spent["upload"]
                                       - spent["dispatch"]) * per}}
    out.update(trace_split(os.path.join(trace_dir, "trace.json"), n_batches))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--db-dir", default=os.path.join("build", "scale_db"))
    p.add_argument("--batch", type=int, default=65536)
    p.add_argument("--batches", type=int, default=2)
    p.add_argument("--trace-dir", default=os.path.join("build", "feed_trace"))
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("feed_split: no CUDA device", file=sys.stderr)
        return 1
    import pantax_tpu_torch
    from pantax_tpu_torch import _host
    from pantax_tpu_torch.bench import card_line
    from pantax_tpu_torch.benchmarks import scale_db, simulate_read_batch
    from pantax_tpu_torch.convert import aligner_from_reference
    from pantax_tpu_torch.ops.fused import build_fused_tables

    dev = torch.device("cuda", 0)
    t0 = time.time()
    db = scale_db(args.db_dir)
    index = _host.build_align_index(db)
    aligner = aligner_from_reference(index, _host.AlignConfig(), dev)
    tables = build_fused_tables(db, index, dev, aligner.segment_lookup)
    n = (1 + 2 * args.batches) * args.batch
    codes, lens, _ = simulate_read_batch(index, n, 150, 0.01, seed=3)
    print(f"set-up {time.time() - t0:.1f} s; code {pantax_tpu_torch.__file__}")
    split = feed_split(aligner, tables, codes, lens, args.batch, args.batches,
                       args.trace_dir)
    print("feed split: " + json.dumps({"card": card_line(), **split}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
