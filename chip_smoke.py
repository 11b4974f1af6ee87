#!/usr/bin/env python3
"""Smoke run of the PyTorch port (pantax_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero):

1. require a CUDA device; print the card's name and power limit;
2. build the banded-DP kernels (K1 and K2, csrc/banded_extend.cu) with
   nvcc and print ptxas's register report, and the SASS instructions of
   one step of K1's and of K2's main loop at pad 4 and pad 8 (cuobjdump);
3. hold K1 against its plain torch version on the card, bit for bit on all
   four outputs, at the main path's shape (131072 candidates, 160-base
   reads, pad 4) over the smoke DB's text, at a pad-8 random case and
   (after phase 5) on windows at the text's two ends, where K1 takes its
   clamped path, and time K1 and the plain version at the main shape;
4. run the port on the tiny 2-species DB on the CPU (plain versions) and on
   the GPU (kernels): packed query rows, na/ta/bc and the align_long_reads
   arrays of 16 long reads must be identical;
5. drive the main path: profile_fused over scale_db at its defaults (10
   species x 3 strains x 1 Mb), 1M simulated 150 bp reads, batch 65536,
   host tail, ADMM; K1 must be launched once per batch and the plain DP
   never; all 10 species and 30 strains must be reported;
6. hold the DP over given windows (K2) against its plain version, bit for
   bit on all four outputs, at the long-read rescue pass's shape (16384
   chunks of 512 bases, pad 8, windows of 528 cut from the smoke DB's text)
   at a pad-4 random case with N bases, on a windows view that starts off
   a 16-byte boundary at the narrowest width the wrapper takes (Lr + 2*pad
   - 1), and on the buffer's last rows (a view that ends where its
   allocation ends); hold K1 to the same outputs on the same candidates
   (K1 fetches the windows itself) and at the seeded pass's shape (32768
   candidates of 512 bases, pad 8); time K2, its plain version and K1, K2
   at 2048 to 131072 rows, and K1 and its plain version at the seeded
   pass's shape;
7. drive the long-read path over the same DB: 50,000 simulated HiFi-like
   reads of 8192 bp, align_long_reads with the hifi preset (chunk 512,
   seed stride 2) at batch 16384, FusedPipeline.feed_intervals, finish,
   and the long-read profile (host tail, ADMM); K1 must be launched once
   per seeded batch, K2 once per rescue batch, the plain DPs never; >= 95%
   of the reads emitted, >= 99% species accuracy, 10 species and 30
   strains;
8. drive the paired path over the same DB: 500,000 simulated FR pairs of
   150 bp mates (fragments uniform in 250-500 bp, 1% substitutions and
   0.05% indels per mate), FusedPipeline.feed_paired at 32768 pairs a
   batch, finish, and the device profile tail (ADMM), timed after one warm
   call; K1 must be launched once per paired batch (the joint mate query
   over 131072 candidates, phase 3's shape) and the plain DP never; >= 99%
   of the reads aligned, >= 99% species accuracy, 10 species and 30
   strains; then the host tail on the same FusedResult must report the
   same strains with abundances within 2e-4;
9. drive the dup-graph path over dup_db at its defaults (10 species x 3
   strains of 15625 64 bp nodes, a repeat node every 8 path steps, so
   every haplotype revisits a node and the fused path takes the windowed
   scatter): (a) has_dups set, the range scatter refused, the node window
   printed; (b) profile_fused on 1M simulated 150 bp reads at batch 65536,
   tail "auto", with K1 once per batch, the plain DP never, >= 99%
   aligned, >= 99% species accuracy, 10 species and 30 strains, and the
   windowed classify+scatter timed per batch; (c) the first 65536 reads
   fed at the automatic window and at a window of 3 segments (which sends
   a third of them to the host residual): identical na/ta/bc; (d) 500,000
   FR pairs through feed_paired with K1 once per paired batch and (b)'s
   bars; (e) 5,000 HiFi-like 8 kb reads through align_long_reads and
   feed_intervals (every row on a revisiting haplotype: the windowed
   scatter or the host residual), >= 95% emitted, >= 99% species accuracy,
   10 species and 30 strains.  Phase 4 also holds the windowed feeds of a
   small dup community CPU == CUDA;
10. drive the per-species GAF flow from read files: (a) phase 5's 1M reads
   written to a FASTQ file, Aligner.align_file at batch 65536 (the native
   parser, K1 once per batch, the plain DP never), write_gaf and read_gaf
   (the records equal those align_file returned, identity at its 6-decimal
   text), profile_from_gaf with device and with host coverage (ADMM):
   classification and species tables byte-identical, the same strains
   with every numeric column within STRAIN_RTOL relative (rows matched by
   genome ID: strains of tied abundance may come in another order), the
   device-coverage species and strain tables
   byte-identical to phase 5's (the same float32 coverage), and phase 5's
   bars; (b) phase 8's 500,000 pairs written to two FASTQ files,
   align_paired_files (K1 once per paired batch), profile_from_gaf with
   device coverage, phase 8's bars; (c) collect_alignment_arrays on (a)'s
   codes (K1 once per batch) and profile_from_alignments with device
   coverage: the four tables byte-identical to phase 5's profile_fused
   tables of the same reads; (d) phase 9e's 5,000 long reads written to a
   FASTA file, iter_read_groups, align_long_reads (GafRecords; K1 once per
   seeded batch, K2 once per rescue batch, the plain DPs never),
   filter_best_long_read_alignments, write_gaf / read_gaf, profile_from_gaf
   with device and with host coverage (held as in (a)), the widest node row
   over 64 nodes (where the reference's dedup switches form), phase 9e's
   bars; (e) for one species of (d) and one of (a), node_abundances_device
   on the card and on the CPU bit-identical in na, ta and bc. The stage times of (a), (b) and (d) are
   printed with the card's name and power limit.

The line before last is a JSON record of the kernels, each with its time,
its plain version's, and the bound the card's peaks put on the same work
(this run's inputs: read bytes and window bytes over the HBM rate, 5
instructions per DP cell over the SMs' instruction issue rate); the last
line is
{"ok": true, "device": {...}}.  Databases and the kernel build go under
build/ (git-ignored).
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
import subprocess
import time

import numpy as np
import torch

from pantax_tpu_torch import _host
from pantax_tpu_torch.align.long_read import (
    LONG_READ_PRESETS, LONG_READ_SEED_STRIDE, align_long_reads,
    iter_read_groups,
)
from pantax_tpu_torch.benchmarks import (
    dup_db, scale_db, simulate_long_reads, simulate_read_batch, tiny_db,
)
from pantax_tpu_torch.convert import aligner_from_reference
from pantax_tpu_torch.device import require_cuda
from pantax_tpu_torch.fastpath import (
    collect_alignment_arrays, profile_from_alignments,
)
from pantax_tpu_torch.io.gaf import (
    filter_best_long_read_alignments, read_gaf, write_gaf,
)
from pantax_tpu_torch.ops import extend
from pantax_tpu_torch.ops.coverage_device import node_abundances_device
from pantax_tpu_torch.ops.fused import (
    FusedPipeline, _ensure_tail_tables, _tail_mode, build_fused_tables,
    classify_scatter, classify_scatter_ranges, profile_from_fused_result,
    profile_fused,
)
from pantax_tpu_torch.pipeline import classify_gaf, profile_from_gaf
from pantax_tpu_torch.profile.coverage import pack_reads
from pantax_tpu_torch.profile.records import ReadRecord

KERNEL = {
    "name": "banded_extend",
    "route": "cuda",
    "source": "pantax_tpu_torch/csrc/banded_extend.cu",
    "replaces": "pantax_tpu/ops/extend_pallas.py:171",
}
KERNEL2 = {
    "name": "banded_extend_windows",
    "route": "cuda",
    "source": "pantax_tpu_torch/csrc/banded_extend.cu",
    "replaces": "pantax_tpu/ops/extend_pallas.py:316",
}
MATCH, MISMATCH, GAP = 1, -1, -2
N_READS, BATCH = 1_000_000, 65536
# the long path: run_long_e2e_benchmark's read length, read type and batch;
# its 100,000 reads halved for the run's time (the host simulator alone
# costs ~0.36 ms a read)
N_LONG, LONG_LEN, LONG_BATCH, READ_TYPE = 50_000, 8192, 16384, "hifi"
# the paired path: 1M reads as 500,000 pairs, in 16 batches
N_PAIRS, PAIR_BATCH, MATE_LEN = 500_000, 32768, 150
# the dup-graph path's long reads: few, since every row takes the windowed
# scatter or the host residual
N_DUP_LONG = 5000
# the bound: HBM bytes/s of an H100 SXM (published), and the DP's
# instructions per cell at their fewest on sm_90 (match test, score select,
# diagonal add, and the up and the left add+max as one DPX instruction each)
HBM_BYTES_PER_S = 3.35e12
DP_OPS_PER_CELL = 5
# opcodes whose counts in the kernels' SASS say how the DP was compiled
CLASS_SPECIES = ("reads_classification.tsv", "species_abundance.txt")
STRAINS = ("strain_abundance.txt", "ori_strain_abundance.txt")
BASES = np.frombuffer(b"ACGTN", np.uint8)
SASS_OPS = ("VIADDMNMX", "VIMNMX", "IMNMX", "IADD3", "IMAD", "ISETP", "SEL",
            "LOP3")
# device (float32) against host (float64) coverage in the per-species flow:
# every numeric column of the strain tables within this relative
# difference.  On an H100 the largest was 1.84e-6, in total_cov_diff, a
# difference of two near-equal coverage sums (its relative error is the
# sums' times their ratio to it); the other columns stayed below 7.3e-7
STRAIN_RTOL = 1e-5


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def issue_ops_per_s() -> float:
    """The card's instruction issue peak: SMs x 4 schedulers x 32 lanes x
    the maximum SM clock (nvidia-smi clocks.max.sm).  No mix of pipes (the
    ALU, IMAD on the FMA pipe, DPX) issues more than one warp instruction
    per scheduler per clock, so this bounds the DP whatever nvcc emits."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    mhz = float(out.stdout.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * 128 * mhz * 1e6


def sass_counts(lib_path: str) -> str:
    """Counts of SASS_OPS in the built kernels (cuobjdump beside nvcc), or
    why there are none."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    try:
        out = subprocess.run([tool, "-sass", lib_path], check=True,
                             capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.SubprocessError) as e:
        return f"not available ({type(e).__name__})"
    ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9]+)",
                     out.stdout)
    return ", ".join(f"{op} {ops.count(op)}" for op in SASS_OPS)


def ptxas_lines(log: str) -> list[str]:
    """ptxas's register report of each kernel instantiation in an nvcc
    log, as "kernel<WB>: report"."""
    lines, entry = [], ""
    for ln in log.splitlines():
        m = re.search(r"(banded_extend\w*_kernel)ILi(\d+)E", ln)
        if m:
            entry = f"{m[1]}<{m[2]}>"
        elif "registers" in ln:
            lines.append(f"{entry}: {ln.split(':', 1)[1].strip()}")
    return lines


def step_sass(lib_path: str, wb: int,
              kernel: str = "banded_extend_kernel") -> dict | str:
    """A DP kernel's main step loop in a built library (cuobjdump beside
    nvcc): the body of the widest innermost loop of ``kernel``<wb> (K1's
    banded_extend_kernel or K2's banded_extend_windows_kernel), its SASS
    instructions, the DP steps it holds (the maxes its max instructions
    take, fused with an add or not, over the 2 * (wb - 1) of one step) and
    instructions per step; or why there is none."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    try:
        out = subprocess.run([tool, "-sass", lib_path], check=True,
                             capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.SubprocessError) as e:
        return f"not available ({type(e).__name__})"
    funcs = re.split(r"\n\s*Function : ", out.stdout)
    body = next((f for f in funcs[1:]
                 if re.match(rf"\S*\d{kernel}ILi{wb}E", f)), None)
    if body is None:
        return "kernel not found"
    addrs, ops, labels, pending = [], [], {}, []
    for ln in body.splitlines():
        m = re.match(r"\s*(\.L_x_\d+):", ln)
        if m:
            pending.append(m[1])
            continue
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", ln)
        if m:
            labels.update((lb, int(m[1], 16)) for lb in pending)
            pending = []
            addrs.append(int(m[1], 16))
            ops.append(m[2])
    loops = []
    for a, op in zip(addrs, ops):
        m = re.match(r"(?:@!?U?P\w+\s+)?BRA\S*\s+(?:`\()?(0x[0-9a-f]+|\.L_x_\d+)",
                     op)
        if m:
            t = labels.get(m[1]) if m[1].startswith(".") else int(m[1], 16)
            if t is not None and t <= a:
                loops.append((a - t, t, a))
    # the widest of the innermost loops (the step loop, not one around it)
    inner = [lp for lp in loops
             if not any(lp[1] <= o[1] and o[2] < lp[2] for o in loops)]
    if not inner:
        return "no loop found"
    _, lo, hi = max(inner)
    names = [re.sub(r"^@!?U?P\w+\s+", "", op).split()[0]
             for a, op in zip(addrs, ops) if lo <= a <= hi]
    dpx = sum(n.startswith("VIADDMNMX") for n in names)
    # a three-input max (VIMNMX3) takes two of the DP's maxes
    maxes = dpx + sum((2 if n.split(".")[0].endswith("3") else 1)
                      for n in names if n.startswith(("VIMNMX", "IMNMX")))
    steps = max(1, round(maxes / (2 * (wb - 1))))
    return {"instructions": len(names), "steps": steps,
            "per_step": round(len(names) / steps, 2), "viaddmnmx": dpx,
            "max_ops": maxes}


def dp_bound(lens: np.ndarray, Lr: int, pad: int,
             issue_peak: float) -> tuple[float, str]:
    """(bound ms, what bounds it) of the banded DP over candidates with
    read lengths ``lens``: the rows it runs (min(len, Lr) each) times 2*pad
    band cells at DP_OPS_PER_CELL instructions, over ``issue_peak``;
    against the read and window bytes those rows touch plus w0, read_len
    and the four int32 outputs, over the HBM rate."""
    rows = np.minimum(np.asarray(lens, dtype=np.int64), Lr)
    wb = 2 * pad
    ops = float(rows.sum()) * wb * DP_OPS_PER_CELL
    nbytes = float(rows.sum() + (rows + wb - 1).sum() + 6 * 4 * len(rows))
    t_ops, t_bytes = ops / issue_peak, nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


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


def cuda_ms(fn, iters: int, hold: bool = False) -> float:
    """ms per call of ``fn`` over ``iters`` calls (CUDA events, after one
    warm-up).  With ``hold``, a sleep kernel first holds the stream while
    the host enqueues the calls, so that a kernel that takes less time than
    its launch's host work (Python, the checks, four output allocations)
    is timed by the device and not by the host's launch rate."""
    fn()  # warm-up
    torch.cuda.synchronize()
    if hold:
        t0 = time.perf_counter()
        fn()
        host_s = time.perf_counter() - t0
        # cycles at up to 2 GHz for 4x the host's time to enqueue the calls
        torch.cuda._sleep(int(min(1.0, 4 * iters * host_s + 1e-3) * 2e9))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def hold_k1(text, args, pad: int, what: str) -> int:
    """K1 against its plain version on the same tensors, bit for bit on
    all four outputs; returns the largest absolute difference (0)."""
    ker = extend.banded_extend_cuda(text, *args, pad, MATCH, MISMATCH, GAP)
    plain = extend.banded_extend_plain(text, *args, pad, MATCH, MISMATCH, GAP)
    torch.cuda.synchronize()
    err = max(int((k - p).abs().max()) for k, p in zip(ker, plain))
    for k, p, name in zip(ker, plain, ("score", "start", "end", "matches")):
        if not torch.equal(k, p):
            raise AssertionError(f"K1 != plain on {name} {what}")
    print(f"K1 == plain {what} (4 outputs bit-identical)")
    return err


def check_kernel(text_np: np.ndarray, dev, N: int, Lr: int, pad: int,
                 seed: int, timed: bool):
    text = torch.tensor(text_np).to(dev)
    args = [torch.from_numpy(a).to(dev)
            for a in dp_case(text_np, N, Lr, pad, seed)]
    err = hold_k1(text, args, pad, f"at N={N} Lr={Lr} pad={pad}")
    if not timed:
        return err, None, None
    ms = cuda_ms(lambda: extend.banded_extend_cuda(
        text, *args, pad, MATCH, MISMATCH, GAP), 50, hold=True)
    plain_ms = cuda_ms(lambda: extend.banded_extend_plain(
        text, *args, pad, MATCH, MISMATCH, GAP), 3)
    print(f"K1 {ms:.4f} ms, plain torch {plain_ms:.3f} ms at N={N} Lr={Lr} pad={pad}")
    return err, ms, plain_ms


def check_kernel_clamped(text_np: np.ndarray, dev, N: int = 8192,
                         Lr: int = 160, pad: int = 4, seed: int = 7) -> int:
    """K1 against its plain version where windows reach past either end of
    the text (w0 within 40 bases of position 0 or of the text's end, so
    that K1 takes its clamped per-byte path for them)."""
    rng = np.random.default_rng(seed)
    _, reads, lens = dp_case(text_np, N, Lr, pad, seed)
    T, W = len(text_np), Lr + 2 * pad
    w0 = np.where(rng.random(N) < 0.5, rng.integers(-40, 40, size=N),
                  rng.integers(T - W - 40, T + 40, size=N)).astype(np.int32)
    args = [torch.from_numpy(a).to(dev) for a in (w0, reads, lens)]
    return hold_k1(torch.from_numpy(text_np).to(dev), args, pad,
                   f"on windows at the text's ends at N={N} Lr={Lr} pad={pad}")


def windows_case(text_np: np.ndarray, dev, N: int, Lr: int, pad: int,
                 seed: int, n_bases: float = 0.0):
    """dp_case candidates with their windows text[w0 : w0 + Lr + 2*pad]
    cut out (and a share ``n_bases`` of N codes put into windows and
    reads), on ``dev``: (w0, windows, reads, read_len)."""
    rng = np.random.default_rng(seed + 100)
    w0, reads, lens = dp_case(text_np, N, Lr, pad, seed)
    windows = text_np[w0[:, None] + np.arange(Lr + 2 * pad)]
    if n_bases:
        windows = np.where(rng.random(windows.shape) < n_bases, 4, windows)
        reads = np.where(rng.random(reads.shape) < n_bases, 4, reads)
    return [torch.from_numpy(np.ascontiguousarray(a, dtype=d)).to(dev)
            for a, d in ((w0, np.int32), (windows, np.int8),
                         (reads, np.int8), (lens, np.int32))]


def hold_k2(args, pad: int, what: str):
    """K2 against its plain version on the same (windows, reads, read_len),
    bit for bit on all four outputs; returns the largest absolute
    difference (0) and the plain version's outputs."""
    ker = extend.banded_extend_windows_cuda(*args, pad, MATCH, MISMATCH, GAP)
    plain = extend.banded_extend_windows_plain(*args, pad, MATCH, MISMATCH,
                                               GAP)
    torch.cuda.synchronize()
    err = max(int((k - p).abs().max()) for k, p in zip(ker, plain))
    for k, p, name in zip(ker, plain, ("score", "start", "end", "matches")):
        if not torch.equal(k, p):
            raise AssertionError(f"K2 != plain on {name} {what}")
    print(f"K2 == plain {what} (4 outputs bit-identical)")
    return err, plain


def check_windows_kernel(text_np: np.ndarray, dev, N: int, Lr: int, pad: int,
                         seed: int, n_bases: float, timed: bool):
    """K2 against its plain version on windows cut from ``text_np`` at
    dp_case positions (with a share ``n_bases`` of N codes in windows and
    reads).  Without N codes the windows are the text's own, so K1 on the
    same candidates must give the same outputs: it is held to them too.
    With ``timed``, K2, the plain version and K1 are timed.  Returns (K2's
    err, K1's err or None, K2 ms, plain ms, K1 ms)."""
    w0, *args = windows_case(text_np, dev, N, Lr, pad, seed, n_bases)
    err, plain = hold_k2(args, pad, f"at N={N} Lr={Lr} pad={pad} "
                                    f"W={args[0].shape[1]}")
    text = torch.from_numpy(text_np).to(dev)
    err1 = None
    if not n_bases:
        k1 = extend.banded_extend_cuda(text, w0, *args[1:], pad, MATCH,
                                       MISMATCH, GAP)
        torch.cuda.synchronize()
        err1 = max(int((k - p).abs().max()) for k, p in zip(k1, plain))
        for k, p, name in zip(k1, plain, ("score", "start", "end", "matches")):
            if not torch.equal(k, p):
                raise AssertionError(
                    f"K1 != plain on {name} at N={N} Lr={Lr} pad={pad}")
        print("K1 == plain on the same candidates (4 outputs bit-identical)")
    if not timed:
        return err, err1, None, None, None
    ms = cuda_ms(lambda: extend.banded_extend_windows_cuda(
        *args, pad, MATCH, MISMATCH, GAP), 50, hold=True)
    plain_ms = cuda_ms(lambda: extend.banded_extend_windows_plain(
        *args, pad, MATCH, MISMATCH, GAP), 3)
    k1_ms = cuda_ms(lambda: extend.banded_extend_cuda(
        text, w0, *args[1:], pad, MATCH, MISMATCH, GAP), 50, hold=True)
    print(f"K2 {ms:.4f} ms, plain torch {plain_ms:.3f} ms, K1 on the same "
          f"candidates {k1_ms:.4f} ms at N={N} Lr={Lr} pad={pad}")
    return err, err1, ms, plain_ms, k1_ms


def k2_scaling(text_np: np.ndarray, dev, Lr: int, pad: int, lib=None,
               what: str = "") -> None:
    """K2's time (``lib``'s build, the current source's by default)
    against the number of rows at the rescue shape: a time that stays flat
    while N grows says the card had idle issue slots (latency-bound); a
    time that grows with N says it had none."""
    lib = lib or extend.build_kernels()
    got = {}
    for N in (2048, 4096, 8192, 16384, 32768, 65536, 131072):
        _w0, *args = windows_case(text_np, dev, N, Lr, pad, seed=N)
        got[N] = cuda_ms(lambda: extend.launch_k2(
            lib, *args, pad, MATCH, MISMATCH, GAP), 20, hold=True)
    print(f"K2{what} ms by rows at Lr={Lr} pad={pad}: "
          + ", ".join(f"{n}: {ms:.4f}" for n, ms in got.items()))


def check_windows_edges(text_np: np.ndarray, dev, N: int, Lr: int,
                        pad: int, seed: int) -> int:
    """K2 against its plain version at the fast DP's edges, on windows of
    the narrowest width (Lr + 2*pad - 1) cut from ``text_np``: the buffer
    as a view that starts 1 byte past a 16-byte boundary (its first row
    takes the per-byte path), and its last 3 rows at full read length as a
    view that ends where its allocation ends (where the fast DP's loads
    would pass the buffer's end).  Returns the largest absolute difference
    (0)."""
    _w0, windows, reads, lens = windows_case(text_np, dev, N, Lr, pad, seed)
    W = Lr + 2 * pad - 1
    buf = torch.empty(N * W + 16, dtype=torch.int8, device=dev)
    off = (1 - buf.data_ptr()) % 16
    view = buf[off:off + N * W].view(N, W)
    view.copy_(windows[:, :W])
    err, _ = hold_k2((view, reads, lens), pad,
                     f"on a view off a 16-byte boundary at N={N} Lr={Lr} "
                     f"pad={pad} W={W}")
    last = windows[:, :W].contiguous()
    lens = lens.clone()
    lens[-3:] = Lr
    err_last, _ = hold_k2((last[-3:], reads[-3:], lens[-3:]), pad,
                          f"on the buffer's last 3 rows at Lr={Lr} pad={pad} "
                          f"W={W}")
    return max(err, err_last)


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

    # the long-read path: seeded K1 at Lr 512, pad 8, and the rescue K2
    reads, _ = simulate_long_reads(index, 16, 4096, seed=9)
    arrs = []
    for d in ("cpu", dev):
        aligner = aligner_from_reference(
            index, _host.AlignConfig.for_read_type("long"), d)
        arrs.append(align_long_reads(aligner, reads, chunk=512, batch_size=256,
                                     seed_stride=2, as_arrays=True))
    cpu, gpu = arrs
    if cpu.read_ids != gpu.read_ids or not all(
            np.array_equal(getattr(cpu, k), getattr(gpu, k))
            for k in ("ts", "te", "mapq", "read_len")):
        raise AssertionError("tiny DB: CPU and CUDA long-read arrays differ")
    if len(gpu.read_ids) < 0.9 * len(reads):
        raise AssertionError("tiny DB: fewer than 90% of long reads emitted")
    print(f"tiny DB: CPU == CUDA on {len(reads)} long reads (align_long_reads "
          f"arrays, {len(gpu.read_ids)} emitted)")

    # the windowed scatter on a small dup-graph community: codes, paired
    # and interval feeds, at the automatic window and at 3 segments (the
    # host residual)
    db = dup_db(os.path.join(build, "dup_small"), n_species=2, strains=2,
                n_blocks=400)
    index = _host.build_align_index(db)
    codes, lens, _ = simulate_read_batch(index, 3000, 150, 0.01, seed=3)
    pairs, _ = simulate_pairs(index, 1500, seed=4)
    h0 = index.hap_offsets[:-1]  # per haplotype a windowed and a residual row
    ts, te = np.concatenate([h0 + 10, h0 + 1000]), np.concatenate([h0 + 400,
                                                                   h0 + 4000])
    iv = (ts, te, np.full(len(ts), 60), te - ts)
    for L_cap in (None, 3):
        res = []
        for d in ("cpu", dev):
            aligner = aligner_from_reference(index, cfg, d)
            pipe = FusedPipeline(aligner, build_fused_tables(db, index, d),
                                 1024, L_cap)
            pipe.feed(codes, lens)
            pipe.feed_paired(*pairs)
            pipe.feed_intervals(*iv)
            r = pipe.finish()
            res.append((r.na_d.cpu(), r.ta_d.cpu(), r.bc_d.cpu(), r.reads,
                        r.n_overflow))
        (na_c, ta_c, bc_c, reads_c, ov_c), (na_g, ta_g, bc_g, reads_g, ov_g) = res
        if not (torch.equal(na_c, na_g) and torch.equal(ta_c, ta_g)
                and torch.equal(bc_c, bc_g) and ov_c == ov_g and all(
                    np.array_equal(reads_c[k], reads_g[k])
                    for k in ("mapq", "aligned", "ridx", "read_len"))):
            raise AssertionError(f"dup community: CPU and CUDA windowed feeds "
                                 f"differ at L_cap={L_cap}")
        if pipe.use_ranges or (ov_g > 0) != (L_cap is not None):
            raise AssertionError("dup community: not the windowed scatter, or "
                                 "no overflow at the forced window")
        print(f"dup community: CPU == CUDA on the windowed feeds at L_cap "
              f"{pipe.L_cap} (na/ta/bc, per-read, {ov_g} overflowing reads)")


def read_table(path):
    lines = open(path).read().splitlines()
    head = lines[0].split("\t")
    return [dict(zip(head, ln.split("\t"))) for ln in lines[1:]]


def check_tables(out: str, truth_species, n_reads: int, n_out: int,
                 what: str, min_frac: float = 0.95):
    """Species accuracy over reads_classification.tsv (ids: one letter and
    the read's index), the fraction of reads ``what`` (``n_out`` of
    ``n_reads``, at least ``min_frac``) and the species / strain tables
    (10 species and 30 strains); raises below the smoke's bars."""
    n_ok = n_cls = 0
    with open(os.path.join(out, "reads_classification.tsv")) as f:
        for line in f:
            rid, _mapq, sp, _len = line.rstrip("\n").split("\t")
            n_cls += 1
            n_ok += truth_species[int(rid[1:])] == sp
    species = read_table(os.path.join(out, "species_abundance.txt"))
    strains = read_table(os.path.join(out, "strain_abundance.txt"))
    acc = n_ok / max(n_cls, 1)
    print(f"{what} fraction {n_out / n_reads:.4f}, species accuracy "
          f"{acc:.4f} over {n_cls} classified reads, {len(species)} species "
          f"rows, {len(strains)} strain rows")
    if len(species) != 10 or len(strains) != 30:
        raise AssertionError(f"expected 10 species and 30 strains, got "
                             f"{len(species)} and {len(strains)}")
    ab = np.array([float(r["predicted_abundance"]) for r in strains])
    if not (np.isfinite(ab).all() and abs(ab.sum() - 1.0) < 1e-6):
        raise AssertionError("strain abundances are not finite or do not sum to 1")
    if n_out / n_reads < min_frac or acc < 0.99:
        raise AssertionError(f"{what} fraction or species accuracy too low")


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
    print(f"K1 launches {launches['banded_extend']} for {stage['n_batches']} "
          f"batches; plain DP runs {launches['banded_extend_plain']}")
    if launches["banded_extend"] != stage["n_batches"]:
        raise AssertionError("K1 was not launched exactly once per batch")
    if launches["banded_extend_plain"] != 0:
        raise AssertionError("the plain DP ran on the CUDA main path")
    # reads_classification.tsv rows are R<read index>
    check_tables(out, np.asarray(index.hap_species, dtype=object)[hap],
                 N_READS, stage["n_aligned"], "aligned")
    return ((launches["banded_extend"], err1, ms, plain_ms),
            (db, index, tables), (codes, lens, hap, out))


def long_path(build: str, dev, db, index, tables):
    """Phase 7: the long-read path over the smoke DB."""
    aligner = aligner_from_reference(
        index, _host.AlignConfig.for_read_type("long"), dev)
    chunk, stride = LONG_READ_PRESETS[READ_TYPE], LONG_READ_SEED_STRIDE[READ_TYPE]
    t0 = time.time()
    reads, hap = simulate_long_reads(index, N_LONG, LONG_LEN, seed=9)
    print(f"simulated {N_LONG} reads of {LONG_LEN} bp in {time.time() - t0:.2f} s")
    # warm-up on a slice (first launches, pinned-memory pool), not timed
    align_long_reads(aligner, reads[:512], chunk=chunk, batch_size=LONG_BATCH,
                     seed_stride=stride, as_arrays=True)

    cfg = _host.ProfilingConfig.for_read_type("long")
    cfg.tail = "host"
    cfg.solver = "admm"
    out = os.path.join(build, "smoke_long_out")
    shutil.rmtree(out, ignore_errors=True)
    stage = {}
    extend.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    merged = align_long_reads(aligner, reads, chunk=chunk,
                              batch_size=LONG_BATCH, seed_stride=stride,
                              as_arrays=True, stage_out=stage)
    t_align = time.time() - t0
    pipe = FusedPipeline(aligner, tables, LONG_BATCH)
    pipe.feed_intervals(merged.ts, merged.te, merged.mapq, merged.read_len,
                        ids=merged.read_ids)
    result = pipe.finish()  # the per-read columns are host arrays
    torch.cuda.synchronize()
    t_feed = time.time() - t0 - t_align
    profile_from_fused_result(result, tables, index, db, cfg, out)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = dict(extend.LAUNCHES)

    mb = N_LONG * LONG_LEN / 1e6
    print(f"long: align {t_align:.3f} s (chunking {stage['chunk_s']:.3f} s, "
          f"seeded pass {stage['seeded_s']:.3f} s, rescue pass "
          f"{stage['rescue_s']:.3f} s, host merge "
          f"{t_align - stage['chunk_s'] - stage['seeded_s'] - stage['rescue_s']:.3f} s), "
          f"feed+finish {t_feed:.3f} s, profile {wall - t_align - t_feed:.3f} s, "
          f"e2e {wall:.3f} s for {N_LONG} reads ({mb:.1f} Mb): "
          f"{mb / t_align:.2f} Mb/s align, {mb / wall:.2f} Mb/s e2e")
    print(f"long: {stage['n_chunks']} chunks, {stage['n_seeded']} seeded in "
          f"{stage['seeded_batches']} batches, {stage['n_rescue']} rescued "
          f"in {stage['rescue_batches']} batches, "
          f"{pipe.n_interval_batches} interval batches")
    print(f"long: K1 launches {launches['banded_extend']}, K2 launches "
          f"{launches['banded_extend_windows']}; plain DP runs "
          f"{launches['banded_extend_plain']} (K1) and "
          f"{launches['banded_extend_windows_plain']} (K2)")
    if launches["banded_extend"] != stage["seeded_batches"]:
        raise AssertionError("K1 was not launched exactly once per seeded batch")
    if (launches["banded_extend_windows"] != stage["rescue_batches"]
            or stage["rescue_batches"] == 0):
        raise AssertionError("K2 was not launched exactly once per rescue batch")
    if launches["banded_extend_plain"] or launches["banded_extend_windows_plain"]:
        raise AssertionError("a plain DP ran on the CUDA long-read path")
    if pipe.n_interval_batches != -(-len(merged.read_ids) // LONG_BATCH):
        raise AssertionError("unexpected number of interval batches")
    check_tables(out, np.asarray(index.hap_species, dtype=object)[hap],
                 N_LONG, len(merged.read_ids), "emitted")
    return launches


def simulate_pairs(index, n: int, seed: int, sub: float = 0.01,
                   indel: float = 0.0005):
    """FR mate pairs over the index text: fragments uniform in 250-500 bp
    on a uniform haplotype; in the fragment's frame mate 1 is its first
    MATE_LEN bases and mate 2 the reverse complement of its last, and half
    the fragments are read from the other strand (mates swapped).  Each
    mate gets substitutions and 1 bp indels as simulate_read_batch makes
    them.  Returns ((codes1, lens1, codes2, lens2), truth hap per pair)."""
    rng = np.random.default_rng(seed)
    hap = rng.integers(0, len(index.hap_names), size=n)
    spans = np.diff(index.hap_offsets) - 1
    frag = rng.integers(250, 501, size=n)
    starts = (index.hap_offsets[hap] + rng.integers(
        0, np.maximum(spans[hap] - frag - 64, 1))).astype(np.int64)
    cols = np.arange(MATE_LEN)
    mates = []
    for origin in (starts, starts + frag - MATE_LEN):
        ev = rng.random((n, MATE_LEN))
        shift = np.cumsum((ev < indel / 2).astype(np.int64)
                          - ((ev >= indel / 2) & (ev < indel)), axis=1)
        m = index.text[origin[:, None] + np.clip(cols + shift, 0, None)]
        is_ins = (ev >= indel / 2) & (ev < indel)
        m[is_ins] = rng.integers(0, 4, size=int(is_ins.sum()), dtype=np.int8)
        sub_m = rng.random(m.shape) < sub
        m[sub_m] = rng.integers(0, 4, size=int(sub_m.sum()), dtype=np.int8)
        mates.append(m)
    end = mates[1][:, ::-1]
    mates[1] = np.where(end < 4, 3 - end, 4).astype(np.int8)
    swap = rng.random(n) < 0.5
    L = -(-MATE_LEN // 32) * 32
    out = []
    for m in (np.where(swap[:, None], mates[1], mates[0]),
              np.where(swap[:, None], mates[0], mates[1])):
        codes = np.full((n, L), 4, np.int8)
        codes[:, :MATE_LEN] = m
        out += [codes, np.full(n, MATE_LEN, np.int64)]
    return tuple(out), hap


def strain_abundance(out: str) -> dict:
    return {r["genome_ID"]: float(r["predicted_abundance"])
            for r in read_table(os.path.join(out, "strain_abundance.txt"))}


def paired_path(build: str, dev, db, index, tables):
    """Phase 8: paired reads over the smoke DB, the device tail, and the host
    tail on the same result."""
    aligner = aligner_from_reference(index, _host.AlignConfig(), dev)
    t0 = time.time()
    (c1, l1, c2, l2), hap = simulate_pairs(index, N_PAIRS, seed=13)
    ids1 = [f"A{i}" for i in range(N_PAIRS)]
    ids2 = [f"B{i}" for i in range(N_PAIRS)]
    print(f"simulated {N_PAIRS} pairs of {MATE_LEN} bp mates in "
          f"{time.time() - t0:.2f} s")
    cfg = _host.ProfilingConfig.for_read_type("short")
    cfg.solver = "admm"
    print(f"paired: tail 'auto' resolves to '{_tail_mode(tables, cfg)}' on "
          f"this DB (N_pad {tables.N_pad}, U_pad {tables.U_pad}: "
          f"{(tables.N_pad * 8 + tables.U_pad * 4) / 2**20:.1f} MiB of "
          f"na/ta/bc)")
    cfg.tail = "device"
    t0 = time.time()
    _ensure_tail_tables(tables)
    torch.cuda.synchronize()
    print(f"paired: tail tables {time.time() - t0:.3f} s")

    out = os.path.join(build, "smoke_paired_out")
    shutil.rmtree(out, ignore_errors=True)
    extend.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    pipe = FusedPipeline(aligner, tables, PAIR_BATCH)
    pipe.feed_paired(c1, l1, c2, l2, ids1=ids1, ids2=ids2)
    result = pipe.finish()  # the per-read download synchronises the device
    t_align = time.time() - t0
    times = {}
    for rep in ("cold", "warm"):  # the first call pays first uses
        stage = {}
        torch.cuda.synchronize()
        t1 = time.time()
        profile_from_fused_result(result, tables, index, db, cfg, out,
                                  stage_out=stage)
        torch.cuda.synchronize()
        times[rep] = (time.time() - t1, stage)
    launches = dict(extend.LAUNCHES)

    cfg.tail = "host"
    out_host = os.path.join(build, "smoke_paired_host_out")
    shutil.rmtree(out_host, ignore_errors=True)
    stage_h = {}
    torch.cuda.synchronize()
    t1 = time.time()
    profile_from_fused_result(result, tables, index, db, cfg, out_host,
                              stage_out=stage_h)
    torch.cuda.synchronize()
    t_host = time.time() - t1

    n_aligned = int(result.reads["aligned"].sum())
    t_dev, stage_d = times["warm"]

    def stages(st):
        return ", ".join(f"{k} {v:.3f}" for k, v in st.items())

    print(f"paired: align+cover {t_align:.3f} s for {N_PAIRS} pairs "
          f"({pipe.n_batches} batches); profile with the device tail "
          f"{t_dev:.3f} s warm ({stages(stage_d)}), first call "
          f"{times['cold'][0]:.3f} s; with the host tail {t_host:.3f} s "
          f"({stages(stage_h)}); e2e {t_align + t_dev:.3f} s (device tail, "
          f"{2 * N_PAIRS / (t_align + t_dev):.0f} reads/s)")
    print(f"paired: K1 launches {launches['banded_extend']} for "
          f"{pipe.n_batches} batches; plain DP runs "
          f"{launches['banded_extend_plain']}")
    if launches["banded_extend"] != pipe.n_batches or pipe.n_batches != -(
            -N_PAIRS // PAIR_BATCH):
        raise AssertionError("K1 was not launched exactly once per paired batch")
    if launches["banded_extend_plain"] != 0:
        raise AssertionError("the plain DP ran on the CUDA paired path")
    # reads_classification.tsv rows are A<pair index> / B<pair index>
    check_tables(out, np.asarray(index.hap_species, dtype=object)[hap],
                 2 * N_PAIRS, n_aligned, "aligned", min_frac=0.99)
    dev_ab, host_ab = strain_abundance(out), strain_abundance(out_host)
    if set(dev_ab) != set(host_ab):
        raise AssertionError("device and host tails report different strains")
    diff = max(abs(dev_ab[k] - host_ab[k]) for k in dev_ab)
    print(f"paired: device and host tails report the same {len(dev_ab)} "
          f"strains; abundances differ by at most {diff:.3g}")
    if diff > 2e-4:
        raise AssertionError("device and host tail abundances differ by > 2e-4")
    return launches["banded_extend"], ((c1, l1, c2, l2), hap)


def dup_path(build: str, dev):
    """Phase 9: the dup-graph community through the windowed scatter.
    Returns K1's launches by path and K2's on the long reads."""
    t0 = time.time()
    db = dup_db(os.path.join(build, "dup_db"))
    index = _host.build_align_index(db)
    tables = build_fused_tables(db, index, dev)
    print(f"dup DB build (or cache load) + index + tables: "
          f"{time.time() - t0:.2f} s, text {index.text_len} bases, "
          f"{len(index.hap_names)} haplotypes, has_dups {tables.has_dups}, "
          f"{int(tables.hap_dup.sum())} revisiting haplotypes")
    if not (tables.has_dups and tables.hap_dup.all()):
        raise AssertionError("dup DB: haplotypes do not revisit nodes")
    aligner = aligner_from_reference(index, _host.AlignConfig(), dev)
    codes, lens, hap = simulate_read_batch(index, N_READS, 150, 0.01, seed=3)
    truth = np.asarray(index.hap_species, dtype=object)

    # (b) single-end reads through profile_fused, tail "auto"
    cfg = _host.ProfilingConfig.for_read_type("short")
    cfg.solver = "admm"
    out = os.path.join(build, "smoke_dup_out")
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
    L_cap = stage["L_cap"]
    if L_cap is None:
        raise AssertionError("dup DB: profile_fused took the range scatter")
    align_s = stage["align_cover_s"]
    print(f"dup: windowed scatter at L_cap {L_cap} (tail '{_tail_mode(tables, cfg)}'); "
          f"align+cover {align_s:.3f} s, profile {wall - align_s:.3f} s, "
          f"e2e {wall:.3f} s for {N_READS} reads "
          f"({N_READS / wall:.0f} reads/s e2e); {stage['n_overflow']} "
          f"overflowing reads")
    print(f"dup: K1 launches {launches['banded_extend']} for "
          f"{stage['n_batches']} batches; plain DP runs "
          f"{launches['banded_extend_plain']}")
    if launches["banded_extend"] != stage["n_batches"]:
        raise AssertionError("K1 was not launched exactly once per batch")
    if launches["banded_extend_plain"] != 0:
        raise AssertionError("the plain DP ran on the CUDA dup path")
    check_tables(out, truth[hap], N_READS, stage["n_aligned"], "aligned",
                 min_frac=0.99)
    by_path = {"dup_short": launches["banded_extend"]}

    # the windowed classify+scatter of one batch, against the range scatter
    # of the same intervals (same reads, not exact on this DB: timing only)
    up = aligner.upload(codes[:BATCH], lens[:BATCH])
    ts, te, _s, _m, _q, _st, aligned = aligner.query(*up)
    pipe = FusedPipeline(aligner, tables, BATCH)
    win_ms = cuda_ms(lambda: classify_scatter(
        ts, te, aligned, tables, aligner.tstart, aligner.tnode, pipe.acc,
        L_cap), 20)
    rng_ms = cuda_ms(lambda: classify_scatter_ranges(
        ts, te, aligned, tables, aligner.tstart, aligner.tnode, pipe.acc), 20)
    print(f"dup: windowed classify+scatter {win_ms:.3f} ms per batch of "
          f"{BATCH} reads at L_cap {L_cap} (the range scatter over the same "
          f"intervals {rng_ms:.3f} ms)")

    # (c) the first batch at the automatic window and at 3 segments
    res = []
    for cap in (L_cap, 3):
        pipe = FusedPipeline(aligner, tables, BATCH, cap)
        pipe.feed(codes[:BATCH], lens[:BATCH])
        res.append(pipe.finish())
    (auto, forced) = res
    if not (torch.equal(auto.na_d, forced.na_d)
            and torch.equal(auto.ta_d, forced.ta_d)
            and torch.equal(auto.bc_d, forced.bc_d)):
        raise AssertionError("dup: na/ta/bc differ between L_cap "
                             f"{L_cap} and 3")
    print(f"dup: na/ta/bc identical at L_cap {L_cap} ({auto.n_overflow} "
          f"overflowing) and L_cap 3 ({forced.n_overflow} overflowing of "
          f"{BATCH}, through the host residual)")
    if forced.n_overflow <= 0:
        raise AssertionError("dup: L_cap 3 forced no overflow")

    # (d) pairs through the windowed paired step
    (c1, l1, c2, l2), phap = simulate_pairs(index, N_PAIRS, seed=13)
    ids1 = [f"A{i}" for i in range(N_PAIRS)]
    ids2 = [f"B{i}" for i in range(N_PAIRS)]
    out = os.path.join(build, "smoke_dup_paired_out")
    shutil.rmtree(out, ignore_errors=True)
    extend.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    pipe = FusedPipeline(aligner, tables, PAIR_BATCH)
    pipe.feed_paired(c1, l1, c2, l2, ids1=ids1, ids2=ids2)
    result = pipe.finish()
    t_align = time.time() - t0
    stage = {}
    profile_from_fused_result(result, tables, index, db, cfg, out,
                              stage_out=stage)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = dict(extend.LAUNCHES)
    split = ", ".join(f"{k} {v:.3f}" for k, v in stage.items())
    print(f"dup paired: align+cover {t_align:.3f} s for {N_PAIRS} pairs "
          f"({pipe.n_batches} batches, L_cap {pipe.L_cap}, "
          f"{result.n_overflow} overflowing reads), profile "
          f"{wall - t_align:.3f} s ({split}), e2e {wall:.3f} s; K1 launches "
          f"{launches['banded_extend']}, plain DP runs "
          f"{launches['banded_extend_plain']}")
    if pipe.use_ranges or launches["banded_extend"] != pipe.n_batches:
        raise AssertionError("K1 was not launched once per windowed paired batch")
    if launches["banded_extend_plain"] != 0:
        raise AssertionError("the plain DP ran on the CUDA dup paired path")
    check_tables(out, truth[phap], 2 * N_PAIRS,
                 int(result.reads["aligned"].sum()), "aligned", min_frac=0.99)
    by_path["dup_paired"] = launches["banded_extend"]

    # (e) long reads: every row on a revisiting haplotype
    long_al = aligner_from_reference(
        index, _host.AlignConfig.for_read_type("long"), dev)
    chunk, stride = LONG_READ_PRESETS[READ_TYPE], LONG_READ_SEED_STRIDE[READ_TYPE]
    reads, lhap = simulate_long_reads(index, N_DUP_LONG, LONG_LEN, seed=9)
    cfg = _host.ProfilingConfig.for_read_type("long")
    cfg.solver = "admm"
    out = os.path.join(build, "smoke_dup_long_out")
    shutil.rmtree(out, ignore_errors=True)
    stage = {}
    extend.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    merged = align_long_reads(long_al, reads, chunk=chunk,
                              batch_size=LONG_BATCH, seed_stride=stride,
                              as_arrays=True, stage_out=stage)
    t_align = time.time() - t0
    pipe = FusedPipeline(long_al, tables, LONG_BATCH)
    pipe.feed_intervals(merged.ts, merged.te, merged.mapq, merged.read_len,
                        ids=merged.read_ids)
    result = pipe.finish()
    torch.cuda.synchronize()
    t_feed = time.time() - t0 - t_align
    profile_from_fused_result(result, tables, index, db, cfg, out)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = dict(extend.LAUNCHES)
    print(f"dup long: align {t_align:.3f} s, feed+finish {t_feed:.3f} s, "
          f"profile {wall - t_align - t_feed:.3f} s for {N_DUP_LONG} reads; "
          f"interval rows {pipe.interval_rows} in {pipe.n_interval_batches} "
          f"windowed batches; K1 launches {launches['banded_extend']} "
          f"({stage['seeded_batches']} seeded batches), K2 launches "
          f"{launches['banded_extend_windows']} ({stage['rescue_batches']} "
          f"rescue batches); plain DP runs {launches['banded_extend_plain']} "
          f"(K1) and {launches['banded_extend_windows_plain']} (K2)")
    if (launches["banded_extend"] != stage["seeded_batches"]
            or launches["banded_extend_windows"] != stage["rescue_batches"]):
        raise AssertionError("dup long: K1 / K2 not once per seeded / rescue batch")
    if launches["banded_extend_plain"] or launches["banded_extend_windows_plain"]:
        raise AssertionError("a plain DP ran on the CUDA dup long-read path")
    if pipe.interval_rows["range"]:
        raise AssertionError("dup long: rows took the range scatter")
    check_tables(out, truth[lhap], N_DUP_LONG, len(merged.read_ids),
                 "emitted")
    by_path["dup_long"] = launches["banded_extend"]
    return by_path, launches["banded_extend_windows"], (db, index, reads,
                                                        lhap)


# ---------------------------------------------------------------------------
# phase 10: the per-species GAF flow from read files
# ---------------------------------------------------------------------------
def write_fastq(path: str, ids, codes: np.ndarray, lens: np.ndarray) -> None:
    """FASTQ of code rows (quality 'I'), written 65536 records at a time."""
    with open(path, "wb") as f:
        for lo in range(0, len(lens), 65536):
            block = BASES[codes[lo:lo + 65536]]
            f.write(b"".join(
                b"@%s\n%s\n+\n%s\n" % (ids[i].encode(),
                                      block[i - lo, :lens[i]].tobytes(),
                                      b"I" * int(lens[i]))
                for i in range(lo, min(lo + 65536, len(lens)))))


def gaf_round_trip(records, path: str) -> tuple[list, float]:
    """write_gaf then read_gaf: (records read back, seconds).  Raises unless
    every field equals the written record's, identity at its 6-decimal
    text."""
    t0 = time.time()
    write_gaf(path, records)
    back = read_gaf(path)
    seconds = time.time() - t0
    if len(back) != len(records) or any(
            dataclasses.replace(r, identity=float(f"{r.identity:.6f}")) != b
            for r, b in zip(records, back)):
        raise AssertionError(f"{path}: read_gaf(write_gaf(x)) != x")
    return back, seconds


def files_identical(out_a: str, out_b: str, names, what: str) -> None:
    for name in names:
        with open(os.path.join(out_a, name), "rb") as fa, \
                open(os.path.join(out_b, name), "rb") as fb:
            if fa.read() != fb.read():
                raise AssertionError(f"{what}: {name} differs")


def strains_agree(out_a: str, out_b: str, what: str) -> dict:
    """The same strains in both strain tables (rows matched by genome_ID:
    strains of equal abundance may tie in another order), every numeric
    column within STRAIN_RTOL relative, empty fields on both sides alike.
    Returns the largest relative difference of each numeric column."""
    rows_a, rows_b = ({r["genome_ID"]: r for r in read_table(
        os.path.join(out, "strain_abundance.txt"))} for out in (out_a, out_b))
    if set(rows_a) != set(rows_b):
        raise AssertionError(f"{what}: the strain tables name other strains")
    worst = {}
    for gid, ra in rows_a.items():
        rb = rows_b[gid]
        for k in list(ra)[3:]:
            if (ra[k] == "") != (rb[k] == ""):
                raise AssertionError(f"{what}: {gid} {k} empty on one side")
            a, b = (float(x) if x else 0.0 for x in (ra[k], rb[k]))
            d = 0.0 if a == b else abs(a - b) / max(abs(a), abs(b))
            worst[k] = max(worst.get(k, 0.0), d)
    over = {k: v for k, v in worst.items() if v > STRAIN_RTOL}
    if over:
        raise AssertionError(f"{what}: strain columns differ by more than "
                             f"{STRAIN_RTOL} relative: {worst_text(over)}")
    return worst


def worst_text(worst: dict) -> str:
    return ", ".join(f"{k} {v:.3g}" for k, v in worst.items())


def profile_gaf_runs(records, db, dev, read_type: str, out_base: str,
                     coverages=("device", "host")):
    """profile_from_gaf with each coverage (ADMM): {coverage: (seconds,
    stage, out dir)}."""
    runs = {}
    for cov in coverages:
        cfg = _host.ProfilingConfig.for_read_type(read_type)
        cfg.solver, cfg.coverage = "admm", cov
        out = f"{out_base}_{cov}"
        shutil.rmtree(out, ignore_errors=True)
        stage = {}
        torch.cuda.synchronize()
        t0 = time.time()
        profile_from_gaf(records, db, cfg, out, device=dev, stage_out=stage)
        torch.cuda.synchronize()
        runs[cov] = (time.time() - t0, stage, out)
    return runs


def stage_line(what: str, card: str, t_align: float, t_gaf: float,
               runs: dict) -> str:
    t_dev, st, _ = runs["device"]
    host = (f"{runs['host'][1]['coverage_s']:.3f} s (PAO "
            f"{runs['host'][1]['pao_s']:.3f} s)" if "host" in runs
            else "not run")
    return (f"{what} [{card}]: parse+align {t_align:.3f} s, GAF write+read "
            f"{t_gaf:.3f} s, classification {st['classify_s']:.3f} s, "
            f"species {st['species_s']:.3f} s, grouping {st['group_s']:.3f} s, "
            f"coverage device "
            f"{st['coverage_s']:.3f} s / host {host}, PAO {st['pao_s']:.3f} s, "
            f"report {st['report_s']:.3f} s; profile {t_dev:.3f} s; e2e "
            f"{t_align + t_gaf + t_dev:.3f} s (device coverage)")


def coverage_card_vs_cpu(records, db, dev, what: str) -> int:
    """Phase 10 (e): node_abundances_device on the card and on the CPU for
    the first species with reads, packed as the strain stage packs them.
    Returns the widest node row of all the records."""
    species, node_paths = classify_gaf(records, db)
    r = next(r for r in _host.load_species_range(db.range_file)
             if r.species in set(species))
    sp = r.species
    packed = pack_reads([
        ReadRecord(g.read_id, p, g.path_len, g.path_start, g.path_end, s)
        for g, p, s in zip(records, node_paths, species) if s == sp], r.start)
    graph = db.load_graph(sp)
    nodes_len = graph.nodes_len
    trio = _host.build_trio_index(nodes_len, graph.paths_dict())
    outs = []
    for d in (dev, "cpu"):
        torch.cuda.synchronize()
        t0 = time.time()
        outs.append((node_abundances_device(packed, nodes_len, trio,
                                            device=d), time.time() - t0))
    (gpu, t_gpu), (cpu, t_cpu) = outs
    for name, a, b in zip(("na", "ta", "bc"), gpu, cpu):
        if not np.array_equal(a, b):
            raise AssertionError(f"{what}: node_abundances_device {name} "
                                 f"differs between the card and the CPU")
    print(f"{what}: node_abundances_device card == CPU (na, ta, bc) for "
          f"species {sp}: {packed.nodes.shape[0]} reads x "
          f"{packed.nodes.shape[1]} nodes, {len(nodes_len)} graph nodes, "
          f"{trio.num_unique} unique trios; card {t_gpu:.3f} s, CPU "
          f"{t_cpu:.3f} s")
    return max(len(p) for p in node_paths)


def check_k1(launches: dict, n: int, what: str) -> None:
    if launches["banded_extend"] != n or launches["banded_extend_plain"]:
        raise AssertionError(f"{what}: K1 launches {launches['banded_extend']}"
                             f" for {n} batches, plain DP "
                             f"{launches['banded_extend_plain']}")


def gaf_flow(build: str, dev, card: str, scale, short, pairs, dup_long):
    """Phase 10.  Returns K1's and K2's launches by path."""
    db, index = scale
    codes, lens, hap, fused_out = short
    truth = np.asarray(index.hap_species, dtype=object)
    aligner = aligner_from_reference(index, _host.AlignConfig(), dev)
    k1, k2 = {}, {}

    # (a) single-end reads from a FASTQ file
    fq = os.path.join(build, "smoke_reads.fq")
    t0 = time.time()
    write_fastq(fq, [f"S{i}" for i in range(N_READS)], codes, lens)
    print(f"gaf short: wrote {N_READS} reads to FASTQ "
          f"({os.path.getsize(fq) / 1e6:.1f} MB) in {time.time() - t0:.2f} s")
    stage = {}
    extend.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    records = aligner.align_file(fq, batch_size=BATCH, stage_out=stage)
    t_align = time.time() - t0
    launches = dict(extend.LAUNCHES)
    check_k1(launches, stage["n_batches"], "gaf short")
    if stage["parser"] != "native":
        raise AssertionError("gaf short: the native parser did not run")
    k1["gaf_short"] = launches["banded_extend"]
    back, t_gaf = gaf_round_trip(records, os.path.join(build, "smoke.gaf"))
    runs = profile_gaf_runs(back, db, dev, "short",
                            os.path.join(build, "smoke_gaf"))
    out_dev, out_host = runs["device"][2], runs["host"][2]
    files_identical(out_dev, out_host, CLASS_SPECIES, "gaf short")
    worst = strains_agree(out_dev, out_host, "gaf short")
    # the same reads' float32 coverage as phase 5's fused path
    files_identical(out_dev, fused_out, ("species_abundance.txt", *STRAINS),
                    "gaf short (device coverage) vs profile_fused")
    print(stage_line("gaf short", card, t_align, t_gaf, runs)
          + f"; {len(records)} GAF records, {stage['n_batches']} batches, "
          f"K1 {launches['banded_extend']}")
    print(f"gaf short: device coverage: species and strain tables "
          f"byte-identical to phase 5's profile_fused; against host "
          f"coverage: classification and species byte-identical, the same "
          f"strains, largest relative differences {worst_text(worst)}")
    check_tables(runs["device"][2], truth[hap], N_READS, len(records),
                 "aligned")
    coverage_card_vs_cpu(back, db, dev, "gaf short")
    del records, back

    # (b) paired reads from two FASTQ files
    (c1, l1, c2, l2), phap = pairs
    p1, p2 = (os.path.join(build, f"smoke_pairs_{m}.fq") for m in (1, 2))
    write_fastq(p1, [f"A{i}" for i in range(N_PAIRS)], c1, l1)
    write_fastq(p2, [f"B{i}" for i in range(N_PAIRS)], c2, l2)
    stage = {}
    extend.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    records = aligner.align_paired_files(p1, p2, batch_size=PAIR_BATCH,
                                         stage_out=stage)
    t_align = time.time() - t0
    launches = dict(extend.LAUNCHES)
    check_k1(launches, stage["n_batches"], "gaf paired")
    k1["gaf_paired"] = launches["banded_extend"]
    back, t_gaf = gaf_round_trip(records,
                                 os.path.join(build, "smoke_pairs.gaf"))
    runs = profile_gaf_runs(back, db, dev, "short",
                            os.path.join(build, "smoke_gaf_paired"),
                            coverages=("device",))
    print(stage_line("gaf paired", card, t_align, t_gaf, runs)
          + f"; {len(records)} GAF records, {stage['n_batches']} paired "
          f"batches, K1 {launches['banded_extend']}")
    check_tables(runs["device"][2], truth[phap], 2 * N_PAIRS, len(records),
                 "aligned", min_frac=0.99)
    del records, back

    # (c) the array flow against phase 5's profile_fused tables
    stage = {}
    extend.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    arrays = collect_alignment_arrays(aligner, codes, lens, BATCH,
                                      stage_out=stage)
    t_align = time.time() - t0
    launches = dict(extend.LAUNCHES)
    check_k1(launches, stage["n_batches"], "arrays short")
    k1["arrays_short"] = launches["banded_extend"]
    cfg = _host.ProfilingConfig.for_read_type("short")
    cfg.solver, cfg.coverage = "admm", "device"
    out = os.path.join(build, "smoke_arrays_out")
    shutil.rmtree(out, ignore_errors=True)
    st = {}
    t0 = time.time()
    profile_from_alignments(arrays, index, db, cfg, out, device=dev,
                            stage_out=st)
    torch.cuda.synchronize()
    t_prof = time.time() - t0
    files_identical(out, fused_out, CLASS_SPECIES + STRAINS,
                    "arrays short vs profile_fused")
    print(f"arrays short [{card}]: align {t_align:.3f} s "
          f"({stage['n_batches']} batches, K1 {launches['banded_extend']}), "
          f"profile {t_prof:.3f} s ("
          + ", ".join(f"{k} {v:.3f}" for k, v in st.items())
          + "); the four tables byte-identical to phase 5's profile_fused")

    # (d) long reads on the dup DB from a FASTA file
    ddb, dindex, reads, lhap = dup_long
    fa = os.path.join(build, "smoke_dup_long.fa")
    _host.write_fasta(fa, reads)
    long_al = aligner_from_reference(
        dindex, _host.AlignConfig.for_read_type("long"), dev)
    chunk, stride = LONG_READ_PRESETS[READ_TYPE], LONG_READ_SEED_STRIDE[READ_TYPE]
    extend.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    records, n_seeded, n_rescue = [], 0, 0
    for group in iter_read_groups([fa]):
        stage = {}
        records += align_long_reads(long_al, group, chunk=chunk,
                                    batch_size=LONG_BATCH, seed_stride=stride,
                                    stage_out=stage)
        n_seeded += stage["seeded_batches"]
        n_rescue += stage["rescue_batches"]
    records = filter_best_long_read_alignments(records)
    t_align = time.time() - t0
    launches = dict(extend.LAUNCHES)
    check_k1(launches, n_seeded, "gaf dup long")
    if (launches["banded_extend_windows"] != n_rescue or not n_rescue
            or launches["banded_extend_windows_plain"]):
        raise AssertionError("gaf dup long: K2 not once per rescue batch")
    k1["gaf_dup_long"] = launches["banded_extend"]
    k2["gaf_dup_long"] = launches["banded_extend_windows"]
    back, t_gaf = gaf_round_trip(records,
                                 os.path.join(build, "smoke_dup_long.gaf"))
    widest = coverage_card_vs_cpu(back, ddb, dev, "gaf dup long")
    print(f"gaf dup long: widest node row {widest} nodes")
    if widest <= 64:
        raise AssertionError("gaf dup long: no node row wider than 64")
    runs = profile_gaf_runs(back, ddb, dev, "long",
                            os.path.join(build, "smoke_gaf_dup_long"))
    files_identical(runs["device"][2], runs["host"][2], CLASS_SPECIES,
                    "gaf dup long")
    worst = strains_agree(runs["device"][2], runs["host"][2], "gaf dup long")
    print(stage_line("gaf dup long", card, t_align, t_gaf, runs)
          + f"; {len(records)} GAF records after the filter, K1 "
          f"{launches['banded_extend']} ({n_seeded} seeded batches), K2 "
          f"{launches['banded_extend_windows']} ({n_rescue} rescue batches)")
    print(f"gaf dup long: device and host coverage: classification and "
          f"species byte-identical, the same strains, largest relative "
          f"differences {worst_text(worst)}")
    check_tables(runs["device"][2], np.asarray(dindex.hap_species,
                                               dtype=object)[lhap],
                 N_DUP_LONG, len(records), "emitted")
    return k1, k2


def main() -> None:
    dev = require_cuda()
    print(card_line())
    issue_peak = issue_ops_per_s()
    print(f"issue peak {issue_peak / 1e12:.2f} T instructions/s (SMs x 128 "
          f"lanes x the maximum SM clock); HBM {HBM_BYTES_PER_S / 1e12:.2f} "
          f"TB/s")
    build = str(extend.build_dir())
    t0 = time.time()
    lib = extend.build_kernels()
    print(f"kernel build (K1, K2) {time.time() - t0:.2f} s")
    print(f"SASS of K1 and K2: {sass_counts(lib._name)}")
    k1_sass = {f"pad{pad}": step_sass(lib._name, 2 * pad) for pad in (4, 8)}
    k2_sass = {f"pad{pad}": step_sass(lib._name, 2 * pad,
                                      "banded_extend_windows_kernel")
               for pad in (4, 8)}
    print(f"K1 main step loop SASS: {json.dumps(k1_sass)}")
    print(f"K2 main step loop SASS: {json.dumps(k2_sass)}")
    for ln in ptxas_lines(lib.build_log):
        print(f"  ptxas: {ln}")

    rng = np.random.default_rng(0)
    text8 = np.concatenate([rng.integers(0, 4, size=8192).astype(np.int8),
                            np.full(1024, 4, np.int8)])
    err2, _, _ = check_kernel(text8, dev, 4096, 96, 8, seed=2, timed=False)
    cross_device_check(build, dev)
    (launches, err1, ms, plain_ms), (db, index, tables), short = main_path(
        build, dev)
    err_c = check_kernel_clamped(index.text, dev)
    bound1, by1 = dp_bound(dp_case(index.text, 2 * BATCH, 160, 4, seed=1)[2],
                           160, 4, issue_peak)

    chunk = LONG_READ_PRESETS[READ_TYPE]
    err_k2, err1_r, ms2, plain_ms2, k1_ms = check_windows_kernel(
        index.text, dev, LONG_BATCH, chunk, 8, seed=4, n_bases=0.0,
        timed=True)
    bound2, by2 = dp_bound(dp_case(index.text, LONG_BATCH, chunk, 8, seed=4)[2],
                           chunk, 8, issue_peak)
    err_k2r, _, _, _, _ = check_windows_kernel(
        text8, dev, 4096, 96, 4, seed=5, n_bases=0.01, timed=False)
    err_k2e = check_windows_edges(index.text, dev, 4099, chunk, 8, seed=8)
    k2_scaling(index.text, dev, chunk, 8)
    # K1 at the seeded pass's shape (two strands per chunk), over this text
    err1_l, ms1_l, _ = check_kernel(index.text, dev, 2 * LONG_BATCH, chunk, 8,
                                    seed=6, timed=True)
    bound1_l, _ = dp_bound(dp_case(index.text, 2 * LONG_BATCH, chunk, 8,
                                   seed=6)[2], chunk, 8, issue_peak)
    print(f"bounds: K1 {bound1:.4f} ms ({by1}) at N={2 * BATCH} Lr=160 pad=4, "
          f"{bound1_l:.4f} ms at N={2 * LONG_BATCH} Lr={chunk} pad=8; K2 "
          f"{bound2:.4f} ms ({by2}) at N={LONG_BATCH} Lr={chunk} pad=8")
    long_launches = long_path(build, dev, db, index, tables)
    paired_launches, pairs = paired_path(build, dev, db, index, tables)
    dup_launches, dup_k2, dup_long = dup_path(build, dev)
    card = card_line()
    gaf_k1, gaf_k2 = gaf_flow(build, dev, card, (db, index), short, pairs,
                              dup_long)

    k1_by_path = {"short": launches, "long": long_launches["banded_extend"],
                  "paired": paired_launches, **dup_launches, **gaf_k1}
    k2_by_path = {"long": long_launches["banded_extend_windows"],
                  "dup_long": dup_k2, **gaf_k2}
    print(json.dumps({"kernels": [
        dict(KERNEL, launches=sum(k1_by_path.values()),
             launches_by_path=k1_by_path,
             max_abs_err=max(err1, err2, err1_r, err1_l, err_c), ms=ms,
             plain_ms=plain_ms, bound_ms=bound1, bound_by=by1,
             library_ms=None, long_seeded_ms=ms1_l,
             long_seeded_bound_ms=bound1_l, sass_per_step=k1_sass),
        dict(KERNEL2, launches=sum(k2_by_path.values()),
             launches_by_path=k2_by_path,
             max_abs_err=max(err_k2, err_k2r, err_k2e), ms=ms2,
             plain_ms=plain_ms2, bound_ms=bound2, bound_by=by2,
             library_ms=None, k1_same_candidates_ms=k1_ms,
             sass_per_step=k2_sass),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
