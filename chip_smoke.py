#!/usr/bin/env python3
"""Smoke run of the PyTorch port (pantax_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero):

1. require a CUDA device; print the card's name and power limit;
2. build the banded-DP kernels (K1 and K2, csrc/banded_extend.cu), the
   seed stage (K3, csrc/seed_stage.cu), the classify + scatter (K6 and
   K11, csrc/classify_scatter.cu), the ADMM chunk (K8,
   csrc/admm_chunk.cu) and the device tail's stats and polish (K9 and
   K10b, csrc/profile_tail.cu) with nvcc, one process per source
   started together, and print ptxas's register report, the SASS
   instructions of one step of K1's and of K2's main loop at pad 4 and pad
   8, and those of K3's vote loops (cuobjdump);
3. hold K1 against its plain torch version on the card, bit for bit on all
   four outputs, at the main path's shape (131072 candidates, 160-base
   reads, pad 4) over the smoke DB's text, at a pad-8 random case and
   (after phase 5) on windows at the text's two ends, where K1 takes its
   clamped path, and time K1 and the plain version at the main shape;
3b. hold the seed stage (K3, csrc/seed_stage.cu) against its plain torch
   version, bit for bit on its three outputs, over the smoke DB's seed
   tables: phase 5's first 65536 reads at the main path's width (160) and
   cut to 150 bases (width 152), with the CHD lookup at density 3; 131072
   mates (the paired query's rows); 16384 long-read chunks of 512 bases
   at pad 8; the first case on a forced bisection table and on a density-4
   index of the same DB; the crafted cases of ``seed_cases`` (hand-built
   seed tables at the edges of the stage's semantics: ties, the strands'
   tie, a round with every count 0, 256 slots at top_k 8, int32
   differences of -2^31 and 2^31 - 1, empty, short and all-N rows, a row
   of 8192 columns); time K3 and the plain version at both widths of
   the first case.  Every later phase that counts K1 launches holds K3's
   to them (one seed stage per query dispatch) and the plain seed stage
   to 0, the subprocesses of phases 11, 12 and 14 included;
3c. hold the classify + scatter against its plain torch versions, bit for
   bit in ridx, overflow and every accumulator (the sink slots aside, the
   diff array's last slot included; the kernels' sinks stay 0): K6, the
   range scatter, on the crafted cases of ``scatter_cases`` (tiny_db and
   the small dup community, each of ``table_variants``' tables: as built,
   masked, haplotype offsets shifted into segments, buckets 32x wider),
   phase 5's first 65536 reads, a paired batch of 2 x 65536 mates, an
   interval batch of 16384 rows of 1-160 segments and reads in the smoke
   DB's fullest buckets; K11, the windowed
   scatter (after phase 9 (b), where the dup DB is built), on the crafted
   cases at node windows of 8 (tiny_db) and 4, 12, 16, 32 and 64 (the dup
   community: every template width, and a tile left part empty), the dup
   DB's first 65536 reads at its automatic window and at 3
   segments (overflow) and an interval batch at 8; each timed with its
   plain version on the same rows, beside its bound (``scatter_work``'s
   bytes).  Every later phase holds K6's launches to the fused pipeline's
   range dispatches and K11's to its windowed ones, the plain scatters to
   0 (``check_k6``, ``check_k11``, in ``check_k3``), and the in-process
   paths hold those dispatches to their own batch counts
   (``check_dispatches``);
3d. hold the strain solve's ADMM chunk (K8, csrc/admm_chunk.cu) against
   its plain torch version (in phase 8, after the device tail, whose
   buckets it takes): the device tail once more with the plain chunk put
   in its place by assignment in this process, recording each chunk's
   inputs, its tables against K8's (the same strains, abundances within
   2e-4); the device tail once more with K8, its tables byte-identical
   to the first run's, and each chunk's residual of both runs printed
   beside four chunks of the plain chunk in float64 from the largest
   bucket's zero state;
   the plan (cluster, rows a thread, bits or float) of every bucket the
   tail dispatched; K8 against the plain chunk after one step and after
   25 (every state vector and the residual within K8_BARS, the inputs
   untouched) on the largest bucket's first chunk (the zero state,
   aliased as the solvers pass it; the bits plan, and the float plan as
   a non-0/1 A takes it) and its next, on a crafted wide-row case (2,
   4096, 132: the float plan, rows streamed, L in global memory), on
   the bits plan's smallest bucket (1, 4096, 4) and on 0/1 wide rows (1,
   65536, 32); two launches of 250 steps bit-identical (both plans); K8
   and the plain chunk timed at 250 steps beside ``admm_bound`` on the
   bucket, (1, 4096, 4) and (1, 65536, 32).  Every profile of every later phase (and phases 5 and
   7) holds K8's launches to the chunks the solvers dispatched and the
   plain chunk to 0 (``check_k8``, in ``check_k3`` and around each
   profile call), the subprocesses of phases 12 and 14 included;
3e. hold the device tail's strain stats (K9) and coordinate-median polish
   (K10b, both csrc/profile_tail.cu) against their plain torch versions
   (in phase 8, after phase 3d): the device tail once more with the plain
   stats and polish put in their places by assignment, once more with
   the kernels, recording their inputs: its tables byte-identical to
   phase 8's, the plain stages' the same strains with every numeric
   column within STRAIN_RTOL, both runs' strain_s printed, K9 and K10b
   once per dispatch; K9 against the plain stats on the recorded coverage,
   on crafted tables whose trio owners interleave (``k9_case``) and, in
   float64 (``k9_want``), on its edges (K9_EDGES: a hap past its plan's
   registers beside a species of 600,000 nodes, clusters of 2, G + S
   past 132): counts, path_cov, sp_max and sp_valid exact, the float sums
   within K9_RTOL, two launches bit-identical; K10b against the plain polish bit
   for bit (the sign of a zero aside) on every recorded bucket and on the
   crafted edges of ``polish_case`` at (6, 4096, 4) and (6, 65536, 4), at
   0, 1, 3, 8 and 20 sweeps, two launches bit-identical; K9 timed on the
   recorded coverage (its ``stats_plan`` printed), K10b on every recorded bucket, beside their bounds
   (``tail_stats_bound``, ``polish_bound``), the plain versions and a
   CUDA-graph replay of the plain polish, with the sweeps each instance
   ran (``sweeps_run``, from the plain polish) and its live columns.
   Every later phase holds K9's launches to dispatch_tail_stats' calls
   and K10b's to the device polish calls, the plain versions to 0
   (``check_k9_k10b``, in ``check_k3``);
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
   call, the two calls' tables byte-identical; K1 must be launched once
   per paired batch (the joint mate query
   over 131072 candidates, phase 3's shape) and the plain DP never; >= 99%
   of the reads aligned, >= 99% species accuracy, 10 species and 30
   strains; then the host tail on the same FusedResult must report the
   same strains with abundances within 2e-4; then both tails again with
   the node-sampling cap (cfg.sample_nodes) at the median of K9's
   sp_valid (``capped_tail``): the species over it take the device
   tail's host solve, the others the device solve, and the two tails'
   classification and species tables must be byte-identical, the
   strains the same, abundances within 2e-4;
9. drive the dup-graph path over dup_db at its defaults (10 species x 3
   strains of 15625 64 bp nodes, a repeat node every 8 path steps, so
   every haplotype revisits a node and the fused path takes the windowed
   scatter): (a) has_dups set, the range scatter refused, the node window
   printed; (b) profile_fused on 1M simulated 150 bp reads at batch 65536,
   tail "auto", with K1 once per batch, the plain DP never, >= 99%
   aligned, >= 99% species accuracy, 10 species and 30 strains, phase
   3c's K11 half, and the windowed classify+scatter (K11 and its plain
   version) and the range one (K6 and its plain version) timed per batch
   of the same reads; (c) the first 65536 reads
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
   printed with the card's name and power limit.  The FASTQ's read ids
   are R<index>, as phase 5's classification table names its reads;
11. drive the pantax-gpu command line in this process
   (pantax_tpu_torch.cli.main, so the launch counts see it), each run's
   e2e wall time and stage_timer lines printed with the card's line:
   (a) --create over the smoke DB (its skip path) and from scratch on the
   tiny DB's FASTAs (the library build's files, byte for byte); (b)
   --index --warm-kernels; (c) -s --fastpath --tail host --coverage
   device over phase 10's FASTQ, K1 once per dispatch, its species,
   strain and classification files byte-identical to phase 5's
   profile_fused tables, then the -n / --strain resume (no K1 launch, the
   alignment artifact untouched) byte-identical too; (d) -s -p --fastpath
   over phase 10's two pair files at 32768 pairs a batch, K1 once per
   paired dispatch, phase 8's bars; (e) -l --fastpath over phase 7's
   reads written as FASTQ: phase 7's K1 and K2 launches and bars; (f) the
   GAF flow -s --coverage device over phase 10's FASTQ: K1 as phase
   10 (a), the three files byte-identical to phase 10 (a)'s
   device-coverage tables; (g) in a subprocess where torch sees no GPU
   (CUDA_VISIBLE_DEVICES=""), python -m pantax_tpu_torch.cli exits
   non-zero and writes nothing;
12. drive the multi-device paths on the one card: (a) phase 5's 1M reads
   through FusedPipeline with an Aligner on make_mesh([cuda:0, cuda:0])
   and on one device, batch 65536: na/ta/bc and every per-read column
   bit-identical, K1 launched once per row block of each dispatch (twice a
   dispatch) on the mesh, then profile_from_fused_result (phase 5's host
   tail): the three tables byte-identical to phase 5's; (b)-(d) pantax-gpu
   --distributed 127.0.0.1:PORT,2,I as two processes sharing the card
   (this script with --rank; each in its own working directory, each
   waited for at most DIST_TIMEOUT_S, a hang failing the phase), each
   printing its set-up, align and merge seconds and its K1 and K2
   launches (the plain DPs must be 0): (b) phase 11 (c)'s flags over
   phase 10's FASTQ (each rank its byte-range shard): process 0's
   species, strain and classification files byte-identical to phase 11
   (c)'s, process 1 writes none, K1 once per dispatch of the two shards;
   (c) phase 11 (d)'s flags over phase 10's two pair files (the stream
   chunks round-robin): species and strain files byte-identical to phase
   11 (d)'s, the classification rows equal as sorted lists; (d) phase 11
   (e)'s flags over phase 7's reads: its ~410 Mbases make one read group,
   so process 1 owns none (the deadlock of the reference, F3, if its
   collectives differed) and launches nothing while process 0 launches
   phase 7's K1 and K2; files as in (c);
13. drive the benchmark runners of pantax_tpu_torch.benchmarks over the
   smoke DB as a user calls them (no device: the card), each printing its
   dict with the card's line and its K1 and K2 launches (K1 launched,
   K2 on the long runners only, the plain DPs never): (a)
   run_alignment_benchmark, 1M reads at batch 65536, phase 5's aligned
   and species bars; (b) run_e2e_benchmark, the same, 30 strains; (c)
   run_long_e2e_benchmark cut to phase 7's 50,000 reads (the same reads),
   phase 7's bars over its classification table; (d) run_mixed_benchmark
   cut to 990,000 short + 10,000 long reads, both aligned fractions at
   phases 5 and 7's bars, 30 strains; (e) accuracy_benchmark at its
   defaults (262,144 reads, 1:3:9): every strain of weight 3 and 9 found
   (the weight-1 strains, at ~0.30x, may fall below the unique-trio
   filter) and none the truth lacks; then (e') at N_ACC_FULL reads (the
   coverage at which tests/test_pipeline_e2e.py holds the reference to
   L1_BAR): 30 of 30 strains, L1 <= L1_BAR; (f)
   long_read_accuracy_benchmark at its defaults (16,384 x 8192 bp, 1:3:9):
   30 of 30, L1 <= L1_BAR; (g) simulate_reads (100,000 x 150 bp, 1:3:9,
   1% substitutions, seed 21), Aligner.align_reads on the card,
   profile_from_gaf over the aligned and over the truth GAF records: the
   species of >= 99% of the reads as simulated, 10 species and every
   weight-9 strain (~1x) in both flows, no strain outside the DB;
14. run the benchmark driver as users run it, python -m
   pantax_tpu_torch.bench as a subprocess over the smoke DB's cache (each
   run waited for at most BENCH_TIMEOUT_S, a hang failing the phase):
   --config scale (1M reads through both short runners) and --config long
   (100,000 x 8192 bp reads, where phase 7 and 13 (c) take 50,000); each
   exits 0, its last stdout line is one JSON object with bench.py's keys
   and the _per_gpu metric, K1 launched, K2 on long only, the plain DPs
   never (its stderr launch line); scale at aligned and species >= 0.999
   and 30 strains, long at >= 95% emitted and 30 strains.

The line before last is a JSON record of the kernels, each with its time,
its plain version's, and the bound the card's peaks put on the same work
(this run's inputs: K1 and K2, read bytes and window bytes over the HBM
rate against 5 instructions per DP cell over the SMs' instruction issue
rate; K3, code bytes and the seed rows its valid seeds gather against
HASH_OPS_PER_POS instructions per k-mer position inside each read's
read_len and VOTE_OPS_PER_PAIR per pair of valid hits on each strand; K6
and K11, the per-read columns, a 32-byte sector per gather and 64 bytes
per atomic that this run's live rows need, over the HBM rate; K8,
ADMM_OPS_ROW + 2 p instructions a row a step over every row of the
bucket against its inputs and outputs once; K9, its inputs' bytes once
over the HBM rate; K10b, POLISH_OPS_ROW instructions a row of a column of
a sweep against A's bytes once); the
last line is {"ok": true, "device": {...}}.  Databases and the kernel
builds (one nvcc per source, started together) go under build/
(git-ignored).
"""
from __future__ import annotations

import dataclasses
import json
import logging
import os
import re
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from functools import partial
from types import SimpleNamespace

import numpy as np
import torch

from pantax_tpu_torch import _host, benchmarks, cli
from pantax_tpu_torch.bench import card_line
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
from pantax_tpu_torch.align.aligner import Aligner, build_seed_lookup
from pantax_tpu_torch.align.aligner import unpack_reads
from pantax_tpu_torch.ops import (
    admm, extend, profile_tail, scatter, seed, tail_kernels,
)
from pantax_tpu_torch.ops.coverage_device import node_abundances_device
from pantax_tpu_torch.ops.fused import (
    FusedPipeline, _ensure_tail_tables, _tail_mode, build_fused_tables,
    build_pos_lookup, profile_from_fused_result, profile_fused,
)
from pantax_tpu_torch.parallel import make_mesh
from pantax_tpu_torch.pipeline import classify_gaf, profile_from_gaf
from pantax_tpu_torch.profile import pao
from pantax_tpu_torch.profile.coverage import pack_reads
from pantax_tpu_torch.profile.records import ReadRecord
from pantax_tpu_torch.sim import simulate_reads

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
# K3 replaces no pl.pallas_call: the seed stage XLA fuses into the JAX
# package's jitted query (_kmer_hashes_j :226 to the union :537-549)
KERNEL3 = {
    "name": "seed_stage",
    "route": "cuda",
    "source": "pantax_tpu_torch/csrc/seed_stage.cu",
    "replaces": "pantax_tpu/align/aligner.py:226",
}
# K6 and K11 replace no pl.pallas_call either: the classify + scatter XLA
# compiles inside the JAX package's jitted fused steps
KERNEL6 = {
    "name": "classify_scatter_ranges",
    "route": "cuda",
    "source": "pantax_tpu_torch/csrc/classify_scatter.cu",
    "replaces": "pantax_tpu/ops/fused.py:236",
}
KERNEL11 = {
    "name": "classify_scatter",
    "route": "cuda",
    "source": "pantax_tpu_torch/csrc/classify_scatter.cu",
    "replaces": "pantax_tpu/ops/fused.py:170",
}
# K8 replaces no pl.pallas_call: XLA compiles the ADMM chunk, a jitted vmap
# of a lax.scan, into one device program a chunk
KERNEL8 = {
    "name": "admm_chunk",
    "route": "cuda",
    "source": "pantax_tpu_torch/csrc/admm_chunk.cu",
    "replaces": "pantax_tpu/profile/pao.py:133",
}
# K9 and K10b replace no pl.pallas_call: the device tail's stats and polish
# are jitted programs XLA compiles
KERNEL9 = {
    "name": "tail_stats",
    "route": "cuda",
    "source": "pantax_tpu_torch/csrc/profile_tail.cu",
    "replaces": "pantax_tpu/ops/profile_tail.py:167",
}
KERNEL10B = {
    "name": "polish",
    "route": "cuda",
    "source": "pantax_tpu_torch/csrc/profile_tail.cu",
    "replaces": "pantax_tpu/ops/profile_tail.py:391",
}
# K3's crafted cases (seed_cases), in order
SEED_CASES = ("one_diagonal", "strand_tie", "all_killed", "nq8", "int32_wrap",
              "short_rows", "wide")
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
# K3's instructions at their fewest: per k-mer position inside read_len,
# the two rolled hashes (5), their min (1), mix32 (8) and the sample test
# (2); per pair of valid hits on a strand, a difference, the borrow of the
# range test and half a carry-add (sm_90's IADD3.X adds two pairs' borrows)
HASH_OPS_PER_POS = 16
VOTE_OPS_PER_PAIR = 2.5
# opcodes whose counts in the kernels' SASS say how the DP was compiled
CLASS_SPECIES = ("reads_classification.tsv", "species_abundance.txt")
STRAINS = ("strain_abundance.txt", "ori_strain_abundance.txt")
BASES = np.frombuffer(b"ACGTN", np.uint8)
SASS_OPS = ("VIADDMNMX", "VIMNMX", "IMNMX", "IADD3", "IMAD", "ISETP", "SEL",
            "LOP3")
# K8's instructions a row a step besides its 2 p multiply-adds (A^T v and
# Ax): b + z - uz (2), Ax_r (3), z_new (2), the soft threshold (4), uz (3)
ADMM_OPS_ROW = 14
# K8 against its plain version after one step, on every state vector and
# the residual: the sums run in another order (float32 rounding of sums
# over the bucket's rows), the same bar as the CPU test's against the JAX
# chunk (tests/test_torch_admm.py)
K8_STEP_BAR = 5e-5
# ... and after 25 steps, which reach what one step does not (the CTA
# sums' buffer parity, w and uw carried between steps, the
# over-relaxation of a non-zero w): the rounding differences are carried
# and amplified by the iteration, the CPU test's 25-step bar
K8_BARS = {1: K8_STEP_BAR, 25: 1e-3}
# device (float32) against host (float64) coverage in the per-species flow:
# every numeric column of the strain tables within this relative
# difference.  On an H100 the largest was 1.84e-6, in total_cov_diff, a
# difference of two near-equal coverage sums (its relative error is the
# sums' times their ratio to it); the other columns stayed below 7.3e-7
STRAIN_RTOL = 1e-5
# phase 12: the longest one rank of a --distributed run may take
DIST_TIMEOUT_S = 300


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
    """ptxas's register report of each kernel (and instantiation) in an
    nvcc log, as "kernel<template arguments>: report", its stack frame and
    spills after it where ptxas reports them."""
    lines, entry, frame = [], "", ""
    for ln in log.splitlines():
        # the name after its mangled length (an anonymous namespace's
        # mangled name holds the file's name before it)
        m = re.search(r"(?<=\d)((?:banded_extend|seed_stage|classify_scatter"
                      r"|admm_chunk|tail_stats|polish)(?:_[a-z]+)*_kernel)"
                      r"(?:I((?:L[ib]\d+E)+)E)?",
                      ln)
        if m:
            args = ",".join(re.findall(r"\d+", m[2] or ""))
            entry = f"{m[1]}<{args}>" if args else m[1]
        elif "stack frame" in ln:
            frame = ln.strip()
        elif "registers" in ln:
            lines.append(f"{entry}: {ln.split(':', 1)[1].strip()}"
                         + (f"; {frame}" if frame else ""))
            frame = ""
    return lines


def innermost_loops(lib_path: str, kernel: str,
                    wb: int) -> list[list[str]] | str:
    """The innermost loops of ``kernel``<wb> in a built library (cuobjdump
    beside nvcc), each as the list of its SASS instructions (guards
    stripped), or why there are none."""
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
    inner = [lp for lp in loops
             if not any(lp[1] <= o[1] and o[2] < lp[2] for o in loops)]
    return [[re.sub(r"^@!?U?P\w+\s+", "", op).split()[0]
             for a, op in zip(addrs, ops) if lo <= a <= hi]
            for _, lo, hi in sorted(inner, reverse=True)]


def step_sass(lib_path: str, wb: int,
              kernel: str = "banded_extend_kernel") -> dict | str:
    """A DP kernel's main step loop in a built library (cuobjdump beside
    nvcc): the body of the widest innermost loop of ``kernel``<wb> (K1's
    banded_extend_kernel or K2's banded_extend_windows_kernel), its SASS
    instructions, the DP steps it holds (the maxes its max instructions
    take, fused with an add or not, over the 2 * (wb - 1) of one step) and
    instructions per step; or why there is none."""
    loops = innermost_loops(lib_path, kernel, wb)
    if isinstance(loops, str):
        return loops
    if not loops:
        return "no loop found"
    names = loops[0]  # the widest of the innermost loops
    dpx = sum(n.startswith("VIADDMNMX") for n in names)
    # a three-input max (VIMNMX3) takes two of the DP's maxes
    maxes = dpx + sum((2 if n.split(".")[0].endswith("3") else 1)
                      for n in names if n.startswith(("VIMNMX", "IMNMX")))
    steps = max(1, round(maxes / (2 * (wb - 1))))
    return {"instructions": len(names), "steps": steps,
            "per_step": round(len(names) / steps, 2), "viaddmnmx": dpx,
            "max_ops": maxes}


def vote_sass(lib_path: str, nq: int = 2) -> list | str:
    """K3's vote loops in a built library: the innermost loops of
    seed_stage_kernel<nq> that broadcast the compacted hits by 16-byte
    shared loads (one a pair of hits; a loop for each held word count and
    band test), each with its SASS instructions, the hits it takes an
    iteration, instructions per hit (both strands), its band test
    ("carry": the borrow-and-carry adds, IADD3.X; else "wrap", the -2^31
    test) and its op counts; or why there are none."""
    loops = innermost_loops(lib_path, "seed_stage_kernel", nq)
    if isinstance(loops, str):
        return loops
    out = []
    for names in loops:
        wide = sum(n == "LDS.128" for n in names)
        if wide:
            carries = sum(n.startswith("IADD3.X") for n in names)
            ops = {op: sum(n.split(".")[0] == op for n in names)
                   for op in ("IMAD", "IADD3", "ISETP")}
            out.append({"test": "carry" if carries else "wrap",
                        "instructions": len(names), "hits": 2 * wide,
                        "per_hit": round(len(names) / (2 * wide), 2),
                        **ops, "IADD3.X": carries})
    return out or "no vote loop found"


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


def hold_k3(args, what: str) -> int:
    """K3 against its plain version on the same tensors, bit for bit on
    its three outputs; returns the largest absolute difference (0)."""
    ker = seed.seed_candidates_cuda(*args)
    plain = seed.seed_candidates_plain(*args)
    torch.cuda.synchronize()
    err = max(int((k.long() - p.long()).abs().max()) for k, p in zip(ker, plain))
    for k, p, name in zip(ker, plain, ("cand_diag", "cand_votes", "strand")):
        if k.dtype != p.dtype or not torch.equal(k, p):
            raise AssertionError(f"K3 != plain on {name} {what}")
    seeded = float((plain[1][:, 0] > 0).float().mean())
    print(f"K3 == plain {what} (3 outputs bit-identical; {seeded:.4f} of "
          f"the rows voted)")
    return err


def seed_args(aligner, codes: np.ndarray, lens: np.ndarray) -> tuple:
    """K3's arguments for a host batch, as the query makes them: the codes
    uploaded and unpacked, the aligner's seed tables and static config."""
    c, n = aligner.upload(codes, lens)
    return (unpack_reads(c, n), n, aligner.run_table, aligner.seed_pos,
            aligner.bucket_lo, aligner.static())


def chd_table(runs: dict, hits: int) -> tuple:
    """A CHD seed table over ``runs`` ({uint32 key: (run length, [text
    positions])}), laid out as align/aligner.build_seed_lookup lays it out:
    (run_table int32 [D, 2 + hits] of rows [key, run length, the first
    ``hits`` positions], bucket bits, displacements int32 [2^bits]).  The
    buckets, fullest first, each take the first displacement that puts
    their keys on free slots."""
    keys = np.array(sorted(runs), dtype=np.uint32)
    bits = max(1, int(np.ceil(np.log2(max(len(keys), 2)))))
    D = 16
    while D < 2 * len(keys):
        D *= 2
    table = np.zeros((D, 2 + hits), np.int32)
    disp = np.zeros(1 << bits, np.int32)
    taken = np.zeros(D, bool)
    bucket = keys >> np.uint32(32 - bits)
    for b in np.argsort(-np.bincount(bucket, minlength=1 << bits),
                        kind="stable"):
        kb = keys[bucket == b]
        if not len(kb):
            break
        kt = torch.from_numpy(kb.astype(np.int64))
        for d in range(1 << 20):  # the plain lookup's slot of each key
            slot = (seed._mix32(kt ^ seed._mul32(torch.tensor(d),
                                                 seed._CHD_GOLD))
                    & (D - 1)).numpy()
            if len(np.unique(slot)) == len(slot) and not taken[slot].any():
                break
        else:
            raise RuntimeError("no displacement places the keys")
        disp[b] = d
        taken[slot] = True
        for key, s in zip(kb, slot):
            rlen, pos = runs[int(key)]
            pos = (np.asarray(pos, np.int64)[:hits] + 2**31) % 2**32 - 2**31
            table[s, 0] = np.uint32(key).view(np.int32)
            table[s, 1] = rlen
            table[s, 2:2 + len(pos)] = pos
    return table, bits, disp


def _selected_seeds(codes: np.ndarray, k: int, density_bits: int,
                    s_max: int) -> tuple:
    """Each row's selected seeds as the plain stage picks them: (sel_pos,
    sel_hash uint32, sel_valid), [B, s_max] numpy."""
    h, v = seed.kmer_hashes(torch.from_numpy(codes), k)
    p, sh, sv = seed.select_seeds(h, v, density_bits, s_max)
    return p.numpy(), sh.numpy().astype(np.uint32), sv.numpy()


def seed_cases(seed_: int = 0) -> dict:
    """K3's crafted cases: hand-built CHD seed tables over random codes, each
    at an edge of the seed stage's semantics.  {name: (codes int8 [B, L],
    read_len int32 [B], run_table, seed_pos, bucket_lo, cfg_static)}, numpy
    arrays; cfg_static is (k, density bits, bucket bits, steps, s_max, hits,
    top_k, pad) as Aligner.static() gives it.
    - one_diagonal: every hit of a row on one diagonal, so every count ties;
    - strand_tie: a row's only hits are one or two singletons, so its
      forward and reverse candidates have equal votes (the forward wins);
    - all_killed: one seed of a row found, its 4 hits within the band of
      each other on both strands, so round 2 finds every count 0 and, at
      top_k 3, the union takes it: slot 0's diagonal with 0 votes where
      the seed is seed 0 (even rows), BIG where slot 0 is invalid;
    - nq8: s_max 64 x 4 hits = 256 slots, top_k 8, density bits 0, the
      hits in clusters of diagonals;
    - int32_wrap: diagonals 2^30 - 7, its +2^31 (an int32 difference of
      exactly -2^31: within the band under torch's abs) and its +2^31 - 1
      (2^31 - 1: not);
    - short_rows: read_len 0, 1, 20 (< k) and 150 all N among full rows;
    - wide: one row at the wrapper's widest width, 8192.
    """
    rng = np.random.default_rng(seed_)
    k, pad = 21, 4

    def codes_of(B, L, lens):
        c = rng.integers(0, 4, size=(B, L)).astype(np.int8)
        c[np.arange(L)[None, :] >= np.asarray(lens)[:, None]] = 4
        return c

    def case(codes, lens, runs, s_max=16, hits=4, top_k=2, density=3):
        table, bits, disp = chd_table(runs, hits)
        cfg = (k, density, bits, -1, s_max, hits, top_k, pad)
        return (np.ascontiguousarray(codes), np.asarray(lens, np.int32),
                table, np.zeros(1, np.int32), disp, cfg)

    cases = {}
    B, L = 64, 160
    lens = np.full(B, 150)
    codes = codes_of(B, L, lens)
    sp, sh, sv = _selected_seeds(codes, k, 3, 16)
    runs = {}
    for r in range(B):
        d0 = 1000 * (r + 1)
        for p, h in zip(sp[r][sv[r]], sh[r][sv[r]]):
            runs[int(h)] = (int(rng.integers(1, 6)), [p + d0] * 4)
    cases["one_diagonal"] = case(codes, lens, runs)

    codes = codes_of(B, L, lens)
    sp, sh, sv = _selected_seeds(codes, k, 3, 16)
    runs = {}
    for r in range(B):
        n_hit = 1 + r % 2
        j = int(rng.integers(0, max(1, sv[r].sum())))
        if sv[r, j]:
            runs[int(sh[r, j])] = (n_hit, [sp[r, j] + 5000 * r,
                                           sp[r, j] + 5000 * r + 999])
    cases["strand_tie"] = case(codes, lens, runs)

    codes = codes_of(B, L, lens)
    sp, sh, sv = _selected_seeds(codes, k, 3, 16)
    runs = {}
    for r in range(B):
        n_seed = int(sv[r].sum())
        if n_seed > 1:
            j = 0 if r % 2 == 0 else 1 + r % (n_seed - 1)
            jit = rng.integers(-pad // 2, pad // 2 + 1, size=4)
            runs[int(sh[r, j])] = (4, list(sp[r, j] + 777 * r + jit))
    cases["all_killed"] = case(codes, lens, runs, top_k=3)

    codes = codes_of(B, L, lens)
    sp, sh, sv = _selected_seeds(codes, k, 0, 64)
    runs = {}
    for r in range(B):
        for p, h in zip(sp[r][sv[r]], sh[r][sv[r]]):
            if rng.random() < 0.1:
                continue  # absent
            g = rng.integers(0, 12, size=4)
            runs[int(h)] = (int(rng.integers(1, 6)),
                            list(p + 3000 * g + rng.integers(-6, 7, size=4)))
    cases["nq8"] = case(codes, lens, runs, s_max=64, top_k=8, density=0)

    codes = codes_of(B, L, lens)
    sp, sh, sv = _selected_seeds(codes, k, 3, 16)
    a = 2**30 - 7
    diags = (a, a + 2**31, a + 2**31 - 1)
    runs = {}
    for r in range(B):
        for j in np.flatnonzero(sv[r]):
            d = diags[(j + r) % 3]
            runs[int(sh[r, j])] = (int(rng.integers(1, 5)),
                                   [int(sp[r, j]) + d + int(e)
                                    for e in rng.integers(0, 3, size=4)])
    cases["int32_wrap"] = case(codes, lens, runs)

    lens = np.full(B, 150)
    lens[:4] = (0, 1, 20, 150)
    codes = codes_of(B, L, lens)
    codes[3] = 4  # all N
    sp, sh, sv = _selected_seeds(codes, k, 3, 16)
    runs = {}
    for r in range(B):
        for p, h in zip(sp[r][sv[r]], sh[r][sv[r]]):
            runs[int(h)] = (2, [p + 100 * r, p + 100 * r + 50])
    cases["short_rows"] = case(codes, lens, runs)

    W = seed.MAX_WIDTH
    lens = np.array([W])
    codes = codes_of(1, W, lens)
    sp, sh, sv = _selected_seeds(codes, k, 3, 16)
    runs = {int(h): (3, [p + 40_000, p + 90_000 + 2 * p, p + 40_002])
            for p, h in zip(sp[0][sv[0]], sh[0][sv[0]])}
    cases["wide"] = case(codes, lens, runs)
    assert tuple(cases) == SEED_CASES
    return cases


def seed_lookup(args) -> tuple:
    """The plain seed stage's selection and lookup on K3's ``args``:
    (sel_valid [B, s_max], hit validity [B, s_max * hits])."""
    codes, read_len, run_table, seed_pos, bucket_lo, static = args
    k, density_bits, bucket_bits, steps, s_max, hits = static[:6]
    hashes, valid = seed.kmer_hashes(codes, k)
    _, sel_hash, sel_valid = seed.select_seeds(hashes, valid, density_bits,
                                               s_max)
    del hashes, valid
    _, hv = seed.lookup_hits(run_table, seed_pos, bucket_lo, bucket_bits,
                             steps, sel_hash, sel_valid, hits)
    return sel_valid, hv.reshape(codes.shape[0], -1)


def valid_hits(args):
    """Each read's valid seed hits (int64 [B]) on K3's ``args``."""
    return seed_lookup(args)[1].sum(dim=1)


def seed_bound(args, issue_peak: float) -> tuple[float, str]:
    """(bound ms, what bounds it) of the seed stage on ``args``: the
    k-mer positions inside each read's read_len (past it every k-mer holds
    an N) at HASH_OPS_PER_POS and, on each strand, the pairs of
    each read's valid hits at VOTE_OPS_PER_PAIR, over ``issue_peak``;
    against the code bytes, read_len, what each valid seed gathers (CHD:
    its displacement and slot row; bisection: its bucket bounds, key probes,
    run row and positions) and the outputs, over the HBM rate."""
    codes, read_len, run_table, seed_pos, bucket_lo, static = args
    k, density_bits, bucket_bits, steps, s_max, hits, top_k = static[:7]
    B, L = codes.shape
    sel_valid, hv = seed_lookup(args)
    v = hv.sum(dim=1).double()
    positions = (read_len.clamp(0, L) - k + 1).clamp(min=0)
    ops = (float(positions.double().sum()) * HASH_OPS_PER_POS
           + 2 * float((v * v).sum()) * VOTE_OPS_PER_PAIR)
    row = 4 * run_table.shape[1]
    per_seed = 4 + row if steps < 0 else 8 + 4 * steps + row + 4 * hits
    nbytes = (B * L + 4 * B + float(sel_valid.sum()) * per_seed
              + B * top_k * 9)
    t_ops, t_bytes = ops / issue_peak, nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def seed_phase(db, index, aligner, codes, lens, dev, issue_peak: float):
    """Phase 3b.  Returns (largest difference, K3 ms and plain ms at the
    main path's shape, its bound and what bounds it, K3's times by case)."""
    from pantax_tpu_torch.align import aligner as aligner_mod

    card = card_line()
    errs, times = [], {}
    main = seed_args(aligner, codes[:BATCH], lens[:BATCH])
    what = f"(CHD, density {index.density_bits})"
    errs.append(hold_k3(main, f"at B={BATCH} L=160 {what}"))
    w152 = seed_args(aligner, np.ascontiguousarray(codes[:BATCH, :150]),
                     np.minimum(lens[:BATCH], 150))
    errs.append(hold_k3(w152, f"at B={BATCH} L=152 {what}"))
    (c1, l1, c2, l2), _ = simulate_pairs(index, BATCH, seed=17)
    paired = seed_args(aligner, np.concatenate([c1, c2]),
                       np.concatenate([l1, l2]))
    errs.append(hold_k3(paired, f"at B={2 * BATCH} L=160 (the paired rows)"))
    chunk = LONG_READ_PRESETS[READ_TYPE]
    long_al = aligner_from_reference(
        index, _host.AlignConfig.for_read_type("long"), dev)
    lc, ll, _ = simulate_read_batch(index, LONG_BATCH, chunk, 0.01, seed=19)
    long_args = seed_args(long_al, lc, ll)
    errs.append(hold_k3(long_args, f"at B={LONG_BATCH} L={chunk} pad 8 "
                                   f"(long-read chunks)"))
    saved = aligner_mod._build_chd
    aligner_mod._build_chd = lambda keys: None
    try:
        lookup = build_seed_lookup(index.seed_keys, index.seed_pos, 4)
    finally:
        aligner_mod._build_chd = saved
    bis_al = Aligner(index, lookup, _host.AlignConfig(), device=dev)
    errs.append(hold_k3(seed_args(bis_al, codes[:BATCH], lens[:BATCH]),
                        f"at B={BATCH} L=160 on a forced bisection table "
                        f"({bis_al.lookup_steps} steps)"))
    del bis_al
    t0 = time.time()
    index4 = _host.build_align_index(db, density_bits=4, save=False)
    al4 = aligner_from_reference(index4, _host.AlignConfig(), dev)
    print(f"density-4 index of the smoke DB and its aligner: "
          f"{time.time() - t0:.2f} s, {len(index4.seed_keys)} seeds against "
          f"{len(index.seed_keys)} at density {index.density_bits}")
    errs.append(hold_k3(seed_args(al4, codes[:BATCH], lens[:BATCH]),
                        f"at B={BATCH} L=160 on a density-4 index (CHD)"))
    del al4, index4
    for name, case in seed_cases().items():
        args = tuple(torch.from_numpy(a).to(dev) for a in case[:5]) + case[5:]
        errs.append(hold_k3(args, f"on the crafted case {name} (B="
                                  f"{len(case[0])} L={case[0].shape[1]}, "
                                  f"s_max x hits {case[5][4]} x {case[5][5]}, "
                                  f"top_k {case[5][6]})"))

    for name, args in (("main", main), ("w152", w152), ("paired", paired),
                       ("long", long_args)):
        times[name] = cuda_ms(lambda: seed.seed_candidates_cuda(*args), 50,
                              hold=True)
    ms, plain_ms = times["main"], cuda_ms(
        lambda: seed.seed_candidates_plain(*main), 3)
    plain152 = cuda_ms(lambda: seed.seed_candidates_plain(*w152), 3)
    bound, by = seed_bound(main, issue_peak)
    bound152, _ = seed_bound(w152, issue_peak)
    print(f"K3 [{card}]: {ms:.4f} ms, plain torch {plain_ms:.3f} ms, bound "
          f"{bound:.4f} ms ({by}) at B={BATCH} L=160; {times['w152']:.4f} ms,"
          f" plain {plain152:.3f} ms, bound {bound152:.4f} ms at L=152; "
          f"{times['paired']:.4f} ms at B={2 * BATCH} L=160; "
          f"{times['long']:.4f} ms at B={LONG_BATCH} L={chunk} pad 8")
    times.update(plain_w152=plain152, bound_w152=bound152)
    return max(errs), ms, plain_ms, bound, by, times


def check_k3(launches: dict, what: str) -> None:
    """K3 launched once per query dispatch, where K1 is (every K1 launch
    is one query's), and the plain seed stage never; K6 and K11 once per
    range and windowed scatter dispatch, the plain scatters never
    (check_k6, check_k11); K8 once per ADMM chunk dispatch, the plain
    chunk never (check_k8); and K9 and K10b once per device-tail stats and
    polish dispatch, their plain versions never (check_k9_k10b)."""
    if (launches["seed_stage"] != launches["banded_extend"]
            or launches["seed_stage_plain"]):
        raise AssertionError(
            f"{what}: K3 launches {launches['seed_stage']} against K1's "
            f"{launches['banded_extend']}, plain seed stage "
            f"{launches['seed_stage_plain']}")
    check_k6(launches, what)
    check_k11(launches, what)
    check_k8(launches, what)
    check_k9_k10b(launches, what)


# ---------------------------------------------------------------------------
# phase 3c: K6 and K11, the fused step's classify + scatter
# ---------------------------------------------------------------------------
# the crafted cases of scatter_cases, in order, and those added for K6's
# ends, its bucket scan and its pairs of lanes
SCATTER_CASES = ("span_1", "span_2", "span_3_up", "cap", "cap_plus_one",
                 "empty", "unaligned", "text_end", "hap_edges")
K6_CASES = ("seg_start", "ends_at_start", "span_3", "hap_last",
            "full_bucket", "odd_b")
# what K6 and K11 read of FusedTables
SCATTER_FIELDS = ("hap_offsets", "hap_range", "pos_lo", "nodes_len",
                  "base_offset", "trio_seg", "win_shift", "pos_steps",
                  "N_pad", "TB_pad", "U_pad", "has_dups", "seg_rec")
# each path's K6 and K11 launches, by path name (check_k6 / check_k11)
SCATTER_BY_PATH = {"classify_scatter_ranges": {}, "classify_scatter": {}}


def _intervals(rng, index, first, k):
    """Intervals whose first base lies in segment ``first`` and whose last
    lies in segment first + k - 1 (the text's last at most), at random
    offsets in both: (ts, te) int64."""
    tstart = np.asarray(index.tstart, np.int64)
    end = np.append(tstart[1:], index.text_len)
    last = np.minimum(first + k - 1, len(tstart) - 1)

    def pos(seg):
        return tstart[seg] + (rng.random(len(seg))
                              * (end[seg] - tstart[seg])).astype(np.int64)

    ts = pos(first)
    return ts, np.maximum(pos(last) + 1, ts + 1)


def scatter_cases(index, L_cap: int, seed_: int = 0, n: int = 256) -> dict:
    """K6's and K11's crafted cases over ``index``'s text: name -> (ts
    int32 [n], te int32 [n], aligned bool [n]), a tenth of each case's rows
    unaligned.  span_1, span_2: the read's first and last base in one and
    in two consecutive segments; span_3_up: 3 to L_cap + 4 segments; cap,
    cap_plus_one: exactly L_cap and L_cap + 1 segments (K11's last row in
    the window and its first overflow); empty: te == ts and te < ts;
    unaligned: every row; text_end: reads in the text's last L_cap + 2
    segments (K11's window runs past M) and reads ending at text_len;
    hap_edges: reads across a haplotype boundary (the trio windows there
    match nothing).  Then K6_CASES: seg_start, reads from a segment's first
    base (rs 0); ends_at_start, reads whose end is a segment's start (the
    last segment whole); span_3, exactly three segments; hap_last, reads
    in a haplotype's last segment (its separator included) and in the
    text's last; full_bucket, reads whose ends lie in the fullest buckets
    of pos_lo (build_pos_lookup's: at most 2^pos_steps - 1 segments);
    odd_b, 255 rows (B odd) of 1 to L_cap + 2 segments."""
    rng = np.random.default_rng(seed_)
    tstart = np.asarray(index.tstart, np.int64)
    M, T = len(tstart), int(index.text_len)

    def spanning(k):
        k = np.broadcast_to(k, (n,))
        return _intervals(rng, index, rng.integers(0, np.maximum(
            M - k + 1, 1)), k)

    cases = {"span_1": spanning(1), "span_2": spanning(2),
             "span_3_up": spanning(rng.integers(3, L_cap + 5, size=n)),
             "cap": spanning(L_cap), "cap_plus_one": spanning(L_cap + 1)}
    ts = _intervals(rng, index, rng.integers(0, M, size=n), 1)[0]
    cases["empty"] = (ts, np.where(np.arange(n) % 2 == 0, ts, np.maximum(
        ts - rng.integers(1, 50, size=n), 0)))
    cases["unaligned"] = spanning(rng.integers(1, L_cap + 3, size=n))
    ts, te = _intervals(rng, index, rng.integers(max(M - L_cap - 2, 0), M,
                                                 size=n),
                        rng.integers(1, L_cap + 3, size=n))
    cases["text_end"] = (ts, np.where(np.arange(n) % 4 == 0, T, te))
    hap = rng.integers(1, max(len(index.hap_offsets) - 1, 2), size=n)
    edge = np.searchsorted(tstart, index.hap_offsets[hap], side="right") - 1
    first = np.clip(edge - rng.integers(0, 4, size=n), 0, M - 1)
    last = np.clip(edge + rng.integers(0, 4, size=n), first, M - 1)
    cases["hap_edges"] = _intervals(rng, index, first, last - first + 1)
    out = {}
    for name in SCATTER_CASES:
        ts, te = (np.clip(a, 0, T).astype(np.int32) for a in cases[name])
        aligned = rng.random(n) >= 0.1 if name != "unaligned" else np.zeros(
            n, bool)
        out[name] = (ts, te, aligned)
    for name, (ts, te) in k6_cases_crafted(rng, index, L_cap, n).items():
        ts, te = (np.clip(a, 0, T).astype(np.int32) for a in (ts, te))
        out[name] = (ts, te, rng.random(len(ts)) >= 0.1)
    return out


def k6_cases_crafted(rng, index, L_cap: int, n: int) -> dict:
    """K6_CASES' intervals over ``index``'s text: name -> (ts, te) int64."""
    tstart = np.asarray(index.tstart, np.int64)
    M, T = len(tstart), int(index.text_len)
    first = rng.integers(0, M, size=n)
    k = rng.integers(1, 5, size=n)
    out = {"seg_start": (tstart[first], _intervals(rng, index, first, k)[1])}
    nxt = rng.integers(1, M, size=n)
    out["ends_at_start"] = (_intervals(rng, index, np.maximum(
        nxt - rng.integers(1, 4, size=n), 0), 1)[0], tstart[nxt])
    out["span_3"] = _intervals(rng, index, rng.integers(0, max(M - 2, 1),
                                                        size=n), 3)
    hap_end = np.asarray(index.hap_offsets, np.int64)[1:]
    last = np.searchsorted(tstart, hap_end - 1, side="right") - 1
    seg = np.where(np.arange(n) % 4 == 0, M - 1,
                   last[rng.integers(0, len(last), size=n)])
    ts = _intervals(rng, index, seg, 1)[0]
    stop = np.where(seg == M - 1, T, np.append(tstart, T)[
        np.searchsorted(tstart, ts, side="right")])
    te = ts + 1 + (rng.random(n) * (stop - ts)).astype(np.int64)
    out["hap_last"] = (ts, np.minimum(te, stop))
    pos_lo, shift, _ = build_pos_lookup(tstart, T)
    occ = np.diff(pos_lo)
    full = np.flatnonzero(occ == occ.max())
    b0 = full[rng.integers(0, len(full), size=n)]
    b1 = full[np.minimum(np.searchsorted(full, b0) + rng.integers(
        0, 2, size=n), len(full) - 1)]

    def inside(b):
        return (b << shift) + (rng.random(n) * (1 << shift)).astype(np.int64)

    ts, te1 = inside(b0), inside(b1)
    out["full_bucket"] = (ts, np.maximum(te1, ts) + 1)
    ks = rng.integers(1, L_cap + 3, size=n - 1)
    out["odd_b"] = _intervals(rng, index, rng.integers(
        0, np.maximum(M - ks + 1, 1)), ks)
    return out


def masked_tables(tables, seed_: int = 0):
    """The scatter's fields of ``tables`` (SCATTER_FIELDS) with the first
    haplotype's species range taken away (its reads classify to -1) and a
    quarter of the segments' trio matches set to -1."""
    masked = SimpleNamespace(**{k: getattr(tables, k) for k in SCATTER_FIELDS})
    masked.hap_range = tables.hap_range.clone()
    masked.hap_range[0] = -1
    rng = np.random.default_rng(seed_)
    drop = torch.from_numpy(rng.random(tables.trio_seg.shape[0]) < 0.25)
    masked.trio_seg = torch.where(drop.to(tables.trio_seg.device), -1,
                                  tables.trio_seg)
    return _with_records(masked, tables)


def _with_records(variant, tables):
    """``variant`` with K6's records rebuilt from its own fields (tables
    without records keep none)."""
    if tables.seg_rec is not None:
        variant.seg_rec = scatter.scatter_records(
            variant, tables.seg_rec[:, 0], tables.seg_rec[:, 1])
    return variant


def shifted_tables(tables):
    """The scatter's fields of ``tables`` with every haplotype but the
    first starting one base later, inside its first segment: those
    segments' records carry scatter.SEARCH_HAP (K6 takes the haplotype
    search for their reads)."""
    shifted = SimpleNamespace(**{k: getattr(tables, k)
                                 for k in SCATTER_FIELDS})
    shifted.hap_offsets = tables.hap_offsets.clone()
    shifted.hap_offsets[1:-1] += 1
    return _with_records(shifted, tables)


def coarse_tables(tables, tstart, text_len: int):
    """The scatter's fields of ``tables`` with buckets 32 times as wide
    (pos_lo, win_shift and pos_steps rebuilt as build_pos_lookup does), so
    that K6 meets buckets both of up to 7 segments (its scan) and of more
    (the bisection)."""
    coarse = SimpleNamespace(**{k: getattr(tables, k)
                                for k in SCATTER_FIELDS})
    coarse.win_shift = int(tables.win_shift) + 5
    nb = max((tables.pos_lo.shape[0] - 1) >> 5, 1)
    bounds = np.arange(nb + 1, dtype=np.int64) << coarse.win_shift
    pos_lo = np.searchsorted(tstart.cpu().numpy().astype(np.int64), bounds,
                             side="right").astype(np.int32)
    if bounds[-1] < text_len:
        raise ValueError("the coarse buckets do not cover the text")
    occ = int(np.diff(pos_lo).max())
    coarse.pos_steps = int(np.ceil(np.log2(occ + 1))) if occ > 0 else 0
    coarse.pos_lo = torch.from_numpy(pos_lo).to(tables.pos_lo.device)
    return coarse


def table_variants(tables, tstart, text_len: int) -> dict:
    """The crafted cases' tables by tag: as built, masked_tables,
    shifted_tables and coarse_tables."""
    return {"": tables, ", masked": masked_tables(tables),
            ", shifted": shifted_tables(tables),
            ", coarse": coarse_tables(tables, tstart, text_len)}


def interval_batch(index, n: int, max_span: int, seed_: int):
    """``n`` intervals of 1..max_span segments at random over the text (an
    interval feed's batch): (ts int32, te int32, live bool) numpy."""
    rng = np.random.default_rng(seed_)
    k = rng.integers(1, max_span + 1, size=n)
    ts, te = _intervals(rng, index, rng.integers(0, np.maximum(
        len(index.tstart) - k + 1, 1)), k)
    return ts.astype(np.int32), te.astype(np.int32), np.ones(n, bool)


def zero_accs(tables, M: int, dev) -> tuple:
    """The fused pipeline's five accumulators, zero, each with its sink."""
    return (torch.zeros(tables.N_pad + 1, dtype=torch.int64, device=dev),
            torch.zeros(tables.TB_pad + 1, dtype=torch.int32, device=dev),
            torch.zeros(tables.U_pad + 1, dtype=torch.int64, device=dev),
            torch.zeros(M + 1, dtype=torch.int32, device=dev),
            torch.zeros(M + 1, dtype=torch.int32, device=dev))


def hold_scatter(cols, tables, tstart, tnode, what: str,
                 L_cap: int | None = None, lib=None) -> int:
    """K6 (``L_cap`` None) or K11 at ``L_cap`` (of ``lib``, default the
    current source's build; launches not counted) against its plain version
    on the same rows ``cols`` = (ts, te, aligned), each from zero
    accumulators: ridx (and overflow) and every accumulator bit for bit,
    the plain version's sink slots aside (the diff array's last slot, which
    its dropped pairs net to 0, included); the kernel's sinks stay 0.
    Returns the largest absolute difference (0)."""
    dev, M = tstart.device, tstart.shape[0]
    acc_k, acc_p = zero_accs(tables, M, dev), zero_accs(tables, M, dev)
    lib = lib if lib is not None else scatter.build_scatter_kernels()
    if L_cap is None:
        ker = (scatter.launch_k6(lib, *cols, tables, tstart, tnode, acc_k),)
        plain = (scatter.classify_scatter_ranges_plain(*cols, tables, tstart,
                                                       tnode, acc_p),)
        name, names = "K6", ("ridx",)
    else:
        ker = scatter.launch_k11(lib, *cols, tables, tstart, tnode, acc_k,
                                 L_cap)
        plain = scatter.classify_scatter_plain(*cols, tables, tstart, tnode,
                                               acc_p, L_cap)
        name, names = "K11", ("ridx", "overflow")
    torch.cuda.synchronize()
    sinks = (tables.N_pad, tables.TB_pad + 1, tables.U_pad, M, M)
    pairs = [(n, k, p) for n, k, p in zip(names, ker, plain)] + [
        (f"acc[{i}]", a[:n], b[:n])
        for i, (a, b, n) in enumerate(zip(acc_k, acc_p, sinks))]
    err = max(int((k.long() - p.long()).abs().max()) for _, k, p in pairs
              if k.numel())
    for n, k, p in pairs:
        if k.dtype != p.dtype or not torch.equal(k, p):
            raise AssertionError(f"{name} != plain on {n} {what}")
    if any(int(a[n:].abs().sum()) for a, n in zip(acc_k, sinks)):
        raise AssertionError(f"{name} added into a sink slot {what}")
    live = int((cols[2] & (ker[0] >= 0)).sum())
    print(f"{name} == plain {what} (ridx{', overflow' if L_cap else ''} and "
          f"the accumulators bit-identical; {live} of {len(cols[0])} rows "
          f"classified)")
    return err


def _sectors(parts) -> int:
    """The distinct 32-byte sectors of ``parts``, (table, element indices,
    element bytes) triples, the table a small integer."""
    keys = [tab * (1 << 40) + idx.long().reshape(-1) * size // 32
            for tab, idx, size in parts]
    return int(torch.unique(torch.cat(keys)).numel())


def scatter_work(cols, tables, tstart, tnode, L_cap: int | None = None):
    """(bytes, live rows, gathered sectors, atomic sectors) K6 (``L_cap``
    None) or K11 at ``L_cap`` must move on the rows ``cols``, each sector
    once in the launch: the per-read columns read once and ridx (and
    overflow) written; the haplotype tables once; each 32-byte sector of
    the bucket, segment, node and trio tables that the rows need (K6's live
    rows: both ends' buckets, the starts that bracket ts and te - 1, the
    end segments' nodes and the lengths and offsets of their nodes, the two
    end windows' trio matches; K11's aligned rows: the bucket and the starts
    i0 .. i0 + n_more + 1 within the window, and its live rows: the row's
    nodes, their lengths, the offsets of those with a diff interval and the
    windows' trio matches) read once; each sector of the accumulators that
    the plain version leaves non-zero (the sinks aside) read and written
    once.  Adds that cancel (a node's -1 and the next node's +1 at one diff
    word) or share a sector cost nothing more."""
    t = tables
    ts, te, aligned = cols
    dev, M = tstart.device, tstart.shape[0]
    locate = partial(scatter.locate_segment, tstart, t.pos_lo, t.win_shift,
                     t.pos_steps)  # K6's and K11's bisection

    def bucket(x):
        return (x >> int(t.win_shift)).clamp(0, t.pos_lo.shape[0] - 2)

    acc = zero_accs(t, M, dev)
    i0 = locate(ts)
    nbytes = (9 + 4 + (L_cap is not None)) * ts.shape[0] + 4 * (
        t.hap_offsets.shape[0] + t.hap_range.shape[0])
    if L_cap is None:
        ridx = scatter.classify_scatter_ranges_plain(*cols, t, tstart, tnode,
                                                     acc)
        live = aligned & (ridx >= 0) & (te > ts)
        i1 = locate(torch.maximum(te - 1, ts))
        i0, i1 = i0[live], i1[live]
        multi, trio3 = i1 > i0, i1 - i0 >= 2
        n0, n1 = tnode[i0] - 1, tnode[i1] - 1
        b0, b1 = bucket(ts[live]), bucket(torch.maximum(te - 1, ts)[live])
        gathers = _sectors([
            (0, torch.cat([b0, b0 + 1, b1, b1 + 1]), 4),
            (1, torch.cat([i0, i1, i0 + 1, i1 + 1]).clamp(max=M - 1), 4),
            (2, torch.cat([i0, i1[multi]]), 4),
            (3, torch.cat([n0, n1])[torch.cat([multi, multi])], 4),
            (4, torch.cat([n0, n1[multi]]), 4),
            (5, torch.cat([i0[trio3], (i1 - 2)[trio3]]), 4)])
        n_acc = 5
    else:
        ridx, overflow = scatter.classify_scatter_plain(
            *cols, t, tstart, tnode, acc, L_cap)
        cols1 = torch.arange(1, L_cap + 1, device=dev)[None, :]
        nxt = i0[:, None] + cols1
        starts = torch.where(nxt < M, tstart[nxt.clamp(max=M - 1)],
                             torch.iinfo(torch.int32).max)
        n_more = (starts <= torch.maximum(te - 1, ts)[:, None]).sum(dim=1)
        span = n_more + 1
        single = span == 1
        rs = (ts - tstart[i0]).long()
        tgt = (te - ts).long()
        live = aligned & (ridx >= 0) & ~overflow & ~(single & (tgt < 0))
        pos = torch.arange(L_cap + 1, device=dev)[None, :]
        scan = aligned[:, None] & (pos <= span.clamp(max=L_cap)[:, None]) \
            & (i0[:, None] + pos < M)
        take = (i0[:, None] + pos).clamp(max=M - 1)
        valid = live[:, None] & (pos < span[:, None])
        node = tnode[take] - 1
        nl = t.nodes_len[node.clamp(min=0)].long()
        # each position's allocation and diff interval, as the kernel's
        a_nolast = torch.where(valid, torch.where(pos == 0, nl - rs[:, None],
                                                  nl), 0)
        seen = torch.cumsum(a_nolast, dim=1) - a_nolast
        alloc = torch.where(pos == (span - 1)[:, None],
                            (tgt[:, None] - seen).clamp(min=0), a_nolast)
        alloc = torch.where(valid, torch.where(single[:, None], tgt[:, None],
                                               alloc), 0)
        start = torch.where(pos == 0, rs[:, None], 0)
        lo = torch.minimum(start.clamp(min=0), nl)
        hi = torch.minimum(torch.maximum(start + alloc, lo), nl)
        in_b = (tgt > 0)[:, None] & ((rs + tgt)[:, None] <= nl)
        d_add = valid & (~single[:, None] | in_b) & (lo != hi)
        b0 = bucket(ts[aligned])
        gathers = _sectors([
            (0, torch.cat([b0, b0 + 1]), 4),
            (1, take[scan], 4), (2, take[valid], 4), (3, node[valid], 4),
            (4, node[d_add], 4),
            (5, take[valid & (pos + 2 < span[:, None])], 4)])
        n_acc = 3
    sinks = (t.N_pad, t.TB_pad + 1, t.U_pad, M, M)
    atomics = _sectors([(6 + i, a[:n].nonzero().flatten(), a.element_size())
                        for i, (a, n) in enumerate(zip(acc[:n_acc], sinks))])
    return nbytes + 32 * gathers + 64 * atomics, int(live.sum()), gathers, \
        atomics


def scatter_bound(cols, tables, tstart, tnode, L_cap: int | None = None
                  ) -> tuple[float, str, str]:
    """(bound ms, "bytes", what went into it) of K6 / K11 on ``cols``:
    scatter_work's bytes over the HBM rate."""
    nbytes, live, g, a = scatter_work(cols, tables, tstart, tnode, L_cap)
    per = max(live, 1)
    return nbytes / HBM_BYTES_PER_S * 1e3, "bytes", (
        f"{live} live rows, {g / per:.2f} gathered and {a / per:.2f} atomic "
        f"sectors a live row, {nbytes / 1e6:.2f} MB")


def crafted_setup(path: str, dev, make_db):
    """(index, tables, tstart, tnode) on ``dev`` of the DB ``make_db(path)``
    (a cache load where it was built before)."""
    db = make_db(path)
    index = _host.build_align_index(db)
    tstart, tnode = (torch.from_numpy(np.asarray(a, np.int32)).to(dev)
                     for a in (index.tstart, index.tnode))
    return index, build_fused_tables(db, index, dev), tstart, tnode


def crafted_scatter(build: str, dev, L_caps) -> int:
    """K6 (``L_caps`` None) or K11 at each of ``L_caps`` (DB name -> node
    window) against its plain version on every crafted case of
    scatter_cases, with each of table_variants' tables; returns the largest
    difference (0)."""
    dbs = {"tiny": lambda p: tiny_db(p),
           "dup_small": lambda p: dup_db(p, n_species=2, strains=2,
                                         n_blocks=400)}
    err = 0
    for name, caps in ((n, (L_caps or {}).get(n, (None,))) for n in dbs):
        index, tables, tstart, tnode = crafted_setup(
            os.path.join(build, "tiny_db" if name == "tiny" else name), dev,
            dbs[name])
        variants = table_variants(tables, tstart, index.text_len)
        for L_cap in caps:
            cases = scatter_cases(index, L_cap or 32)
            for tag, t in variants.items():
                for case, arrays in cases.items():
                    cols = [torch.from_numpy(a).to(dev) for a in arrays]
                    err = max(err, hold_scatter(
                        cols, t, tstart, tnode,
                        f"on {name}'s crafted case {case}{tag}"
                        + (f" at L_cap {L_cap}" if L_cap else ""), L_cap))
    return err


def query_cols(aligner, codes, lens) -> tuple:
    """(ts, te, aligned) of the query on a host batch, as the fused step's
    scatter gets them."""
    ts, te, _s, _m, _q, _st, aligned = aligner.query(
        *aligner.upload(codes, lens))
    return ts, te, aligned


def scatter_ms(cols, tables, tstart, tnode, L_cap: int | None = None,
               lib=None) -> float:
    """ms of K6 (``L_cap`` None) or K11 at ``L_cap`` (of ``lib``, default
    the current source's build; launches not counted) on the rows ``cols``,
    on accumulators of its own (CUDA events, the stream held while the host
    enqueues; 51 calls add at most that many times each row's entries, far
    inside int32)."""
    lib = lib if lib is not None else scatter.build_scatter_kernels()
    args = (lib, *cols, tables, tstart, tnode,
            zero_accs(tables, tstart.shape[0], tstart.device))
    if L_cap is None:
        return cuda_ms(lambda: scatter.launch_k6(*args), 50, hold=True)
    return cuda_ms(lambda: scatter.launch_k11(*args, L_cap), 50, hold=True)


def time_scatter(cols, tables, tstart, tnode, L_cap: int | None = None
                 ) -> tuple[float, float]:
    """(kernel ms, plain ms) of K6 (``L_cap`` None) or K11 at ``L_cap`` on
    the rows ``cols``, each on accumulators of its own (scatter_ms; the
    plain version over 11 calls)."""
    args = (*cols, tables, tstart, tnode,
            zero_accs(tables, tstart.shape[0], tstart.device))
    plain = (partial(scatter.classify_scatter_ranges_plain, *args)
             if L_cap is None
             else partial(scatter.classify_scatter_plain, *args, L_cap))
    return (scatter_ms(cols, tables, tstart, tnode, L_cap),
            cuda_ms(plain, 10, hold=True))


def scatter_timings(name: str, cases, tables, tstart, tnode) -> tuple:
    """time_scatter and scatter_bound of K6 or K11 on each of ``cases``
    ((tag, cols, L_cap), the first the kernel's headline), printed with
    the card's line.  Returns (times by tag, the first case's bound)."""
    card, times, first = card_line(), {}, None
    for tag, cols, L_cap in cases:
        ms, plain = time_scatter(cols, tables, tstart, tnode, L_cap)
        b = scatter_bound(cols, tables, tstart, tnode, L_cap)
        first = first or b
        times.update({tag: ms, f"plain_{tag}": plain, f"bound_{tag}": b[0]})
        at = f" (L_cap {L_cap})" if L_cap else ""
        print(f"{name} [{card}] {tag}{at}: {ms:.4f} ms, plain torch "
              f"{plain:.3f} ms, bound {b[0]:.4f} ms (bytes: {b[2]}), "
              f"{b[0] / ms:.3f} of the bound")
    return times, first


def k6_cases(aligner, index, codes, lens, dev) -> tuple:
    """K6's rows in phase 3c, on the smoke DB: (tag, cols, None, what) of
    phase 5's first batch, a paired [2B] batch and a long-read interval
    batch (spans of up to 160 segments)."""
    main = query_cols(aligner, codes[:BATCH], lens[:BATCH])
    (c1, l1, c2, l2), _ = simulate_pairs(index, BATCH, seed=17)
    r1, r2 = aligner.query_paired(*aligner.upload(c1, l1),
                                  *aligner.upload(c2, l2))
    paired = tuple(torch.cat([r1[i], r2[i]]) for i in (0, 1, 6))
    iv = tuple(torch.from_numpy(a).to(dev)
               for a in interval_batch(index, LONG_BATCH, 160, seed_=23))
    return (("main", main, None, f"on phase 5's first batch (B={BATCH})"),
            ("paired", paired, None, f"on a paired batch (2B={2 * BATCH})"),
            ("intervals", iv, None, f"on an interval batch ({LONG_BATCH} "
                                    f"rows, 1-160 segments)"))


def k6_phase(build: str, dev, aligner, index, tables, codes, lens) -> tuple:
    """Phase 3c, K6: its registers and records' size printed; against its
    plain version on the crafted cases (tiny and the small dup community),
    on k6_cases' three batches and on reads in the smoke DB's fullest
    buckets (each of table_variants' tables); timed with the plain version
    on each batch.  Returns (largest difference, ms, plain ms, bound ms,
    bound_by, times by case, shape) at phase 5's batch."""
    print("K6 registers: " + "; ".join(
        ln for ln in ptxas_lines(scatter.build_scatter_kernels().build_log)
        if ln.startswith("classify_scatter_ranges_kernel"))
          + f"; its records: {tables.seg_rec.shape[0]} segments x 32 B = "
          f"{tables.seg_rec.numel() * 4 / 1e6:.1f} MB on the card")
    errs = [crafted_scatter(build, dev, None)]
    ts_, tn_ = aligner.tstart, aligner.tnode
    cases = k6_cases(aligner, index, codes, lens, dev)
    errs += [hold_scatter(cols, tables, ts_, tn_, what)
             for _, cols, _, what in cases]
    full = [torch.from_numpy(a).to(dev)
            for a in scatter_cases(index, 32)["full_bucket"]]
    for tag, t in table_variants(tables, ts_, index.text_len).items():
        errs.append(hold_scatter(full, t, ts_, tn_, "on the smoke DB's "
                                 f"fullest buckets{tag}"))
    times, bound = scatter_timings("K6", [c[:3] for c in cases], tables,
                                   ts_, tn_)
    return (max(errs), times["main"], times["plain_main"], bound[0],
            bound[1], times, f"B {BATCH}, smoke DB (scale_db)")


# K11's crafted cases, by DB: the node windows of each template width (a
# tile of 4, 8, 16 and 32 lanes; two positions a lane at 64), 12 a window
# that leaves part of its tile empty
K11_CRAFTED = {"tiny": (8,), "dup_small": (4, 12, 16, 32, 64)}


def k11_phase(build: str, dev, aligner, index, tables, codes, lens,
              L_cap: int) -> tuple:
    """Phase 3c, K11 (in phase 9, after (b), where the dup DB is built):
    against its plain version on the crafted cases (K11_CRAFTED), on the
    dup DB's first batch at the automatic window ``L_cap`` and at 3
    segments (overflow), on an interval batch at 8 (spans of 1-8 segments,
    an interval feed's windowed rows), and timed with the plain version on
    each.  Returns (largest difference, ms, plain ms, bound ms, bound_by,
    times by case, shape) at the automatic window."""
    errs = [crafted_scatter(build, dev, K11_CRAFTED)]
    ts_, tn_ = aligner.tstart, aligner.tnode
    main = query_cols(aligner, codes[:BATCH], lens[:BATCH])
    iv = tuple(torch.from_numpy(a).to(dev)
               for a in interval_batch(index, LONG_BATCH, 8, seed_=29))
    cases = (("main", main, L_cap), ("L3", main, 3), ("intervals", iv, 8))
    for (tag, cols, cap), what in zip(cases, (
            f"on the dup DB's first batch (B={BATCH}) at L_cap {L_cap}",
            f"on the dup DB's first batch (B={BATCH}) at L_cap 3",
            f"on an interval batch ({LONG_BATCH} rows, 1-8 segments) at "
            f"L_cap 8")):
        errs.append(hold_scatter(cols, tables, ts_, tn_, what, cap))
    times, bound = scatter_timings("K11", cases, tables, ts_, tn_)
    return (max(errs), times["main"], times["plain_main"], bound[0],
            bound[1], times, f"B {BATCH}, dup_db, L_cap {L_cap}")


def _check_scatter(launches: dict, what: str, key: str, tally: str) -> None:
    if launches[key] != launches[tally] or launches[key + "_plain"]:
        raise AssertionError(
            f"{what}: {key} launches {launches[key]} for {launches[tally]} "
            f"dispatches, plain scatter {launches[key + '_plain']}")
    if launches[key]:
        SCATTER_BY_PATH[key][what.replace(" ", "_")] = launches[key]


def check_k6(launches: dict, what: str) -> None:
    """K6 launched once per range dispatch of the fused pipeline, the plain
    range scatter never; records the path's launches."""
    _check_scatter(launches, what, "classify_scatter_ranges",
                   "scatter_range_dispatch")


def check_k11(launches: dict, what: str) -> None:
    """K11 launched once per windowed dispatch of the fused pipeline, the
    plain windowed scatter never; records the path's launches."""
    _check_scatter(launches, what, "classify_scatter",
                   "scatter_window_dispatch")


def check_dispatches(launches: dict, what: str, n_range: int,
                     n_window: int) -> None:
    """The path's scatter dispatches are its own count of range and
    windowed batches (one scatter per query dispatch or interval batch)."""
    got = (launches["scatter_range_dispatch"],
           launches["scatter_window_dispatch"])
    if got != (n_range, n_window):
        raise AssertionError(f"{what}: range / windowed dispatches {got}, "
                             f"batches {(n_range, n_window)}")


# ---------------------------------------------------------------------------
# phase 3d: K8, the strain solve's batched ADMM chunk
# K8's launches by path (check_k8)
ADMM_BY_PATH: dict = {}


def check_k8(launches: dict, what: str) -> None:
    """K8 launched once per chunk the strain solvers dispatched, the plain
    chunk never; records the path's launches."""
    if (launches["admm_chunk"] != launches["admm_chunk_dispatch"]
            or launches["admm_chunk_plain"]):
        raise AssertionError(
            f"{what}: K8 launches {launches['admm_chunk']} for "
            f"{launches['admm_chunk_dispatch']} chunk dispatches, plain "
            f"chunk {launches['admm_chunk_plain']}")
    if launches["admm_chunk"]:
        ADMM_BY_PATH[what.replace(" ", "_")] = launches["admm_chunk"]


def admm_bound(S: int, n_pad: int, p_pad: int, iters: int,
               issue_peak: float) -> tuple[float, str, dict]:
    """(bound ms, what bounds it, work) of one ADMM chunk: every row of
    the bucket (the function computes them all), ADMM_OPS_ROW + 2 p_pad
    instructions a row a step, over ``issue_peak``; against A, b, ub, L
    and the state read once and the state and res written once, over the
    HBM rate."""
    ops = (ADMM_OPS_ROW + 2 * p_pad) * n_pad * iters * S
    state = 3 * S * p_pad + 2 * S * n_pad
    nbytes = 4 * (S * n_pad * p_pad + S * n_pad + S * p_pad
                  + S * p_pad * p_pad + 2 * state + S)
    t_ops, t_bytes = ops / issue_peak, nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes",
            {"ops": ops, "bytes": nbytes})


def admm_case(seed_: int, S: int, n_pad: int, p_pad: int, seeded: bool):
    """S instances of one bucket as the solvers build them: 0/1 columns
    over fewer rows than n_pad (the rest zero rows), one padded column
    past p where p_pad > 4 (A and ub zero there), b normalised to max 1,
    and a path of each instance pinned by ub 0.  The state is the
    callers' aliased zero state (one array as x, w and uw, one as z and
    uz) or, ``seeded``, five independent random vectors.  Returns numpy
    float32 (A, b, ub, state, L), L the port's factor of A^T A + I."""
    rng = np.random.default_rng(seed_)
    A = np.zeros((S, n_pad, p_pad), np.float32)
    b = np.zeros((S, n_pad), np.float32)
    ub = np.zeros((S, p_pad), np.float32)
    for s in range(S):
        n = n_pad - int(rng.integers(1, n_pad // 4))
        p = p_pad - 1 if p_pad > 4 else p_pad
        A[s, :n, :p] = rng.random((n, p)) < 0.6
        bb = np.maximum(A[s, :n, :p] @ rng.uniform(0.2, 1.0, p)
                        + rng.normal(0, 0.3, n), 0)
        b[s, :n] = bb / bb.max()
        ub[s, :p] = 3.15 / bb.max()
        ub[s, s % p] = 0.0
    if seeded:
        state = tuple(a.astype(np.float32) for a in (
            rng.uniform(0, 1, (S, p_pad)), rng.normal(0, 0.01, (S, n_pad)),
            rng.uniform(0, 1, (S, p_pad)), rng.normal(0, 0.01, (S, n_pad)),
            rng.normal(0, 0.01, (S, p_pad))))
    else:
        x0 = np.zeros((S, p_pad), np.float32)
        z0 = np.zeros((S, n_pad), np.float32)
        state = (x0, z0, x0, z0, x0)
    L = pao._admm_factor(torch.from_numpy(A)).contiguous().numpy()
    return A, b, ub, state, L


def admm_args(case, dev) -> tuple:
    """admm_case's arrays as the chunk's arguments on ``dev``: (A, b, ub,
    rho 1, state, L), the zero state aliased as the callers pass it (one
    tensor as x, w and uw, one as z and uz) and L in the layout of
    torch.linalg.cholesky on the card (a transposed view)."""
    A, b, ub, state, L = case
    t = [torch.from_numpy(a).to(dev) for a in (A, b, ub)]
    if state[0] is state[2] is state[4]:
        x0, z0 = (torch.from_numpy(a).to(dev) for a in state[:2])
        st = (x0, z0, x0, z0, x0)
    else:
        st = tuple(torch.from_numpy(a).to(dev) for a in state)
    Lt = torch.from_numpy(np.ascontiguousarray(L.transpose(0, 2, 1))).to(dev)
    return (*t, 1.0, st, Lt.mT)


def hold_k8(args, what: str, steps: int = 1, exact: bool = False,
            binary: bool = False) -> float:
    """K8 (uncounted) against its plain version after ``steps`` steps (1
    or 25) from the state in ``args`` (A, b, ub, rho, state, L): every
    state vector and the residual within K8_BARS[steps], the inputs
    untouched; ``binary`` as the solvers pass it (A is 0/1: the bits
    plan where the bucket fits it).  ``exact``: the plain version runs in
    float64 on the same float32 inputs (at p_pad 2048 the float32 plain
    chunk is itself 6.0e-5 off it after one step, 2.7x K8's error).
    Returns the largest difference."""
    bar = K8_BARS[steps]
    before = [t.clone() for t in (*args[:3], *args[4], args[5])]
    got = admm.launch_k8(*args, steps, binary)
    A, b, ub, rho, state, L = args
    if exact:
        A, b, ub, L = (t.double() for t in (A, b, ub, L))
        state = tuple(t.double() for t in state)
    want = pao._admm_chunk_batch_plain(A, b, ub, rho, state, L, steps)
    torch.cuda.synchronize()
    err = 0.0
    for name, g, w in zip(("x", "z", "w", "uz", "uw", "res"),
                          (*got[0], got[1]), (*want[0], want[1])):
        if not torch.isfinite(g).all():
            raise AssertionError(f"K8 {what}: {name} not finite")
        e = float((g.double() - w.double()).abs().max())
        if e > bar:
            raise AssertionError(f"K8 {what}: {name} differs from the plain "
                                 f"chunk by {e:.3g} after {steps} steps (bar "
                                 f"{bar})")
        err = max(err, e)
    for t, t0 in zip((*args[:3], *args[4], args[5]), before):
        if not torch.equal(t, t0):
            raise AssertionError(f"K8 {what}: an input changed")
    S, n, p = args[0].shape
    print(f"K8 == plain{' (float64)' if exact else ''} within {err:.3g} "
          f"after {steps} steps {what} "
          f"(S {S}, n_pad {n}, p_pad {p}, "
          f"{admm.launch_plan(S, n, p, binary)})")
    return err


def k8_repeats(args, iters: int, what: str, binary: bool = False) -> None:
    """Two K8 launches of ``iters`` steps on the same inputs give the same
    bits (no float atomics: the device tail's tables are byte-identical
    across calls)."""
    a, b = (admm.launch_k8(*args, iters, binary) for _ in range(2))
    for x, y in zip((*a[0], a[1]), (*b[0], b[1])):
        if not torch.equal(x, y):
            raise AssertionError(f"K8 {what}: two launches differ")


def k8_times(args, iters: int, binary: bool = False) -> tuple[float, float]:
    """(K8 ms, plain ms) of one chunk of ``iters`` steps (CUDA events; K8
    uncounted over 20 launches with the stream held, the plain chunk over
    3 calls)."""
    ms = cuda_ms(lambda: admm.launch_k8(*args, iters, binary), 20, hold=True)
    plain = cuda_ms(lambda: pao._admm_chunk_batch_plain(*args, iters), 3)
    return ms, plain


def chunk_recorder(chunk, log: list):
    """``chunk`` (a strain solver's chunk function) that also appends each
    call's (inputs, residual) to ``log``."""
    def recorded(A, b, ub, rho, state, L, iters, binary=False):
        out = chunk(A, b, ub, rho, state, L, iters, binary)
        log.append(((A, b, ub, rho, state, L, iters, binary), out[1]))
        return out
    return recorded


def residual_runs(log: list) -> str:
    """Each solver run's chunk residuals (the bucket's largest), in call
    order: a run starts at the callers' aliased zero state."""
    runs = []
    for args, res in log:
        shape, st = tuple(args[0].shape), args[4]
        if st[0] is st[2] or not any(r[0] == shape for r in runs):
            runs.append((shape, []))
        next(r for r in reversed(runs) if r[0] == shape)[1].append(
            float(res.max()))
    return "; ".join(f"{shape}: " + ", ".join(f"{v:.3g}" for v in rs)
                     for shape, rs in runs)


def admm_phase(build: str, dev, result, tables, index, db, cfg, out: str,
               issue_peak: float) -> tuple:
    """Phase 3d (in phase 8, after the device tail, whose buckets it
    takes): the device tail once more with the plain chunk in its place
    (by assignment, in this process), recording each chunk's inputs and
    residual, its tables against ``out``'s (K8's: the same strains,
    abundances within 2e-4) and its seconds; once more with K8, recorded
    the same way, its tables byte-identical to ``out``'s, and both runs'
    chunk residuals printed beside the float64 plain chunk's on the
    largest bucket; the plan of every bucket the tail dispatched; K8
    against the plain chunk after 1 and 25 steps on the largest bucket's
    first chunk (the zero state, aliased; the bits plan, and the float
    plan as a non-0/1 A takes it) and its second (a state in flight), on
    the crafted wide-row case (2, 4096, 132: the float plan, streamed)
    and on the bits plan's smallest bucket (1, 4096, 4) and 0/1 wide rows
    (1, 65536, 32); two launches bit-identical; K8 and the plain chunk
    timed at 250 steps beside admm_bound on the first chunk and the two
    bits-plan cases.  Returns (largest difference after one step, ms,
    plain ms, bound ms, bound_by, extra keys, shape)."""
    k8_chunk = profile_tail._admm_chunk_batch
    logs, secs = {}, {}
    for name, chunk in (("plain", pao._admm_chunk_batch_plain),
                        ("k8", k8_chunk)):
        logs[name] = []
        run_out = os.path.join(build, f"smoke_paired_{name}_chunk_out")
        shutil.rmtree(run_out, ignore_errors=True)
        profile_tail._admm_chunk_batch = chunk_recorder(chunk, logs[name])
        stage = {}
        try:
            torch.cuda.synchronize()
            t0 = time.time()
            profile_from_fused_result(result, tables, index, db, cfg,
                                      run_out, stage_out=stage)
            torch.cuda.synchronize()
        finally:
            profile_tail._admm_chunk_batch = k8_chunk
        secs[name] = (time.time() - t0, stage, run_out)
    t_plain, stage, out_plain = secs["plain"]
    k8_ab, plain_ab = strain_abundance(out), strain_abundance(out_plain)
    if set(k8_ab) != set(plain_ab):
        raise AssertionError("K8 and plain-chunk device tails report "
                             "different strains")
    diff = max(abs(k8_ab[k] - plain_ab[k]) for k in k8_ab)
    if diff > 2e-4:
        raise AssertionError(f"K8 and plain-chunk device tails: abundances "
                             f"differ by {diff:.3g} (> 2e-4)")
    files_identical(out, secs["k8"][2], (*CLASS_SPECIES, *STRAINS),
                    "paired device tail, K8 recorded")
    print(f"K8 device tail against the plain chunk's: the same "
          f"{len(k8_ab)} strains, abundances within {diff:.3g}; the plain "
          f"chunk's tail {t_plain:.3f} s ({len(logs['plain'])} chunks; "
          + ", ".join(f"{k} {v:.3f}" for k, v in stage.items()) + "), "
          f"K8's {secs['k8'][0]:.3f} s ({len(logs['k8'])} chunks; "
          + ", ".join(f"{k} {v:.3f}" for k, v in secs["k8"][1].items())
          + ")")
    for name in ("k8", "plain"):
        print(f"{name} chunk residuals by solver run (S, n_pad, p_pad): "
              f"{residual_runs(logs[name])}")

    plans = {}
    for args, _res in logs["k8"]:
        shape, binary = tuple(args[0].shape), args[7]
        plans[shape, binary] = admm.launch_plan(*shape, binary)
    print("K8 plans of the device tail's buckets: " + "; ".join(
        f"{shape}{' 0/1' if binary else ''}: cluster {pl.cluster}, "
        f"{pl.rows_per_thread} rows a thread of {pl.threads}, "
        f"{'bits' if pl.bits else 'float'}"
        for (shape, binary), pl in plans.items()))
    calls = [args for args, _res in logs["plain"]]
    big = max(calls, key=lambda c: c[0].numel())
    firsts = [c for c in calls if c[0] is big[0]]
    S, n, p = big[0].shape
    # where the exact iteration goes from the largest bucket's zero state:
    # four chunks of the plain chunk in float64
    A, b, ub, rho, state, L, iters, _binary = big
    A, b, ub, L = (t.double() for t in (A, b, ub, L))
    state = tuple(t.double() for t in state)
    exact = []
    for _ in range(4):
        state, res = pao._admm_chunk_batch_plain(A, b, ub, rho, state, L,
                                                 iters)
        exact.append(f"{float(res.max()):.3g}")
    print(f"float64 chunk residuals from the zero state ({S}, {n}, {p}): "
          + ", ".join(exact))
    valid = ((big[1] != 0) | (big[0] != 0).any(-1)).float().mean().item()
    wide = admm_args(admm_case(132, 2, 4096, 132, seeded=False), dev)
    small = admm_args(admm_case(4101, 1, 4096, 4, seeded=False), dev)
    wide01 = admm_args(admm_case(65569, 1, 65536, 32, seeded=False), dev)
    tail = firsts[0][:6]
    cases = [(tail, "on the paired device tail's largest bucket, zero "
              "state", True),
             (tail, "on the same, as a non-0/1 A", False),
             (wide, "on the crafted wide rows", True),
             (small, "on the smallest bucket", True),
             (wide01, "on 0/1 wide rows", True)]
    if len(firsts) > 1:
        cases.append((firsts[1][:6], "on the same bucket's second chunk",
                      True))
    errs = {steps: max(hold_k8(args, what, steps, binary=binary)
                       for args, what, binary in cases)
            for steps in K8_BARS}
    for args, what, binary in cases[:2]:
        k8_repeats(args, 250, what, binary)
    times = {}
    for name, args in (("tail", tail), ("1x4096x4", small),
                       ("1x65536x32", wide01)):
        ms, plain_ms = k8_times(args, 250, binary=True)
        bound, by, work = admm_bound(*args[0].shape, 250, issue_peak)
        times[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                       "bound_by": by}
        print(f"K8 [{card_line()}] at {tuple(args[0].shape)}, 250 steps, "
              f"{admm.launch_plan(*args[0].shape, True)}: {ms:.4f} ms, "
              f"plain chunk {plain_ms:.3f} ms, bound {bound:.4f} ms ({by}: "
              f"{work['ops']} instructions, {work['bytes']} bytes), "
              f"{bound / ms:.3f} of the bound")
    print(f"K8's bucket: valid rows {valid:.3f} of the bucket")
    ms, plain_ms, bound, by = (times["tail"][k] for k in (
        "ms", "plain_ms", "bound_ms", "bound_by"))
    return (errs[1], ms, plain_ms, bound, by,
            {"valid_row_share": valid, "plain_chunk_tail_s": t_plain,
             "max_abs_err_25_steps": errs[25], "ms_by_case": times},
            f"S {S}, n_pad {n}, p_pad {p}, 250 steps (the paired device "
            f"tail's largest bucket)")


# ---------------------------------------------------------------------------
# phase 3e: K9 and K10b, the device tail's strain stats and polish
# K9's and K10b's launches by path (check_k9_k10b)
TAIL_BY_PATH: dict = {"tail_stats": {}, "polish": {}}
# K10b's instructions a row visit (a row of a column of a sweep) at their
# fewest: the column's 0/1 test, the key (negate, flip), one count of a
# single-pass selection, and the residual's add (the 0/1 multiply exact)
POLISH_OPS_ROW = 6
# K9's float sums against the plain version's (float32 sums in another
# order): the CPU test's bar against the JAX stats
K9_RTOL = 1e-5
# k9_case's edges past its defaults, (what, G, S, nodes, trios, heavy,
# max_path): a hap of more trios than its plan's registers hold beside a
# species of 600,000 nodes (clusters of 8, 4 trios a thread); clusters of 2;
# G + S past the card's 132 SMs (a CTA a hap and a species)
K9_EDGES = (("a hap past the registers, a species of 600,000 nodes",
             8, 2, 600_000, 120_000, 0.5, 20_000),
            ("clusters of 2", 70, 6, 40_000, 200_000, 0.0, 5_000),
            ("G + S past 132", 140, 12, 50_000, 60_000, 0.0, 5_000))
# the sweep counts K10b is held to the plain polish at
POLISH_SWEEPS = (0, 1, 3, 8, 20)


def check_k9_k10b(launches: dict, what: str) -> None:
    """K9 launched once per dispatch_tail_stats and K10b once per device
    polish, their plain versions never; records each path's launches."""
    for key in TAIL_BY_PATH:
        if (launches[key] != launches[f"{key}_dispatch"]
                or launches[f"{key}_plain"]):
            raise AssertionError(
                f"{what}: {key} launches {launches[key]} for "
                f"{launches[key + '_dispatch']} dispatches, plain "
                f"{launches[key + '_plain']}")
        if launches[key]:
            TAIL_BY_PATH[key][what.replace(" ", "_")] = launches[key]


def tail_stats_bound(path_node, order, G: int, S: int
                     ) -> tuple[float, str, dict]:
    """(bound ms, "bytes", work) of one K9 launch with TailTables' order
    (ORDER_FIELDS): what it reads once, the na of the species' node spans,
    ta and the owner order over the real trios, path_node and the bc of
    each node a path holds (once a node), the offsets (2 (G + 1) + 2 S),
    and the 3 G + 4 S outputs written once, over the HBM rate (a few
    instructions an element)."""
    trio_order, span = order[0], order[3]
    na_read = int((span[S:] - span[:S]).sum())
    nodes = int(torch.unique(path_node).numel())
    nbytes = 4 * (na_read + 2 * trio_order.numel() + path_node.numel()
                  + nodes + 2 * (G + 1) + 2 * S + 3 * G + 4 * S)
    return nbytes / HBM_BYTES_PER_S * 1e3, "bytes", {"bytes": nbytes}


def polish_bound(S: int, n_pad: int, p_pad: int, sweeps: int,
                 issue_peak: float) -> tuple[float, str, dict]:
    """(bound ms, what bounds it, work) of one K10b launch: every row of
    the bucket in every column of every sweep (the residual update touches
    them all), POLISH_OPS_ROW instructions each, over ``issue_peak``;
    against A, b, x and ub read once and x written once, over the HBM
    rate."""
    ops = POLISH_OPS_ROW * sweeps * p_pad * n_pad * S
    nbytes = 4 * (S * n_pad * p_pad + S * n_pad + 3 * S * p_pad)
    t_ops, t_bytes = ops / issue_peak, nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes",
            {"ops": ops, "bytes": nbytes})


def polish_case(seed_: int, S: int, n_pad: int, p_pad: int,
                crafted: bool = False):
    """S instances of one bucket as DeviceTailSolver polishes them: 0/1
    columns over fewer rows than n_pad, rows of abundance 0 zeroed in A and
    b (build_A_b's row selection), one padded column past p where p_pad >
    4, b normalised to max 1, ub 1.05 but a path of each instance pinned
    by ub 0, and x near the solution, clipped into [0, ub] (the ADMM's).
    ``crafted`` turns instance s into edge s % 5: 0 ties at every median
    (x 0, b in steps of 1/8); 1 zeros of both signs (x -0.0, b +-0.0 on a
    third of the rows); 2 a column with no live row and t* past the upper
    clip (ub 0.01 under an optimum ~1); 3 t* past the lower clip (x 0.5
    over b 0); 4 a dead instance (A and b 0); 5 the first column's live
    rows in one bin of K10b's first digit (x 0, b in [1, 1.2)), more of
    them than its candidate buffer holds (MAX_CAP) from 65536 rows.
    Returns numpy float32 (A, b, x, ub)."""
    rng = np.random.default_rng(seed_)
    A = np.zeros((S, n_pad, p_pad), np.float32)
    b = np.zeros((S, n_pad), np.float32)
    x = np.zeros((S, p_pad), np.float32)
    ub = np.zeros((S, p_pad), np.float32)
    p = p_pad - 1 if p_pad > 4 else p_pad
    for s in range(S):
        n = n_pad - int(rng.integers(1, n_pad // 4))
        A[s, :n, :p] = rng.random((n, p)) < 0.6
        xt = rng.uniform(0.2, 1.0, p)
        bb = np.maximum(A[s, :n, :p] @ xt + rng.normal(0, 0.3, n), 0)
        bb[rng.random(n) < 0.1] = 0.0
        A[s, :n][bb == 0] = 0.0
        b[s, :n] = bb / bb.max()
        ub[s, :p] = 1.05
        ub[s, s % p] = 0.0
        x[s, :p] = np.clip(xt / bb.max() + rng.normal(0, 0.05, p), 0,
                           ub[s, :p])
        if not crafted:
            continue
        edge = s % 6
        if edge == 0:
            x[s] = 0.0
            b[s, :n] = np.round(b[s, :n] * 8) / 8 * (A[s, :n].any(-1))
        elif edge == 1:
            x[s, :p] = -0.0
            third = rng.random(n_pad) < 1 / 3
            b[s, third] = np.where(rng.random(third.sum()) < 0.5, -0.0, 0.0)
        elif edge == 2:
            A[s, :, p - 1] = 0.0
            x[s, 0], ub[s, 0] = 0.0, 0.01
            b[s, :n] = np.where(A[s, :n, 0] > 0, 1.0, b[s, :n])
        elif edge == 3:
            x[s, 0], ub[s, 0] = 0.5, 1.05
            b[s] = 0.0
        elif edge == 4:
            A[s], b[s] = 0.0, 0.0
        else:
            x[s] = 0.0
            col0 = A[s, :, 0] > 0
            b[s, col0] = 1.0 + 0.2 * rng.random(int(col0.sum()))
    return A, b, x, ub


def sweeps_run(args, sweeps: int = 8) -> list[int]:
    """The sweeps K10b runs for each instance of (A, b, x, ub), counted on
    the plain polish: up to and with the first sweep in which no step of
    the instance is not 0 (every later sweep would repeat it), else
    ``sweeps``."""
    moved: list = []
    profile_tail.polish_batch_plain(*args, sweeps, moved=moved)
    if not moved:
        return [0] * args[0].shape[0]
    m = torch.stack(moved).cpu()
    return [int(still[0]) + 1 if len(still := (~m[:, s]).nonzero())
            else sweeps for s in range(m.shape[1])]


def live_columns(A) -> list[int]:
    """Each instance's columns with at least one live row."""
    return (A > 0).any(dim=1).sum(dim=1).tolist()


def hold_k10b(args, what: str, sweeps: int = 8, lib=None) -> float:
    """K10b (uncounted; ``lib``'s build, default the current source's)
    against its plain version on the same (A, b, x, ub): x bit for bit,
    the sign of a zero aside (compared as x + 0.0), the inputs untouched.
    Returns the largest absolute difference."""
    before = [t.clone() for t in args]
    got = tail_kernels.launch_k10b(*args, sweeps, lib=lib)
    want = profile_tail.polish_batch_plain(*args, sweeps)
    torch.cuda.synchronize()
    if not torch.equal(got + 0.0, want + 0.0):
        bad = (got + 0.0 != want + 0.0).nonzero()[:4].tolist()
        raise AssertionError(f"K10b {what}: x differs from the plain polish "
                             f"at {bad}: {got[tuple(zip(*bad))].tolist()} "
                             f"against {want[tuple(zip(*bad))].tolist()}")
    for t, t0 in zip(args, before):
        if not torch.equal(t, t0):
            raise AssertionError(f"K10b {what}: an input changed")
    err = float((got - want).abs().max()) if got.numel() else 0.0
    S, n, p = args[0].shape
    print(f"K10b == plain (bit for bit, +-0 equal) {what} (S {S}, n_pad {n}, "
          f"p_pad {p}, {tail_kernels.polish_plan(S, n, p)})")
    return err


def repeats_identical(fn, what: str) -> None:
    """Two calls of ``fn`` (a kernel's launch) give the same bits."""
    a, b = fn(), fn()
    for x, y in zip(a if isinstance(a, tuple) else (a,),
                    b if isinstance(b, tuple) else (b,)):
        if not torch.equal(x, y):
            raise AssertionError(f"{what}: two launches differ")


K9_OUTPUTS = ("c1", "freq_mean", "path_cov", "sp_nz_cnt", "sp_nz_sum",
              "sp_max", "sp_valid")


def k9_want(args: tuple, kw: dict, exact: bool = False) -> tuple:
    """tail_stats_plain's seven outputs on ``args``; ``exact``: with na and
    ta in float64 (the float sums exact to float32 rounding, where the
    float32 sums of K9_EDGES' 600,000-node species and 70,000-trio hap are
    themselves 2e-5 off), then float32."""
    if exact:
        args = (args[0].double(), args[1].double(), *args[2:])
    return tuple(w.float() for w in profile_tail.tail_stats_plain(
        *args, G=kw["G"], S=kw["S"]))


def hold_k9(args: tuple, kw: dict, what: str, lib=None,
            exact: bool = False) -> float:
    """K9 (uncounted; ``lib``'s build, default the current source's)
    against its plain version on the same tail_stats arguments (``kw``
    holds G, S and order; ``exact``: the plain version in float64,
    k9_want): the counts, path_cov and sp_max exact, freq_mean and
    sp_nz_sum within K9_RTOL; two launches bit-identical.  Returns the
    largest absolute difference."""
    na, ta, bc, _trio_hap, path_node = args[:5]
    G, S, order = kw["G"], kw["S"], kw["order"]

    def launch():
        return tail_kernels.launch_k9(na, ta, bc, path_node, order, args[7],
                                      G=G, S=S, lib=lib)

    got = launch()
    want = k9_want(args, kw, exact)
    torch.cuda.synchronize()
    err = 0.0
    for name, g, w in zip(K9_OUTPUTS, got, want):
        if name in ("freq_mean", "sp_nz_sum"):
            torch.testing.assert_close(g, w, rtol=K9_RTOL, atol=0,
                                       msg=f"K9 {what}: {name}")
        elif not torch.equal(g, w):
            raise AssertionError(f"K9 {what}: {name} differs from the plain "
                                 f"version")
        fin = torch.isfinite(w)
        if fin.any():
            err = max(err, float((g[fin] - w[fin]).abs().max()))
    repeats_identical(launch, f"K9 {what}")
    print(f"K9 == plain {what} (G {G}, S {S}: counts, path_cov, sp_max and "
          f"sp_valid exact, sums within {K9_RTOL} relative; largest "
          f"difference {err:.3g}; two launches bit-identical)")
    return err


def k9_args(tt, na, ta, bc, min_depth: float) -> tuple:
    """The (args, kw) of tail_stats_plain and hold_k9 for one
    dispatch_tail_stats call: the coverage and tt's tables, G, S and K9's
    owner order."""
    return ((na, ta, bc, tt.trio_hap, tt.path_node, tt.path_hap,
             tt.node_species, min_depth),
            {"G": tt.G, "S": tt.S, "order": tuple(
                getattr(tt, f) for f in profile_tail.ORDER_FIELDS)})


def k9_case(seed_: int, dev, G: int = 12, S: int = 4, nodes: int = 4000,
            trios: int = 9000, heavy: float = 0.0,
            max_path: int | None = None) -> tuple:
    """Crafted stats tables whose trio owners interleave within each
    species (and pad trios, owner G, among them), on ``dev``: S species of
    consecutive haps, the last species without nodes, node_species sorted,
    each hap's path a random walk over its species' nodes (at most
    ``max_path`` nodes); hap 0 owns no trio, hap 1 only zero trios, hap 2
    one nonzero trio (sigma 0); hap 3 about ``heavy`` of all trios.
    Returns tail_stats' (args, kw) with K9's order tables."""
    rng = np.random.default_rng(seed_)
    hap_sp = np.sort(rng.integers(0, S - 1, G))
    hap_sp[:S - 1] = np.arange(S - 1)
    hap_sp.sort()
    node_sp = np.sort(rng.integers(0, S - 1, nodes)).astype(np.int32)
    node_sp[:S - 1] = np.arange(S - 1)
    node_sp.sort()
    n_pad = nodes + 96
    node_species = np.concatenate([node_sp, np.full(96, S, np.int32)])
    trio_hap = rng.integers(3, G + 1, trios).astype(np.int32)  # G: pads
    trio_hap[rng.random(trios) < heavy] = 3
    trio_hap[rng.choice(trios, 45, replace=False)] = [1] * 40 + [2] * 5
    ta = np.where(rng.random(trios) < 0.3, 0.0,
                  rng.gamma(2.0, 4.0, trios)).astype(np.float32)
    ta[trio_hap == 1] = 0.0
    two = np.flatnonzero(trio_hap == 2)
    ta[two] = 0.0
    ta[two[0]] = 3.0
    na = np.where(rng.random(n_pad) < 0.25, 0.0,
                  rng.gamma(2.0, 4.0, n_pad)).astype(np.float32)
    bc = rng.integers(0, 400, n_pad).astype(np.int32)
    parts = []
    for g in range(G):
        own = np.flatnonzero(node_species == hap_sp[g])
        size = int(rng.integers(1, 3 * len(own)))
        parts.append(rng.choice(own, size=min(size, max_path or size))
                     .astype(np.int32))
    path_node = np.concatenate(parts)
    hap_node_off = np.zeros(G + 1, np.int64)
    np.cumsum([len(q) for q in parts], out=hap_node_off[1:])
    path_hap = np.repeat(np.arange(G, dtype=np.int32), [len(q) for q in parts])
    sp_off = np.searchsorted(node_sp, np.arange(S))
    order = profile_tail.owner_tables(trio_hap, hap_node_off, sp_off,
                                      np.bincount(node_sp, minlength=S), G,
                                      dev)
    t = [torch.from_numpy(a).to(dev) for a in (
        na, ta, bc, trio_hap, path_node, path_hap, node_species)]
    return ((*t, 1.5), {"G": G, "S": S, "order": tuple(
        order[f] for f in profile_tail.ORDER_FIELDS)})


def graph_of(fn):
    """A CUDA graph of ``fn`` (captured after a warm-up on a side stream),
    or the capture's error: a yardstick, the same launches without their
    host overhead."""
    try:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            fn()
    except RuntimeError as e:
        return None, str(e).splitlines()[0]
    return graph, None


def tail_phase(build: str, dev, result, tables, index, db, cfg, out: str,
               issue_peak: float) -> tuple:
    """Phase 3e (in phase 8, after phase 3d): the device tail once with
    the plain stats and polish in place of K9 and K10b (by assignment, in
    this process) and once with the kernels, recording their inputs: its
    tables byte-identical to ``out``'s, the plain stages' within
    strains_agree's bars, each run's strain_s printed, K9 and K10b once per
    dispatch; K9 against the plain stats on the recorded coverage and on
    crafted tables (owners interleaved), two launches bit-identical; K10b
    against the plain polish on every recorded bucket and the crafted
    edges (polish_case) at each of POLISH_SWEEPS, two launches
    bit-identical; K9 timed on the recorded coverage and K10b on each
    recorded bucket (CUDA events, the stream held) beside its bound, the
    plain version and, for K10b, a CUDA-graph replay of the plain polish
    (a yardstick), the sweeps each instance ran and its live columns.
    Returns ((max err, ms, plain ms, bound ms, bound_by, extra, shape) of
    K9, the same of K10b at its largest bucket)."""
    stats_fn = profile_tail.dispatch_tail_stats
    polish_fn = profile_tail.polish_batch
    stats_log, polish_log, runs = [], [], {}

    def recorded(fn, log):
        def call(*args, **kw):
            log.append((args, kw))
            return fn(*args, **kw)
        return call

    def plain_stats(tt, na, ta, bc, min_depth):
        return profile_tail.tail_stats_plain(*k9_args(tt, na, ta, bc,
                                                      min_depth)[0],
                                             G=tt.G, S=tt.S)

    for name, stats, polish in (
            ("plain", plain_stats, profile_tail.polish_batch_plain),
            ("kernels", recorded(stats_fn, stats_log),
             recorded(polish_fn, polish_log))):
        run_out = os.path.join(build, f"smoke_paired_{name}_tail_out")
        shutil.rmtree(run_out, ignore_errors=True)
        profile_tail.dispatch_tail_stats = stats
        profile_tail.polish_batch = polish
        stage = {}
        extend.reset_launch_counts()
        try:
            torch.cuda.synchronize()
            t0 = time.time()
            profile_from_fused_result(result, tables, index, db, cfg,
                                      run_out, stage_out=stage)
            torch.cuda.synchronize()
        finally:
            profile_tail.dispatch_tail_stats = stats_fn
            profile_tail.polish_batch = polish_fn
        runs[name] = (time.time() - t0, stage, run_out, dict(extend.LAUNCHES))
    launches = runs["kernels"][3]
    check_k9_k10b(launches, "paired tail 3e")
    if not launches["tail_stats"] or not launches["polish"]:
        raise AssertionError(f"phase 3e: K9 {launches['tail_stats']}, K10b "
                             f"{launches['polish']} launches")
    files_identical(out, runs["kernels"][2], (*CLASS_SPECIES, *STRAINS),
                    "paired device tail, K9 and K10b recorded")
    worst = strains_agree(runs["kernels"][2], runs["plain"][2],
                          "paired device tail, plain stats and polish")
    print(f"K9 and K10b device tail against the plain stages': the same "
          f"strains, numeric columns within {STRAIN_RTOL} (largest "
          f"{max(worst.values(), default=0.0):.3g}); strain_s "
          f"{runs['kernels'][1]['strain_s']:.4f} s with the kernels (K9 "
          f"{launches['tail_stats']}, K10b {launches['polish']} launches), "
          f"{runs['plain'][1]['strain_s']:.4f} s with the plain stages; "
          "stages: kernels " + ", ".join(
              f"{k} {v:.4f}" for k, v in runs["kernels"][1].items())
          + "; plain " + ", ".join(
              f"{k} {v:.4f}" for k, v in runs["plain"][1].items()))

    # K9 on the recorded coverage, on crafted tables and on its edges
    args, kw = k9_args(*stats_log[0][0])
    err9 = max(hold_k9(args, kw, "on the paired device tail's coverage"),
               hold_k9(*k9_case(9, dev), "on crafted tables"),
               *(hold_k9(*k9_case(21 + i, dev, *shape), what, exact=True)
                 for i, (what, *shape) in enumerate(K9_EDGES)))
    na, ta, bc, _trio_hap, path_node = args[:5]
    G, S, order = kw["G"], kw["S"], kw["order"]
    ms9 = cuda_ms(lambda: tail_kernels.launch_k9(
        na, ta, bc, path_node, order, args[7], G=G, S=S), 50, hold=True)
    plain9 = cuda_ms(lambda: profile_tail.tail_stats_plain(*args, G=G, S=S),
                     5)
    bound9, by9, work9 = tail_stats_bound(path_node, order, G, S)
    plan9 = tail_kernels.stats_plan(G, S, order[0].numel())
    print(f"K9 [{card_line()}] on the paired device tail (G {G}, S {S}, "
          f"N_pad {na.numel()}, {order[0].numel()} trios, "
          f"{path_node.numel()} path nodes; {plan9}): {ms9:.4f} ms, plain "
          f"{plain9:.3f} ms, bound {bound9:.4f} ms ({by9}: {work9['bytes']} "
          f"bytes), {bound9 / ms9:.3f} of the bound")

    # K10b on every recorded bucket and on the crafted edges, at each of
    # POLISH_SWEEPS
    err10 = 0.0
    for i, (pargs, _kw) in enumerate(polish_log):
        for sw in POLISH_SWEEPS:
            err10 = max(err10, hold_k10b(
                pargs[:4], f"on the paired device tail's bucket, polish "
                f"call {i}, {sw} sweeps", sw))
    for shape in ((6, 4096, 4), (6, 65536, 4)):
        crafted = [torch.from_numpy(a).to(dev)
                   for a in polish_case(sum(shape), *shape, crafted=True)]
        for sw in POLISH_SWEEPS:
            err10 = max(err10, hold_k10b(crafted, f"on the crafted edges, "
                                         f"{sw} sweeps", sw))
    big = max((pargs[:4] for pargs, _kw in polish_log),
              key=lambda a: a[0].numel())
    repeats_identical(lambda: tail_kernels.launch_k10b(*big),
                      "K10b on the largest bucket")
    by_bucket = []
    for i, (pargs, _kw) in enumerate(polish_log):
        args10 = pargs[:4]
        S10, n10, p10 = args10[0].shape
        ms = cuda_ms(lambda: tail_kernels.launch_k10b(*args10), 20, hold=True)
        plain = cuda_ms(lambda: profile_tail.polish_batch_plain(*args10), 3)
        graph, why = graph_of(lambda: profile_tail.polish_batch_plain(*args10))
        graph_ms = cuda_ms(graph.replay, 5) if graph is not None else None
        bound, by, work = polish_bound(S10, n10, p10, 8, issue_peak)
        run, live = sweeps_run(args10), live_columns(args10[0])
        print(f"K10b [{card_line()}] polish call {i} at ({S10}, {n10}, "
              f"{p10}), 8 sweeps, {tail_kernels.polish_plan(S10, n10, p10)}:"
              f" {ms:.4f} ms, plain {plain:.3f} ms, its graph replay "
              + (f"{graph_ms:.3f} ms" if graph_ms is not None else
                 f"not captured ({why})")
              + f", bound {bound:.6f} ms ({by}: {work['ops']} instructions "
              f"for 8 sweeps of every column, {work['bytes']} bytes), "
              f"{bound / ms:.4f} of the bound; sweeps run by instance {run} "
              f"(of 8), live columns by instance {live}")
        by_bucket.append({"shape": [S10, n10, p10], "ms": ms,
                          "plain_ms": plain, "graph_replay_ms": graph_ms,
                          "bound_ms": bound, "sweeps_run": run,
                          "live_columns": live})
    top = max(range(len(by_bucket)),
              key=lambda i: (polish_log[i][0][0].numel(), -i))
    ms10, plain10 = by_bucket[top]["ms"], by_bucket[top]["plain_ms"]
    graph10 = by_bucket[top]["graph_replay_ms"]
    S10, n10, p10 = by_bucket[top]["shape"]
    bound10, by10, _work = polish_bound(S10, n10, p10, 8, issue_peak)
    tail_s = {name: runs[name][1]["strain_s"] for name in runs}
    return ((err9, ms9, plain9, bound9, by9,
             {"strain_s": tail_s, "plan": dataclasses.asdict(plan9)},
             f"G {G}, S {S}, N_pad {na.numel()} (the paired device tail)"),
            (err10, ms10, plain10, bound10, by10,
             {"graph_replay_ms": graph10, "strain_s": tail_s,
              "sweeps_run": by_bucket[top]["sweeps_run"],
              "live_columns": by_bucket[top]["live_columns"],
              "by_bucket": by_bucket},
             f"S {S10}, n_pad {n10}, p_pad {p10}, 8 sweeps (the paired "
             f"device tail's bucket)"))


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


def main_path(build: str, dev, issue_peak: float):
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
    k3 = seed_phase(db, index, aligner, codes, lens, dev, issue_peak)
    k6 = k6_phase(build, dev, aligner, index, tables, codes, lens)

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
          f"batches; plain DP runs {launches['banded_extend_plain']}; K3 "
          f"launches {launches['seed_stage']}, plain seed stage runs "
          f"{launches['seed_stage_plain']}")
    if launches["banded_extend"] != stage["n_batches"]:
        raise AssertionError("K1 was not launched exactly once per batch")
    if launches["banded_extend_plain"] != 0:
        raise AssertionError("the plain DP ran on the CUDA main path")
    check_k3(launches, "short")
    check_dispatches(launches, "short", stage["n_batches"], 0)
    # reads_classification.tsv rows are R<read index>
    check_tables(out, np.asarray(index.hap_species, dtype=object)[hap],
                 N_READS, stage["n_aligned"], "aligned")
    return ((launches["banded_extend"], err1, ms, plain_ms), k3, k6,
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
    check_k3(launches, "long")
    check_dispatches(launches, "long", pipe.n_interval_batches, 0)
    if pipe.n_interval_batches != -(-len(merged.read_ids) // LONG_BATCH):
        raise AssertionError("unexpected number of interval batches")
    check_tables(out, np.asarray(index.hap_species, dtype=object)[hap],
                 N_LONG, len(merged.read_ids), "emitted")
    return launches, (reads, hap)


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


def paired_path(build: str, dev, db, index, tables, issue_peak: float):
    """Phase 8: paired reads over the smoke DB, the device tail, phases 3d
    (K8 on the device tail's buckets) and 3e (K9 and K10b on its coverage
    and buckets), and the host tail on the same result.  Returns K1's
    launches, the pairs, admm_phase's and tail_phase's results."""
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
    shutil.rmtree(out + "_cold", ignore_errors=True)
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
        profile_from_fused_result(result, tables, index, db, cfg,
                                  out + "_cold" if rep == "cold" else out,
                                  stage_out=stage)
        torch.cuda.synchronize()
        times[rep] = (time.time() - t1, stage)
    launches = dict(extend.LAUNCHES)
    # the device tail adds its float32 sums in one order every run
    files_identical(out + "_cold", out, (*CLASS_SPECIES, *STRAINS),
                    "paired device tail, two calls")
    k8 = admm_phase(build, dev, result, tables, index, db, cfg, out,
                    issue_peak)
    k9_k10b = tail_phase(build, dev, result, tables, index, db, cfg, out,
                         issue_peak)

    cfg.tail = "host"
    out_host = os.path.join(build, "smoke_paired_host_out")
    shutil.rmtree(out_host, ignore_errors=True)
    stage_h = {}
    extend.reset_launch_counts()
    torch.cuda.synchronize()
    t1 = time.time()
    profile_from_fused_result(result, tables, index, db, cfg, out_host,
                              stage_out=stage_h)
    torch.cuda.synchronize()
    t_host = time.time() - t1
    check_k8(dict(extend.LAUNCHES), "paired host tail")

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
    check_k3(launches, "paired")
    if not launches["tail_stats"] or not launches["polish"]:
        raise AssertionError(f"paired: the device tail launched K9 "
                             f"{launches['tail_stats']} and K10b "
                             f"{launches['polish']} times")
    check_dispatches(launches, "paired", pipe.n_batches, 0)
    # reads_classification.tsv rows are A<pair index> / B<pair index>
    check_tables(out, np.asarray(index.hap_species, dtype=object)[hap],
                 2 * N_PAIRS, n_aligned, "aligned", min_frac=0.99)
    dev_ab, host_ab = strain_abundance(out), strain_abundance(out_host)
    if set(dev_ab) != set(host_ab):
        raise AssertionError("device and host tails report different strains")
    diff = max(abs(dev_ab[k] - host_ab[k]) for k in dev_ab)
    print(f"paired: device and host tails report the same {len(dev_ab)} "
          f"strains; abundances differ by at most {diff:.3g}; the device "
          f"tail's two calls wrote byte-identical tables")
    if diff > 2e-4:
        raise AssertionError("device and host tail abundances differ by > 2e-4")
    capped_tail(build, result, tables, index, db)
    return launches["banded_extend"], ((c1, l1, c2, l2), hap), k8, k9_k10b


def capped_tail(build: str, result, tables, index, db) -> None:
    """The device tail's sampling-cap fallback on the card (phase 8):
    cfg.sample_nodes at the median of the species' sp_valid from K9, so the
    species over it take the host solve (their rows sampled on the host)
    and the others the device solve (ops/fused.py); the device tail's
    classification and species tables byte-identical to the host tail's at
    the same cap, the same strains, abundances within 2e-4, K9 and K10b
    once per dispatch."""
    from pantax_tpu_torch.profile import engine

    valid = profile_tail.compute_tail_stats(
        _ensure_tail_tables(tables), result.na_d, result.ta_d, result.bc_d,
        0.0).sp_valid
    cap = int(np.sort(valid)[len(valid) // 2])
    over = int((valid > cap).sum())
    if not 0 < over < len(valid):
        raise AssertionError(f"capped tail: cap {cap} splits no species "
                             f"(sp_valid {valid})")
    prepare = engine.prepare_two_stage
    host_solves = []

    def counted(*args, **kw):
        host_solves.append(args[1])
        return prepare(*args, **kw)

    outs = {}
    for tail in ("device", "host"):
        cfg = _host.ProfilingConfig.for_read_type("short")
        cfg.solver, cfg.tail, cfg.sample_nodes = "admm", tail, cap
        outs[tail] = os.path.join(build, f"smoke_paired_capped_{tail}_out")
        shutil.rmtree(outs[tail], ignore_errors=True)
        extend.reset_launch_counts()
        if tail == "device":
            engine.prepare_two_stage = counted
        try:
            profile_from_fused_result(result, tables, index, db, cfg,
                                      outs[tail])
            torch.cuda.synchronize()
        finally:
            engine.prepare_two_stage = prepare
        launches = dict(extend.LAUNCHES)
        check_k3(launches, f"paired capped {tail} tail")
        if tail == "device":
            polish = launches["polish"]
            if not launches["tail_stats"] or not polish or not host_solves:
                raise AssertionError(
                    f"capped tail: K9 {launches['tail_stats']}, K10b "
                    f"{polish} launches, {len(host_solves)} host solves")
    files_identical(outs["host"], outs["device"], CLASS_SPECIES,
                    "paired capped tails")
    dev_ab, host_ab = (strain_abundance(outs[t]) for t in ("device", "host"))
    if set(dev_ab) != set(host_ab):
        raise AssertionError("capped tails report different strains")
    diff = max(abs(dev_ab[k] - host_ab[k]) for k in dev_ab)
    print(f"paired capped: sample_nodes {cap} (the median sp_valid from K9; "
          f"{over} of {len(valid)} species over it): the device tail sent "
          f"{len(host_solves)} species of {sorted(host_solves)} nodes to the "
          f"host solve and the rest to the device solve (K10b {polish} "
          f"launches); classification and species tables byte-identical to "
          f"the host tail's, the same {len(dev_ab)} strains, abundances "
          f"within {diff:.3g}")
    if diff > 2e-4:
        raise AssertionError("capped tails' abundances differ by > 2e-4")


def dup_path(build: str, dev):
    """Phase 9 (and phase 3c's K11 half): the dup-graph community through
    the windowed scatter.  Returns K1's launches by path, K2's on the long
    reads and k11_phase's results."""
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
    check_k3(launches, "dup short")
    check_dispatches(launches, "dup short", 0, stage["n_batches"])
    check_tables(out, truth[hap], N_READS, stage["n_aligned"], "aligned",
                 min_frac=0.99)
    by_path = {"dup_short": launches["banded_extend"]}
    k11 = k11_phase(build, dev, aligner, index, tables, codes, lens, L_cap)

    # the windowed classify+scatter of one batch, K11 and its plain
    # version, against the range scatter of the same intervals, K6 and its
    # plain version (same reads, not exact on this DB: timing only)
    cols = query_cols(aligner, codes[:BATCH], lens[:BATCH])
    k11_ms, k11_plain = time_scatter(cols, tables, aligner.tstart,
                                     aligner.tnode, L_cap)
    k6_ms, k6_plain = time_scatter(cols, tables, aligner.tstart,
                                   aligner.tnode)
    print(f"dup: windowed classify+scatter per batch of {BATCH} reads at "
          f"L_cap {L_cap}: K11 {k11_ms:.4f} ms, plain torch {k11_plain:.3f} "
          f"ms (the range scatter over the same intervals: K6 {k6_ms:.4f} "
          f"ms, plain torch {k6_plain:.3f} ms)")

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
    check_k3(launches, "dup paired")
    check_dispatches(launches, "dup paired", 0, pipe.n_batches)
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
    check_k3(launches, "dup long")
    check_dispatches(launches, "dup long", 0, pipe.n_interval_batches)
    if pipe.interval_rows["range"]:
        raise AssertionError("dup long: rows took the range scatter")
    check_tables(out, truth[lhap], N_DUP_LONG, len(merged.read_ids),
                 "emitted")
    by_path["dup_long"] = launches["banded_extend"]
    return by_path, launches["banded_extend_windows"], k11, (db, index,
                                                             reads, lhap)


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


def same_tables(pairs, what: str) -> None:
    """Every (file, file) pair byte-identical."""
    for a, b in pairs:
        with open(a, "rb") as fa, open(b, "rb") as fb:
            if fa.read() != fb.read():
                raise AssertionError(f"{what}: {a} differs from {b}")


def files_identical(out_a: str, out_b: str, names, what: str) -> None:
    same_tables(((os.path.join(out_a, n), os.path.join(out_b, n))
                 for n in names), what)


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
                     what: str, coverages=("device", "host")):
    """profile_from_gaf with each coverage (ADMM), each run's K8 launches
    held to its chunk dispatches (check_k8, path "<what> <coverage>"):
    {coverage: (seconds, stage, out dir)}."""
    runs = {}
    for cov in coverages:
        cfg = _host.ProfilingConfig.for_read_type(read_type)
        cfg.solver, cfg.coverage = "admm", cov
        out = f"{out_base}_{cov}"
        shutil.rmtree(out, ignore_errors=True)
        stage = {}
        extend.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.time()
        profile_from_gaf(records, db, cfg, out, device=dev, stage_out=stage)
        torch.cuda.synchronize()
        runs[cov] = (time.time() - t0, stage, out)
        check_k8(dict(extend.LAUNCHES), f"{what} {cov}")
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
    """K1 (and K3, check_k3) once per dispatch of ``n``, the plain DP
    never."""
    if launches["banded_extend"] != n or launches["banded_extend_plain"]:
        raise AssertionError(f"{what}: K1 launches {launches['banded_extend']}"
                             f" for {n} batches, plain DP "
                             f"{launches['banded_extend_plain']}")
    check_k3(launches, what)


def gaf_flow(build: str, dev, card: str, scale, short, pairs, dup_long):
    """Phase 10.  Returns K1's and K2's launches by path, and (a)'s
    device-coverage output directory."""
    db, index = scale
    codes, lens, hap, fused_out = short
    truth = np.asarray(index.hap_species, dtype=object)
    aligner = aligner_from_reference(index, _host.AlignConfig(), dev)
    k1, k2 = {}, {}

    # (a) single-end reads from a FASTQ file
    fq = os.path.join(build, "smoke_reads.fq")
    t0 = time.time()
    write_fastq(fq, [f"R{i}" for i in range(N_READS)], codes, lens)
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
                            os.path.join(build, "smoke_gaf"), "gaf short")
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
                            "gaf paired", coverages=("device",))
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
    extend.reset_launch_counts()
    t0 = time.time()
    profile_from_alignments(arrays, index, db, cfg, out, device=dev,
                            stage_out=st)
    torch.cuda.synchronize()
    t_prof = time.time() - t0
    check_k8(dict(extend.LAUNCHES), "arrays short profile")
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
                            os.path.join(build, "smoke_gaf_dup_long"),
                            "gaf dup long")
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
    return k1, k2, out_dev

# ---------------------------------------------------------------------------
# phase 11: the pantax-gpu command line
# ---------------------------------------------------------------------------
class LogLines(logging.Handler):
    """Collects the messages the port's loggers emit during one CLI run."""

    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def run_cli(argv: list, what: str, card: str) -> tuple[float, dict]:
    """pantax_tpu_torch.cli.main(argv) in this process, with the launch
    counts set to 0 just before; prints its e2e wall time and its
    stage_timer lines, raises unless it exits 0 without a plain DP, and
    returns (seconds, launches)."""
    handler = LogLines()
    logger = logging.getLogger("pantax_tpu_torch")
    logger.addHandler(handler)
    extend.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    try:
        rc = cli.main(argv)
        torch.cuda.synchronize()
    finally:
        logger.removeHandler(handler)
    wall = time.time() - t0
    launches = dict(extend.LAUNCHES)
    stages = [ln.lstrip("- ").strip() for ln in handler.lines
              if " wall, " in ln]
    print(f"{what} [{card}]: e2e {wall:.3f} s; " + "; ".join(stages))
    if rc != 0:
        raise AssertionError(f"{what}: pantax-gpu exited {rc}")
    if launches["banded_extend_plain"] or launches["banded_extend_windows_plain"]:
        raise AssertionError(f"{what}: a plain DP ran on the card")
    check_k3(launches, what)
    return wall, launches


def db_files(root: str) -> list:
    """A DB directory's files (relative paths), the align index aside."""
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs
                  if f != "align_index.npz")


def fastpath_batches(paths, batch: int) -> int:
    """The fused dispatches the CLI's fastpath makes of FASTQ ``paths`` (two
    mate files are read side by side): each stream chunk's reads in
    ``batch``-row dispatches."""
    from pantax_tpu_torch.io.fastx import stream_fastx_buffers

    return sum(-(-(bufs[0].count(b"\n") // 4) // batch) for bufs in zip(
        *(stream_fastx_buffers(p, cli.CHUNK_BYTES) for p in paths)))


def cli_flow(build: str, card: str, scale, fused_out: str, phap,
             long_reads, long_launches: dict, gaf_out: str,
             gaf_k1: int) -> tuple[dict, dict]:
    """Phase 11.  Returns K1's and K2's launches by CLI path."""
    db, index = scale
    truth = np.asarray(index.hap_species, dtype=object)
    db_dir = str(db.root)
    fq = os.path.join(build, "smoke_reads.fq")
    p1, p2 = (os.path.join(build, f"smoke_pairs_{m}.fq") for m in (1, 2))
    k1, k2 = {}, {}

    def out(name):
        path = os.path.join(build, name)
        shutil.rmtree(path, ignore_errors=True)
        return path

    # (a) --create over the existing DB (the skip path), then from scratch
    # on the tiny community's FASTAs: the library build's files
    scale_root = str(db.root.parent)
    run_cli(["-f", os.path.join(scale_root, "genomes_info.txt"), "-d", db_dir,
             "--create", "--base-dir", scale_root], "cli create (existing)",
            card)
    tiny_root = os.path.join(build, "tiny_db")
    tiny_new = out("cli_tiny_db")
    run_cli(["-f", os.path.join(tiny_root, "genomes_info.txt"), "-d",
             tiny_new, "--create", "--base-dir", tiny_root],
            "cli create (tiny, from scratch)", card)
    names = db_files(os.path.join(tiny_root, "db"))
    if names != db_files(tiny_new):
        raise AssertionError("cli create: other DB files than the library's")
    files_identical(os.path.join(tiny_root, "db"), tiny_new,
                    [n for n in names if n != "finished_species.txt"],
                    "cli create")

    # (b) --index --warm-kernels (K1 and K2 were built in phase 2, so the
    # build here finds them loaded)
    _, launches = run_cli(["-d", db_dir, "--index", "--warm-kernels"],
                          "cli warm-kernels", card)
    k1["cli_warm"] = launches["banded_extend"]

    # (c) the short fastpath, host tail: phase 5's three tables; then the
    # -n / --strain resume through profile_from_alignments (device
    # coverage): the same tables, with no alignment
    tmp = out("cli_short_tmp")
    _, launches = run_cli([
        "-d", db_dir, "-s", "--fastpath", "-r", fq, "--tail", "host",
        "--coverage", "device", "--batch-size", str(BATCH), "-T", tmp, "-n",
        "-o", os.path.join(build, "cli_short"), "-R",
        os.path.join(build, "cli_short_cls.tsv")], "cli short", card)
    n_batches = fastpath_batches([fq], BATCH)
    check_k1(launches, n_batches, "cli short")
    check_dispatches(launches, "cli short", n_batches, 0)
    k1["cli_short"] = launches["banded_extend"]
    fused = [os.path.join(fused_out, n) for n in (
        "species_abundance.txt", "strain_abundance.txt",
        "reads_classification.tsv")]
    same_tables(zip(fused, [os.path.join(build, n) for n in (
        "cli_short_species_abundance.txt", "cli_short_strains_abundance.txt",
        "cli_short_cls.tsv")]), "cli short vs profile_fused")
    artifact = os.path.join(tmp, "alignment_arrays.npz")
    mtime = os.stat(artifact).st_mtime_ns
    _, launches = run_cli([
        "-d", db_dir, "-s", "--fastpath", "-r", fq, "--strain",
        "--coverage", "device", "-T", tmp, "-n", "-o",
        os.path.join(build, "cli_resume"), "-R",
        os.path.join(build, "cli_resume_cls.tsv")], "cli short resume", card)
    if launches["banded_extend"] or os.stat(artifact).st_mtime_ns != mtime:
        raise AssertionError("cli short resume: the reads were realigned")
    same_tables(zip(fused, [os.path.join(build, n) for n in (
        "cli_resume_species_abundance.txt", "cli_resume_strains_abundance.txt",
        "cli_resume_cls.tsv")]), "cli short resume vs profile_fused")
    print(f"cli short: {n_batches} batches, K1 {k1['cli_short']}; the three "
          f"tables of it and of its resume byte-identical to phase 5's "
          f"profile_fused")

    # (d) paired fastpath from two files, tail "auto" (the device tail on
    # this DB): phase 8's bars
    tmp = out("cli_paired_tmp")
    _, launches = run_cli([
        "-d", db_dir, "-s", "-p", "--fastpath", "-r", p1, p2,
        "--batch-size", str(PAIR_BATCH), "-T", tmp, "--debug", "-o",
        os.path.join(build, "cli_paired")], "cli paired", card)
    n_batches = fastpath_batches([p1, p2], PAIR_BATCH)
    check_k1(launches, n_batches, "cli paired")
    check_dispatches(launches, "cli paired", n_batches, 0)
    k1["cli_paired"] = launches["banded_extend"]
    with open(os.path.join(tmp, "reads_classification.tsv")) as f:
        n_out = sum(1 for _ in f)
    print(f"cli paired: {n_batches} paired batches, K1 {k1['cli_paired']}")
    check_tables(tmp, truth[phap], 2 * N_PAIRS, n_out, "aligned",
                 min_frac=0.99)

    # (e) the long fastpath over phase 7's reads, written once as FASTQ:
    # phase 7's launches and bars
    reads, lhap = long_reads
    lfq = os.path.join(build, "smoke_long.fq")
    t0 = time.time()
    with open(lfq, "wb") as f:
        for lo in range(0, len(reads), 1000):
            f.write(b"".join(b"@%s\n%s\n+\n%s\n" % (rid.encode(), seq,
                                                    b"I" * len(seq))
                             for rid, seq in reads[lo:lo + 1000]))
    print(f"cli long: wrote {len(reads)} reads to FASTQ "
          f"({os.path.getsize(lfq) / 1e6:.1f} MB) in {time.time() - t0:.2f} s")
    tmp = out("cli_long_tmp")
    _, launches = run_cli([
        "-d", db_dir, "-l", "--fastpath", "-r", lfq, "--long-read-type",
        READ_TYPE, "--batch-size", str(LONG_BATCH), "-T", tmp, "--debug",
        "-o", os.path.join(build, "cli_long")], "cli long", card)
    for key in ("banded_extend", "banded_extend_windows",
                "classify_scatter_ranges"):
        if launches[key] != long_launches[key] or not launches[key]:
            raise AssertionError(f"cli long: {key} launched {launches[key]} "
                                 f"times, phase 7 {long_launches[key]}")
    k1["cli_long"] = launches["banded_extend"]
    k2["cli_long"] = launches["banded_extend_windows"]
    print(f"cli long: K1 {k1['cli_long']}, K2 {k2['cli_long']} (phase 7's)")
    with open(os.path.join(tmp, "reads_classification.tsv")) as f:
        n_out = sum(1 for _ in f)
    check_tables(tmp, truth[lhap], N_LONG, n_out, "emitted")

    # (f) the default GAF flow with device coverage: phase 10 (a)'s tables
    tmp = out("cli_gaf_tmp")
    _, launches = run_cli([
        "-d", db_dir, "-s", "-r", fq, "--coverage", "device", "--batch-size",
        str(BATCH), "-T", tmp, "-o", os.path.join(build, "cli_gaf"), "-R",
        os.path.join(build, "cli_gaf_cls.tsv")], "cli gaf short", card)
    check_k1(launches, gaf_k1, "cli gaf short")
    check_dispatches(launches, "cli gaf short", 0, 0)
    k1["cli_gaf_short"] = launches["banded_extend"]
    same_tables(zip([os.path.join(gaf_out, n) for n in (
        "species_abundance.txt", "strain_abundance.txt",
        "reads_classification.tsv")], [os.path.join(build, n) for n in (
            "cli_gaf_species_abundance.txt", "cli_gaf_strains_abundance.txt",
            "cli_gaf_cls.tsv")]), "cli gaf short vs phase 10 (a)")
    print("cli gaf short: the three tables byte-identical to phase 10 (a)'s "
          "device-coverage tables")

    # (g) --device cuda where torch sees no GPU: a non-zero exit, no output
    tmp = out("cli_nogpu_tmp")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.dirname(os.path.abspath(__file__)), env.get("PYTHONPATH", "")])
    proc = subprocess.run(
        [sys.executable, "-m", "pantax_tpu_torch.cli", "-d", db_dir, "-s",
         "--fastpath", "-r", fq, "-T", tmp], env=env, capture_output=True,
        text=True, timeout=300)
    if proc.returncode == 0 or os.path.exists(tmp) or \
            "CUDA is not available" not in proc.stderr:
        raise AssertionError(f"cli without a GPU: exit {proc.returncode}, "
                             f"{proc.stderr[-500:]}")
    print(f"cli without a GPU (CUDA_VISIBLE_DEVICES=''): exit "
          f"{proc.returncode}, no output")
    return k1, k2


# ---------------------------------------------------------------------------
# phase 12: the mesh and the multi-process runs on one card
# ---------------------------------------------------------------------------
def mesh_path(build: str, dev, card: str, scale, short) -> int:
    """Phase 12 (a).  Returns K1's launches on the mesh."""
    db, index, tables = scale
    codes, lens, _, fused_out = short
    runs = {}
    for tag, mesh in (("one", None), ("mesh", make_mesh([dev, dev]))):
        aligner = aligner_from_reference(index, _host.AlignConfig(), dev,
                                         mesh=mesh)
        pipe = FusedPipeline(aligner, tables, BATCH)
        extend.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.time()
        pipe.feed(codes, lens)
        result = pipe.finish()  # the per-read download synchronises
        runs[tag] = (result, time.time() - t0, dict(extend.LAUNCHES),
                     pipe.n_batches)
    (one, t_one, _, n_batches), (res, t_mesh, launches, _) = (
        runs["one"], runs["mesh"])
    print(f"mesh short [{card}]: align+cover {t_mesh:.3f} s on "
          f"make_mesh([{dev}, {dev}]), {t_one:.3f} s on one device, "
          f"{n_batches} batches; K1 launches {launches['banded_extend']}, "
          f"plain DP {launches['banded_extend_plain']}")
    if (launches["banded_extend"] != 2 * n_batches
            or launches["banded_extend_plain"]):
        raise AssertionError("mesh short: K1 not launched once per row block")
    check_k3(launches, "mesh short")
    check_dispatches(launches, "mesh short", n_batches, 0)
    for name in ("na_d", "ta_d", "bc_d"):
        if not torch.equal(getattr(res, name), getattr(one, name)):
            raise AssertionError(f"mesh short: {name} differs from one device")
    for k in ("mapq", "aligned", "ridx", "read_len", "ts", "te"):
        if not np.array_equal(res.reads[k], one.reads[k]):
            raise AssertionError(f"mesh short: per-read {k} differs")
    cfg = _host.ProfilingConfig.for_read_type("short")
    cfg.tail = "host"
    cfg.solver = "admm"
    out = os.path.join(build, "smoke_mesh_out")
    shutil.rmtree(out, ignore_errors=True)
    extend.reset_launch_counts()
    profile_from_fused_result(res, tables, index, db, cfg, out)
    check_k8(dict(extend.LAUNCHES), "mesh short profile")
    files_identical(out, fused_out, ("species_abundance.txt",
                                     "strain_abundance.txt",
                                     "reads_classification.tsv"),
                    "mesh short vs phase 5")
    print("mesh short: na/ta/bc and the per-read columns bit-identical to "
          "one device; the three tables byte-identical to phase 5's")
    return launches["banded_extend"]


def rank_main(argv: list) -> int:
    """One rank of a phase 12 run (``chip_smoke.py --rank <json argv>``):
    pantax_tpu_torch.cli.main(argv) in this process, then one line
    ``RANK {json}`` with its exit code, e2e seconds, launches and
    stage_timer lines."""
    handler = LogLines()
    logging.getLogger("pantax_tpu_torch").addHandler(handler)
    extend.reset_launch_counts()
    t0 = time.time()
    rc = cli.main(argv)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    print("RANK " + json.dumps({
        "rc": rc, "wall": time.time() - t0, "launches": extend.LAUNCHES,
        "stages": [ln for ln in handler.lines if " wall, " in ln]}))
    return rc


def stage_seconds(stages: list, *names) -> float:
    """The wall seconds of the stage_timer lines whose stage starts with
    one of ``names``."""
    total = 0.0
    for ln in stages:
        name, _, rest = ln.lstrip("- ").partition(": ")
        if name.startswith(names):
            total += float(rest.split("s wall")[0])
    return total


def run_ranks(argv: list, what: str, card: str, base: str) -> list:
    """pantax-gpu ``argv`` --distributed 127.0.0.1:PORT,2,I as two
    processes sharing the card, rank I in base/rank<I> with its standard
    output and errors in base/rank<I>.out and .err (files: a rank that
    writes much never blocks on a pipe the other's wait leaves undrained);
    both are waited for until one deadline DIST_TIMEOUT_S away (past it
    both are killed and the phase fails).  Prints each rank's set-up, align and merge seconds and launches;
    raises unless both exit 0 without a plain DP.  Returns the two
    reports."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.dirname(os.path.abspath(__file__)),
         os.environ.get("PYTHONPATH", "")]))
    procs, logs = [], []
    for i in range(2):
        wd = os.path.join(base, f"rank{i}")
        shutil.rmtree(wd, ignore_errors=True)
        os.makedirs(wd)
        logs.append(tuple(os.path.join(base, f"rank{i}.{s}")
                          for s in ("out", "err")))
        with open(logs[i][0], "w") as out, open(logs[i][1], "w") as err:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--rank",
                 json.dumps([*argv, "--distributed",
                             f"127.0.0.1:{port},2,{i}"])],
                cwd=wd, env=env, stdout=out, stderr=err))
    t0 = time.time()
    try:
        for p in procs:
            p.wait(timeout=max(DIST_TIMEOUT_S - (time.time() - t0), 1))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.time() - t0
    reports = []
    for i, p in enumerate(procs):
        out, err = (open(f, errors="replace").read() for f in logs[i])
        lines = [ln for ln in out.splitlines() if ln.startswith("RANK ")]
        if p.returncode or not lines:
            raise AssertionError(f"{what} rank {i}: exit {p.returncode}\n"
                                 f"{out[-2000:]}{err[-3000:]}")
        rep = json.loads(lines[-1][5:])
        la, st = rep["launches"], rep["stages"]
        align = stage_seconds(st, "alignment+coverage", "long-read alignment")
        # set-up: all before the align stage (DB and index load, aligner,
        # fused tables); the merge runs inside the align stage of the
        # short flows and inside the profiling stage of the long one
        setup = rep["wall"] - align - stage_seconds(st, "profiling")
        print(f"{what} rank {i} [{card}]: e2e {rep['wall']:.3f} s, set-up "
              f"{setup:.3f} s, align+cover {align:.3f} s, merge "
              f"{stage_seconds(st, 'cross-process merge'):.3f} s; "
              f"K1 {la['banded_extend']}, K2 {la['banded_extend_windows']}, "
              f"K3 {la['seed_stage']}, K6 {la['classify_scatter_ranges']}, "
              f"K11 {la['classify_scatter']}, plain DPs "
              f"{la['banded_extend_plain']} "
              f"and {la['banded_extend_windows_plain']}, plain seed stage "
              f"{la['seed_stage_plain']}")
        print(f"  {what} rank {i} stages: " + "; ".join(
            ln.lstrip("- ") for ln in rep["stages"]))
        if la["banded_extend_plain"] or la["banded_extend_windows_plain"]:
            raise AssertionError(f"{what} rank {i}: a plain DP ran on the card")
        check_k3(la, f"{what} rank {i}")
        reports.append(rep)
    print(f"{what}: two ranks in {wall:.3f} s of wall time")
    return reports


def shard_batches(path: str, n_proc: int, batch: int) -> list:
    """Each process's fused dispatches over its byte-range shard of the
    FASTQ ``path`` at the CLI's stream granularity."""
    from pantax_tpu_torch.io.fastx import shard_fastx_buffers

    return [sum(-(-(buf.count(b"\n") // 4) // batch) for buf in
                shard_fastx_buffers(path, i, n_proc, cli.CHUNK_BYTES))
            for i in range(n_proc)]


def sorted_lines(path: str) -> list:
    with open(path) as f:
        return sorted(f.read().splitlines())


def dist_flow(build: str, card: str, db_dir: str,
              long_launches: dict) -> tuple[dict, dict]:
    """Phase 12 (b)-(d).  Returns K1's and K2's launches by path (both
    ranks')."""
    fq = os.path.join(build, "smoke_reads.fq")
    p1, p2 = (os.path.join(build, f"smoke_pairs_{m}.fq") for m in (1, 2))
    lfq = os.path.join(build, "smoke_long.fq")
    names = ("dist_species_abundance.txt", "dist_strains_abundance.txt",
             "dist_cls.tsv")
    out = ["-o", "dist", "-R", "dist_cls.tsv", "-T", "tmp"]
    k1, k2 = {}, {}

    def rank_dirs(tag):
        base = os.path.join(build, tag)
        return base, [os.path.join(base, f"rank{i}") for i in range(2)]

    def none_written(rank1, what):
        if any(os.path.exists(os.path.join(rank1, n)) for n in names):
            raise AssertionError(f"{what}: process 1 wrote an output file")

    # (b) the short fastpath, phase 11 (c)'s flags: each rank its shard
    base, (r0, r1) = rank_dirs("dist_short")
    reps = run_ranks(["-d", db_dir, "-s", "--fastpath", "-r", fq, "--tail",
                      "host", "--coverage", "device", "--batch-size",
                      str(BATCH), *out], "dist short", card, base)
    want = shard_batches(fq, 2, BATCH)
    got = [r["launches"]["banded_extend"] for r in reps]
    if got != want:
        raise AssertionError(f"dist short: K1 {got}, dispatches {want}")
    for i, r in enumerate(reps):
        check_dispatches(r["launches"], f"dist short rank {i}", want[i], 0)
    k1["dist_short"] = sum(got)
    same_tables(zip([os.path.join(build, n) for n in (
        "cli_short_species_abundance.txt", "cli_short_strains_abundance.txt",
        "cli_short_cls.tsv")], [os.path.join(r0, n) for n in names]),
        "dist short vs phase 11 (c)")
    none_written(r1, "dist short")
    print(f"dist short: K1 {got} for the shards' {want} dispatches; process "
          f"0's three files byte-identical to phase 11 (c)'s, process 1 "
          f"wrote none")

    # (c) the paired fastpath, phase 11 (d)'s flags: chunks round-robin
    base, (r0, r1) = rank_dirs("dist_paired")
    reps = run_ranks(["-d", db_dir, "-s", "-p", "--fastpath", "-r", p1, p2,
                      "--batch-size", str(PAIR_BATCH), "--debug", *out],
                     "dist paired", card, base)
    got = [r["launches"]["banded_extend"] for r in reps]
    if not all(got):
        raise AssertionError(f"dist paired: K1 {got}, a rank owned no chunk")
    for i, r in enumerate(reps):  # one scatter per paired query dispatch
        check_dispatches(r["launches"], f"dist paired rank {i}", got[i], 0)
    k1["dist_paired"] = sum(got)
    ref = os.path.join(build, "cli_paired")
    same_tables([(f"{ref}_species_abundance.txt", os.path.join(r0, names[0])),
                 (f"{ref}_strains_abundance.txt", os.path.join(r0, names[1]))],
                "dist paired vs phase 11 (d)")
    if sorted_lines(os.path.join(r0, names[2])) != sorted_lines(os.path.join(
            build, "cli_paired_tmp", "reads_classification.tsv")):
        raise AssertionError("dist paired: other classification rows than "
                             "phase 11 (d)'s")
    none_written(r1, "dist paired")
    print(f"dist paired: K1 {got}; species and strain files byte-identical "
          f"to phase 11 (d)'s, the classification rows equal as sorted "
          f"lists, process 1 wrote none")

    # (d) the long fastpath, phase 11 (e)'s flags: one read group, so
    # process 1 owns none
    base, (r0, r1) = rank_dirs("dist_long")
    reps = run_ranks(["-d", db_dir, "-l", "--fastpath", "-r", lfq,
                      "--long-read-type", READ_TYPE, "--batch-size",
                      str(LONG_BATCH), "--debug", *out], "dist long", card,
                     base)
    for key in ("banded_extend", "banded_extend_windows",
                "classify_scatter_ranges"):
        got = [r["launches"][key] for r in reps]
        if got != [long_launches[key], 0]:
            raise AssertionError(f"dist long: {key} {got}, phase 7 "
                                 f"{long_launches[key]} (process 1 owns no "
                                 f"read group)")
    k1["dist_long"] = long_launches["banded_extend"]
    k2["dist_long"] = long_launches["banded_extend_windows"]
    ref = os.path.join(build, "cli_long")
    same_tables([(f"{ref}_species_abundance.txt", os.path.join(r0, names[0])),
                 (f"{ref}_strains_abundance.txt", os.path.join(r0, names[1]))],
                "dist long vs phase 11 (e)")
    if sorted_lines(os.path.join(r0, names[2])) != sorted_lines(os.path.join(
            build, "cli_long_tmp", "reads_classification.tsv")):
        raise AssertionError("dist long: other classification rows than "
                             "phase 11 (e)'s")
    none_written(r1, "dist long")
    print(f"dist long: process 1 owned no read group and completed; K1 "
          f"{k1['dist_long']} and K2 {k2['dist_long']} on process 0 "
          f"(phase 7's); species and strain files byte-identical to phase "
          f"11 (e)'s, the classification rows equal as sorted lists")
    os.remove(lfq)
    return k1, k2


# ---------------------------------------------------------------------------
# phase 13: the benchmark runners and simulate_reads
# ---------------------------------------------------------------------------
# the accuracy runners' L1 bar, the one tests/test_pipeline_e2e.py holds
# the reference's accuracy_benchmark to (its lowest strains at ~1.05x)
L1_BAR = 0.12
# (e'): accuracy_benchmark at that test's coverage of its lowest strains
# (16384 150 bp reads over 3 x 3 genomes of 60 kb at 1:3:9): 56 of the
# runner's batches of 16384, ~1.06x for the weight-1 strains
N_ACC_FULL = 56 * 16384
# (d): the mixed runner's 99:1 mix, cut to 1M reads for the run's time (the
# bench's --config mixed runs it in full on the 102-strain community)
N_MIX_SHORT, N_MIX_LONG = 990_000, 10_000
# (g): simulate_reads at 1:3:9 strain weights
N_SIM, SIM_SEED = 100_000, 21


def bench_run(what: str, card: str, fn, *args, k2: bool = False, **kw):
    """One phase 13 runner call, as a user makes it (no device: the
    card): prints its dict (without pred and truth), its wall seconds and
    its K1 / K2 launches; raises unless K1 (and, with ``k2``, K2) launched
    and the plain DPs never did.  Returns the dict and the launches."""
    extend.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    res = fn(*args, **kw)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = dict(extend.LAUNCHES)
    shown = {k: v for k, v in res.items() if k not in ("pred", "truth")}
    print(f"{what} [{card}]: {json.dumps(shown)}; runner {wall:.3f} s; K1 "
          f"{launches['banded_extend']}, K2 "
          f"{launches['banded_extend_windows']}, K6 "
          f"{launches['classify_scatter_ranges']}, K11 "
          f"{launches['classify_scatter']}")
    if (not launches["banded_extend"]
            or k2 != bool(launches["banded_extend_windows"])):
        raise AssertionError(f"{what}: K1 / K2 launches {launches}")
    if launches["banded_extend_plain"] or launches["banded_extend_windows_plain"]:
        raise AssertionError(f"{what}: a plain DP ran on the card")
    check_k3(launches, what)
    return res, launches


def check_strains(res: dict, what: str, all_strains: bool) -> None:
    """An accuracy runner's strains: with ``all_strains`` every one of the
    30 found and the L1 error at most L1_BAR; else every strain above the
    lightest weight found (the lightest may fall below the unique-trio
    filter's covered fraction at the runner's coverage).  No strain that
    the truth lacks; abundances finite, summing to 1."""
    pred, truth = res["pred"], res["truth"]
    ab = np.array(list(pred.values()))
    if not (np.isfinite(ab).all() and abs(ab.sum() - 1.0) < 1e-6):
        raise AssertionError(f"{what}: abundances not finite or not summing to 1")
    if not set(pred) <= set(truth) or res["total"] != 30:
        raise AssertionError(f"{what}: strains the truth lacks: "
                             f"{sorted(set(pred) - set(truth))}")
    light = min(truth.values())
    heavy = {g for g, t in truth.items() if t > light}
    if all_strains:
        if res["detected"] != 30 or res["l1_error"] > L1_BAR:
            raise AssertionError(f"{what}: {res['detected']} of 30 strains, "
                                 f"L1 {res['l1_error']} (bar {L1_BAR})")
    elif not heavy <= set(pred):
        raise AssertionError(f"{what}: strains of weight 3 and 9 missed: "
                             f"{sorted(heavy - set(pred))}")
    print(f"{what}: {res['detected']} of 30 strains ({len(heavy & set(pred))}"
          f" of the {len(heavy)} of weight 3 and 9), L1 {res['l1_error']:.6f}"
          + (f" (bar {L1_BAR})" if all_strains else ""))


def sim_flow(build: str, dev, card: str, db, index) -> int:
    """Phase 13 (g): simulate_reads at 1:3:9, Aligner.align_reads on the
    card, then profile_from_gaf over the aligned and over the truth GAF
    records.  Returns K1's launches."""
    weights = {h: float(3 ** (i % 3)) for i, h in enumerate(index.hap_names)}
    t0 = time.time()
    reads = simulate_reads(db, weights, N_SIM, 150, seed=SIM_SEED,
                           error_rate=0.01)
    t_sim = time.time() - t0
    aligner = aligner_from_reference(index, _host.AlignConfig(), dev)
    stage = {}
    extend.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    gaf = aligner.align_reads([(r.read_id, r.seq) for r in reads],
                              batch_size=BATCH, stage_out=stage)
    torch.cuda.synchronize()
    t_align = time.time() - t0
    launches = dict(extend.LAUNCHES)
    check_k1(launches, stage["n_batches"], "sim reads")
    cfg = _host.ProfilingConfig.for_read_type("short")
    outs, t_prof = {}, {}
    for tag, records in (("aligned", gaf), ("truth", [r.truth for r in reads])):
        outs[tag] = os.path.join(build, f"p13_sim_{tag}")
        extend.reset_launch_counts()
        t0 = time.time()
        profile_from_gaf(records, db, cfg, outs[tag], force=True, device=dev)
        t_prof[tag] = time.time() - t0
        check_k8(dict(extend.LAUNCHES), f"sim {tag} profile")
    species_of = {r.read_id: r.species for r in reads}
    with open(os.path.join(outs["aligned"], "reads_classification.tsv")) as f:
        n_ok = sum(species_of[ln.split("\t")[0]] == ln.split("\t")[2]
                   for ln in f)
    acc = n_ok / N_SIM
    genome_of = {g.hap_id: g.genome_id
                 for g in _host.read_genomes_info(db.genomes_info_file)}
    heavy = {genome_of[h] for h, w in weights.items() if w == 9.0}
    found = {}
    for tag, out in outs.items():
        species = read_table(os.path.join(out, "species_abundance.txt"))
        strains = {r["genome_ID"] for r in
                   read_table(os.path.join(out, "strain_abundance.txt"))}
        found[tag] = strains
        if len(species) != 10 or not heavy <= strains <= set(genome_of.values()):
            raise AssertionError(
                f"sim reads ({tag} GAF): {len(species)} species; strains "
                f"{sorted(strains)} against the weight-9 ones {sorted(heavy)}")
    print(f"sim reads [{card}]: simulate_reads {N_SIM} x 150 bp at 1:3:9 in "
          f"{t_sim:.3f} s, align_reads {t_align:.3f} s ({len(gaf)} records, "
          f"K1 {launches['banded_extend']}), profile_from_gaf aligned "
          f"{t_prof['aligned']:.3f} s / truth {t_prof['truth']:.3f} s; "
          f"species of {acc:.4f} of the reads as simulated; strains found "
          f"aligned {len(found['aligned'])} / truth {len(found['truth'])} "
          f"(every weight-9 strain in both)")
    if acc < 0.99:
        raise AssertionError(f"sim reads: species accuracy {acc:.4f} < 0.99")
    return launches["banded_extend"]


def bench_flow(build: str, dev, card: str, db, index, long_hap) -> tuple:
    """Phase 13 (a)-(g).  Returns K1's and K2's launches by sub-phase."""
    k1, k2 = {}, {}

    def keep(tag, launches):
        k1[tag] = launches["banded_extend"]
        if launches["banded_extend_windows"]:
            k2[tag] = launches["banded_extend_windows"]

    out = os.path.join(build, "p13_{}")
    res, la = bench_run("bench alignment", card,
                        benchmarks.run_alignment_benchmark, db, N_READS, BATCH)
    keep("bench_alignment", la)
    if res["aligned_frac"] < 0.95 or res["species_acc"] < 0.99:
        raise AssertionError("bench alignment: below phase 5's bars")

    res, la = bench_run("bench e2e", card, benchmarks.run_e2e_benchmark, db,
                        N_READS, BATCH, out_dir=out.format("e2e"))
    keep("bench_e2e", la)
    if res["aligned_frac"] < 0.95 or res["strains_detected"] != 30:
        raise AssertionError("bench e2e: below phase 5's bars")

    res, la = bench_run("bench long e2e", card,
                        benchmarks.run_long_e2e_benchmark, db, n_long=N_LONG,
                        out_dir=out.format("long_e2e"), k2=True)
    keep("bench_long_e2e", la)
    # phase 7's reads (the same count and seed): phase 7's bars
    check_tables(out.format("long_e2e"),
                 np.asarray(index.hap_species, dtype=object)[long_hap],
                 N_LONG, round(res["aligned_frac"] * N_LONG), "bench long e2e")

    res, la = bench_run("bench mixed", card, benchmarks.run_mixed_benchmark,
                        db, n_short=N_MIX_SHORT, n_long=N_MIX_LONG,
                        out_dir=out.format("mixed"), k2=True)
    keep("bench_mixed", la)
    if (res["short_aligned_frac"] < 0.95 or res["long_aligned_frac"] < 0.95
            or res["strains_detected"] != 30):
        raise AssertionError("bench mixed: below phases 5 and 7's bars")

    res, la = bench_run("bench accuracy", card, benchmarks.accuracy_benchmark,
                        db, out_dir=out.format("acc"))
    keep("bench_accuracy", la)
    check_strains(res, "bench accuracy (262,144 reads)", all_strains=False)
    res, la = bench_run("bench accuracy full", card,
                        benchmarks.accuracy_benchmark, db, n_reads=N_ACC_FULL,
                        out_dir=out.format("acc_full"))
    keep("bench_accuracy_full", la)
    check_strains(res, f"bench accuracy ({N_ACC_FULL} reads)", all_strains=True)

    res, la = bench_run("bench long accuracy", card,
                        benchmarks.long_read_accuracy_benchmark, db,
                        out_dir=out.format("lr_acc"), k2=True)
    keep("bench_long_accuracy", la)
    check_strains(res, "bench long accuracy (16,384 reads)", all_strains=True)

    k1["sim_reads"] = sim_flow(build, dev, card, db, index)
    return k1, k2


# ---------------------------------------------------------------------------
# phase 14: the benchmark driver as users run it
# ---------------------------------------------------------------------------
# the longest one driver run may take (the long config: ~35 s of Python
# read simulation, ~30 s of set-up and ~10 s of alignment)
BENCH_TIMEOUT_S = 600
# each config's metric and its JSON keys: bench.py's, with _per_gpu for
# _per_chip
BENCH_RECORDS = {
    "scale": ("scale_1M_reads_aligned_per_sec_per_gpu",
              ["e2e_reads_per_sec", "e2e_wall_s", "e2e_profile_s",
               "e2e_vs_baseline"]),
    "long": ("hifi_100k_8kb_e2e_reads_per_sec_per_gpu",
             ["e2e_wall_s", "e2e_profile_s", "bases_per_sec",
              "strains_detected"]),
}


def bench_module(build: str, card: str, config: str) -> dict:
    """One ``python -m pantax_tpu_torch.bench --config <config>`` run over
    the smoke DB's cache, waited for at most BENCH_TIMEOUT_S (a hang fails
    the phase): exit code 0, its last stdout line one JSON object with
    bench.py's keys and the _per_gpu metric, K1 launched (K2 on ``long``
    only) and the plain DPs never.  Prints the JSON line and the driver's
    stderr lines; returns the runners' dicts and the launches."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.dirname(os.path.abspath(__file__)),
         os.environ.get("PYTHONPATH", "")]))
    t0 = time.time()
    proc = subprocess.run(
        [sys.executable, "-m", "pantax_tpu_torch.bench", "--config", config,
         "--db-dir", os.path.join(build, "scale_db")],
        env=env, capture_output=True, text=True, timeout=BENCH_TIMEOUT_S)
    wall = time.time() - t0
    if proc.returncode:
        raise AssertionError(f"bench {config}: exit {proc.returncode}: "
                             f"{proc.stderr[-3000:]}")
    last = proc.stdout.splitlines()[-1]
    record = json.loads(last)
    tagged = dict(ln[2:].split(": ", 1) for ln in proc.stderr.splitlines()
                  if ln.startswith("# ") and ": " in ln)
    print(f"bench {config} json: {last}")
    for tag, text in tagged.items():
        print(f"bench {config} {tag}: {text}")
    print(f"bench {config} [{card}]: {wall:.1f} s as a subprocess")
    metric, extra = BENCH_RECORDS[config]
    if (record["metric"] != metric or list(record) != [
            "metric", "value", "unit", "vs_baseline", *extra]
            or not record["value"] > 0):
        raise AssertionError(f"bench {config}: record {record}")
    launches = json.loads(tagged["launches"])
    if (not launches["banded_extend"]
            or (config == "long") != bool(launches["banded_extend_windows"])
            or launches["banded_extend_plain"]
            or launches["banded_extend_windows_plain"]):
        raise AssertionError(f"bench {config}: launches {launches}")
    check_k3(launches, f"bench {config}")
    return {"results": json.loads(tagged["results"]), "launches": launches}


def bench_driver(build: str, card: str) -> tuple:
    """Phase 14: ``scale`` at phase 5's bars (aligned and species >= 0.999)
    and 30 strains; ``long`` at its full 100,000 reads, phase 7's emitted
    bar and 30 strains.  Returns K1's and K2's launches by config."""
    scale = bench_module(build, card, "scale")
    al, e2e = scale["results"]["alignment"], scale["results"]["e2e"]
    if (al["aligned_frac"] < 0.999 or al["species_acc"] < 0.999
            or e2e["aligned_frac"] < 0.999 or e2e["strains_detected"] != 30):
        raise AssertionError(f"bench scale: below phase 5's bars: {al}, {e2e}")
    long = bench_module(build, card, "long")
    lr = long["results"]["long_e2e"]
    if (lr["total_reads"] != 100_000 or lr["aligned_frac"] < 0.95
            or lr["strains_detected"] != 30):
        raise AssertionError(f"bench long: below phase 7's bars: {lr}")
    k1 = {"bench_scale": scale["launches"]["banded_extend"],
          "bench_long": long["launches"]["banded_extend"]}
    return k1, {"bench_long": long["launches"]["banded_extend_windows"]}


def main() -> None:
    t_smoke = time.time()
    dev = require_cuda()
    print(card_line())
    issue_peak = issue_ops_per_s()
    print(f"issue peak {issue_peak / 1e12:.2f} T instructions/s (SMs x 128 "
          f"lanes x the maximum SM clock); HBM {HBM_BYTES_PER_S / 1e12:.2f} "
          f"TB/s")
    build = str(extend.build_dir())
    t0 = time.time()
    with ThreadPoolExecutor(5) as pool:  # one nvcc per source, together
        built = [pool.submit(extend.build_kernels),
                 pool.submit(seed.build_seed_kernel),
                 pool.submit(scatter.build_scatter_kernels),
                 pool.submit(admm.build_admm_kernel),
                 pool.submit(tail_kernels.build_tail_kernels)]
        lib, lib3, lib6, lib8, lib9 = (f.result() for f in built)
    print(f"kernel build (K1 and K2, K3, K6 and K11, K8, K9 and K10b; five "
          f"nvcc processes) {time.time() - t0:.2f} s")
    print(f"SASS of K1 and K2: {sass_counts(lib._name)}")
    k1_sass = {f"pad{pad}": step_sass(lib._name, 2 * pad) for pad in (4, 8)}
    k2_sass = {f"pad{pad}": step_sass(lib._name, 2 * pad,
                                      "banded_extend_windows_kernel")
               for pad in (4, 8)}
    print(f"K1 main step loop SASS: {json.dumps(k1_sass)}")
    print(f"K2 main step loop SASS: {json.dumps(k2_sass)}")
    k3_sass = vote_sass(lib3._name)
    print(f"K3 vote loop SASS (seed_stage_kernel<2>): {json.dumps(k3_sass)}")
    for ln in (ptxas_lines(lib.build_log) + ptxas_lines(lib3.build_log)
               + ptxas_lines(lib6.build_log) + ptxas_lines(lib8.build_log)
               + ptxas_lines(lib9.build_log)):
        print(f"  ptxas: {ln}")

    rng = np.random.default_rng(0)
    text8 = np.concatenate([rng.integers(0, 4, size=8192).astype(np.int8),
                            np.full(1024, 4, np.int8)])
    err2, _, _ = check_kernel(text8, dev, 4096, 96, 8, seed=2, timed=False)
    cross_device_check(build, dev)
    (launches, err1, ms, plain_ms), k3, k6, (db, index, tables), short = \
        main_path(build, dev, issue_peak)
    err3, ms3, plain_ms3, bound3, by3, k3_times = k3
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
    long_launches, long_reads = long_path(build, dev, db, index, tables)
    paired_launches, pairs, k8, (k9, k10b) = paired_path(
        build, dev, db, index, tables, issue_peak)
    dup_launches, dup_k2, k11, dup_long = dup_path(build, dev)
    card = card_line()
    gaf_k1, gaf_k2, gaf_out = gaf_flow(build, dev, card, (db, index), short,
                                       pairs, dup_long)
    cli_k1, cli_k2 = cli_flow(build, card, (db, index), short[3], pairs[1],
                              long_reads, long_launches, gaf_out,
                              gaf_k1["gaf_short"])
    mesh_k1 = mesh_path(build, dev, card, (db, index, tables), short)
    torch.cuda.empty_cache()  # the ranks share the card with this process
    dist_k1, dist_k2 = dist_flow(build, card, str(db.root), long_launches)
    bench_k1, bench_k2 = bench_flow(build, dev, card, db, index,
                                    long_reads[1])
    torch.cuda.empty_cache()  # the driver's processes share the card
    driver_k1, driver_k2 = bench_driver(build, card)

    k1_by_path = {"short": launches, "long": long_launches["banded_extend"],
                  "paired": paired_launches, **dup_launches, **gaf_k1,
                  **cli_k1, "mesh_short": mesh_k1, **dist_k1, **bench_k1,
                  **driver_k1}
    k2_by_path = {"long": long_launches["banded_extend_windows"],
                  "dup_long": dup_k2, **gaf_k2, **cli_k2, **dist_k2,
                  **bench_k2, **driver_k2}
    # every path's K3 launches were held equal to its K1 launches
    # (check_k3): one seed stage per query dispatch
    k3_by_path = dict(k1_by_path)
    print(f"smoke: every phase in {time.time() - t_smoke:.1f} s")
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
        dict(KERNEL3, launches=sum(k3_by_path.values()),
             launches_by_path=k3_by_path, max_abs_err=err3, ms=ms3,
             plain_ms=plain_ms3, bound_ms=bound3, bound_by=by3,
             library_ms=None, shape=f"B {BATCH}, L 160, CHD, density {index.density_bits}",
             ms_by_case=k3_times, vote_sass=k3_sass),
        *(dict(kernel, launches=sum(SCATTER_BY_PATH[kernel["name"]].values()),
               launches_by_path=SCATTER_BY_PATH[kernel["name"]],
               max_abs_err=res[0], ms=res[1], plain_ms=res[2],
               bound_ms=res[3], bound_by=res[4], library_ms=None,
               shape=res[6], ms_by_case=res[5])
          for kernel, res in ((KERNEL6, k6), (KERNEL11, k11))),
        dict(KERNEL8, launches=sum(ADMM_BY_PATH.values()),
             launches_by_path=ADMM_BY_PATH, max_abs_err=k8[0], ms=k8[1],
             plain_ms=k8[2], bound_ms=k8[3], bound_by=k8[4], library_ms=None,
             shape=k8[6], **k8[5]),
        *(dict(kernel, launches=sum(TAIL_BY_PATH[kernel["name"]].values()),
               launches_by_path=TAIL_BY_PATH[kernel["name"]],
               max_abs_err=res[0], ms=res[1], plain_ms=res[2],
               bound_ms=res[3], bound_by=res[4], library_ms=None,
               shape=res[6], **res[5])
          for kernel, res in ((KERNEL9, k9), (KERNEL10B, k10b))),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        sys.exit(rank_main(json.loads(sys.argv[2])))
    main()
