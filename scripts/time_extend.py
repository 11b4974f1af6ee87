#!/usr/bin/env python3
"""Time two builds of K1 (``banded_extend_launch``), K2
(``banded_extend_windows_launch``), K3 (``seed_stage_launch``), K6 (the
range classify + scatter), K11 (``classify_scatter_launch``), K8, K9 or
K10b on one GPU,
in turns: the current ``csrc/banded_extend.cu`` (``csrc/seed_stage.cu``
for K3, ``csrc/classify_scatter.cu`` for K6 and K11) and a baseline source
with the same C entry points, such as an earlier commit's (K6's entry with
or without its records, ``scatter.launch_k6``):

    git show <commit>:pantax_tpu_torch/csrc/banded_extend.cu \\
        > build/banded_extend_base.cu
    PYTHONPATH=. python scripts/time_extend.py build/banded_extend_base.cu
    PYTHONPATH=. python scripts/time_extend.py --kernel k2 \\
        build/banded_extend_base.cu
    git show <commit>:pantax_tpu_torch/csrc/seed_stage.cu \\
        > build/seed_stage_base.cu
    PYTHONPATH=. python scripts/time_extend.py --kernel k3 \\
        build/seed_stage_base.cu [--ablate rehash --ablate carry ...]
    git show <commit>:pantax_tpu_torch/csrc/classify_scatter.cu \\
        > build/classify_scatter_base.cu
    PYTHONPATH=. python scripts/time_extend.py --kernel k11 \\
        build/classify_scatter_base.cu [--ablate ballot_scan]
    PYTHONPATH=. python scripts/time_extend.py --kernel k6 \\
        build/classify_scatter_base.cu [--ablate pair --ablate scan ...]

or against the current source with one step of the fast DP's design taken
out (``--ablate unroll``: the step loop not unrolled), written under the
build directory:

    PYTHONPATH=. python scripts/time_extend.py --ablate unroll

K8 (``--kernel k8``) times the current ``csrc/admm_chunk.cu`` against a
baseline source, driven through its own C entry (``admm_chunk_launch``
with the float plan, where the source has no ``admm_chunk_plan_launch``),
its levers' ablations (K8_ABLATIONS), the plain chunk and a CUDA-graph
replay of the plain chunk (a yardstick: the same ~9,000 small launches
without their host overhead, its solve on cuSOLVER, which a graph can
capture), in turns, at 250 steps on ``chip_smoke.admm_case`` buckets
(10, 65536, 4) and (1, 65536, 4), the smallest (1, 4096, 4) and 0/1
(1, 65536, 32) (K8_BITS), and K8_STREAMED's (1, 524288, 4) and
(1, 65536, 32) as a non-0/1 A (the float plan), from the callers' zero
state, every build held to the plain chunk after 1 and 25 steps first
(``chip_smoke.K8_BARS``).  Then the current source at every cluster size
the bits plan could take at each bucket (K8_TABLE), the times behind
ops/admm.py's BITS_CLUSTER:

    git show <commit>:pantax_tpu_torch/csrc/admm_chunk.cu \
        > build/admm_chunk_base.cu
    PYTHONPATH=. python scripts/time_extend.py --kernel k8 \
        build/admm_chunk_base.cu [--ablate regs --ablate push ...]

K9 (``--kernel k9``) and K10b (``--kernel k10b``), the device tail's
stats and polish (``csrc/profile_tail.cu``), time the current source
against a baseline source with the same C entry points, in turns with the
plain version (and for K10b a CUDA-graph replay of the plain polish, a
yardstick), every build held to the plain version first
(``chip_smoke.hold_k9``, ``hold_k10b``): K9 on ``chip_smoke.k9_case``
tables at the smoke DB's size and a community102-like size (held to the
plain version in float64, ``chip_smoke.k9_want``) and on the smoke DB's
paired device tail (SHAPES["k9"]; each line prints ``stats_plan``'s
plan), K10b on ``chip_smoke.polish_case`` buckets (SHAPES["k10b"], and its
crafted edges at K10B_CRAFTED, where instances stop early; each line
prints the sweeps each instance runs and its live columns), beside
``chip_smoke.tail_stats_bound`` and ``polish_bound``.  Given ``--ablate``
(repeatable), each also times the current source without one lever of its
design (K9_ABLATIONS, K10B_ABLATIONS), in the same turns:

    git show <commit>:pantax_tpu_torch/csrc/profile_tail.cu \
        > build/profile_tail_base.cu
    PYTHONPATH=. python scripts/time_extend.py --kernel k9 \
        build/profile_tail_base.cu [--ablate cluster --ablate regs ...]
    PYTHONPATH=. python scripts/time_extend.py --kernel k10b \
        build/profile_tail_base.cu [--ablate stop --ablate candidates ...]

K1 (the default) at the main path's shape (131072 candidates of 160
bases, pad 4) and the long-read seeded pass's (32768 candidates of 512
bases, pad 8), on ``chip_smoke.dp_case`` candidates (read lengths uniform
in [Lr/2, Lr]) over a random text of 30 M bases (the smoke DB's size) with
a sentinel tail, and at the main shape with every read_len 150 (the main
path's reads).  K2 (``--kernel k2``) at the rescue pass's shape (16384
chunks of 512 bases, pad 8, windows of 528), on ``chip_smoke.windows_case``
candidates cut from the same text, once with their ragged lengths and once
with every read_len 512 (rescue chunks are nearly all full), and at
(16384, 160, pad 4) with windows of 168 bytes (rows off 16-byte
boundaries); K1 of the current source is timed on the same candidates (it
fetches the windows from the text itself), and each build's K2 time
against the number of rows is printed (``chip_smoke.k2_scaling``).

K3 (``--kernel k3``) on the smoke DB (``scale_db`` at its defaults, built
under the build directory if absent) with its CHD tables at density 3:
65536 reads of 150 bases at the main path's width (160) and cut to width
152, 131072 mates (the paired query's rows), and 16384 long-read chunks of
512 bases at pad 8, as smoke phase 3b makes them.  Given ``--ablate``
(repeatable) with a baseline, K3 also times the current source with one
lever of its design taken out (K3_ABLATIONS), in the same turns.

K11 (``--kernel k11``) on the dup DB (``dup_db`` at its defaults, built
under the build directory if absent): its first batch of 65536 reads at
the automatic node window (4) and at 3 (a third of the reads overflow),
and interval batches of 16384 rows of 1..L_cap segments at L_cap 8 (phase
3c's), 16, 32 and 64 (the wide rows, one template width each); both
builds' K6 at phase 3c's three shapes on the smoke DB (base, new, new,
base), which shows whether K6 moved.  K6 (``--kernel k6``) on the smoke DB
at phase 3c's three shapes (``chip_smoke.k6_cases``: phase 5's first batch,
the paired [2B] batch, 16384 interval rows of 1-160 segments), every build
on every shape, its levers' ablations (K6_ABLATIONS) in the same turns.
Each build is held to the plain version first (``chip_smoke.hold_scatter``);
``--ablate`` (repeatable) times the current source without its lever
(K11_ABLATIONS, K6_ABLATIONS) as K3's does.  Each reading is 50 launches
on accumulators of its own (``chip_smoke.scatter_ms``); the bound is
``chip_smoke.scatter_bound``.

Both builds' outputs must equal each other's and the plain version's,
bit for bit; then base, new, new, base, ROUNDS times, ITERS launches a
reading (CUDA events, the stream held by a sleep kernel while the host
enqueues the launches: ``chip_smoke.cuda_ms``; for K2 two K1 readings
follow each turn; for K3 every ablated build takes its two turns between
the new build's).  Prints the card's name and power limit, each build's
ptxas registers and main-loop SASS per step (K3: its vote loops'), and one
JSON line per shape: every reading's ms, the bound (``chip_smoke.dp_bound``,
``chip_smoke.seed_bound`` for K3), each build's share of it and the
speedup, both from the medians.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as smoke  # noqa: E402
from pantax_tpu_torch.device import require_cuda  # noqa: E402
from pantax_tpu_torch.ops import (  # noqa: E402
    admm, extend, profile_tail, scatter, seed, tail_kernels,
)
from pantax_tpu_torch.profile import pao  # noqa: E402

# N, Lr, pad, seed, and read_len for every candidate (None: the case's
# ragged lengths; 150: the main path's reads, all of one length; 512: full
# rescue chunks).  K2's windows are Lr + 2*pad wide.
SHAPES = {
    "k1": ((131072, 160, 4, 1, None), (32768, 512, 8, 6, None),
           (131072, 160, 4, 1, 150)),
    "k2": ((16384, 512, 8, 4, None), (16384, 512, 8, 4, 512),
           (16384, 160, 4, 3, None)),
    # K3: B, code width, pad, and the rows (the short reads, the paired
    # query's mates, long-read chunks)
    "k3": ((65536, 160, 4, "short"), (65536, 152, 4, "short"),
           (131072, 160, 4, "paired"), (16384, 512, 8, "long")),
    # K6: chip_smoke.k6_cases' rows on the smoke DB
    "k6": ("main", "paired", "intervals"),
    # K11: the rows and the node window (None: the automatic one)
    "k11": (("main", None), ("L3", 3), ("intervals", 8), ("intervals", 16),
            ("intervals", 32), ("intervals", 64)),
    # K8: (S, n_pad, p_pad) at K8_STEPS steps: the smoke's device-tail
    # bucket and one of its instances alone
    "k8": ((10, 65536, 4), (1, 65536, 4)),
    # K9: chip_smoke.k9_case's (G, S, nodes, trios) at the smoke DB's size
    # (30 haps of 10 species, the last of S without nodes; N_pad 524288)
    # and community102-like (102 haps of 34 species: the smoke DB's counts
    # scaled by 34/10, an estimate, not a measured database); then the
    # smoke DB's paired device tail (phase 8's pairs fed on the card)
    "k9": ((30, 11, 524192, 500_000), (102, 35, 1_782_000, 1_700_000),
           "paired"),
    # K10b: (S, n_pad, p_pad) of chip_smoke.polish_case: the smoke's
    # device-tail bucket, the smallest, wide rows and the residuals in
    # global memory
    "k10b": ((10, 65536, 4), (1, 4096, 4), (1, 65536, 32), (1, 524288, 4)),
}
# K8's bits plan past the smoke's bucket: the smallest bucket and wide
# 0/1 rows
K8_BITS = ((1, 4096, 4), (1, 65536, 32))
# K8's streamed plan (rows read from L2 every step): the host tail's
# largest singleton bucket (500,000 sampled nodes) and wide rows of a
# non-0/1 A
K8_STREAMED = ((1, 524288, 4), (1, 65536, 32))
# the bits plan's cluster sizes timed at each bucket: (S, p_pad) by n_pad
K8_TABLE = ((1, 4), (10, 4), (1, 32))
KERNELS = {"k1": "banded_extend_kernel", "k2": "banded_extend_windows_kernel",
           "k3": "seed_stage_kernel", "k6": "classify_scatter_ranges_kernel",
           "k11": "classify_scatter_kernel", "k8": "admm_chunk_kernel",
           "k9": "tail_stats_kernel", "k10b": "polish_kernel"}
K8_STEPS = 250  # the solvers' chunk
TEXT_LEN = 30_000_000
ITERS = 200  # launches per timed reading
ROUNDS = 3  # base, new, new, base this many times
# one step of the fast DP's design taken out: (text in the source, its
# replacement)
ABLATIONS = {
    "unroll": [("#pragma unroll\n    for (int s = 0; s < kChunk; ++s) {",
                "#pragma unroll 1\n    for (int s = 0; s < kChunk; ++s) {")],
}
# K3's levers, each taken out of csrc/seed_stage.cu: "rehash" hashes each
# selected seed again from its k codes (no sampled hash kept);
# "exact_band" runs every vote with the -2^31 test (no span check); "carry"
# adds the band test's bool (no borrow-and-carry pair)
K3_ABLATIONS = {
    "rehash": [
        ("                hs[p] = h;\n", ""),
        ("            seeds[rank] = make_int4(ps, static_cast<int>(hs[ps]), 0, 0);",
         "            uint32_t f = 0, g = 0, pk = 1;\n"
         "            for (int t = 0; t < k; ++t) {\n"
         "                const uint32_t c = code_of(cs[ps + t]);\n"
         "                f = f * kBase + c;\n"
         "                g += (3u - c) * pk;\n"
         "                pk *= kBase;\n"
         "            }\n"
         "            seeds[rank] = make_int4(ps, static_cast<int>(\n"
         "                mix32(f < g ? f : g)), 0, 0);"),
    ],
    "exact_band": [("    const bool wrap =\n", "    const bool wrap = true ||\n")],
    "carry": [("""        asm("{\\n\\t.reg .u32 t;\\n\\tsub.cc.u32 t, %1, %2;\\n\\t"
            "addc.u32 %0, %0, 0;\\n\\t}"
            : "+r"(cnt) : "r"(band2), "r"(u));""",
               "        cnt += u <= band2;")],
}


# K11's lever, taken out of csrc/classify_scatter.cu: without "ballot_scan"
# every lane counts the start scan one start after another (no ballot)
K11_ABLATIONS = {
    "ballot_scan": [
        ("    const int n_more = start_scan<G, S>(t, i0, te1, L_cap, lane, "
         "tmask);\n",
         "    int n_more = 0;\n"
         "    while (n_more < L_cap && (i0 + n_more + 1 < t.M\n"
         "               ? __ldg(t.tstart + i0 + n_more + 1) : INT_MAX) <= te1)\n"
         "        ++n_more;\n"),
    ],
}


# K6's levers, each taken out of csrc/classify_scatter.cu: without "pair"
# one thread takes both ends of a read (their searches in the same rounds);
# without "scan" every end takes the bisection, then its record; without
# "packed" a record's fields come from the separate arrays, a load each
# (tstart, tnode, trio_seg twice; nodes_len and base_offset after the
# node); without "node_copy" only the node's fields do; without
# "interleave" the haplotype search and the live test come before the
# ends' searches
K6_ABLATIONS = {
    "pair": [("constexpr int kLanes = 2;", "constexpr int kLanes = 1;")],
    "scan": [("        if (n >= 0 && n <= fits) {",
              "        if (false) {")],
    "packed": [
        ("    return __ldg(&t.seg_rec[2 * i].x);\n",
         "    return __ldg(t.tstart + i);\n"),
        ("    return __ldg(t.seg_rec + 2 * i);\n",
         "    return make_int4(__ldg(t.tstart + i), __ldg(t.tnode + i),\n"
         "                     __ldg(t.trio_seg + i),\n"
         "                     i >= 2 ? __ldg(t.trio_seg + i - 2) : -1);\n"),
        ("    return __ldg(t.seg_rec + 2 * i + 1);\n",
         "    return make_int4(__ldg(&t.seg_rec[2 * i + 1].x),\n"
         "                     __ldg(t.nodes_len + head.y - 1),\n"
         "                     __ldg(t.base_offset + head.y - 1), 0);\n"),
    ],
    "node_copy": [
        ("    return __ldg(t.seg_rec + 2 * i + 1);\n",
         "    return make_int4(__ldg(&t.seg_rec[2 * i + 1].x),\n"
         "                     __ldg(t.nodes_len + head.y - 1),\n"
         "                     __ldg(t.base_offset + head.y - 1), 0);\n"),
    ],
    "interleave": [
        ("    const int ts = ts_[r], te = te_[r];\n    // this lane's ends",
         "    const int ts = ts_[r], te = te_[r];\n"
         "    {\n"
         "        const int first = __ldg(t.hap_range + haplotype(t, ts));\n"
         "        if (first < 0 || te <= ts) {\n"
         "            if (lane == 0) ridx_out[r] = first;\n"
         "            return;\n"
         "        }\n"
         "    }\n"
         "    // this lane's ends"),
    ],
}


# K8's levers, each taken out of csrc/admm_chunk.cu's bits plan: without
# "regs" the rows' b and c sit in shared memory at p 4 too (the bits stay
# in registers); without "mbar" the CTAs' pushed sums are waited for by a
# cluster barrier a step, not by each CTA's barrier counting their bytes;
# without "push" each CTA writes its sums into its own slot and every warp
# reads the other CTAs' through distributed shared memory after a cluster
# barrier (a pull); without "cluster" every bucket takes a cluster of 8
_K8_WAIT = ("        mbar_wait(bar + (k & 1), (k >> 1) & 1);\n"
            "        if (tid == 0) mbar_expect(bar + (k & 1), slot_bytes);")
_K8_PUSH = "                st_async(sl + rank * PC + c, bar + parity, lane, t);"
K8_ABLATIONS = {
    "regs": [("__host__ __device__ constexpr bool rows_in_registers(int pc) "
              "{\n    return pc == 4;\n}",
              "__host__ __device__ constexpr bool rows_in_registers(int pc) "
              "{\n    return false;\n}")],
    "mbar": [(_K8_WAIT, "        cluster.sync();"),
             (_K8_PUSH, "                cluster.map_shared_rank(sl, lane)"
                        "[rank * PC + c] = t;")],
    "push": [
        (_K8_WAIT, "        cluster.sync();"),
        ("        auto slot_of = [&](int r) -> const float* "
         "{ return sl + r * PC; };",
         "        auto slot_of = [&](int r) -> const float* {\n"
         "            return cluster.map_shared_rank(sl, r) + r * PC;\n"
         "        };"),
        ("            if (lane < C)  // slot `rank` of every CTA in the "
         "cluster\n" + _K8_PUSH,
         "            if (lane == 0) sl[rank * PC + c] = t;  // its own slot"),
    ],
    "cluster": [("    const int C = cluster, T = threads, R = rpt;",
                 "    const int C = bits ? kBitsCluster : cluster;\n"
                 "    const int T = bits ? (n / C < kMaxThreads ? n / C : "
                 "kMaxThreads) : threads;\n"
                 "    const int R = bits ? n / (C * T) : rpt;")],
}


# K10b's levers, each taken out of csrc/profile_tail.cu: without "stop"
# every instance runs every sweep; without "candidates" no bin's keys are
# pushed (every selection takes three rounds over all rows); without
# "registers" r and the live bits stay in shared memory; without "rank"
# the last candidates take radix rounds to the last bit (none ranked)
_K10B_REGS = ("(rows == 4 * kPolishThreads || rows == kRegRows * "
              "kPolishThreads)")
K10B_ABLATIONS = {
    "stop": [("        if (!moved) break;  // every later sweep would "
              "repeat this one\n", "")],
    "candidates": [("    L->cap = static_cast<int>(cap);",
                    "    L->cap = 0;")],
    "registers": [(f"    return p <= 32 && {_K10B_REGS}",
                   f"    return false && {_K10B_REGS}")],
    "rank": [("constexpr int kRankSelect = 256;",
              "constexpr int kRankSelect = 0;")],
}
# K9's levers, each taken out of csrc/profile_tail.cu: without "cluster" a
# CTA takes a hap or a species alone (16 trio values a thread in
# registers); without "regs" a hap's trio values are gathered again from
# L2 in passes 2 and 3; with "path_late" the path's gathers are issued
# after the third trio pass
K9_ABLATIONS = {
    "cluster": [("constexpr bool kStatsCluster = true;",
                 "constexpr bool kStatsCluster = false;")],
    "regs": [("constexpr bool kKeepTrios = true;",
              "constexpr bool kKeepTrios = false;")],
    "path_late": [("constexpr bool kPathEarly = true;",
                   "constexpr bool kPathEarly = false;")],
}
# K10b's crafted buckets timed beside SHAPES["k10b"]: the edges of
# chip_smoke.polish_case, where instances stop early
K10B_CRAFTED = ((6, 65536, 4),)


def ablated_source(name: str, kernel: str | None = None) -> Path:
    """The current source with ABLATIONS[name] (K1's), K3_ABLATIONS[name]
    (K3's), K6_ABLATIONS[name] (K6's), K11_ABLATIONS[name] (K11's),
    K8_ABLATIONS[name] (K8's), K9_ABLATIONS[name] (K9's, where ``kernel``
    is "k9": K8 and K9 share lever names) or K10B_ABLATIONS[name] (K10b's)
    applied, written under the build directory."""
    path, table = ((tail_kernels._SRC, K9_ABLATIONS) if kernel == "k9"
                   else (seed._SRC, K3_ABLATIONS) if name in K3_ABLATIONS
                   else (admm._SRC, K8_ABLATIONS) if name in K8_ABLATIONS
                   else (tail_kernels._SRC, K10B_ABLATIONS)
                   if name in K10B_ABLATIONS
                   else (scatter._SRC, K6_ABLATIONS)
                   if name in K6_ABLATIONS
                   else (scatter._SRC, K11_ABLATIONS)
                   if name in K11_ABLATIONS else (extend._SRC, ABLATIONS))
    src = path.read_text()
    for old, new in table[name]:
        if old not in src:
            raise ValueError(f"ablation {name}: {old!r} not in {path}")
        src = src.replace(old, new)
    out = extend.build_dir() / "kernels" / f"{path.stem}_no_{name}.cu"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(src)
    return out


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("baseline", nargs="?", help="the baseline .cu source")
    ap.add_argument("--ablate", action="append",
                    choices=sorted(ABLATIONS) + sorted(K3_ABLATIONS)
                    + sorted(K6_ABLATIONS) + sorted(K11_ABLATIONS)
                    + sorted(K8_ABLATIONS) + sorted(K9_ABLATIONS)
                    + sorted(K10B_ABLATIONS),
                    help="time the current source without this step instead "
                         "(K3, K6, K11, K8, K9, K10b: as well, repeatable)")
    ap.add_argument("--kernel", choices=sorted(SHAPES), default="k1",
                    help="K1 (text + w0), K2 (windows given), K3 (the seed "
                         "stage), K6 (the range classify + scatter), K11 "
                         "(the windowed classify + scatter), K8 (the ADMM "
                         "chunk), K9 (the device tail's stats) or K10b (its "
                         "polish); default k1")
    args = ap.parse_args(argv)
    mine = {"k3": K3_ABLATIONS, "k6": K6_ABLATIONS, "k11": K11_ABLATIONS,
            "k8": K8_ABLATIONS, "k9": K9_ABLATIONS,
            "k10b": K10B_ABLATIONS}.get(args.kernel, ABLATIONS)
    if any(a not in mine for a in args.ablate or ()):
        ap.error(f"--ablate for {args.kernel}: one of {sorted(mine)}")
    if args.kernel in ("k3", "k6", "k11", "k8", "k9", "k10b"):
        if args.baseline is None:
            ap.error(f"{args.kernel.upper()} takes a baseline source")
    elif (args.baseline is None) == (args.ablate is None) or len(
            args.ablate or ()) > 1:
        ap.error("give a baseline source or one --ablate, not both")
    return args


def check_equal(outs, plain, what: str) -> None:
    for k, p, out in zip(outs, plain, ("score", "start", "end", "matches")):
        if not torch.equal(k, p):
            raise AssertionError(f"{what} != plain on {out}")


def k3_cases(dev):
    """K3's arguments at each SHAPES["k3"] shape, over the smoke DB's CHD
    tables at density 3, as smoke phase 3b makes them."""
    from pantax_tpu_torch import _host
    from pantax_tpu_torch.align.long_read import LONG_READ_PRESETS
    from pantax_tpu_torch.benchmarks import scale_db, simulate_read_batch
    from pantax_tpu_torch.convert import aligner_from_reference

    db = scale_db(str(extend.build_dir() / "scale_db"))
    index = _host.build_align_index(db)
    aligner = aligner_from_reference(index, _host.AlignConfig(), dev)
    long_al = aligner_from_reference(
        index, _host.AlignConfig.for_read_type("long"), dev)
    cases = []
    for B, L, pad, rows in SHAPES["k3"]:
        if rows == "short":
            codes, lens, _ = simulate_read_batch(index, B, 150, 0.01, seed=3)
            if L < 160:
                codes = np.ascontiguousarray(codes[:, :L - 2])
                lens = np.minimum(lens, L - 2)
            args = smoke.seed_args(aligner, codes, lens)
        elif rows == "paired":
            (c1, l1, c2, l2), _ = smoke.simulate_pairs(index, B // 2, seed=17)
            args = smoke.seed_args(aligner, np.concatenate([c1, c2]),
                                   np.concatenate([l1, l2]))
        else:
            chunk = LONG_READ_PRESETS[smoke.READ_TYPE]
            codes, lens, _ = simulate_read_batch(index, B, chunk, 0.01,
                                                 seed=19)
            args = smoke.seed_args(long_al, codes, lens)
        if tuple(args[0].shape) != (B, L) or args[-1][7] != pad:
            raise AssertionError(f"K3 case {rows}: {tuple(args[0].shape)} "
                                 f"pad {args[-1][7]}, not ({B}, {L}) pad {pad}")
        cases.append((rows, args))
    return cases


def build_turns(args, build, default_src, notes=lambda lib: "") -> dict:
    """The baseline's, the current source's and each ablated source's
    builds by name ("base", "new", "no_<lever>"), one nvcc each at once,
    each printed with its ptxas lines and ``notes(lib)``."""
    from concurrent.futures import ThreadPoolExecutor

    srcs = {"base": Path(args.baseline), "new": None}
    srcs.update((f"no_{a}", ablated_source(a, args.kernel))
                for a in args.ablate or ())
    with ThreadPoolExecutor(len(srcs)) as pool:
        built = {name: pool.submit(build, src) for name, src in srcs.items()}
    libs = {name: f.result() for name, f in built.items()}
    for name, src in srcs.items():
        print(f"{name}: {src or default_src}\n  " + "\n  ".join(
            smoke.ptxas_lines(libs[name].build_log)) + notes(libs[name]),
            flush=True)
    return libs


def time_in_turns(libs: dict, reading, line: dict, bound: float,
                  by: str) -> None:
    """Time ``reading(lib)`` (ms) for each build of ``libs`` in turns
    (base, new, the ablations, the ablations backwards, new, base; ROUNDS
    times) and print ``line`` with every reading, the bound, each build's
    share of it, the speedup and each ablation against the new build, all
    from the medians."""
    others = [n for n in libs if n not in ("base", "new")]
    ms = {name: [] for name in libs}
    for _ in range(ROUNDS):
        for name in ["base", "new", *others, *others[::-1], "new", "base"]:
            ms[name].append(reading(libs[name]))
    med = {k: float(np.median(v)) for k, v in ms.items()}
    line.update({f"{k}_ms": v for k, v in ms.items()})
    line.update({"bound_ms": bound, "bound_by": by})
    line.update({f"{k}_share": bound / med[k] for k in ms})
    line["speedup"] = med["base"] / med["new"]
    line.update({f"{k}_vs_new": med[k] / med["new"] for k in others})
    print(json.dumps(line), flush=True)


def main_k3(args, dev, issue_peak: float) -> None:
    """K3: the baseline, the current source and its ablations in turns."""
    libs = build_turns(args, seed.build_seed_kernel, seed._SRC, lambda lib: (
        "\n  K3 vote loop SASS: " + json.dumps(smoke.vote_sass(lib._name))))
    for rows, case in k3_cases(dev):
        B, L = case[0].shape
        plain = seed.seed_candidates_plain(*case)
        for name, lib in libs.items():
            outs = seed.launch_k3(lib, *case)
            for o, p, out in zip(outs, plain, ("cand_diag", "cand_votes",
                                               "strand")):
                if o.dtype != p.dtype or not torch.equal(o, p):
                    raise AssertionError(f"{name} K3 != plain on {out} at "
                                         f"B={B} L={L} ({rows})")
        hits = smoke.valid_hits(case).double()
        time_in_turns(
            libs, lambda lib: smoke.cuda_ms(
                lambda: seed.launch_k3(lib, *case), ITERS, hold=True),
            {"B": B, "L": L, "pad": case[-1][7], "rows": rows,
             "valid_hits_mean": float(hits.mean()),
             "rows_over_32_hits": float((hits > 32).double().mean())},
            *smoke.seed_bound(case, issue_peak))


def scatter_cases(dev, kernel: str) -> list:
    """K6's rows at phase 3c's three shapes on the smoke DB (SHAPES["k6"])
    and, for K11, its rows at each SHAPES["k11"] shape on the dup DB first,
    as smoke phases 3c and 9 make them: [(kernel, tag, cols, node window,
    (tables, tstart, tnode))]."""
    from pantax_tpu_torch import _host
    from pantax_tpu_torch.benchmarks import (
        dup_db, scale_db, simulate_read_batch)
    from pantax_tpu_torch.convert import aligner_from_reference
    from pantax_tpu_torch.ops.fused import (
        auto_node_window, build_fused_tables)

    cases = []
    dbs = (("dup_db", dup_db),) if kernel == "k11" else ()
    for name, make in dbs + (("scale_db", scale_db),):
        db = make(str(extend.build_dir() / name))
        index = _host.build_align_index(db)
        cfg = _host.AlignConfig()
        aligner = aligner_from_reference(index, cfg, dev)
        tab = (build_fused_tables(db, index, dev), aligner.tstart,
               aligner.tnode)
        codes, lens, _ = simulate_read_batch(index, smoke.BATCH, 150, 0.01,
                                             seed=3)
        if name == "scale_db":
            k6 = smoke.k6_cases(aligner, index, codes, lens, dev)
            if tuple(c[0] for c in k6) != SHAPES["k6"]:
                raise AssertionError(f"K6's cases {[c[0] for c in k6]}")
            cases += [("K6", tag, cols, None, tab) for tag, cols, _, _ in k6]
            continue
        auto = auto_node_window(index, codes.shape[1], cfg.extension_band)
        main = smoke.query_cols(aligner, codes, lens)
        for tag, cap in SHAPES["k11"]:
            cols = main if tag != "intervals" else tuple(
                torch.from_numpy(a).to(dev) for a in smoke.interval_batch(
                    index, smoke.LONG_BATCH, cap, seed_=29))
            cases.append(("K11", tag, cols, cap or auto, tab))
    return cases


def main_scatter(args, dev) -> None:
    """K6 or K11 (``args.kernel``): the baseline, the current source and
    its ablations in turns; with K11 both builds' K6 in turns (base, new,
    new, base)."""
    libs = build_turns(args, scatter.build_scatter_kernels, scatter._SRC)
    for kernel, tag, cols, cap, tab in scatter_cases(dev, args.kernel):
        mine = libs if kernel == args.kernel.upper() else {
            k: libs[k] for k in ("base", "new")}
        for name, lib in mine.items():
            smoke.hold_scatter(cols, *tab, f"({name} build, {tag})", cap,
                               lib=lib)
        bound, by, work = smoke.scatter_bound(cols, *tab, cap)
        time_in_turns(
            mine, lambda lib: smoke.scatter_ms(cols, *tab, cap, lib=lib),
            {"kernel": kernel, "case": tag, "L_cap": cap,
             "B": int(cols[0].shape[0]), "work": work}, bound, by)


def plain_chunk_graph(args8, steps: int):
    """A CUDA graph of the plain chunk of ``steps`` steps on ``args8``
    (captured after a warm-up on a side stream), or the capture's error.
    Its cholesky_solve goes to cuSOLVER: MAGMA's batched solve, which
    PyTorch picks for a batch of more than one, allocates device memory
    and cannot be captured."""
    library = torch.backends.cuda.preferred_linalg_library()
    torch.backends.cuda.preferred_linalg_library("cusolver")
    try:
        return smoke.graph_of(
            lambda: pao._admm_chunk_batch_plain(*args8, steps))
    finally:
        torch.backends.cuda.preferred_linalg_library(library)


def k8_launch(lib, args8, steps: int, binary: bool, plan=None):
    """One uncounted launch of any build of K8 on admm_args' ``args8``:
    through ``admm_chunk_plan_launch`` with ``plan`` (default
    admm.launch_plan's for ``binary``), or, for a source without it,
    through its own ``admm_chunk_launch`` with the float plan (a cluster
    of 8).  Returns ((x, z, w, uz, uw), res)."""
    A, b, ub, rho, state, L = args8
    S, n, p = A.shape
    outs = tuple(torch.empty_like(t) for t in state)
    res = torch.empty(S, dtype=torch.float32, device=A.device)
    ptrs = (A.data_ptr(), b.data_ptr(), ub.data_ptr(), state[1].data_ptr(),
            state[2].data_ptr(), state[3].data_ptr(), state[4].data_ptr(),
            L.data_ptr(), *L.stride(), S, n, p, steps, 1.0 / (n * rho))
    tail = (*(t.data_ptr() for t in outs), res.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    try:
        entry = lib.admm_chunk_plan_launch
    except AttributeError:
        pl = admm.launch_plan(S, n, p)
        rc = lib.admm_chunk_launch(*ptrs, pl.threads, pl.rows_per_thread,
                                   int(pl.on_chip), *tail)
    else:
        pl = plan or admm.launch_plan(S, n, p, binary)
        rc = entry(*ptrs, pl.cluster, pl.threads, pl.rows_per_thread,
                   int(pl.on_chip), int(pl.bits), *tail)
    if rc != 0:
        raise RuntimeError(f"K8 launch failed: CUDA error {rc}")
    return outs, res


def k8_held(lib, args8, binary: bool, what: str) -> dict:
    """A build of K8 against the plain chunk after each K8_BARS step count
    (every state vector and res within its bar); the largest
    differences by step count."""
    errs = {}
    for steps, bar in smoke.K8_BARS.items():
        got = k8_launch(lib, args8, steps, binary)
        want = pao._admm_chunk_batch_plain(*args8, steps)
        errs[steps] = max(float((g - w).abs().max()) for g, w in
                          zip((*got[0], got[1]), (*want[0], want[1])))
        if not errs[steps] <= bar:
            raise AssertionError(f"K8 {what}: {errs[steps]:.3g} from the "
                                 f"plain chunk after {steps} steps (bar "
                                 f"{bar})")
    return errs


def main_k8(args, dev, issue_peak: float) -> None:
    """K8: the baseline, the current source, its ablations, the plain
    chunk and its graph replay in turns at each SHAPES["k8"], K8_BITS and
    K8_STREAMED bucket, K8_STEPS steps from the zero state; then the
    current source at each cluster size of K8_TABLE."""
    libs = build_turns(args, compile_k8, admm._SRC)
    cases = ([(shape, True) for shape in (*SHAPES["k8"], *K8_BITS)]
             + [(shape, False) for shape in K8_STREAMED])
    for (S, n, p), binary in cases:
        args8 = smoke.admm_args(smoke.admm_case(S + n + p, S, n, p, False),
                                dev)
        what = f"at ({S}, {n}, {p}){' 0/1' if binary else ''}"
        errs = {name: k8_held(lib, args8, binary, f"{name} {what}")
                for name, lib in libs.items()}
        graph, why = plain_chunk_graph(args8, K8_STEPS)
        turns = dict(libs, plain="plain")
        if graph is not None:
            turns["graph"] = "graph"

        def reading(lib):
            if lib == "plain":
                return smoke.cuda_ms(lambda: pao._admm_chunk_batch_plain(
                    *args8, K8_STEPS), 3)
            if lib == "graph":
                return smoke.cuda_ms(graph.replay, 5)
            return smoke.cuda_ms(lambda: k8_launch(lib, args8, K8_STEPS,
                                                   binary), 20, hold=True)

        bound, by, work = smoke.admm_bound(S, n, p, K8_STEPS, issue_peak)
        line = {"kernel": "K8", "S": S, "n_pad": n, "p_pad": p,
                "binary": binary, "steps": K8_STEPS,
                "plan": str(admm.launch_plan(S, n, p, binary)),
                "errs": errs, "card": smoke.card_line(), "work": work}
        if graph is None:
            line["graph_error"] = why
        time_in_turns(turns, reading, line, bound, by)
    new = libs["new"]
    for S, p in K8_TABLE:
        for n in sorted(admm.BITS_CLUSTER):
            args8 = smoke.admm_args(smoke.admm_case(S + n + p, S, n, p,
                                                    False), dev)
            for cluster in (1, 2, 4, 8):
                threads = min(admm.MAX_THREADS, n // cluster)
                rpt = n // (cluster * threads)
                if rpt not in ((1, 2, 4, 8) if p == 4 else (4, 8)):
                    continue
                plan = admm.AdmmPlan(cluster, threads, rpt, True, 0, True)
                got = k8_launch(new, args8, 1, True, plan)
                want = pao._admm_chunk_batch_plain(*args8, 1)
                err = max(float((g - w).abs().max()) for g, w in
                          zip((*got[0], got[1]), (*want[0], want[1])))
                if not err <= smoke.K8_STEP_BAR:
                    raise AssertionError(f"K8 cluster {cluster} at ({S}, "
                                         f"{n}, {p}): {err:.3g}")
                ms = [smoke.cuda_ms(lambda: k8_launch(
                    new, args8, K8_STEPS, True, plan), 20, hold=True)
                    for _ in range(2 * ROUNDS)]
                print(json.dumps({
                    "kernel": "K8", "table": True, "S": S, "n_pad": n,
                    "p_pad": p, "cluster": cluster, "threads": threads,
                    "rows_per_thread": rpt, "step_err": err,
                    "chosen": admm.launch_plan(S, n, p, True).cluster
                    == cluster, "ms": ms,
                    "median_ms": float(np.median(ms))}), flush=True)


def main_tail(args, dev, issue_peak: float) -> None:
    """K9 or K10b: the baseline and the current source in turns with the
    plain version (and for K10b a CUDA-graph replay of the plain polish,
    a yardstick), at each SHAPES shape, each build held to the plain
    version first (chip_smoke.hold_k9, hold_k10b)."""
    libs = build_turns(args, tail_kernels.build_tail_kernels,
                       tail_kernels._SRC)
    cases = [(shape, False) for shape in SHAPES[args.kernel]]
    if args.kernel == "k10b":
        cases += [(shape, True) for shape in K10B_CRAFTED]
    for shape, crafted in cases:
        line = {"kernel": args.kernel.upper(), "card": smoke.card_line()}
        if args.kernel == "k9":
            if shape == "paired":
                targs, kw = k9_paired_case(dev)
            else:
                targs, kw = smoke.k9_case(sum(shape), dev, *shape)
            na, ta, bc, _trio_hap, path_node = targs[:5]
            G, S, order = kw["G"], kw["S"], kw["order"]
            for name, lib in libs.items():
                smoke.hold_k9(targs, kw, f"{name} at {shape}", lib,
                              exact=shape != "paired")

            def run(lib):
                return tail_kernels.launch_k9(na, ta, bc, path_node, order,
                                              targs[7], G=G, S=S, lib=lib)

            def plain():
                return profile_tail.tail_stats_plain(*targs, G=G, S=S)

            bound, by, work = smoke.tail_stats_bound(path_node, order, G, S)
            line.update(shape=shape, G=G, S=S, N_pad=na.numel(),
                        trios=order[0].numel(), path_nodes=path_node.numel(),
                        plan=str(tail_kernels.stats_plan(
                            G, S, order[0].numel())), work=work)
            graph = None
        else:
            S, n, p = shape
            pargs = [torch.from_numpy(a).to(dev)
                     for a in smoke.polish_case(sum(shape), *shape, crafted)]
            for name, lib in libs.items():
                smoke.hold_k10b(pargs, f"{name} at {shape}", lib=lib)

            def run(lib):
                return tail_kernels.launch_k10b(*pargs, lib=lib)

            def plain():
                return profile_tail.polish_batch_plain(*pargs)

            graph, why = smoke.graph_of(plain)
            bound, by, work = smoke.polish_bound(S, n, p, 8, issue_peak)
            line.update(S=S, n_pad=n, p_pad=p, sweeps=8, crafted=crafted,
                        plan=str(tail_kernels.polish_plan(S, n, p)),
                        sweeps_run=smoke.sweeps_run(pargs),
                        live_columns=smoke.live_columns(pargs[0]),
                        work=work)
            if graph is None:
                line["graph_error"] = why
        turns = dict(libs, plain="plain")
        if graph is not None:
            turns["graph"] = "graph"

        def reading(lib):
            if lib == "plain":
                return smoke.cuda_ms(plain, 3)
            if lib == "graph":
                return smoke.cuda_ms(graph.replay, 5)
            return smoke.cuda_ms(lambda: run(lib), 20, hold=True)

        time_in_turns(turns, reading, line, bound, by)


def k9_paired_case(dev) -> tuple:
    """K9's arguments on the smoke DB's paired device tail: phase 8's
    pairs (chip_smoke.simulate_pairs, seed 13) fed on the card over the
    smoke DB (built under the build directory if absent), the coverage
    and tail tables as dispatch_tail_stats gets them."""
    from pantax_tpu_torch import _host
    from pantax_tpu_torch.benchmarks import scale_db
    from pantax_tpu_torch.convert import aligner_from_reference
    from pantax_tpu_torch.ops.fused import (
        FusedPipeline, _ensure_tail_tables, build_fused_tables,
    )

    db = scale_db(str(extend.build_dir() / "scale_db"))
    index = _host.build_align_index(db)
    aligner = aligner_from_reference(index, _host.AlignConfig(), dev)
    tables = build_fused_tables(db, index, dev)
    pipe = FusedPipeline(aligner, tables, smoke.PAIR_BATCH)
    pairs, _hap = smoke.simulate_pairs(index, smoke.N_PAIRS, seed=13)
    pipe.feed_paired(*pairs)
    r = pipe.finish()
    return smoke.k9_args(_ensure_tail_tables(tables), r.na_d, r.ta_d, r.bc_d,
                         _host.ProfilingConfig.for_read_type("short")
                         .min_depth)


def compile_k8(src):
    """Build K8 from ``src`` (None: the current source) and set the
    argument types of its C entry, the current one or a baseline's."""
    import ctypes
    lib = extend.compile_kernels(src or admm._SRC)
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    head = [vp] * 8 + [i64] * 3 + [i32] * 4 + [ctypes.c_float]
    try:
        lib.admm_chunk_plan_launch.argtypes = head + [i32] * 5 + [vp] * 7
    except AttributeError:
        lib.admm_chunk_launch.argtypes = head + [i32] * 3 + [vp] * 7
    return lib


def main() -> None:
    args = parse_args()
    dev = require_cuda()
    print(smoke.card_line())
    if args.kernel in ("k6", "k11"):
        main_scatter(args, dev)
        return
    issue_peak = smoke.issue_ops_per_s()
    if args.kernel == "k8":
        main_k8(args, dev, issue_peak)
        return
    if args.kernel in ("k9", "k10b"):
        main_tail(args, dev, issue_peak)
        return
    if args.kernel == "k3":
        main_k3(args, dev, issue_peak)
        return
    base = args.baseline or ablated_source(args.ablate[0])
    kname = KERNELS[args.kernel]
    libs = {}
    for name, src in (("new", None), ("base", base)):
        libs[name] = extend.build_kernels(src)
        regs = smoke.ptxas_lines(libs[name].build_log)
        sass = {f"pad{pad}": smoke.step_sass(libs[name]._name, 2 * pad, kname)
                for pad in (4, 8)}
        print(f"{name}: {src or extend._SRC}\n  " + "\n  ".join(regs)
              + f"\n  {args.kernel.upper()} main step loop SASS: "
              + json.dumps(sass))

    rng = np.random.default_rng(0)
    text_np = np.concatenate([rng.integers(0, 4, size=TEXT_LEN, dtype=np.int8),
                              np.full(1024, 4, np.int8)])
    text = torch.from_numpy(text_np).to(dev)
    consts = (smoke.MATCH, smoke.MISMATCH, smoke.GAP)
    for N, Lr, pad, seed, fixed_len in SHAPES[args.kernel]:
        if args.kernel == "k1":
            case = [torch.from_numpy(a).to(dev)
                    for a in smoke.dp_case(text_np, N, Lr, pad, seed)]
            w0 = case[0]
        else:
            w0, *case = smoke.windows_case(text_np, dev, N, Lr, pad, seed)
        if fixed_len is not None:
            case[-1][:] = fixed_len
        k1_args = (text, w0, *case[-2:])

        def run(name):
            if args.kernel == "k1":
                return extend.launch_k1(libs[name], text, *case, pad, *consts)
            return extend.launch_k2(libs[name], *case, pad, *consts)

        def run_k1():
            return extend.launch_k1(libs["new"], *k1_args, pad, *consts)

        if args.kernel == "k1":
            plain = extend.banded_extend_plain(text, *case, pad, *consts)
        else:
            plain = extend.banded_extend_windows_plain(*case, pad, *consts)
            check_equal(run_k1(), plain, f"K1 at N={N} Lr={Lr} pad={pad}")
        for name in libs:
            check_equal(run(name), plain, f"{name} {args.kernel.upper()} at "
                        f"N={N} Lr={Lr} pad={pad}")
        ms = {"base": [], "new": [], "k1": []}
        for _ in range(ROUNDS):
            for name in ("base", "new", "new", "base"):
                ms[name].append(smoke.cuda_ms(lambda: run(name), ITERS,
                                              hold=True))
            if args.kernel == "k2":
                ms["k1"] += [smoke.cuda_ms(run_k1, ITERS, hold=True)
                             for _ in range(2)]
        bound, by = smoke.dp_bound(case[-1].cpu().numpy(), Lr, pad, issue_peak)
        med = {k: float(np.median(v)) for k, v in ms.items() if v}
        line = {"N": N, "Lr": Lr, "pad": pad,
                "read_len": fixed_len or "ragged"}
        if args.kernel == "k2":
            line["W"] = case[0].shape[1]
        line.update({
            "base_ms": ms["base"], "new_ms": ms["new"], "bound_ms": bound,
            "bound_by": by, "base_share": bound / med["base"],
            "new_share": bound / med["new"],
            "speedup": med["base"] / med["new"],
        })
        if args.kernel == "k2":
            line.update(k1_ms=ms["k1"], k1_share=bound / med["k1"])
        print(json.dumps(line), flush=True)
    if args.kernel == "k2":
        for name in ("base", "new"):
            smoke.k2_scaling(text_np, dev, 512, 8, libs[name], f" ({name})")


if __name__ == "__main__":
    main()
