#!/usr/bin/env python3
"""Time two builds of K1 (``banded_extend_launch``) or K2
(``banded_extend_windows_launch``) on one GPU, in turns: the current
``csrc/banded_extend.cu`` and a baseline source with the same C entry
points, such as an earlier commit's:

    git show <commit>:pantax_tpu_torch/csrc/banded_extend.cu \\
        > build/banded_extend_base.cu
    PYTHONPATH=. python scripts/time_extend.py build/banded_extend_base.cu
    PYTHONPATH=. python scripts/time_extend.py --kernel k2 \\
        build/banded_extend_base.cu

or against the current source with one step of the fast DP's design taken
out (``--ablate unroll``: the step loop not unrolled), written under the
build directory:

    PYTHONPATH=. python scripts/time_extend.py --ablate unroll

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

Both builds' four outputs must equal each other's and the plain version's,
bit for bit; then base, new, new, base, ROUNDS times, ITERS launches a
reading (CUDA events, the stream held by a sleep kernel while the host
enqueues the launches: ``chip_smoke.cuda_ms``; for K2 two K1 readings
follow each turn).  Prints the card's name and power limit, each build's
ptxas registers and main-loop SASS per step, and one JSON line per shape:
every reading's ms, the bound (``chip_smoke.dp_bound``), each build's
share of it and the speedup, both from the medians.  Needs a CUDA device.
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
from pantax_tpu_torch.ops import extend  # noqa: E402

# N, Lr, pad, seed, and read_len for every candidate (None: the case's
# ragged lengths; 150: the main path's reads, all of one length; 512: full
# rescue chunks).  K2's windows are Lr + 2*pad wide.
SHAPES = {
    "k1": ((131072, 160, 4, 1, None), (32768, 512, 8, 6, None),
           (131072, 160, 4, 1, 150)),
    "k2": ((16384, 512, 8, 4, None), (16384, 512, 8, 4, 512),
           (16384, 160, 4, 3, None)),
}
KERNELS = {"k1": "banded_extend_kernel", "k2": "banded_extend_windows_kernel"}
TEXT_LEN = 30_000_000
ITERS = 200  # launches per timed reading
ROUNDS = 3  # base, new, new, base this many times
# one step of the fast DP's design taken out: (text in the source, its
# replacement)
ABLATIONS = {
    "unroll": [("#pragma unroll\n    for (int s = 0; s < kChunk; ++s) {",
                "#pragma unroll 1\n    for (int s = 0; s < kChunk; ++s) {")],
}


def ablated_source(name: str) -> Path:
    """The current source with ABLATIONS[name] applied, written under the
    build directory."""
    src = extend._SRC.read_text()
    for old, new in ABLATIONS[name]:
        if old not in src:
            raise ValueError(f"ablation {name}: {old!r} not in {extend._SRC}")
        src = src.replace(old, new)
    out = extend.build_dir() / "kernels" / f"banded_extend_no_{name}.cu"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(src)
    return out


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("baseline", nargs="?", help="the baseline .cu source")
    ap.add_argument("--ablate", choices=sorted(ABLATIONS),
                    help="time the current source without this step instead")
    ap.add_argument("--kernel", choices=sorted(SHAPES), default="k1",
                    help="K1 (text + w0) or K2 (windows given); default k1")
    args = ap.parse_args(argv)
    if (args.baseline is None) == (args.ablate is None):
        ap.error("give a baseline source or --ablate, not both")
    return args


def check_equal(outs, plain, what: str) -> None:
    for k, p, out in zip(outs, plain, ("score", "start", "end", "matches")):
        if not torch.equal(k, p):
            raise AssertionError(f"{what} != plain on {out}")


def main() -> None:
    args = parse_args()
    dev = require_cuda()
    print(smoke.card_line())
    issue_peak = smoke.issue_ops_per_s()
    base = args.baseline or ablated_source(args.ablate)
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
