#!/usr/bin/env python3
"""Time two builds of K1 (``banded_extend_launch``) on one GPU, in turns:
the current ``csrc/banded_extend.cu`` and a baseline source with the same
C entry points, such as an earlier commit's:

    git show <commit>:pantax_tpu_torch/csrc/banded_extend.cu \\
        > build/banded_extend_base.cu
    PYTHONPATH=. python scripts/time_extend.py build/banded_extend_base.cu

or against the current source with one step of K1's design taken out
(``--ablate unroll``: the step loop not unrolled), written under the
build directory:

    PYTHONPATH=. python scripts/time_extend.py --ablate unroll

At the main path's shape (131072 candidates of 160 bases, pad 4) and the
long-read seeded pass's (32768 candidates of 512 bases, pad 8), on
``chip_smoke.dp_case`` candidates (read lengths uniform in [Lr/2, Lr])
over a random text of 30 M bases (the smoke DB's size) with a sentinel
tail, and at the main shape with every read_len 150 (the main path's
reads): both builds' four outputs must equal each other's and the plain
version's, bit for bit; then base, new, new, base, ROUNDS times, ITERS
launches a reading (CUDA events).  Prints the card's name and power
limit, each build's ptxas registers and main-loop SASS per step, and one
JSON line per shape: every reading's ms, the bound
(``chip_smoke.dp_bound``), each build's share of it and the speedup, both
from the medians.  Needs a CUDA device.
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

# N, Lr, pad, seed, and read_len for every candidate (None: dp_case's
# ragged lengths; 150: the main path's reads, all of one length)
SHAPES = ((131072, 160, 4, 1, None), (32768, 512, 8, 6, None),
          (131072, 160, 4, 1, 150))
TEXT_LEN = 30_000_000
ITERS = 200  # launches per timed reading
ROUNDS = 3  # base, new, new, base this many times
# one step of K1's design taken out: (text in the source, its replacement)
ABLATIONS = {
    "unroll": [("#pragma unroll\n    for (int s = 0; s < kChunk; ++s) {",
                "#pragma unroll 1\n    for (int s = 0; s < kChunk; ++s) {")],
}


def ablated_source(name: str) -> Path:
    """The current K1 source with ABLATIONS[name] applied, written under
    the build directory."""
    src = extend._SRC.read_text()
    for old, new in ABLATIONS[name]:
        if old not in src:
            raise ValueError(f"ablation {name}: {old!r} not in {extend._SRC}")
        src = src.replace(old, new)
    out = extend.build_dir() / "kernels" / f"banded_extend_no_{name}.cu"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(src)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("baseline", nargs="?", help="the baseline .cu source")
    ap.add_argument("--ablate", choices=sorted(ABLATIONS),
                    help="time the current source without this step instead")
    args = ap.parse_args()
    if (args.baseline is None) == (args.ablate is None):
        ap.error("give a baseline source or --ablate, not both")
    dev = require_cuda()
    print(smoke.card_line())
    issue_peak = smoke.issue_ops_per_s()
    base = args.baseline or ablated_source(args.ablate)
    libs = {}
    for name, src in (("new", None), ("base", base)):
        libs[name] = extend.build_kernels(src)
        regs = smoke.ptxas_lines(libs[name].build_log)
        sass = {f"pad{pad}": smoke.k1_step_sass(libs[name]._name, 2 * pad)
                for pad in (4, 8)}
        print(f"{name}: {src or extend._SRC}\n  " + "\n  ".join(regs)
              + f"\n  K1 main step loop SASS: {json.dumps(sass)}")

    rng = np.random.default_rng(0)
    text_np = np.concatenate([rng.integers(0, 4, size=TEXT_LEN, dtype=np.int8),
                              np.full(1024, 4, np.int8)])
    text = torch.from_numpy(text_np).to(dev)
    for N, Lr, pad, seed, fixed_len in SHAPES:
        w0, reads, lens = smoke.dp_case(text_np, N, Lr, pad, seed)
        if fixed_len is not None:
            lens[:] = fixed_len
        case = [torch.from_numpy(a).to(dev) for a in (w0, reads, lens)]

        def run(name):
            return extend.launch_k1(libs[name], text, *case, pad, smoke.MATCH,
                                    smoke.MISMATCH, smoke.GAP)

        plain = extend.banded_extend_plain(text, *case, pad, smoke.MATCH,
                                           smoke.MISMATCH, smoke.GAP)
        for name in libs:
            for k, p, out in zip(run(name), plain,
                                 ("score", "start", "end", "matches")):
                if not torch.equal(k, p):
                    raise AssertionError(f"{name} K1 != plain on {out} at "
                                         f"N={N} Lr={Lr} pad={pad}")
        ms = {"base": [], "new": []}
        for _ in range(ROUNDS):
            for name in ("base", "new", "new", "base"):
                ms[name].append(smoke.cuda_ms(lambda: run(name), ITERS))
        bound, by = smoke.dp_bound(case[2].cpu().numpy(), Lr, pad, issue_peak)
        med = {k: float(np.median(v)) for k, v in ms.items()}
        print(json.dumps({
            "N": N, "Lr": Lr, "pad": pad, "read_len": fixed_len or "ragged",
            "base_ms": ms["base"], "new_ms": ms["new"], "bound_ms": bound,
            "bound_by": by, "base_share": bound / med["base"],
            "new_share": bound / med["new"],
            "speedup": med["base"] / med["new"],
        }), flush=True)


if __name__ == "__main__":
    main()
