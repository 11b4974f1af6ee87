"""Runs of one cell as the benchmark's check makes them: each run a new
process of ``python -m pantax_bench.run``, one seed each, in one call;
then each metric's median and spread (the distance between the first and
third quartiles of ``statistics.quantiles(values, n=4)`` over the median).

    python -m pantax_bench.sets --workload ecoli9.short --seconds 51 \\
        --seeds 11,12,13,14,15,16 [--trace-seeds 17,18] --out chiprun_out/s1

Each run's standard output and error go to <out>/<workload>.<seed>.<trace>
.{out,err}; the result lines to <out>/<workload>.jsonl.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path


def spread(values: list[float]) -> float:
    if len(values) < 2:
        return 0.0
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med if med else 0.0


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=int, required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--trace-seeds", default="")
    p.add_argument("--out", required=True)
    a = p.parse_args(argv)
    out = Path(a.out)
    out.mkdir(parents=True, exist_ok=True)
    plan = [(int(s), 0) for s in a.seeds.split(",") if s] + \
        [(int(s), 1) for s in a.trace_seeds.split(",") if s]
    results = []
    for seed, trace in plan:
        stem = out / f"{a.workload}.{seed}.{trace}"
        t0 = time.time()
        with open(f"{stem}.out", "w") as fo, open(f"{stem}.err", "w") as fe:
            rc = subprocess.run(
                [sys.executable, "-m", "pantax_bench.run", "--workload",
                 a.workload, "--seed", str(seed), "--seconds", str(a.seconds),
                 "--trace", str(trace)], stdout=fo, stderr=fe).returncode
        wall = time.time() - t0
        lines = Path(f"{stem}.out").read_text().strip().splitlines()
        res = None
        if rc == 0 and lines:
            try:
                res = json.loads(lines[-1])
            except ValueError:
                res = None
        rec = {"seed": seed, "trace": trace, "rc": rc, "wall_s": wall,
               "result": res}
        results.append(rec)
        with open(out / f"{a.workload}.jsonl", "a") as f:
            f.write(json.dumps(rec) + "\n")
        short = None if res is None else {
            "correct": res["correct"], "attempted": res["attempted"],
            "metrics": {k: v["value"] for k, v in res["metrics"].items()},
            "checks": {k: v["value"] for k, v in res.get("checks", {}).items()}}
        print(f"{a.workload} seed {seed} trace {trace}: rc {rc}, "
              f"{wall:.1f} s, {json.dumps(short)}", flush=True)
    for trace in (0, 1):
        done = [r["result"] for r in results
                if r["trace"] == trace and r["result"]]
        names = sorted({k for r in done for k in r["metrics"]})
        for n in names:
            v = [r["metrics"][n]["value"] for r in done if n in r["metrics"]]
            print(f"{a.workload} trace {trace} {n}: n {len(v)}, median "
                  f"{statistics.median(v)!r}, spread {spread(v)!r}, "
                  f"values {v}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
