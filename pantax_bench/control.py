"""The control of the comparison: the reference put in the program's place
with one guarantee of the configuration broken.

The guarantee broken is "every read of the sample is classified and
counted": the control is the reference profile of every KEEP_EVERY-th
read (in the order of the files), the subsampling shortcut a faster
profiler would be tempted by.  It writes the three files the command line
writes and is held to the run's comparison against the full reference.

    python -m pantax_bench.control --workload ecoli9.short --seeds 1,2,3

prints, for each seed and each of the run's two samples, the three numbers
of the control and of the reference against itself, from the same data a
run of that seed makes (no program runs).
"""
from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path

import numpy as np

from . import check, gen
from .reference.profile import KmerIndex, read_fastq, reference_profile
from .run import load_cell

KEEP_EVERY = 4


def control_numbers(traffic: dict, wl: dict, com: gen.Community, seed: int,
                    tmp: Path, n_reads: int | None = None) -> list[dict]:
    """[{control: numbers, self: numbers}] for the two samples of ``seed``
    (drawn as run.py draws them)."""
    seeds = np.random.SeedSequence(seed).spawn(3)
    genomes = [com.genome(h) for h in range(len(com.hap_names))]
    index = KmerIndex(genomes)
    hap_species = dict(zip(com.hap_names, com.hap_species))
    long_reads = traffic["kind"] == "long"
    out = []
    for fs in range(2):
        s = gen.make_sample(traffic, com, seeds[fs],
                            n_reads or traffic["n_reads"], tmp, f"sample{fs}")
        n = sum(len(read_fastq(f).lens) for f in s.files)
        kw = dict(long_reads=long_reads, em_sample=wl["em_sample"],
                  seed=np.random.SeedSequence([seed, 7, fs]), index=index)
        ref = reference_profile(s.files, com.hap_names, com.hap_species,
                                genomes, **kw)
        sub = reference_profile(s.files, com.hap_names, com.hap_species,
                                genomes, keep_rows=np.arange(n) % KEEP_EVERY == 0,
                                **kw)
        files = {k: tmp / f"control_{k}" for k in ("cls", "species", "strain")}
        rows = {}
        for name, prof in (("control", sub), ("self", ref)):
            check.write_profile(prof, files, hap_species)
            rows[name] = check.compare_outputs(ref, files, hap_species)
        out.append(rows)
        for f in s.files:
            f.unlink()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    a = p.parse_args(argv)
    spec = load_cell(Path.cwd(), a.workload)
    com = gen.community(spec["config"])
    limits = spec["workload"]["limits"]
    for seed in (int(s) for s in a.seeds.split(",")):
        with tempfile.TemporaryDirectory(prefix="pantax_bench_control_") as t:
            rows = control_numbers(spec["traffic"], spec["workload"], com,
                                   seed, Path(t))
        for fs, r in enumerate(rows):
            fails = [n for n in check.NUMBERS if r["control"][n] > limits[n]]
            print(json.dumps({"workload": a.workload, "seed": seed,
                              "sample": fs, **r, "control_fails": fails}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
