#!/usr/bin/env python3
"""Run the short-read accuracy runner of both packages on the CPU over a
slice of the smoke community: ``n_species`` species of scale_db's 3
strains x 1 Mb genomes (default 2), with ``reads_per_species`` reads a
species (default 24,576: 245,760 reads over scale_db's 10 species, the
per-genome depth of accuracy_benchmark's 262,144 reads within 7%), at
its 1:3:9 strain weights.

    JAX_PLATFORMS=cpu PYTHONPATH=. python scripts/accuracy_slice.py [n_species] [reads_per_species]

Prints, for the JAX package's accuracy_benchmark and for the port's (the
plain versions), its L1 error, the strains detected, each strain's
pre-filter unique-trio fraction (ori_strain_abundance.txt), and whether
the two runs' four tables are byte-identical.  Both use the HiGHS
solver, so equal alignments give equal tables.  The read count is a
multiple of the runner's batch (16384): the JAX runner fails on a
partial last batch.  Databases and outputs go under build/accuracy_slice.
"""
from __future__ import annotations

import csv
import filecmp
import os
import sys

import jax

jax.config.update("jax_platforms", "cpu")

import pantax_tpu.benchmarks as ref_bench  # noqa: E402
import pantax_tpu.config as ref_config  # noqa: E402
from pantax_tpu_torch import benchmarks as port_bench  # noqa: E402
from pantax_tpu_torch import config as port_config  # noqa: E402

OUT_FILES = ("species_abundance.txt", "strain_abundance.txt",
             "ori_strain_abundance.txt", "reads_classification.tsv")


def highs(cls) -> None:
    orig = cls.for_read_type.__func__
    cls.for_read_type = classmethod(
        lambda c, rt, **kw: orig(c, rt, **{"solver": "highs", **kw}))


def main() -> None:
    n_species = int(sys.argv[1]) if len(sys.argv) > 1 else 2
    per_species = int(sys.argv[2]) if len(sys.argv) > 2 else 24576
    n_reads = -(-n_species * per_species // 16384) * 16384
    root = os.path.join("build", "accuracy_slice")
    db = port_bench.scale_db(os.path.join(root, f"scale{n_species}"),
                             n_species=n_species)
    for cls in (ref_config.ProfilingConfig, port_config.ProfilingConfig):
        highs(cls)
    outs = {}
    for tag, mod, kw in (("jax", ref_bench, {}),
                         ("port", port_bench, {"device": "cpu"})):
        outs[tag] = os.path.join(root, f"acc_{tag}")
        r = mod.accuracy_benchmark(db, n_reads=n_reads, out_dir=outs[tag],
                                   **kw)
        with open(os.path.join(outs[tag], "ori_strain_abundance.txt")) as f:
            rows = list(csv.DictReader(f, delimiter="\t"))
        trio = {row["genome_ID"]: row["unique_trio_fraction"] for row in rows}
        print(f"{tag}: {n_reads} reads over {n_species} species, L1 "
              f"{r['l1_error']}, {r['detected']} of {r['total']} strains; "
              f"unique-trio fraction {trio}")
    same = all(filecmp.cmp(os.path.join(outs["jax"], f),
                           os.path.join(outs["port"], f), shallow=False)
               for f in OUT_FILES)
    print(f"four tables byte-identical: {same}")


if __name__ == "__main__":
    main()
