#!/usr/bin/env python3
"""Aligned fraction against the seed-sampling density, for both packages
on the CPU: a 34-species x 3-strain community of 100 kb genomes (the
102-strain community's species and strains at a tenth of its genome
length), its align index built at density_bits 3, 4 and 5 (1/8, 1/16 and
1/32 of the k-mer positions sampled, on the index and the read side), and
``n_reads`` simulated 150 bp reads at 1% substitutions and 0.05% indels
(default 32,768) through each package's aligner (the port's plain
versions).

    JAX_PLATFORMS=cpu PYTHONPATH=. python scripts/density_slice.py [n_reads]

auto_density_bits picks 3 below ~50M bases of text and 4 up to ~201M, so
the 30-strain community (30 Mb) aligns at 3 and the 102-strain one (102
Mb) at 4.  Prints each density's aligned fraction in both packages and
whether their aligned flags and text starts are equal read for read.
The database goes under build/density_slice.
"""
from __future__ import annotations

import os
import sys

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

from pantax_tpu.align.aligner import Aligner as RefAligner  # noqa: E402
from pantax_tpu_torch import _host  # noqa: E402
from pantax_tpu_torch.benchmarks import (  # noqa: E402
    scale_db, simulate_read_batch,
)
from pantax_tpu_torch.convert import aligner_from_reference  # noqa: E402


def main() -> None:
    n_reads = int(sys.argv[1]) if len(sys.argv) > 1 else 32768
    db = scale_db(os.path.join("build", "density_slice"), n_species=34,
                  strains_per=3, genome_len=100_000)
    for bits in (3, 4, 5):
        index = _host.build_align_index(db, density_bits=bits, save=False)
        codes, lens, _ = simulate_read_batch(index, n_reads, 150, 0.01)
        port = aligner_from_reference(index, _host.AlignConfig(), "cpu")
        got = port.align_codes(codes, lens)
        want = RefAligner(index).align_codes(codes, lens)
        same = (np.array_equal(got.aligned, np.asarray(want.aligned))
                and np.array_equal(got.text_start,
                                   np.asarray(want.text_start)))
        print(f"density_bits {bits} (text {index.text_len} bases): aligned "
              f"port {np.mean(got.aligned):.6f}, JAX "
              f"{np.mean(np.asarray(want.aligned)):.6f}; read for read "
              f"{'equal' if same else 'DIFFERENT'}", flush=True)


if __name__ == "__main__":
    main()
