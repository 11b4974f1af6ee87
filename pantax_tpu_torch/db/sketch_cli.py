"""pantax-gpu-sketch: pre-build the genome sketch cache used by --fast.

Parity: the reference ships a standalone `sketch` binary exposing sylph's
sketcher so users can pre-build a .syldb before query time
(PanTax's src/bin/sketch.rs:1-6, consumed via --syldb at
cli.rs:70-72 / construct.rs:22-63).  Here the same role is a directory of
per-genome FracMinHash .npz sketches, consumed by `pantax-gpu --fast
--syldb <dir>`.

The port's copy of pantax_tpu/db/sketch_cli.py.
"""
from __future__ import annotations

import argparse
import logging
import sys

from ..io.metadata import read_genomes_info
from .sketch import DEFAULT_DENSITY_BITS, DEFAULT_K, sketch_genomes


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        prog="pantax-gpu-sketch",
        description="pre-sketch genomes for --fast query screening",
    )
    p.add_argument("-f", "--genomesInformation", dest="genomes_info",
                   required=True, help="genomes_info.txt metadata table")
    p.add_argument("-o", "--out", default="genomes_sketches",
                   help="sketch cache directory (pass to pantax-gpu --syldb)")
    p.add_argument("--base-dir", default=None,
                   help="directory genome paths are relative to "
                        "(default: the metadata file's directory)")
    p.add_argument("-k", type=int, default=DEFAULT_K, help="k-mer size")
    p.add_argument("--density-bits", type=int, default=DEFAULT_DENSITY_BITS,
                   help="FracMinHash sampling density (keep 1/2^bits k-mers)")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO, stream=sys.stderr)

    import os

    base = args.base_dir or os.path.dirname(os.path.abspath(args.genomes_info))
    infos = read_genomes_info(args.genomes_info)
    sketches = sketch_genomes(infos, base, cache_dir=args.out, k=args.k,
                              density_bits=args.density_bits)
    logging.info("sketched %d genomes into %s", len(sketches), args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
