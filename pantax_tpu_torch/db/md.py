"""pantax-gpu-md: merge databases CLI (pantax-md equivalent,
PanTax's src/bin/pantax_md.rs:299-326).

The port's copy of pantax_tpu/db/md.py.
"""
from __future__ import annotations

import argparse
import logging
import sys

from .merge import merge_databases


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        prog="pantax-gpu-md", description="merge pantax_tpu_torch databases"
    )
    p.add_argument("-i", "--inputs", nargs="+", required=True,
                   help="database directories to merge, in order")
    p.add_argument("-o", "--out", default="pantax_db_merged")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO, stream=sys.stderr)
    db = merge_databases(args.inputs, args.out)
    logging.info("merged %d databases into %s", len(args.inputs), db.root)
    return 0


if __name__ == "__main__":
    sys.exit(main())
