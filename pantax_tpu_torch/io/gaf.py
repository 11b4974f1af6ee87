"""GAF (Graph Alignment Format) records, the port's copy of the record type
of pantax_tpu/io/gaf.py (parsing, writing and the long-read filter are the
GAF flow, ROADMAP M11).

A GAF line has 12+ columns:
  1 read_id  2 read_len  3 query_start  4 query_end  5 strand
  6 path (e.g. ``>12>13<14``)  7 path_len  8 path_start  9 path_end
  10 residue_matches  11 block_len  12 mapq  [tags...]

Parity: column usage matches the reference's readers
(PanTax's src/rcls.rs:119-146, profile.rs:351-463) and the
long-read best-alignment filter (PanTax's src/gaf_filter.rs:44-97).
"""
from __future__ import annotations

import os
import re
from dataclasses import dataclass

_NODE_RE = re.compile(r"-?\d+")


@dataclass
class GafRecord:
    read_id: str
    read_len: int
    query_start: int
    query_end: int
    strand: str
    path: str                # raw path string, e.g. ">12>13"
    path_len: int
    path_start: int
    path_end: int
    matches: int
    block_len: int
    mapq: int
    identity: float = 0.0    # id:f tag

    def path_nodes(self) -> list[int]:
        return [int(m) for m in _NODE_RE.findall(self.path)]
