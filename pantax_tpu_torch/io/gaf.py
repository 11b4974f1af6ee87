"""GAF (Graph Alignment Format) records: parsing, writing, long-read
filtering; the port's copy of pantax_tpu/io/gaf.py.

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

    def to_line(self) -> str:
        return "\t".join(
            [
                self.read_id,
                str(self.read_len),
                str(self.query_start),
                str(self.query_end),
                self.strand,
                self.path,
                str(self.path_len),
                str(self.path_start),
                str(self.path_end),
                str(self.matches),
                str(self.block_len),
                str(self.mapq),
                f"id:f:{self.identity:.6f}",
            ]
        )


def parse_gaf_line(line: str) -> GafRecord | None:
    fields = line.rstrip("\n").split("\t")
    if len(fields) < 12:
        return None
    # Unaligned rows carry '*' in path_len/path_start/path_end; the reference
    # drops them before strain profiling (profile.rs:380-399 null-row drop) —
    # keeping them with 0s would wrongly contribute full intermediate-node
    # base allocations in coverage.
    if fields[6] == "*" or fields[7] == "*" or fields[8] == "*":
        return None

    def _int(s: str) -> int:
        return 0 if s == "*" else int(s)

    identity = 0.0
    for tag in fields[12:]:
        if tag.startswith("id:f:"):
            identity = float(tag.rsplit(":", 1)[1])
            break
    return GafRecord(
        read_id=fields[0],
        read_len=_int(fields[1]),
        query_start=_int(fields[2]),
        query_end=_int(fields[3]),
        strand=fields[4],
        path=fields[5],
        path_len=_int(fields[6]),
        path_start=_int(fields[7]),
        path_end=_int(fields[8]),
        matches=_int(fields[9]),
        block_len=_int(fields[10]),
        mapq=_int(fields[11]) if fields[11] != "*" else 0,
        identity=identity,
    )


def read_gaf(path: str | os.PathLike) -> list[GafRecord]:
    records = []
    with open(path) as f:
        for line in f:
            if line.startswith("@"):
                continue
            rec = parse_gaf_line(line)
            if rec is not None:
                records.append(rec)
    return records


def write_gaf(path: str | os.PathLike, records: list[GafRecord]) -> None:
    with open(path, "w") as f:
        for rec in records:
            f.write(rec.to_line() + "\n")


def filter_best_long_read_alignments(records: list[GafRecord]) -> list[GafRecord]:
    """Keep, per read, the alignment with max residue matches (ties broken by
    identity); drop alignments with mapq <= 20 or query span <= 1000; emit at
    most one line per read.

    Parity: PanTax's src/gaf_filter.rs:44-97.
    """
    best: dict[str, tuple[int, float]] = {}
    for rec in records:
        key = (rec.matches, rec.identity)
        cur = best.get(rec.read_id)
        if cur is None or key > cur:
            best[rec.read_id] = key

    out: list[GafRecord] = []
    written: set[str] = set()
    for rec in records:
        if rec.mapq <= 20 or (rec.query_end - rec.query_start) <= 1000:
            continue
        if (rec.matches, rec.identity) == best[rec.read_id] and rec.read_id not in written:
            written.add(rec.read_id)
            out.append(rec)
    return out
