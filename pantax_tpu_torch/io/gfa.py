"""GFA 1.1 reading/writing with the reference's path semantics.

Parity notes (behavior matched against PanTax's src/zip.rs:78-234):
  - S lines must have sequential node ids: id == index + 1 + previous.
  - W lines: haplotype id = sample field (col 2); the walk's node ids are all
    integers in the last field; the walk is reversed when it starts with '<'.
  - P lines: haplotype id = col 2 up to the first '#' (PanSN sample); reversed
    when the first path segment ends with '-'.
  - Multiple contigs/chromosomes of the same haplotype are concatenated into a
    single path in line order (zip.rs:154-158).
  - Node ids are re-based to 0 by subtracting (1 + previous).

Extension beyond the reference (which delegates bidirected handling to vg and
keeps only node ids): per-step orientations are parsed and preserved
(``path_strands``), so the alignment index can linearize haplotypes with
reverse-complemented node sequences where a step is reverse-oriented.  The id
semantics above are unchanged — profiling consumes ids only, exactly like
profile.rs.  On whole-walk reversal the step orientations are flipped along
with the id order (the walk read back on the other strand).
"""
from __future__ import annotations

import os
import re
from dataclasses import dataclass, field

import numpy as np

_INT_RE = re.compile(rb"-?\d+")
_W_STEP_RE = re.compile(rb"([><])(\d+)")
_P_STEP_RE = re.compile(rb"(\d+)([+-])")


@dataclass
class ParsedGfa:
    nodes_len: np.ndarray                 # int64 [N]
    node_seqs: list[bytes]                # len N (empty bytes if unknown)
    paths: dict[str, np.ndarray]          # hap_id -> int64 local node indices
    edges: list[tuple[int, int]] = field(default_factory=list)  # local ids
    path_strands: dict[str, np.ndarray] = field(default_factory=dict)
    # hap_id -> int8 per-step strand (0 forward, 1 reverse), aligned to paths

    @property
    def num_nodes(self) -> int:
        return len(self.nodes_len)

    @property
    def is_pan(self) -> bool:
        return len(self.paths) > 1


def read_gfa(path: str | os.PathLike, previous: int = 0, keep_seq: bool = True) -> ParsedGfa:
    nodes_len: list[int] = []
    node_seqs: list[bytes] = []
    paths: dict[str, np.ndarray] = {}
    strands: dict[str, np.ndarray] = {}
    edges: list[tuple[int, int]] = []
    node_index = 0
    base = 1 + previous

    with open(path, "rb") as f:
        for line in f:
            if line.startswith(b"S"):
                parts = line.rstrip().split(b"\t")
                if len(parts) < 3:
                    continue
                node_id = int(parts[1])
                if node_id - base != node_index:
                    raise ValueError(
                        f"{path}: node id {node_id} out of order (expected {node_index + base})"
                    )
                node_index += 1
                seq = parts[2]
                if len(seq) == 0:
                    raise ValueError(f"{path}: zero-length node {node_id}")
                nodes_len.append(len(seq))
                node_seqs.append(seq.upper() if keep_seq else b"")
            elif line.startswith(b"L"):
                parts = line.rstrip().split(b"\t")
                if len(parts) >= 4:
                    edges.append((int(parts[1]) - base, int(parts[3]) - base))
            elif line.startswith(b"W") or line.startswith(b"P"):
                parts = line.rstrip().split(b"\t")
                if not parts:
                    continue
                if parts[0] == b"W":
                    hap_id = parts[1].decode()
                    walk = parts[-1]
                    reverse = walk.startswith(b"<")
                    steps = _W_STEP_RE.findall(walk)
                    if steps:
                        ids = np.array([int(i) for _, i in steps], dtype=np.int64) - base
                        st = np.array(
                            [0 if o == b">" else 1 for o, _ in steps], dtype=np.int8
                        )
                    else:  # orientation-less walk (ids only)
                        ids = np.array(
                            [int(m) for m in _INT_RE.findall(walk)], dtype=np.int64
                        ) - base
                        st = np.zeros(len(ids), dtype=np.int8)
                else:
                    hap_id = parts[1].split(b"#")[0].decode()
                    path_field = parts[2] if len(parts) > 2 else b""
                    first_seg = path_field.split(b",")[0]
                    reverse = first_seg.endswith(b"-")
                    steps = _P_STEP_RE.findall(path_field)
                    if steps:
                        ids = np.array([int(i) for i, _ in steps], dtype=np.int64) - base
                        st = np.array(
                            [0 if o == b"+" else 1 for _, o in steps], dtype=np.int8
                        )
                    else:
                        ids = np.array(
                            [int(m) for m in re.findall(rb"\d+", path_field)],
                            dtype=np.int64,
                        ) - base
                        st = np.zeros(len(ids), dtype=np.int8)
                if reverse:
                    # the walk was written on the other strand: reverse the
                    # step order and flip each step's orientation
                    ids = ids[::-1].copy()
                    st = (1 - st[::-1]).astype(np.int8)
                if hap_id in paths:
                    paths[hap_id] = np.concatenate([paths[hap_id], ids])
                    strands[hap_id] = np.concatenate([strands[hap_id], st])
                else:
                    paths[hap_id] = ids
                    strands[hap_id] = st

    return ParsedGfa(
        nodes_len=np.asarray(nodes_len, dtype=np.int64),
        node_seqs=node_seqs,
        paths=paths,
        edges=edges,
        path_strands=strands,
    )


def write_gfa(
    path: str | os.PathLike,
    node_seqs: list[bytes],
    walks: list[tuple[str, str, str, int, np.ndarray]],
    edges: list[tuple[int, int]] | None = None,
    previous: int = 0,
    walk_strands: list[np.ndarray] | None = None,
) -> None:
    """Write a GFA 1.1 file.

    walks: (sample, hap_idx, contig, seq_len, local node indices) per W line.
    walk_strands: optional per-walk int8 step strands (0 fwd / 1 rev).
    Without ``edges`` the L lines are the sorted set of the walks'
    consecutive (node, strand, node, strand) steps.  Node ids are written
    1-based with offset ``previous``.
    """
    base = 1 + previous
    sts = walk_strands or [None] * len(walks)
    with open(path, "wb") as f:
        f.write(b"H\tVN:Z:1.1\n")
        for i, seq in enumerate(node_seqs):
            f.write(b"S\t%d\t%s\n" % (i + base, seq))
        if edges is None:
            edge_set = set()
            for (_, _, _, _, ids), st in zip(walks, sts):
                so = st if st is not None else np.zeros(len(ids), np.int8)
                for a, sa, b, sb in zip(ids[:-1], so[:-1], ids[1:], so[1:]):
                    edge_set.add((int(a), int(sa), int(b), int(sb)))
            edges4 = sorted(edge_set)
        else:
            edges4 = [(a, 0, b, 0) for a, b in edges]
        ori = (b"+", b"-")
        for a, sa, b, sb in edges4:
            f.write(b"L\t%d\t%s\t%d\t%s\t0M\n"
                    % (a + base, ori[sa], b + base, ori[sb]))
        step = (b">", b"<")
        for (sample, hap_idx, contig, seq_len, ids), st in zip(walks, sts):
            if st is None or not np.any(st):
                walk = b"".join(b">%d" % (i + base) for i in ids)
            else:
                walk = b"".join(step[int(s)] + b"%d" % (i + base)
                                for i, s in zip(ids, st))
            f.write(b"W\t%s\t%s\t%s\t0\t%d\t%s\n"
                    % (sample.encode(), hap_idx.encode(), contig.encode(),
                       seq_len, walk))
