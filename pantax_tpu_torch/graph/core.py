"""Species pangenome graph model and serialization.

A :class:`SpeciesGraph` is the framework's equivalent of the reference's
serialized ``Graph { nodes_len, paths }`` (PanTax's src/types.rs:51-55)
with two TPU-first extensions:

  - paths are stored flat (CSR: ``path_indptr``/``path_nodes``) so they can be
    shipped to the device without ragged structures;
  - node sequences are optionally stored as a flat uint8 buffer + offsets so the
    alignment index can be built directly from the graph.

Path iteration order is sorted by haplotype name (BTreeMap parity).

Serialization is a single ``.npz`` per species under ``species_graph_info/``
(replacing bincode/.bin.lz4/.bin.zst of PanTax's src/zip.rs:178-234).

``species_range.txt`` is the 4-column global node-id → species table
(taxid, start, end, is_pan; 1-based inclusive), produced by offset-accumulating
per-species local ranges in species order
(PanTax's src/sort_range.rs:8-41).
"""
from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

GRAPH_DIR = "species_graph_info"
GRAPH_SUFFIX = ".graph.npz"


# reverse-complement table over ASCII (A<->T, C<->G, everything else -> N)
_RC_TABLE = np.full(256, ord("N"), dtype=np.uint8)
for _a, _b in ((b"A", b"T"), (b"C", b"G"), (b"G", b"C"), (b"T", b"A")):
    _RC_TABLE[_a[0]] = _b[0]
    _RC_TABLE[_a[0] + 32] = _b[0]  # lowercase


def revcomp_ascii(seq: np.ndarray) -> np.ndarray:
    return _RC_TABLE[seq[::-1]]


@dataclass
class SpeciesGraph:
    nodes_len: np.ndarray        # int64 [N]
    path_names: list[str]        # [P], sorted ascending
    path_indptr: np.ndarray      # int64 [P+1]
    path_nodes: np.ndarray       # int64 [sum path lens], local 0-based node ids
    seq: np.ndarray | None = None        # uint8 [sum nodes_len] ASCII bases
    seq_indptr: np.ndarray | None = None  # int64 [N+1]
    path_strands: np.ndarray | None = None  # int8, aligned to path_nodes
    # (0 forward / 1 reverse per step; None = all forward.  The reference
    # stores ids only — zip.rs:116-159 — so strands are an extension used by
    # the alignment-text linearization; profiling consumes ids only.)

    # ---- construction -----------------------------------------------------
    @classmethod
    def from_paths(
        cls,
        nodes_len: np.ndarray,
        paths: dict[str, np.ndarray],
        node_seqs: list[bytes] | None = None,
        strands: dict[str, np.ndarray] | None = None,
    ) -> "SpeciesGraph":
        names = sorted(paths)
        indptr = np.zeros(len(names) + 1, dtype=np.int64)
        chunks = []
        strand_chunks = []
        for i, name in enumerate(names):
            p = np.asarray(paths[name], dtype=np.int64)
            indptr[i + 1] = indptr[i] + len(p)
            chunks.append(p)
            if strands is not None:
                strand_chunks.append(np.asarray(strands[name], dtype=np.int8))
        path_nodes = np.concatenate(chunks) if chunks else np.zeros(0, dtype=np.int64)
        path_strands = None
        if strand_chunks:
            path_strands = np.concatenate(strand_chunks)
            if not path_strands.any():
                path_strands = None  # all-forward: store nothing
        seq = seq_indptr = None
        if node_seqs is not None:
            seq_indptr = np.zeros(len(node_seqs) + 1, dtype=np.int64)
            np.cumsum([len(s) for s in node_seqs], out=seq_indptr[1:])
            seq = np.frombuffer(b"".join(node_seqs), dtype=np.uint8).copy()
        return cls(
            nodes_len=np.asarray(nodes_len, dtype=np.int64),
            path_names=names,
            path_indptr=indptr,
            path_nodes=path_nodes,
            seq=seq,
            seq_indptr=seq_indptr,
            path_strands=path_strands,
        )

    # ---- accessors --------------------------------------------------------
    @property
    def num_nodes(self) -> int:
        return len(self.nodes_len)

    @property
    def num_paths(self) -> int:
        return len(self.path_names)

    @property
    def is_pan(self) -> bool:
        return self.num_paths > 1

    def path(self, i: int) -> np.ndarray:
        return self.path_nodes[self.path_indptr[i] : self.path_indptr[i + 1]]

    def paths_dict(self) -> dict[str, np.ndarray]:
        return {name: self.path(i) for i, name in enumerate(self.path_names)}

    def node_seq(self, i: int) -> bytes:
        if self.seq is None:
            raise ValueError("graph has no sequence data")
        return self.seq[self.seq_indptr[i] : self.seq_indptr[i + 1]].tobytes()

    def path_strand(self, i: int) -> np.ndarray:
        """Per-step strand of path i (0 forward / 1 reverse)."""
        lo, hi = self.path_indptr[i], self.path_indptr[i + 1]
        if self.path_strands is None:
            return np.zeros(hi - lo, dtype=np.int8)
        return self.path_strands[lo:hi]

    def path_seq(self, i: int) -> np.ndarray:
        """Linearized haplotype sequence: concatenation of its nodes' bases,
        reverse-complemented where a step is reverse-oriented (bidirected
        pggb/vg GFA interop; the reference delegates this to vg)."""
        if self.seq is None:
            raise ValueError("graph has no sequence data")
        nodes = self.path(i)
        strands = self.path_strand(i)
        parts = []
        for n, s in zip(nodes, strands):
            chunk = self.seq[self.seq_indptr[n] : self.seq_indptr[n + 1]]
            parts.append(revcomp_ascii(chunk) if s else chunk)
        return np.concatenate(parts) if parts else np.zeros(0, dtype=np.uint8)

    def path_node_starts(self, i: int) -> np.ndarray:
        """Cumulative base offset of each node along path i (length len+1)."""
        lens = self.nodes_len[self.path(i)]
        out = np.zeros(len(lens) + 1, dtype=np.int64)
        np.cumsum(lens, out=out[1:])
        return out

    def local_range(self) -> tuple[int, int]:
        """(min, max) local node index over all paths, 1-based
        (zip.rs:160-165,316: min+1, max+1)."""
        if len(self.path_nodes) == 0:
            return 1, self.num_nodes
        return int(self.path_nodes.min()) + 1, int(self.path_nodes.max()) + 1

    # ---- serialization ----------------------------------------------------
    def save(self, path: str | os.PathLike, compress: bool = True) -> None:
        data = dict(
            nodes_len=self.nodes_len,
            path_names=np.array(self.path_names, dtype=np.str_),
            path_indptr=self.path_indptr,
            path_nodes=self.path_nodes,
        )
        if self.seq is not None:
            data["seq"] = self.seq
            data["seq_indptr"] = self.seq_indptr
        if self.path_strands is not None:
            data["path_strands"] = self.path_strands
        (np.savez_compressed if compress else np.savez)(os.fspath(path), **data)

    @classmethod
    def load(cls, path: str | os.PathLike) -> "SpeciesGraph":
        with np.load(os.fspath(path)) as z:
            return cls(
                nodes_len=z["nodes_len"],
                path_names=[str(s) for s in z["path_names"]],
                path_indptr=z["path_indptr"],
                path_nodes=z["path_nodes"],
                seq=z["seq"] if "seq" in z else None,
                seq_indptr=z["seq_indptr"] if "seq_indptr" in z else None,
                path_strands=z["path_strands"] if "path_strands" in z else None,
            )


def graph_path(db: str | os.PathLike, taxid: str) -> str:
    return os.path.join(os.fspath(db), GRAPH_DIR, f"{taxid}{GRAPH_SUFFIX}")


# ---- species range table --------------------------------------------------
@dataclass
class SpeciesRange:
    species: str
    start: int   # 1-based inclusive global node id
    end: int     # 1-based inclusive
    is_pan: int


def load_species_range(path: str | os.PathLike) -> list[SpeciesRange]:
    out = []
    with open(path) as f:
        for line in f:
            fields = line.split()
            if len(fields) != 4:
                raise ValueError(f"{path}: bad species_range line {line!r}")
            out.append(SpeciesRange(fields[0], int(fields[1]), int(fields[2]), int(fields[3])))
    return out


def save_species_range(path: str | os.PathLike, ranges: list[SpeciesRange]) -> None:
    with open(path, "w") as f:
        for r in ranges:
            f.write(f"{r.species}\t{r.start}\t{r.end}\t{r.is_pan}\n")


def sort_range(
    local_ranges: dict[str, tuple[int, int, int]],
    multi_species: list[str],
    single_species: list[str],
) -> list[SpeciesRange]:
    """Offset-accumulate per-species local (start, end, is_pan) into global
    node-id ranges, multi-genome species first then single-genome species.

    Parity: PanTax's src/sort_range.rs:8-41 (offset = previous end).
    """
    out: list[SpeciesRange] = []
    offset = 0
    for taxid in list(multi_species) + list(single_species):
        start, end, is_pan = local_ranges[taxid]
        out.append(SpeciesRange(taxid, start + offset, end + offset, is_pan))
        offset = out[-1].end
    return out
