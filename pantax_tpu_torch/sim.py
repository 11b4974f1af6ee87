"""Read simulation with ground truth, the port's copy of pantax_tpu/sim.py:
sample reads from database haplotypes, emit sequences (with optional
substitutions and reverse complement) and the truth GAF record of each read,
projected onto its haplotype's node path.  Numpy on the host; for one seed
the reads and records equal the reference's (the generator's draws come in
the same order).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .graph.core import SpeciesGraph, load_species_range
from .io.gaf import GafRecord

_COMP = bytes.maketrans(b"ACGTN", b"TGCAN")


def revcomp(seq: bytes) -> bytes:
    return seq.translate(_COMP)[::-1]


@dataclass
class SimRead:
    read_id: str
    seq: bytes
    truth: GafRecord          # perfect-alignment GAF record
    species: str
    hap_id: str


def truth_gaf(graph: SpeciesGraph, range_start: int, hap_idx: int,
              start: int, end: int, read_id: str, mapq: int = 60) -> GafRecord:
    """Project the haplotype interval [start, end) onto the node path and
    emit the GAF record vg giraffe would produce for a perfect match."""
    starts = graph.path_node_starts(hap_idx)
    path = graph.path(hap_idx)
    i0 = int(np.searchsorted(starts, start, side="right")) - 1
    i1 = int(np.searchsorted(starts, end - 1, side="right")) - 1
    nodes = path[i0:i1 + 1]
    path_str = "".join(f">{n}" for n in nodes + range_start)  # global 1-based
    path_start = start - int(starts[i0])
    span = end - start
    return GafRecord(
        read_id=read_id, read_len=span, query_start=0, query_end=span,
        strand="+", path=path_str, path_len=int(graph.nodes_len[nodes].sum()),
        path_start=path_start, path_end=path_start + span, matches=span,
        block_len=span, mapq=mapq, identity=1.0,
    )


def _mutate(seq: bytes, rng: np.random.Generator, error_rate: float) -> bytes:
    if error_rate <= 0:
        return seq
    arr = np.frombuffer(seq, dtype=np.uint8).copy()
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    mask = rng.random(len(arr)) < error_rate
    arr[mask] = bases[rng.integers(0, 4, size=int(mask.sum()))]
    return arr.tobytes()


def simulate_reads(db, abundances: dict[str, float], n_reads: int,
                   read_len: int, seed: int = 0, error_rate: float = 0.0,
                   reverse_frac: float = 0.5) -> list[SimRead]:
    """Reads of the haplotypes named in ``abundances`` (hap_id -> relative
    coverage), uniform over each haplotype's sequence; raises ValueError
    listing the database's haplotypes when a name is unknown."""
    rng = np.random.default_rng(seed)
    ranges = {r.species: r for r in load_species_range(db.range_file)}

    entries = []  # (hap_id, species, graph, hap_idx, seq, weight)
    available: list[str] = []
    for sp in ranges:
        graph = db.load_graph(sp)
        for hi, name in enumerate(graph.path_names):
            available.append(name)
            if name in abundances:
                entries.append((name, sp, graph, hi,
                                graph.path_seq(hi).tobytes(), abundances[name]))
    unknown = set(abundances) - {e[0] for e in entries}
    if unknown:
        raise ValueError(
            f"abundance table names unknown haplotypes: {sorted(unknown)}; "
            f"database haplotypes: {sorted(available)}")

    # coverage-proportional read counts: weight by abundance x genome length
    weights = np.array([e[5] * len(e[4]) for e in entries], dtype=np.float64)
    weights /= weights.sum()
    picks = rng.choice(len(entries), size=n_reads, p=weights)

    reads: list[SimRead] = []
    for i, pick in enumerate(picks):
        hap_id, sp, graph, hi, seq, _ = entries[pick]
        if len(seq) <= read_len:
            start, end = 0, len(seq)
        else:
            start = int(rng.integers(0, len(seq) - read_len + 1))
            end = start + read_len
        truth = truth_gaf(graph, ranges[sp].start, hi, start, end,
                          f"S{pick}R{i}")
        read_seq = _mutate(seq[start:end], rng, error_rate)
        if rng.random() < reverse_frac:
            read_seq = revcomp(read_seq)
        reads.append(SimRead(read_id=truth.read_id, seq=read_seq, truth=truth,
                             species=sp, hap_id=hap_id))
    return reads
