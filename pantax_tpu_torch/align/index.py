"""Alignment index over the linearized haplotype paths of a database.

TPU-first replacement for the vg giraffe index stack
(PanTax's src/index.rs — gbwt/.gbz/.dist/.min):  every haplotype
path of every species graph is linearized (its node sequences concatenated —
reads always originate from *some* haplotype, so graph alignment reduces to
linear alignment plus projection onto the node path); all haplotypes are packed
into one device-resident text with sentinel separators, over which a sampled
canonical k-mer seed table is built.  Projection tables map any text interval
back to the graph's global node ids, which is what the GAF and the profiling
engine consume.

Arrays (device-friendly, all flat):
  text        int8 [T]      base codes, 4 = N/separator
  hap_offsets int64 [H+1]   text span of haplotype h  (separator after each)
  seed_keys   uint32 [S]    sorted sampled canonical k-mer hashes
  seed_pos    int32 [S]     text position of each seed
  tstart      int64 [P]     sorted text positions where a path node begins
  tnode       int64 [P]     global 1-based node id of that span
  tlen        int32 [P]     node length of that span
"""
from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from ..db.construct import DatabasePaths
from ..graph.core import load_species_range
from .encode import encode_seq, kmer_hashes, sample_positions


class StaleIndexError(RuntimeError):
    pass

INDEX_FILE = "align_index.npz"
# bump whenever the on-disk layout changes; stale caches are rebuilt
FORMAT_VERSION = 3


@dataclass
class AlignIndex:
    text: np.ndarray
    hap_offsets: np.ndarray
    hap_names: list[str]
    hap_species: list[str]
    seed_keys: np.ndarray
    seed_pos: np.ndarray
    tstart: np.ndarray
    tnode: np.ndarray
    tlen: np.ndarray
    k: int
    density_bits: int
    # per-segment walk-step strand (1 = reverse-oriented step of an imported
    # bidirected graph); None when every step is forward (native chunk /
    # anchor-partition graphs) — GAF emission then prints all '>'
    tstrand: np.ndarray | None = None

    @property
    def text_len(self) -> int:
        return len(self.text)

    @property
    def num_seeds(self) -> int:
        return len(self.seed_keys)

    # ---- projection (host, vectorized) ------------------------------------
    def project(self, ts: np.ndarray, te: np.ndarray):
        """Text intervals [ts, te) -> (first-node index into tstart/tnode,
        last-node index, offset of ts within its node)."""
        i0 = np.searchsorted(self.tstart, ts, side="right") - 1
        i1 = np.searchsorted(self.tstart, np.maximum(te - 1, ts), side="right") - 1
        off = ts - self.tstart[i0]
        return i0, i1, off

    def path_nodes(self, i0: int, i1: int) -> np.ndarray:
        return self.tnode[i0 : i1 + 1]

    def path_str(self, i0: int, i1: int) -> str:
        """GAF path string for segments [i0, i1]: orientation-faithful —
        reverse-oriented walk steps of an imported bidirected graph emit
        '<' (GAF spec; the reference consumes orientations via regex node
        extraction, rcls.rs:119-146, so both characters must round-trip)."""
        nodes = self.tnode[i0 : i1 + 1]
        if self.tstrand is None:
            return "".join(f">{n}" for n in nodes)
        strands = self.tstrand[i0 : i1 + 1]
        return "".join(
            f"{'<' if s else '>'}{n}" for n, s in zip(nodes, strands)
        )

    # ---- serialization ----------------------------------------------------
    def save(self, path: str | os.PathLike) -> None:
        np.savez_compressed(
            os.fspath(path),
            text=self.text,
            hap_offsets=self.hap_offsets,
            hap_names=np.array(self.hap_names, dtype=np.str_),
            hap_species=np.array(self.hap_species, dtype=np.str_),
            seed_keys=self.seed_keys,
            seed_pos=self.seed_pos,
            tstart=self.tstart,
            tnode=self.tnode,
            tlen=self.tlen,
            tstrand=(self.tstrand if self.tstrand is not None
                     else np.zeros(0, dtype=np.int8)),
            params=np.array(
                [self.k, self.density_bits, FORMAT_VERSION], dtype=np.int64
            ),
        )

    @classmethod
    def load(cls, path: str | os.PathLike) -> "AlignIndex":
        with np.load(os.fspath(path)) as z:
            params = z["params"]
            if len(params) < 3 or int(params[2]) != FORMAT_VERSION:
                raise StaleIndexError(
                    f"{path}: index format {params[2] if len(params) > 2 else 1}"
                    f" != {FORMAT_VERSION}"
                )
            return cls(
                text=z["text"],
                hap_offsets=z["hap_offsets"],
                hap_names=[str(s) for s in z["hap_names"]],
                hap_species=[str(s) for s in z["hap_species"]],
                seed_keys=z["seed_keys"],
                seed_pos=z["seed_pos"],
                tstart=z["tstart"],
                tnode=z["tnode"],
                tlen=z["tlen"],
                tstrand=(z["tstrand"] if "tstrand" in z and len(z["tstrand"])
                         else None),
                k=int(z["params"][0]),
                density_bits=int(z["params"][1]),
            )


def auto_density_bits(text_len: int) -> int:
    """Seed-sampling density sized to the DB: 1/2^bits of k-mer positions
    are sampled on BOTH the index and the read side.  Small/mid DBs keep
    bits=3 (~16 sampled seeds on a 150bp read); for every ~4x of text beyond
    48M bases one more bit halves the seed table — the seed-lookup gather
    rounds are HBM-latency-bound over that table, so capping its footprint
    is what keeps large-DB query time flat (VERDICT r3 item 2: scale-2 query
    cost grew in the seed lookup, not the DP).  Capped at 5 so a 150bp read
    still samples ~4 seeds (the diagonal vote needs >= 2 agreeing)."""
    bits = 3
    t = 48 << 20
    while text_len > t and bits < 5:
        bits += 1
        t *= 4
    return bits


def build_align_index(
    db: DatabasePaths,
    k: int = 21,
    density_bits: int | None = None,
    max_occ: int = 512,
    save: bool = True,
) -> AlignIndex:
    """Build (or load cached) alignment index for a database.

    ``density_bits=None`` (default) sizes the seed sampling to the database
    (auto_density_bits) once the linearized text length is known."""
    cache = db.root / INDEX_FILE
    if save and cache.exists():
        try:
            return AlignIndex.load(cache)
        except StaleIndexError as e:
            import logging

            logging.getLogger(__name__).warning("rebuilding stale index: %s", e)
            cache.unlink()

    ranges = load_species_range(db.range_file)
    text_parts: list[np.ndarray] = []
    hap_offsets = [0]
    hap_names: list[str] = []
    hap_species: list[str] = []
    tstart_parts: list[np.ndarray] = []
    tnode_parts: list[np.ndarray] = []
    tlen_parts: list[np.ndarray] = []
    tstrand_parts: list[np.ndarray] = []
    offset = 0
    for r in ranges:
        graph = db.load_graph(r.species)
        for hi, name in enumerate(graph.path_names):
            seq_codes = encode_seq(graph.path_seq(hi).tobytes())
            node_starts = graph.path_node_starts(hi)[:-1] + offset
            global_nodes = graph.path(hi) + r.start  # local 0-based -> global 1-based
            text_parts.append(seq_codes)
            text_parts.append(np.full(1, 4, dtype=np.int8))  # separator
            tstart_parts.append(node_starts)
            tnode_parts.append(global_nodes)
            tlen_parts.append(graph.nodes_len[graph.path(hi)].astype(np.int32))
            tstrand_parts.append(graph.path_strand(hi).astype(np.int8))
            offset += len(seq_codes) + 1
            hap_offsets.append(offset)
            hap_names.append(name)
            hap_species.append(r.species)

    # trailing sentinel pad lets fixed-size window fetches run off the last
    # haplotype without bounds handling, and rounds the text to a multiple of
    # 256 for the device's [rows, 256] view (aligner window extraction)
    text_parts.append(np.full(1024, 4, dtype=np.int8))
    total = sum(len(t) for t in text_parts)
    text_parts.append(np.full((-total) % 256, 4, dtype=np.int8))
    text = np.concatenate(text_parts)
    if density_bits is None:
        density_bits = auto_density_bits(len(text))
    tstart = np.concatenate(tstart_parts)
    tnode = np.concatenate(tnode_parts)
    tlen = np.concatenate(tlen_parts)
    tstrand = np.concatenate(tstrand_parts) if tstrand_parts else None
    if tstrand is not None and not tstrand.any():
        tstrand = None  # all-forward: store nothing, emit all '>'

    native = None
    try:
        from ..utils.native import kmer_hash_sample_native

        native = kmer_hash_sample_native(text, k, density_bits)
    except Exception:  # pragma: no cover - fallback path
        native = None
    if native is not None:
        keys, pos = native
    else:
        hashes, valid = kmer_hashes(text, k)
        pos = sample_positions(hashes, valid, density_bits)
        keys = hashes[pos]
    order = np.argsort(keys, kind="stable")
    keys = keys[order]
    pos = pos[order].astype(np.int32)
    # drop over-frequent seeds (repeats): keys occurring more than max_occ
    uniq, counts = np.unique(keys, return_counts=True)
    if (counts > max_occ).any():
        bad = uniq[counts > max_occ]
        keep = ~np.isin(keys, bad)
        keys = keys[keep]
        pos = pos[keep]

    index = AlignIndex(
        text=text,
        hap_offsets=np.array(hap_offsets, dtype=np.int64),
        hap_names=hap_names,
        hap_species=hap_species,
        seed_keys=keys,
        seed_pos=pos,
        tstart=tstart,
        tnode=tnode,
        tlen=tlen,
        tstrand=tstrand,
        k=k,
        density_bits=density_bits,
    )
    if save:
        index.save(cache)
    return index
