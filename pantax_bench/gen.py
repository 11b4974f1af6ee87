"""The benchmark's data: genomes from a configuration's fixed seed, reads
from a run's seed, and the files the command line reads.

The generators are frozen copies of the port's own (``scale_db``'s genome
draws, ``simulate_read_batch`` and
``simulate_long_reads`` of ``pantax_tpu_torch/benchmarks.py``,
``simulate_pairs`` of ``chip_smoke.py``): the same draws in the same order,
so a seed gives the reads the port's own tools give, but they sample the
harness's genomes, never the port's index.  ``tests/test_bench_gen.py``
holds them to their sources.  ``variation_gfa`` is the benchmark's own:
the species graphs of those genomes in the shape pggb gives them.
"""
from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np

CODE2BASE = np.frombuffer(b"ACGTN", dtype=np.uint8)
_COMP = bytes.maketrans(b"ACGTN", b"TGCAN")
_SIM_ROWS = 1 << 16  # simulate_read_batch's rows a block
# the index text's sentinel tail (align/index.py): reads never reach it,
# but their templates are cut from the same layout
_TEXT_TAIL = 1024
GENOMES_HEADER = "genome_ID\tstrain_taxid\tspecies_taxid\torganism_name\tid"


@dataclass
class Community:
    """A configuration's haplotypes, species-major, strains in order.

    ``text`` is the haplotypes' codes (int8 0-3) joined with one separator
    (4) each and a tail of 4s, the layout the port's index builds from the
    same genomes; ``hap_offsets`` [H + 1] are the haplotypes' starts."""
    hap_names: list[str]
    strain_taxids: list[str]
    hap_species: list[str]
    text: np.ndarray
    hap_offsets: np.ndarray
    # () -> {species taxid: GFA bytes}, called only when the database is
    # written; None builds the graphs from the FASTAs (--create)
    make_gfa: object = None

    def genome(self, h: int) -> np.ndarray:
        return self.text[self.hap_offsets[h]:self.hap_offsets[h + 1] - 1]

    def write_files(self, root: Path) -> tuple[Path, Path | None]:
        """genomes_info.txt and one FASTA per haplotype under ``root`` (and
        the GFAs under root/gfa); returns (genomes_info, gfa dir or None)."""
        root.mkdir(parents=True, exist_ok=True)
        lines = [GENOMES_HEADER]
        for h, name in enumerate(self.hap_names):
            fa = f"{name}_genomic.fna"
            seq = CODE2BASE[self.genome(h)].tobytes()
            with open(root / fa, "wb") as f:
                f.write(b">c%d\n" % h)
                for i in range(0, len(seq), 80):
                    f.write(seq[i:i + 80] + b"\n")
            lines.append(f"{name}\t{self.strain_taxids[h]}\t"
                         f"{self.hap_species[h]}\tsynthetic\t{fa}")
        info = root / "genomes_info.txt"
        info.write_text("\n".join(lines) + "\n")
        if self.make_gfa is None:
            return info, None
        gfa = self.make_gfa()
        gdir = root / "gfa"
        gdir.mkdir(exist_ok=True)
        for sp, data in gfa.items():
            (gdir / f"{sp}.gfa").write_bytes(data)
        return info, gdir


def _community(genomes: list[np.ndarray], names, strains,
               species) -> Community:
    parts, offsets = [], [0]
    for g in genomes:
        parts += [g.astype(np.int8), np.full(1, 4, np.int8)]
        offsets.append(offsets[-1] + len(g) + 1)
    total = offsets[-1] + _TEXT_TAIL
    parts.append(np.full(_TEXT_TAIL + (-total) % 256, 4, np.int8))
    return Community(list(names), list(strains), list(species),
                     np.concatenate(parts), np.asarray(offsets, np.int64))


def scale_community(n_species: int, strains_per: int, genome_len: int,
                    snp_rate: float, seed: int) -> Community:
    """``scale_db``'s genomes: n_species random references, strains_per
    strains each at snp_rate SNPs."""
    rng = np.random.default_rng(seed)
    genomes, names, strains, species = [], [], [], []
    for sp in range(n_species):
        ref = rng.integers(0, 4, size=genome_len).astype(np.int8)
        for st in range(strains_per):
            g = ref.copy()
            m = rng.random(genome_len) < snp_rate
            g[m] = rng.integers(0, 4, size=int(m.sum()))
            genomes.append(g)
            names.append(f"GCF_{900 + sp}{chr(97 + st)}.1_x")
            strains.append(f"{900 + sp}.{st + 1}")
            species.append(str(900 + sp))
    return _community(genomes, names, strains, species)


def snp_community(n_species: int, strains_per: int, genome_len: int,
                  snp_rate: float, seed: int, max_node: int = 1024) -> Community:
    """``scale_community``'s genomes (the same draws), each species' strains
    joined in a variation graph of pggb's shape: a node for each allele of a
    column where the strains differ, the runs between those columns shared
    and cut into nodes of at most ``max_node`` bases."""
    com = scale_community(n_species, strains_per, genome_len, snp_rate, seed)

    def make_gfa() -> dict[str, bytes]:
        out = {}
        for sp in range(n_species):
            haps = range(sp * strains_per, (sp + 1) * strains_per)
            out[com.hap_species[haps[0]]] = variation_gfa(
                np.stack([com.genome(h) for h in haps]),
                ["_".join(com.hap_names[h].split("_")[:2]) for h in haps],
                max_node)
        return out

    com.make_gfa = make_gfa
    return com


def variation_gfa(g: np.ndarray, hap_ids: list[str], max_node: int) -> bytes:
    """GFA of the equal-length genomes ``g`` [S, G] (codes 0-3): one node
    an allele of every column where they differ, the runs between cut into
    nodes of at most ``max_node`` bases; one walk a genome, named by
    ``hap_ids``, spelling it."""
    S, G = g.shape
    var = np.flatnonzero((g != g[0]).any(axis=0))
    run_lo = np.concatenate([[0], var + 1])
    run_hi = np.concatenate([var, [G]])
    keep = run_hi > run_lo
    run_lo, run_hi = run_lo[keep], run_hi[keep]
    pieces = -(-(run_hi - run_lo) // max_node)
    lo = np.repeat(run_lo, pieces) + max_node * (
        np.arange(int(pieces.sum())) - np.repeat(np.cumsum(pieces) - pieces,
                                                 pieces))
    hi = np.minimum(lo + max_node, np.repeat(run_hi, pieces))
    # a column's alleles: each genome takes the node of the first genome
    # with its base; the first genome of each base makes one
    col = g[:, var]                                   # [S, V]
    eq = col[:, None, :] == col[None, :, :]           # [t, s, V]
    first = eq.argmax(axis=0)                         # [s, V]
    new = first == np.arange(S)[:, None]
    rank = np.cumsum(new, axis=0) - 1                 # node rank of a maker
    strain_rank = np.take_along_axis(rank, first, axis=0)
    # items in position order: shared pieces and variant columns
    pos = np.concatenate([lo, var])
    n_nodes = np.concatenate([np.ones(len(lo), np.int64), new.sum(axis=0)])
    order = np.argsort(pos, kind="stable")
    first_id = np.empty(len(pos), np.int64)
    first_id[order] = np.cumsum(n_nodes[order]) - n_nodes[order] + 1
    shared_id, var_id = first_id[:len(lo)], first_id[len(lo):]
    seqs: list[bytes] = [b""] * int(n_nodes.sum())
    text = CODE2BASE[g[0]].tobytes()
    for i, a, b in zip(shared_id.tolist(), lo.tolist(), hi.tolist()):
        seqs[i - 1] = text[a:b]
    bases = CODE2BASE[col]
    for s in range(S):
        for i, c in zip((var_id + rank[s])[new[s]].tolist(),
                        bases[s][new[s]].tolist()):
            seqs[i - 1] = bytes((c,))
    lines = [b"H\tVN:Z:1.1\n"]
    lines += [b"S\t%d\t%s\n" % (i + 1, q) for i, q in enumerate(seqs)]
    for s in range(S):
        ids = np.concatenate([shared_id, var_id + strain_rank[s]])[order]
        walk = b"".join(b">%d" % i for i in ids.tolist())
        lines.append(b"W\t%s\t0\tmerged\t0\t%d\t%s\n"
                     % (hap_ids[s].encode(), G, walk))
    return b"".join(lines)


def community(config: dict) -> Community:
    """The community a configuration file describes (its "genomes")."""
    g = dict(config["genomes"])
    kind = g.pop("generator")
    return {"scale": scale_community, "snp": snp_community}[kind](**g)


def _encode(ascii_seq: np.ndarray) -> np.ndarray:
    lut = np.full(256, 4, np.int8)
    lut[np.frombuffer(b"ACGT", np.uint8)] = np.arange(4, dtype=np.int8)
    return lut[ascii_seq]


def _row_blocks(n: int):
    return (slice(lo, min(lo + _SIM_ROWS, n)) for lo in range(0, n, _SIM_ROWS))


def _haps(rng, H: int, n: int, hap_weights):
    if hap_weights is None:
        return rng.integers(0, H, size=n)
    w = np.asarray(hap_weights, dtype=np.float64)
    return rng.choice(H, size=n, p=w / w.sum())


def simulate_read_batch(com: Community, n_reads: int, read_len: int,
                        error_rate: float, seed=0, hap_weights=None,
                        indel_rate: float = 0.0005):
    """Reads from the community's text with substitutions and 1 bp indels,
    half reverse-complemented: (codes int8 [n, Lr+pad], lens, truth hap)."""
    rng = np.random.default_rng(seed)
    hap = _haps(rng, len(com.hap_names), n_reads, hap_weights)
    spans = np.diff(com.hap_offsets) - 1
    margin = 32
    starts = (com.hap_offsets[hap] + rng.integers(
        0, np.maximum(spans[hap] - read_len - margin, 1))).astype(np.int64)
    L = ((read_len + 31) // 32) * 32
    cols = np.arange(read_len)
    codes = np.full((n_reads, L), 4, dtype=np.int8)
    body = codes[:, :read_len]
    if indel_rate > 0:
        ins_at = [np.zeros(0, dtype=np.int64)]
        for sl in _row_blocks(n_reads):
            ev = rng.random((sl.stop - sl.start, read_len))
            is_del = ev < indel_rate / 2
            is_ins = (ev >= indel_rate / 2) & (ev < indel_rate)
            shift = np.cumsum(is_del.astype(np.int64) - is_ins.astype(np.int64),
                              axis=1)
            take = np.clip(cols[None, :] + shift, 0, None)
            body[sl] = com.text[starts[sl, None] + take]
            ins_at.append(np.flatnonzero(is_ins) + sl.start * read_len)
        ins_at = np.concatenate(ins_at)
        body[ins_at // read_len, ins_at % read_len] = rng.integers(
            0, 4, size=len(ins_at), dtype=np.int8)
    else:
        for sl in _row_blocks(n_reads):
            body[sl] = com.text[starts[sl, None] + cols[None, :]]
    if error_rate > 0:
        m = np.empty((n_reads, read_len), dtype=bool)
        for sl in _row_blocks(n_reads):
            m[sl] = rng.random((sl.stop - sl.start, read_len)) < error_rate
        np.copyto(body, rng.integers(0, 4, size=m.shape, dtype=np.int8),
                  where=m)
        del m
    flip = rng.random(n_reads) < 0.5
    for sl in _row_blocks(n_reads):
        blk, f = codes[sl], flip[sl]
        rc = 3 - blk[f][:, ::-1]
        rc = np.where(rc < 0, 4, rc)
        blk[f] = np.roll(rc, read_len - L, axis=1)
    lens = np.full(n_reads, read_len, dtype=np.int64)
    return codes, lens, hap


def simulate_long_reads(com: Community, n_reads: int, read_len: int,
                        sub_rate: float = 0.004, ins_rate: float = 0.003,
                        del_rate: float = 0.003, seed=0, hap_weights=None):
    """HiFi/ONT-like reads with substitutions and 1 bp indels, half
    reverse-complemented: ([(read_id, seq bytes)], truth hap per read)."""
    rng = np.random.default_rng(seed)
    hap = _haps(rng, len(com.hap_names), n_reads, hap_weights)
    spans = np.diff(com.hap_offsets) - 1
    margin = int(read_len * max(del_rate, 0.01) * 4) + 64
    starts = (com.hap_offsets[hap] + rng.integers(
        0, np.maximum(spans[hap] - read_len - margin, 1))).astype(np.int64)
    reads = []
    for i in range(n_reads):
        tmpl = com.text[starts[i]:starts[i] + read_len + margin]
        ev = rng.random(read_len)
        is_del = ev < del_rate
        is_ins = (ev >= del_rate) & (ev < del_rate + ins_rate)
        shift = np.cumsum(is_del.astype(np.int64) - is_ins.astype(np.int64))
        codes = tmpl[np.clip(np.arange(read_len) + shift, 0,
                             len(tmpl) - 1)].copy()
        codes[is_ins] = rng.integers(0, 4, size=int(is_ins.sum()),
                                     dtype=np.int8)
        sub = rng.random(read_len) < sub_rate
        codes[sub] = rng.integers(0, 4, size=int(sub.sum()), dtype=np.int8)
        seq = CODE2BASE[np.clip(codes, 0, 4)].tobytes()
        if rng.random() < 0.5:
            seq = seq.translate(_COMP)[::-1]
        reads.append((f"L{i}", seq))
    return reads, hap


def simulate_pairs(com: Community, n: int, seed, mate_len: int = 150,
                   sub: float = 0.01, indel: float = 0.0005,
                   hap_weights=None):
    """FR mate pairs: fragments uniform in 250-500 bp; mate 1 the
    fragment's first mate_len bases, mate 2 the reverse complement of its
    last, half the fragments read from the other strand (mates swapped);
    substitutions and 1 bp indels a mate.  ((codes1, lens1, codes2,
    lens2), truth hap per pair).  ``hap_weights`` None draws the haplotypes
    as chip_smoke.simulate_pairs does."""
    rng = np.random.default_rng(seed)
    hap = _haps(rng, len(com.hap_names), n, hap_weights)
    spans = np.diff(com.hap_offsets) - 1
    frag = rng.integers(250, 501, size=n)
    starts = (com.hap_offsets[hap] + rng.integers(
        0, np.maximum(spans[hap] - frag - 64, 1))).astype(np.int64)
    cols = np.arange(mate_len)
    mates = []
    for origin in (starts, starts + frag - mate_len):
        ev = rng.random((n, mate_len))
        shift = np.cumsum((ev < indel / 2).astype(np.int64)
                          - ((ev >= indel / 2) & (ev < indel)), axis=1)
        m = com.text[origin[:, None] + np.clip(cols + shift, 0, None)]
        is_ins = (ev >= indel / 2) & (ev < indel)
        m[is_ins] = rng.integers(0, 4, size=int(is_ins.sum()), dtype=np.int8)
        sub_m = rng.random(m.shape) < sub
        m[sub_m] = rng.integers(0, 4, size=int(sub_m.sum()), dtype=np.int8)
        mates.append(m)
    end = mates[1][:, ::-1]
    mates[1] = np.where(end < 4, 3 - end, 4).astype(np.int8)
    swap = rng.random(n) < 0.5
    L = -(-mate_len // 32) * 32
    out = []
    for m in (np.where(swap[:, None], mates[1], mates[0]),
              np.where(swap[:, None], mates[0], mates[1])):
        codes = np.full((n, L), 4, np.int8)
        codes[:, :mate_len] = m
        out += [codes, np.full(n, mate_len, np.int64)]
    return tuple(out), hap


# ---------------------------------------------------------------------------
# FASTQ files
# ---------------------------------------------------------------------------
def _id_bytes(prefix: bytes, idx: np.ndarray, width: int = 8) -> np.ndarray:
    """[n, len(prefix) + width] ASCII ids: prefix and zero-padded index."""
    digits = (idx[:, None] // 10 ** np.arange(width - 1, -1, -1)) % 10
    head = np.broadcast_to(np.frombuffer(prefix, np.uint8),
                           (len(idx), len(prefix)))
    return np.concatenate([head, (digits + 48).astype(np.uint8)], axis=1)


def write_fastq_codes(path: Path, prefix: str, codes: np.ndarray,
                      read_len: int) -> None:
    """FASTQ of equal-length code rows (quality 'I'), ids prefix + the
    row's zero-padded index, written as fixed-width records."""
    n = len(codes)
    with open(path, "wb") as f:
        for lo in range(0, n, _SIM_ROWS):
            hi = min(lo + _SIM_ROWS, n)
            ids = _id_bytes(prefix.encode(), np.arange(lo, hi))
            m = hi - lo
            rec = np.concatenate([
                np.full((m, 1), ord("@"), np.uint8), ids,
                np.full((m, 1), 10, np.uint8),
                CODE2BASE[codes[lo:hi, :read_len]],
                np.broadcast_to(np.frombuffer(b"\n+\n", np.uint8), (m, 3)),
                np.full((m, read_len), ord("I"), np.uint8),
                np.full((m, 1), 10, np.uint8)], axis=1)
            f.write(rec.tobytes())


def write_fastq_records(path: Path, reads) -> None:
    """FASTQ of (id, sequence bytes) records (quality 'I')."""
    with open(path, "wb") as f:
        for rid, seq in reads:
            f.write(b"@%s\n%s\n+\n%s\n" % (rid.encode(), seq, b"I" * len(seq)))


@dataclass
class Sample:
    """One sample's read files and its read (mate) and base counts."""
    files: list[Path]
    n_reads: int
    bases: int
    origins: np.ndarray | None = None  # reads (pairs) drawn from each haplotype


def _origins(hap: np.ndarray, com: Community) -> np.ndarray:
    return np.bincount(hap, minlength=len(com.hap_names))


def make_sample(traffic: dict, com: Community, seed, n: int, out: Path,
                name: str) -> Sample:
    """The sample files of ``n`` reads (pairs) of a traffic mix, drawn from
    ``seed`` (an int or a numpy SeedSequence), under ``out``."""
    kind = traffic["kind"]
    w = traffic.get("strain_weights")
    weights = None if w is None else w * (len(com.hap_names) // len(w))
    if kind == "short":
        L = traffic["read_len"]
        codes, _, hap = simulate_read_batch(
            com, n, L, traffic["sub_rate"], seed=seed, hap_weights=weights,
            indel_rate=traffic["indel_rate"])
        path = out / f"{name}.fq"
        write_fastq_codes(path, "r", codes, L)
        return Sample([path], n, n * L, _origins(hap, com))
    if kind == "paired":
        L = traffic["mate_len"]
        (c1, _, c2, _), hap = simulate_pairs(
            com, n, seed, mate_len=L, sub=traffic["sub_rate"],
            indel=traffic["indel_rate"], hap_weights=weights)
        files = [out / f"{name}_1.fq", out / f"{name}_2.fq"]
        write_fastq_codes(files[0], "a", c1, L)
        write_fastq_codes(files[1], "b", c2, L)
        return Sample(files, 2 * n, 2 * n * L, _origins(hap, com))
    if kind == "long":
        L = traffic["read_len"]
        reads, hap = simulate_long_reads(
            com, n, L, traffic["sub_rate"], traffic["ins_rate"],
            traffic["del_rate"], seed=seed, hap_weights=weights)
        path = out / f"{name}.fq"
        write_fastq_records(path, reads)
        return Sample([path], n, sum(len(s) for _, s in reads),
                      _origins(hap, com))
    raise ValueError(f"unknown traffic kind {kind!r}")
