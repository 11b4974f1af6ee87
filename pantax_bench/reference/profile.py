"""Reference profile of a sample: which species each read comes from, each
species' coverage and each strain's coverage.

Semantics (PanTax's outputs, computed plainly):

- a read is classified to the species of the genomes it matches: votes of
  its k-mers (both strands) against a k-mer index of every haplotype; a
  read is placed when its best species has at least MIN_VOTES votes and
  more than twice the next one's;
- a species' coverage is the bases of the reads placed on it over the
  mean length of its genomes (species_abundance.txt's predicted_coverage);
- a strain's coverage is the species' coverage times the strain's share
  of the species' reads: the maximum-likelihood shares (EM) over a seeded
  sample of the placed reads, each read compatible with the strains its
  banded edit distance ties for best (strain_abundance.txt's
  predicted_coverage).  Long reads are aligned as PIECES pieces of PIECE
  bp, each placed by its own votes, and a read's distance to a strain is
  the sum over its pieces.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
from numpy.lib.stride_tricks import sliding_window_view

K = 16          # k-mer length (2 bits a base: a k-mer is one uint32)
STRIDE = 4      # the index holds the k-mers that start at multiples of it
MIN_VOTES = 2
BAND = 6        # the edit-distance band's half width
PIECE = 150     # long reads are aligned in pieces of this many bases,
PIECES = 8      # this many a read
EM_ITERS = 200
_POWF = 4.0 ** np.arange(K - 1, -1, -1)


# ---------------------------------------------------------------------------
# FASTQ
# ---------------------------------------------------------------------------
@dataclass
class Reads:
    ids: np.ndarray     # bytes ids (numpy 'S'), first header word
    codes: np.ndarray   # int8 [n, Lmax], 0-3 and 4 (N and padding)
    lens: np.ndarray    # int64 [n]


def _lines(data: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    ends = np.flatnonzero(data == 10)
    starts = np.concatenate([[0], ends[:-1] + 1])
    return starts, ends


def _gather(data: np.ndarray, starts: np.ndarray, lens: np.ndarray,
            fill: int, width: int | None = None) -> np.ndarray:
    """[n, width] bytes of data[starts[i]:starts[i] + lens[i]], fill after."""
    width = int(lens.max(initial=0)) if width is None else width
    col = np.arange(width)
    idx = np.minimum(starts[:, None] + col, len(data) - 1)
    out = data[idx]
    out[col[None, :] >= lens[:, None]] = fill
    return out


def _words(data: np.ndarray, starts: np.ndarray, ends: np.ndarray) -> np.ndarray:
    """numpy 'S' array of data[starts:ends] cut at the first space or tab."""
    width = max(int((ends - starts).max(initial=1)), 1)
    raw = _gather(data, starts, ends - starts, 32, width)
    stop = np.argmax((raw == 32) | (raw == 9), axis=1)
    stop[~((raw == 32) | (raw == 9)).any(axis=1)] = width
    raw[np.arange(width)[None, :] >= stop[:, None]] = 0
    return np.ascontiguousarray(raw).view(f"S{width}").ravel()


_LUT = np.full(256, 4, np.int8)
_LUT[np.frombuffer(b"ACGTacgt", np.uint8)] = [0, 1, 2, 3, 0, 1, 2, 3]


def read_fastq(path) -> Reads:
    data = np.fromfile(path, np.uint8)
    starts, ends = _lines(data)
    if len(starts) % 4 or (len(starts) and np.any(data[starts[0::4]] != 64)):
        raise ValueError(f"{path}: not a 4-line FASTQ")
    ids = _words(data, starts[0::4] + 1, ends[0::4])
    s0, e0 = starts[1::4], ends[1::4]
    lens = (e0 - s0).astype(np.int64)
    step = np.diff(s0)
    if len(s0) and np.all(lens == lens[0]) and np.all(step == step[:1]):
        # equal records: a strided view, no index matrix
        stride = int(step[0]) if len(step) else 0
        seqs = np.lib.stride_tricks.as_strided(
            data[s0[0]:], shape=(len(s0), int(lens[0])), strides=(stride, 1))
        codes = _LUT[seqs]
    else:
        codes = np.concatenate([_LUT[_gather(data, s0[i:i + 4096],
                                             lens[i:i + 4096], ord("N"),
                                             int(lens.max()))]
                                for i in range(0, len(s0), 4096)])
    return Reads(ids, codes, lens)


def concat_reads(parts: list[Reads]) -> Reads:
    width = max(p.codes.shape[1] for p in parts)
    codes = np.concatenate([np.pad(p.codes, ((0, 0), (0, width - p.codes.shape[1])),
                                   constant_values=4) for p in parts])
    ids = np.concatenate([p.ids.astype(object) for p in parts]).astype(bytes)
    return Reads(ids, codes, np.concatenate([p.lens for p in parts]))


def revcomp(codes: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """Each row's reverse complement over its own length, padded with 4."""
    width = codes.shape[1]
    col = np.arange(width)
    src = lens[:, None] - 1 - col[None, :]
    rc = np.take_along_axis(codes, np.clip(src, 0, width - 1), axis=1)
    rc = np.where(rc < 4, 3 - rc, 4).astype(np.int8)
    rc[src < 0] = 4
    return rc


# ---------------------------------------------------------------------------
# k-mer index and votes
# ---------------------------------------------------------------------------
def kmers_at(codes: np.ndarray, offsets: np.ndarray):
    """Canonical k-mers of each row at ``offsets`` ([m] for every row, or
    [n, m]): (keys uint32 [n, m], forward_is_canonical [n, m], valid
    [n, m]: inside the row's width and free of N)."""
    n, width = codes.shape
    if width < K:
        z = np.zeros((n, np.shape(offsets)[-1]), np.uint32)
        return z, z.astype(bool), z.astype(bool)
    sw = sliding_window_view(codes, K, axis=1)
    off = np.clip(offsets, 0, width - K)
    win = sw[:, off] if off.ndim == 1 else sw[np.arange(n)[:, None], off]
    valid = (win < 4).all(axis=2) & (np.asarray(offsets) >= 0) \
        & (np.asarray(offsets) <= width - K)
    # float64 products are exact below 2**53 and run through BLAS
    w = (win & 3).astype(np.float64)
    fwd = w @ _POWF
    rev = 3.0 * _POWF.sum() - w @ _POWF[::-1]
    return np.minimum(fwd, rev).astype(np.uint32), fwd <= rev, valid


class KmerIndex:
    """The canonical k-mers at every STRIDE-th position of every haplotype,
    sorted, with a table of where each 24-bit prefix's keys start: a hit
    gives the haplotype, the position and the k-mer's orientation."""

    PREFIX_SHIFT = 2 * K - 24

    def __init__(self, genomes: list[np.ndarray]):
        keys, orient, hap, pos = [], [], [], []
        for h, g in enumerate(genomes):
            p = np.arange(0, len(g) - K + 1, STRIDE)
            k, o, ok = kmers_at(np.asarray(g, np.int8)[None, :], p)
            keys.append(k[0][ok[0]])
            orient.append(o[0][ok[0]])
            pos.append(p[ok[0]])
            hap.append(np.full(int(ok[0].sum()), h, np.int32))
        keys = np.concatenate(keys)
        order = np.argsort(keys)
        # one entry a key: strains share most k-mers and a repeat node's
        # recur thousands of times, and a lookup takes the first anyway
        first = np.ones(len(order), bool)
        first[1:] = keys[order[1:]] != keys[order[:-1]]
        order = order[first]
        self.keys = keys[order]
        self.orient = np.concatenate(orient)[order]
        self.hap = np.concatenate(hap)[order]
        self.pos = np.concatenate(pos)[order]
        counts = np.bincount(self.keys >> self.PREFIX_SHIFT, minlength=1 << 24)
        self.starts = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)

    def lookup(self, keys: np.ndarray, valid: np.ndarray) -> np.ndarray:
        """The index entry of each key, -1 where none."""
        entry = np.full(keys.shape, -1, np.int64)
        flat = np.flatnonzero(valid)
        kf = keys.ravel()[flat]
        pfx = (kf >> self.PREFIX_SHIFT).astype(np.int64)
        lo, hi = self.starts[pfx], self.starts[pfx + 1]
        live = lo < hi
        flat, kf, lo, hi = flat[live], kf[live], lo[live], hi[live]
        out = entry.ravel()
        while len(flat):
            eq = self.keys[lo] == kf
            out[flat[eq]] = lo[eq]
            more = ~eq & (lo + 1 < hi)
            flat, kf, lo, hi = flat[more], kf[more], lo[more] + 1, hi[more]
        return entry


def _window_offsets(L: int, n_windows: int) -> np.ndarray:
    """STRIDE consecutive k-mer starts at n_windows spots along a read of
    length L: one of each run starts on the index's stride where the read
    has no indel before it."""
    last = max(L - K - STRIDE + 1, 0)
    spots = np.unique(np.linspace(0, last, n_windows).astype(np.int64))
    return (spots[:, None] + np.arange(STRIDE)).ravel()


def place_species(reads: Reads, index: KmerIndex, hap_species: np.ndarray,
                  n_species: int, n_windows: int, rows: int = 1 << 14
                  ) -> np.ndarray:
    """Species index of every read, -1 where it is not placed."""
    out = np.full(len(reads.lens), -1, np.int64)
    for lo in range(0, len(out), rows):
        sl = slice(lo, min(lo + rows, len(out)))
        codes, lens = reads.codes[sl], reads.lens[sl]
        L = int(lens.max(initial=0))
        off = _window_offsets(L, n_windows)
        # a row shorter than the widest keeps its windows inside itself
        off_rows = np.minimum(off[None, :], np.maximum(lens[:, None] - K, 0))
        k, _, ok = kmers_at(codes, off_rows)
        e = index.lookup(k, ok & (off_rows + K <= lens[:, None]))
        r, c = np.nonzero(e >= 0)
        votes = np.zeros((len(lens), max(n_species, 2)), np.int64)
        np.add.at(votes, (r, hap_species[index.hap[e[r, c]]]), 1)
        top2 = -np.sort(-votes, axis=1)[:, :2]
        placed = (top2[:, 0] >= MIN_VOTES) & (top2[:, 0] > 2 * top2[:, 1])
        out[sl] = np.where(placed, votes.argmax(axis=1), -1)
    return out


# ---------------------------------------------------------------------------
# placement on the species' coordinates and edit distance to its strains
# ---------------------------------------------------------------------------
def _mode_rows(keys: np.ndarray, valid: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Per row, the most frequent valid key (the smallest on ties) and its
    count (0 where the row has none)."""
    n, m = keys.shape
    big = np.iinfo(np.int64).max
    s = np.sort(np.where(valid, keys, big), axis=1)
    flat = s.ravel()
    row = np.repeat(np.arange(n), m)
    brk = np.ones(len(flat), bool)
    brk[1:] = (flat[1:] != flat[:-1]) | (row[1:] != row[:-1])
    run = np.cumsum(brk) - 1
    cnt = np.bincount(run)[run]
    cnt[flat == big] = 0
    cnt2 = cnt.reshape(n, m)
    j = np.argmax(cnt2, axis=1)
    return s[np.arange(n), j], cnt2[np.arange(n), j]


def place_on_species(codes: np.ndarray, lens: np.ndarray, species: np.ndarray,
                     index: KmerIndex, hap_species: np.ndarray):
    """(forward-strand rows, diagonal, placed) of reads on their species'
    coordinates: the most voted (strand, position - offset) of the k-mer
    hits inside the species."""
    width = codes.shape[1]
    off = np.arange(0, max(width - K + 1, 1))
    k, r_or, ok = kmers_at(codes, off)
    ok &= off[None, :] + K <= lens[:, None]
    e = index.lookup(k, ok)
    es = np.maximum(e, 0)
    inside = (e >= 0) & (hap_species[index.hap[es]] == species[:, None])
    # the same orientation on both sides: the read runs forward on the
    # genome; else its reverse complement does, where this k-mer starts
    # at lens - K - off
    rc = r_or != index.orient[es]
    o = np.where(rc, lens[:, None] - K - off[None, :], off[None, :])
    diag = index.pos[es].astype(np.int64) - o
    key = (diag + (1 << 40)) * 2 + rc
    best_key, best_cnt = _mode_rows(key, inside)
    strand = best_key % 2
    diag = best_key // 2 - (1 << 40)
    fwd = np.where(strand[:, None] == 1, revcomp(codes, lens), codes)
    return fwd, diag, best_cnt >= MIN_VOTES


def edit_distance(reads: np.ndarray, lens: np.ndarray, windows: np.ndarray
                  ) -> np.ndarray:
    """Banded edit distance of each read (all of it) against its window
    (BAND bases of slack on both sides, free ends on the window):
    windows [n, Lmax + 2 BAND] hold the reference around the diagonal."""
    n, width = reads.shape
    W = 2 * BAND + 1
    big = 1 << 20
    D = np.zeros((n, W), np.int64)            # free start on the window
    kk = np.arange(W)
    best = np.full(n, big, np.int64)
    for i in range(1, width + 1):
        ref = windows[:, i - 1 + kk]          # [n, W]
        sub = (reads[:, i - 1:i] != ref) | (ref >= 4) | (reads[:, i - 1:i] >= 4)
        new = D + sub
        new[:, :-1] = np.minimum(new[:, :-1], D[:, 1:] + 1)   # read base vs gap
        for k in range(1, W):                                  # window base vs gap
            np.minimum(new[:, k], new[:, k - 1] + 1, out=new[:, k])
        D = new
        done = lens == i
        if done.any():
            best[done] = D[done].min(axis=1)
    return best


def strain_distances(codes, lens, species, index, genomes, hap_species,
                     sp_haps: list[np.ndarray], rows: int = 4096) -> np.ndarray:
    """[n, max strains] edit distance of each read to each strain of its
    species (big where unplaced or past the species' strains)."""
    big = 1 << 20
    n = len(lens)
    S = max(len(h) for h in sp_haps)
    out = np.full((n, S), big, np.int64)
    if n == 0:
        return out
    parts = [place_on_species(codes[lo:lo + rows], lens[lo:lo + rows],
                              species[lo:lo + rows], index, hap_species)
             for lo in range(0, n, rows)]
    fwd, diag, ok = (np.concatenate(p) for p in zip(*parts))
    width = codes.shape[1]
    col = np.arange(width + 2 * BAND)
    for sp in np.unique(species[ok]):
        rows = np.flatnonzero(ok & (species == sp))
        for j, h in enumerate(sp_haps[sp]):
            g = genomes[h]
            idx = diag[rows, None] - BAND + col[None, :]
            win = np.where((idx >= 0) & (idx < len(g)),
                           g[np.clip(idx, 0, len(g) - 1)], 4).astype(np.int8)
            out[rows, j] = edit_distance(fwd[rows], lens[rows], win)
    return out


def em_shares(dist: np.ndarray, n_strains: int, max_dist: np.ndarray
              ) -> np.ndarray:
    """Maximum-likelihood strain shares of reads each compatible with the
    strains at its smallest distance (reads over max_dist left out)."""
    d = dist[:, :n_strains]
    low = d.min(axis=1)
    keep = low <= max_dist
    compat = (d[keep] == low[keep, None]).astype(np.float64)
    f = np.full(n_strains, 1.0 / n_strains)
    if not len(compat):
        return f
    for _ in range(EM_ITERS):
        w = compat * f
        w /= w.sum(axis=1, keepdims=True)
        f = w.mean(axis=0)
    return f


def _pieces(codes: np.ndarray, lens: np.ndarray):
    """PIECES PIECE-bp pieces of each long read, spread evenly along it:
    (codes [m, PIECE], lens, read row of each piece)."""
    n_fit = lens // PIECE
    per = np.minimum(n_fit, PIECES)
    row = np.repeat(np.arange(len(lens)), per)
    k = np.arange(len(row)) - np.repeat(np.cumsum(per) - per, per)
    start = k * (n_fit[row] // np.maximum(per[row], 1)) * PIECE
    idx = start[:, None] + np.arange(PIECE)
    return codes[row[:, None], idx], np.full(len(row), PIECE, np.int64), row


# ---------------------------------------------------------------------------
# the profile
# ---------------------------------------------------------------------------
@dataclass
class Profile:
    """What the reference (or the control) says of a sample."""
    ids: np.ndarray = None              # bytes ids of every read
    species_of: np.ndarray = None       # species taxid (bytes) or b"" unplaced
    lens_of: np.ndarray = None          # read lengths
    species_cov: dict = field(default_factory=dict)   # taxid -> coverage
    strain_cov: dict = field(default_factory=dict)    # genome_ID -> coverage
    n_reads: int = 0
    n_placed: int = 0


def reference_profile(files, hap_names, hap_species, genomes, *,
                      long_reads: bool, em_sample: int, seed,
                      keep_rows: np.ndarray | None = None,
                      index: KmerIndex | None = None) -> Profile:
    """The reference profile of the sample in ``files`` (one FASTQ, or two
    mate files whose reads all count).  ``keep_rows`` (a bool mask over the
    reads in file order) restricts it to those reads: the control.  The EM
    sample of ``em_sample`` placed reads is drawn from ``seed``."""
    reads = concat_reads([read_fastq(f) for f in files])
    n = len(reads.lens)
    sp_names = sorted(set(hap_species), key=list(hap_species).index)
    sp_idx = {s: i for i, s in enumerate(sp_names)}
    hs = np.array([sp_idx[s] for s in hap_species], np.int64)
    sp_haps = [np.flatnonzero(hs == i) for i in range(len(sp_names))]
    index = index or KmerIndex(genomes)
    species = place_species(reads, index, hs, len(sp_names),
                            n_windows=6)
    if keep_rows is not None:
        species = np.where(keep_rows, species, -1)
    placed = species >= 0
    mean_len = np.array([np.mean([len(genomes[h]) for h in hh])
                         for hh in sp_haps])
    bases = np.bincount(species[placed], weights=reads.lens[placed],
                        minlength=len(sp_names))
    prof = Profile(n_reads=n, n_placed=int(placed.sum()))
    prof.ids = reads.ids
    prof.species_of = np.array(list(sp_names) + [""], dtype=bytes)[species]
    prof.lens_of = reads.lens
    prof.species_cov = {sp_names[i]: float(bases[i] / mean_len[i])
                        for i in range(len(sp_names)) if bases[i] > 0}

    rng = np.random.default_rng(seed)
    cand = np.flatnonzero(placed)
    take = np.sort(rng.choice(cand, size=min(em_sample, len(cand)),
                              replace=False)) if len(cand) else cand
    codes, lens, sp = reads.codes[take], reads.lens[take], species[take]
    if long_reads:
        pc, pl, prow = _pieces(codes, lens)
        pd = strain_distances(pc, pl, sp[prow], index, genomes, hs, sp_haps)
        good = pd.min(axis=1) <= PIECE // 10
        dist = np.zeros((len(take), pd.shape[1]), np.int64)
        np.add.at(dist, prow[good], pd[good])
        max_dist = lens  # every read whose pieces placed counts
    else:
        dist = strain_distances(codes, lens, sp, index, genomes, hs, sp_haps)
        max_dist = lens // 10
    for i, hh in enumerate(sp_haps):
        if sp_names[i] not in prof.species_cov:
            continue
        rows = sp == i
        f = em_shares(dist[rows], len(hh), max_dist[rows])
        for j, h in enumerate(hh):
            prof.strain_cov[hap_names[h]] = float(
                f[j] * prof.species_cov[sp_names[i]])
    return prof
