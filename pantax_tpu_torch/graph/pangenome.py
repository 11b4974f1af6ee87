"""Anchor-partition pangenome constructor for multi-genome species.

Replaces the reference's external pggb/cactus pipeline
(PanTax's src/task_scheduling.rs:404-500) with an in-process,
deterministic construction designed for strain-level genomes (ANI >= ~95):

  1. find *universal unique anchors* — k-mers occurring exactly once in every
     genome of the species;
  2. enforce collinearity by keeping, per genome, a longest-increasing
     subsequence of anchor positions (assembly strand is normalized first —
     see :func:`orient_genomes` — and exact segmental inversions share the
     forward nodes reverse-oriented; other structural rearrangements degrade
     into longer segments, never into a broken graph);
  3. cut every genome at its anchor start positions; between consecutive
     anchors each genome contributes one segment;
  4. collapse identical segment sequences within a slot into shared nodes;
     distinct sequences become parallel bubble nodes; every node is chopped
     into <= chunk_size pieces (matching the eq-1 chunking granularity,
     PanTax's src/constants.rs:3);
  5. haplotype paths spell each input genome exactly.

The output is a :class:`SpeciesGraph` whose unique trio nodes discriminate
strains exactly as pggb-built graphs do in the reference pipeline.
"""
from __future__ import annotations

from bisect import bisect_left

import numpy as np

from .core import SpeciesGraph

DEFAULT_K = 31
# Pangenome nodes are chopped finer than the eq-1 chain graphs (1024) so that
# short reads span >= 3 nodes and produce trio-node coverage — the strain
# filters key on it (profile.rs:1080-1227).  pggb graphs get this granularity
# from base-level alignment; the anchor-partition graph gets it by chunking.
DEFAULT_PAN_CHUNK = 64


def _unique_kmers(seq: bytes, k: int) -> tuple[np.ndarray, np.ndarray]:
    """(sorted keys, positions) of k-mers occurring exactly once.

    Native single-pass scan when available (utils/native.py); Python dict
    fallback otherwise.  N-containing k-mers are excluded."""
    from ..align.encode import encode_seq

    try:
        from ..utils.native import unique_kmer_positions_native

        res = unique_kmer_positions_native(encode_seq(seq), k)
        if res is not None:
            return res
    except Exception:  # pragma: no cover - fallback path
        pass
    # Mirror the native last_invalid logic: skip windows containing any
    # ambiguity code (code 4 covers N plus lowercase/IUPAC bases), not just
    # uppercase b'N' — code 4 would overflow the 2-bit key shift and make
    # keys non-injective (spurious cross-genome anchor matches).
    codes = encode_seq(seq)
    invalid = np.flatnonzero(codes == 4)
    bad = np.zeros(max(len(seq) - k + 1, 0), dtype=bool)
    for p in invalid:
        bad[max(p - k + 1, 0) : p + 1] = True
    seen: dict[bytes, int] = {}
    dup: set[bytes] = set()
    for i in range(len(seq) - k + 1):
        if bad[i]:
            continue
        kmer = seq[i : i + k]
        if kmer in dup:
            continue
        if kmer in seen:
            del seen[kmer]
            dup.add(kmer)
        else:
            seen[kmer] = i
    # pack to 2-bit keys for a sorted representation matching the native path
    keys = np.empty(len(seen), dtype=np.uint64)
    poss = np.empty(len(seen), dtype=np.int64)
    for j, (kmer, p) in enumerate(seen.items()):
        key = np.uint64(0)
        for c in codes[p : p + k]:
            key = (key << np.uint64(2)) | np.uint64(c)
        keys[j] = key
        poss[j] = p
    order = np.argsort(keys)
    return keys[order], poss[order]


_RC_BYTES = np.full(256, ord("N"), dtype=np.uint8)
for _a, _b in ((b"A", b"T"), (b"C", b"G"), (b"G", b"C"), (b"T", b"A")):
    _RC_BYTES[_a[0]] = _b[0]
    _RC_BYTES[_a[0] + 32] = _b[0]


def _rc_seq(seq: bytes) -> bytes:
    return _RC_BYTES[np.frombuffer(seq, dtype=np.uint8)[::-1]].tobytes()


def _rc_keys(keys: np.ndarray, k: int) -> np.ndarray:
    """Reverse-complement 2-bit-packed k-mer keys arithmetically (no rescan):
    complement every base (~code & 3) then reverse the 2-bit groups."""
    x = (~keys.astype(np.uint64))  # complement: 3 - c == ~c & 3 per group
    m2 = np.uint64(0x3333333333333333)
    x = ((x & m2) << np.uint64(2)) | ((x >> np.uint64(2)) & m2)
    m4 = np.uint64(0x0F0F0F0F0F0F0F0F)
    x = ((x & m4) << np.uint64(4)) | ((x >> np.uint64(4)) & m4)
    x = x.byteswap()
    return x >> np.uint64(64 - 2 * k)


def orient_genomes(
    seqs: list[bytes], k: int = DEFAULT_K, uniq=None
) -> list[bool]:
    """Per-genome flag: build on the reverse complement? (True = flip.)

    A genome assembled on the opposite strand of genome 0 shares (almost) no
    forward unique k-mers but (almost) all reverse-complemented ones.  The
    reference never faces this — pggb/vg handle orientation natively
    (zip.rs:116-159 consumes already-bidirected graphs); the anchor
    constructor normalizes orientation up front instead, so inverted
    assemblies share anchors/nodes rather than degrading to parallel chains.
    """
    if uniq is None:
        uniq = [_unique_kmers(s, k) for s in seqs]
    flips = [False]
    base = uniq[0][0]
    for keys, _ in uniq[1:]:
        fwd = np.intersect1d(base, keys, assume_unique=True).size
        rc = np.intersect1d(
            base, np.sort(_rc_keys(keys, k)), assume_unique=True
        ).size
        flips.append(rc > 2 * fwd)
    return flips


def _flip_uniq(
    keys: np.ndarray, poss: np.ndarray, seq_len: int, k: int
) -> tuple[np.ndarray, np.ndarray]:
    """Unique-kmer table of the reverse-complemented sequence, derived
    arithmetically from the forward scan (uniqueness is strand-symmetric)."""
    rk = _rc_keys(keys, k)
    rp = seq_len - k - poss
    order = np.argsort(rk)
    return rk[order], rp[order]


def _lis_indices(values: list[int]) -> list[int]:
    """Indices of a longest strictly-increasing subsequence (O(n log n))."""
    tails: list[int] = []          # values
    tails_idx: list[int] = []      # index of tail element
    prev = [-1] * len(values)
    for i, v in enumerate(values):
        pos = bisect_left(tails, v)
        if pos == len(tails):
            tails.append(v)
            tails_idx.append(i)
        else:
            tails[pos] = v
            tails_idx[pos] = i
        prev[i] = tails_idx[pos - 1] if pos > 0 else -1
    out: list[int] = []
    i = tails_idx[-1] if tails_idx else -1
    while i >= 0:
        out.append(i)
        i = prev[i]
    return out[::-1]


def find_universal_anchors(
    seqs: list[bytes], k: int = DEFAULT_K, uniq=None
) -> list[list[int]]:
    """Anchor positions per genome: k-mers unique in every genome, made
    collinear (LIS per genome, anchored to genome 0 order), then thinned so
    consecutive anchors don't overlap (>= k apart in every genome)."""
    if uniq is None:
        uniq = [_unique_kmers(s, k) for s in seqs]
    common = uniq[0][0]
    for keys, _ in uniq[1:]:
        common = np.intersect1d(common, keys, assume_unique=True)
    if len(common) == 0:
        return [[] for _ in seqs]
    # positions of the common anchors in every genome
    pos = []
    for keys, poss in uniq:
        idx = np.searchsorted(keys, common)
        pos.append(poss[idx])
    order0 = np.argsort(pos[0], kind="stable")
    pos = [p[order0] for p in pos]
    keep_idx = np.arange(len(common))
    for g in range(1, len(seqs)):
        keep = _lis_indices(pos[g][keep_idx].tolist())
        keep_idx = keep_idx[keep]
        if len(keep_idx) == 0:
            break
    # thin overlapping anchors
    thinned: list[int] = []
    last = np.full(len(seqs), -(10**18), dtype=np.int64)
    for i in keep_idx:
        cur = np.array([pos[g][i] for g in range(len(seqs))])
        if (cur >= last + k).all():
            thinned.append(int(i))
            last = cur
    return [[int(pos[g][i]) for i in thinned] for g in range(len(seqs))]


def _lcp(a: bytes, b: bytes) -> int:
    n = min(len(a), len(b))
    av = np.frombuffer(a[:n], np.uint8)
    bv = np.frombuffer(b[:n], np.uint8)
    neq = np.flatnonzero(av != bv)
    return int(neq[0]) if len(neq) else n


def _hamming(a: bytes, b: bytes) -> int:
    return int(
        (np.frombuffer(a, np.uint8) != np.frombuffer(b, np.uint8)).sum()
    )


def _plan_slot(rep: bytes, slot_segs: list) -> list[tuple]:
    """Relate each slot segment to the representative (the first genome's):
    ('rep',) identical; ('rc',) exact reverse complement; ('inv', xl, yl)
    common prefix/suffix with an exactly-inverted middle (a clean segmental
    inversion); ('inv_snp', xl, yl) same but the inverted middle carries
    substitutions — matching chunks still share the representative's nodes
    reverse-oriented, SNP-bearing chunks become parallel bubble nodes (the
    emit step decides per chunk); ('own',) unrelated.  The prefix/suffix
    search backs off a few bases because a chance palindromic base at the
    inversion boundary can extend the literal common prefix past the true
    breakpoint."""
    plans: list[tuple] = []
    rc_rep = _rc_seq(rep)
    for i, (_, seg) in enumerate(slot_segs):
        if i == 0 or seg == rep:
            plans.append(("rep",))
            continue
        if seg == rc_rep:
            plans.append(("rc",))
            continue
        plan: tuple = ("own",)
        if len(seg) == len(rep):
            n = len(seg)
            xl0 = _lcp(seg, rep)
            yl0 = _lcp(seg[::-1], rep[::-1])
            for xl in range(xl0, max(xl0 - 4, 0) - 1, -1):
                for yl in range(min(yl0, n - xl), max(yl0 - 4, 0) - 1, -1):
                    if xl + yl >= n:
                        continue
                    if seg[xl : n - yl] == _rc_seq(rep[xl : n - yl]):
                        plan = ("inv", xl, yl)
                        break
                if plan[0] == "inv":
                    break
            if plan[0] == "own" and xl0 + yl0 < n:
                # SNP-bearing inversion: the middle is much closer to the
                # reverse complement than to the forward representative
                mid_s = seg[xl0 : n - yl0]
                mid_r = rep[xl0 : n - yl0]
                d_rc = _hamming(mid_s, _rc_seq(mid_r))
                if d_rc <= len(mid_s) // 10 and d_rc * 2 < _hamming(mid_s, mid_r):
                    plan = ("inv_snp", xl0, yl0)
        plans.append(plan)
    return plans


def _emit_rep(rep: bytes, plans: list[tuple], new_nodes, chunk_size: int) -> dict:
    """Emit the representative's nodes, cut at every boundary an inversion
    plan needs, so followers can reference sub-spans on node boundaries.
    Returns {(lo, hi) byte span -> node ids}."""
    n = len(rep)
    cuts = {0, n}
    for p in plans:
        if p[0] in ("inv", "inv_snp"):
            cuts.add(p[1])
            cuts.add(n - p[2])
    bounds = sorted(cuts)
    return {
        (lo, hi): new_nodes(rep[lo:hi])
        for lo, hi in zip(bounds[:-1], bounds[1:])
        if hi > lo
    }


def _emit_follower(
    segment: bytes, plan: tuple, rep_pieces: dict, node_ids: dict, new_nodes,
    rep: bytes, chunk_size: int,
) -> tuple[list[int], list[int]]:
    def span(lo: int, hi: int) -> list[int]:
        ids: list[int] = []
        for (a, b), pid in sorted(rep_pieces.items()):
            if a >= lo and b <= hi:
                ids.extend(pid)
        return ids

    n_rep = max((b for _, b in rep_pieces), default=0)
    if plan[0] == "rep":
        ids = span(0, n_rep)
        return ids, [0] * len(ids)
    if plan[0] == "rc":
        ids = span(0, n_rep)[::-1]
        return ids, [1] * len(ids)
    if plan[0] == "inv":
        xl, yl = plan[1], plan[2]
        n = len(segment)
        head = span(0, xl)
        mid = span(xl, n - yl)[::-1]
        tail = span(n - yl, n)
        return head + mid + tail, [0] * len(head) + [1] * len(mid) + [0] * len(tail)
    if plan[0] == "inv_snp":
        # walk the representative's chunk nodes across the inverted middle in
        # reverse; chunks whose bytes match the reverse complement exactly are
        # shared (strand 1), SNP-bearing chunks become parallel bubble nodes
        xl, yl = plan[1], plan[2]
        n = len(segment)
        S = xl + (n - yl)  # seg index for rep index p is S - 1 - p
        head = span(0, xl)
        tail = span(n - yl, n)
        mid_ids: list[int] = []
        mid_st: list[int] = []
        for (a, b), pid in sorted(rep_pieces.items(), reverse=True):
            if a < xl or b > n - yl:
                continue
            offs = list(range(a, b, chunk_size))
            for j in range(len(pid) - 1, -1, -1):
                a2 = offs[j]
                b2 = min(a2 + chunk_size, b)
                seg_chunk = segment[S - b2 : S - a2]
                if seg_chunk == _rc_seq(rep[a2:b2]):
                    mid_ids.append(pid[j])
                    mid_st.append(1)
                else:
                    own = node_ids.get(seg_chunk)
                    if own is None:
                        own = new_nodes(seg_chunk)
                        node_ids[seg_chunk] = own
                    mid_ids.extend(own)
                    mid_st.extend([0] * len(own))
        return (
            head + mid_ids + tail,
            [0] * len(head) + mid_st + [0] * len(tail),
        )
    ids = node_ids.get(segment)  # 'own': dedupe exact/rc among non-rep segs
    if ids is not None:
        return ids, [0] * len(ids)
    rc_ids = node_ids.get(_rc_seq(segment))
    if rc_ids is not None:
        return rc_ids[::-1], [1] * len(rc_ids)
    ids = new_nodes(segment)
    node_ids[segment] = ids
    return ids, [0] * len(ids)


def build_pangenome_graph(
    genomes: dict[str, bytes],
    k: int = DEFAULT_K,
    chunk_size: int = DEFAULT_PAN_CHUNK,
) -> SpeciesGraph:
    """Build a variation graph from strain genomes of one species.

    genomes: hap_id -> full genome sequence (contigs pre-concatenated; the
    reference likewise merges chromosomes of a haplotype into one path,
    zip.rs:154-158).
    """
    names = sorted(genomes)
    if len(names) < 2:
        raise ValueError("pangenome construction needs >= 2 genomes")
    # normalize assembly strand so opposite-strand genomes share anchors;
    # their paths are emitted reversed with flipped strands below, so every
    # path still spells its INPUT genome exactly.  One unique-kmer scan per
    # genome serves orientation AND anchoring (the flipped table is an
    # arithmetic transform of the forward one).
    uniq = [_unique_kmers(genomes[n], k) for n in names]
    flips = orient_genomes(None, k, uniq=uniq)
    seqs = [
        _rc_seq(genomes[n]) if fl else genomes[n]
        for n, fl in zip(names, flips)
    ]
    uniq = [
        _flip_uniq(u[0], u[1], len(genomes[n]), k) if fl else u
        for u, n, fl in zip(uniq, names, flips)
    ]

    anchor_pos = find_universal_anchors(seqs, k, uniq=uniq)
    n_anchors = len(anchor_pos[0]) if anchor_pos else 0

    node_seqs: list[bytes] = []
    paths: dict[str, list[int]] = {n: [] for n in names}
    strands: dict[str, list[int]] = {n: [] for n in names}

    def new_nodes(segment: bytes) -> list[int]:
        ids = []
        for off in range(0, len(segment), chunk_size):
            ids.append(len(node_seqs))
            node_seqs.append(segment[off : off + chunk_size])
        return ids

    # slot boundaries per genome: [0, a_0, a_1, ..., len]
    for slot in range(n_anchors + 1):
        # gather the slot's segments, then emit: identical segments collapse
        # only within a slot (keeps node order coordinate-sorted and paths
        # collinear); an exact inverted block against the slot representative
        # shares the representative's nodes reverse-oriented
        slot_segs: list[tuple[str, bytes]] = []
        for g, name in enumerate(names):
            lo = 0 if slot == 0 else anchor_pos[g][slot - 1]
            hi = len(seqs[g]) if slot == n_anchors else anchor_pos[g][slot]
            segment = seqs[g][lo:hi]
            if segment:
                slot_segs.append((name, segment))
        if not slot_segs:
            continue
        rep = slot_segs[0][1]
        plans = _plan_slot(rep, slot_segs)
        rep_pieces = _emit_rep(rep, plans, new_nodes, chunk_size)
        node_ids: dict[bytes, list[int]] = {}
        for (name, segment), plan in zip(slot_segs, plans):
            ids, st = _emit_follower(
                segment, plan, rep_pieces, node_ids, new_nodes, rep, chunk_size
            )
            paths[name].extend(ids)
            strands[name].extend(st)

    for name, fl in zip(names, flips):
        if fl:  # spell the original genome: reverse step order, flip strands
            paths[name] = paths[name][::-1]
            strands[name] = [1 - s for s in strands[name]][::-1]

    nodes_len = np.array([len(s) for s in node_seqs], dtype=np.int64)
    return SpeciesGraph.from_paths(
        nodes_len,
        {n: np.array(p, dtype=np.int64) for n, p in paths.items()},
        node_seqs,
        strands={n: np.array(s, dtype=np.int8) for n, s in strands.items()},
    )
