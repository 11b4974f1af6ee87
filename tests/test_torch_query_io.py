"""K4 and K5's module (ops/query.py) on the CPU: the plain versions of the
query's prologue (K4a, the unpack; K4b, the candidates' read rows on
their strands) and epilogue (K5 and K5p, the single-end and paired pick)
bit for bit against the JAX package's functions on inputs made from a
numpy seed: ``_unpack_reads_j`` over both read wires, ``_rev_codes_j``
and the strand selects of ``_all_candidates`` and ``_extend_batch``, and
``_query_batch`` / ``_query_batch_paired`` (their ``_all_candidates``
replaced by a stub that hands them ``chip_smoke.pick_cases``'
candidates) with ``_pack_result_rows``; the
node projection against ``jnp.searchsorted``; K5's bucket table against
the reference's build_pos_lookup, and the kernels' bucketed search and K4b's
word-wise rows modelled in Python against the plain versions; the entry
points' plain
route and counts on CPU tensors; the launch wrappers' refusals; the feed
split's reading of a profiler trace.  The kernels themselves run in
tests/test_torch_cuda.py (marker ``cuda``) and chip_smoke.py's phase 3f."""
import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import pantax_tpu.align.aligner as ref
from pantax_tpu_torch.align import aligner as port
from pantax_tpu_torch.ops import extend, query

NEG = extend.NEG
# the reference's unpack and reverse complement, jitted: eagerly each of
# their ops compiles anew for every shape
unpack_j = jax.jit(ref._unpack_reads_j)
rev_codes_j = jax.jit(ref._rev_codes_j)
_SPLIT = importlib.util.spec_from_file_location(
    "feed_split", os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "scripts", "feed_split.py"))
feed_split = importlib.util.module_from_spec(_SPLIT)
_SPLIT.loader.exec_module(feed_split)


@pytest.fixture
def one_thread():
    """One torch thread: the cases are small, and threads only slow them
    down when the test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reads(seed: int, B: int, L: int, garbage: bool = False):
    """int8 codes [B, L] with ~2% N bases, read_len with 0 and L among
    them; columns past read_len hold 4 (or, with ``garbage``, any base)."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, size=(B, L)).astype(np.int8)
    codes[rng.random((B, L)) < 0.02] = 4
    lens = rng.integers(0, L + 1, size=B).astype(np.int32)
    lens[:3] = (0, L, 1)
    if not garbage:
        codes[np.arange(L)[None, :] >= lens[:, None]] = 4
    return codes, lens


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _eq(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("L", [150, 151, 160, 512])
@pytest.mark.parametrize("wire", ["nibble", "two_bit"])
def test_unpack_matches_reference(one_thread, L, wire):
    """K4a's plain version against _unpack_reads_j: the 4-bit nibble wire
    (pad bases already 4) and the 2-bit wire with its N exceptions (any
    base past read_len, blanked by read_len)."""
    codes, lens = _reads(L, 96, L, garbage=wire == "two_bit")
    packed = (ref.pack_codes(codes) if wire == "nibble"
              else ref.pack_codes2(codes, lens))
    assert packed is not None
    want = unpack_j(
        jax.tree_util.tree_map(jnp.asarray, packed), jnp.asarray(lens))
    fwd, n = query.query_prologue_plain(_t(codes), _t(lens))
    _eq(fwd, want)
    assert n is not None and torch.equal(n, _t(lens))


@pytest.mark.parametrize("widths", [(150, 150), (160, 150), (151, 512)])
def test_paired_unpack_matches_reference(one_thread, widths):
    """The paired prologue: both mates' rows in one buffer, mate 1's
    first, each _unpack_reads_j's rows padded with 4 to the wider (the
    reference concatenates mates of one width), and both read_len."""
    (c1, n1), (c2, n2) = (_reads(w + i, 64, w) for i, w in enumerate(widths))
    mates = [np.asarray(unpack_j(jnp.asarray(ref.pack_codes(c)),
                                 jnp.asarray(n)))
             for c, n in ((c1, n1), (c2, n2))]
    Lw = max(m.shape[1] for m in mates)
    want = np.concatenate([np.pad(m, ((0, 0), (0, Lw - m.shape[1])),
                                  constant_values=4) for m in mates])
    fwd, lens = query.query_prologue_plain(_t(c1), _t(n1), _t(c2), _t(n2))
    _eq(fwd, want)
    _eq(lens, np.concatenate([n1, n2]))


@pytest.mark.parametrize("L,K,pad", [(150, 2, 4), (151, 2, 4), (160, 2, 4),
                                     (512, 1, 8), (160, 8, 4)])
def test_candidate_rows_match_reference(one_thread, L, K, pad):
    """K4b's plain version against _rev_codes_j and _all_candidates'
    strand select, its clip of the window starts and its repeated
    read_len: the rows padded with 4 to a multiple of 16; strands 0, 1
    and 2 (only 1 reverses), diagonals below 0 and past the text."""
    codes, lens = _reads(L * 10 + K, 64, L)
    fwd_j = unpack_j(jnp.asarray(ref.pack_codes(codes)), jnp.asarray(lens))
    fwd = _t(np.asarray(fwd_j))
    rng = np.random.default_rng(K)
    strand = rng.integers(0, 3, size=(64, K)).astype(np.int8)
    diag = rng.integers(-50, 5000, size=(64, K)).astype(np.int32)
    w_hi = 4000
    rev = rev_codes_j(fwd_j, jnp.asarray(lens))
    want = jnp.where((jnp.asarray(strand) == 1)[:, :, None], rev[:, None, :],
                     fwd_j[:, None, :]).reshape(64 * K, -1)
    width = -(-fwd.shape[1] // 16) * 16
    rows, len_rep, w0 = query.query_rows_plain(
        fwd, _t(lens), _t(strand), _t(diag), pad, w_hi, width)
    assert rows.shape == (64 * K, width)
    _eq(rows[:, :fwd.shape[1]].contiguous(), want)
    assert bool((rows[:, fwd.shape[1]:] == 4).all())
    _eq(w0, np.asarray(jnp.clip(jnp.asarray(diag) - pad, 0, w_hi)).reshape(-1))
    _eq(len_rep, np.asarray(jnp.repeat(jnp.asarray(lens), K)))


def test_extension_rows_match_reference(one_thread):
    """K4b as the extension takes it (K 1, int32 strands, w0 given, pad 0)
    against _extend_batch's select and clip."""
    codes, lens = _reads(7, 80, 512)
    fwd_j = unpack_j(jnp.asarray(ref.pack_codes(codes)), jnp.asarray(lens))
    rng = np.random.default_rng(8)
    strand = rng.integers(0, 2, size=80).astype(np.int32)
    w0 = rng.integers(-600, 70000, size=80).astype(np.int32)
    want = jnp.where((jnp.asarray(strand) == 1)[:, None],
                     rev_codes_j(fwd_j, jnp.asarray(lens)), fwd_j)
    rows, len_rep, w0c = query.query_rows_plain(
        _t(np.asarray(fwd_j)), _t(lens), _t(strand), _t(w0), 0, 65000, 512)
    _eq(rows, want)
    _eq(w0c, np.asarray(jnp.clip(jnp.asarray(w0), 0, 65000)))
    assert torch.equal(len_rep, _t(lens))


def _stub_candidates(text2d, run_table, seed_pos, bucket_lo, tstart, tnode,
                     codes_fwd, codes_rev, read_len, cfg_static):
    """A stand-in for the reference's _all_candidates that returns the
    candidates handed to it in its table arguments (K1's outputs and w0 as
    ``text2d``, the votes as ``run_table``, the strands as ``seed_pos``),
    its tail (:567-577) computed as the reference computes it."""
    score, soff, eoff, mat, w0 = text2d
    votes, strand = run_table, seed_pos
    B, K = votes.shape
    scores = jnp.where(votes > 0, score.reshape(B, K), NEG)
    ts = (w0 + soff).reshape(B, K)
    te = (w0 + eoff).reshape(B, K)
    i0 = jnp.clip(jnp.searchsorted(tstart, ts, side="right") - 1, 0,
                  tnode.shape[0] - 1)
    return (scores, ts, te, mat.reshape(B, K), strand, tnode[i0],
            ts - tstart[i0])


def _ref_pick(arrays, paired: bool, monkeypatch):
    """The reference's _query_batch (or _query_batch_paired) on the case's
    candidates: the per-read 7 arrays (mate 1's then mate 2's) and its
    packed rows.  Its jit traces the stub: the case rides in the table
    arguments, a tuple where the index's text would be, so no trace of
    the real query is reused."""
    monkeypatch.setattr(ref, "_all_candidates", _stub_candidates)
    a = [jnp.asarray(x) for x in arrays]
    tables = (tuple(a[:5]), a[5], a[6], None, a[7], a[8])
    rl = a[9]
    cfg = (0,) * 11 + chip_smoke.PICK_CFG
    if not paired:
        res = ref._query_batch(*tables, jnp.zeros((rl.shape[0], 2), jnp.uint8),
                               rl, cfg)
        return res, ref._pack_result_rows(res)
    B = rl.shape[0] // 2
    r1, r2 = ref._query_batch_paired(
        *tables, jnp.zeros((B, 2), jnp.uint8), rl[:B],
        jnp.zeros((B, 2), jnp.uint8), rl[B:], cfg, *chip_smoke.PAIR_CFG)
    return (tuple(jnp.concatenate([a, b]) for a, b in zip(r1, r2)),
            jnp.concatenate([ref._pack_result_rows(r1),
                             ref._pack_result_rows(r2)]))


@pytest.mark.parametrize("name", chip_smoke.PICK_CASES + chip_smoke.PAIR_CASES)
def test_pick_matches_reference(one_thread, monkeypatch, name):
    """K5's and K5p's plain versions against the reference's picks on the
    crafted candidates: score ties, all-NEG rows, a second best at the
    best's location, NEG seconds, the thresholds' float32 rounding, the
    projection's edges, padding rows, the packing's clip and mask, the
    frag_max boundary, the rescue and ok_best ties; the 7 columns in the
    reference's dtypes and the packed rows."""
    paired, arrays = chip_smoke.pick_cases()[name]
    args = chip_smoke.pick_args((paired, arrays), "cpu")
    pick = query.query_pick_paired_plain if paired else query.query_pick_plain
    want, want_packed = _ref_pick(arrays, paired, monkeypatch)
    got = pick(*args)
    assert len(got) == 7
    for g, w in zip(got, want):
        _eq(g, w)
    _eq(pick(*args, packed=True), want_packed)


@pytest.mark.parametrize("M", [1, 2, 50])
def test_projection_matches_searchsorted(M):
    """project's segment and offset against the reference's
    searchsorted(tstart, ts, right) - 1 clipped: a ts before the first
    start (a negative offset), at a start (that segment), inside, in the
    last segment and past it."""
    tstart, tnode = (a[:M] for a in chip_smoke._segments())
    ts = np.concatenate([np.arange(-3, 13), tstart, tstart + 1,
                         tstart[-1:] + 10**6]).astype(np.int32)
    node, off = query.project(_t(ts), _t(tstart), _t(tnode))
    i0 = jnp.clip(jnp.searchsorted(jnp.asarray(tstart), jnp.asarray(ts),
                                   side="right") - 1, 0, M - 1)
    _eq(node, np.asarray(jnp.asarray(tnode)[i0]))
    _eq(off, np.asarray(jnp.asarray(ts) - jnp.asarray(tstart)[i0]))


# ---------------------------------------------------------------------------
# K5's bucketed projection and K4b's word-wise rows, modelled in numpy
# ---------------------------------------------------------------------------
def _scale_slice(tmp_path):
    """The segment starts of a small scale_db (2 species x 2 strains of
    50 kb) and its text's length."""
    from pantax_tpu_torch import _host
    from pantax_tpu_torch.benchmarks import scale_db

    db = scale_db(str(tmp_path / "scale"), n_species=2, strains_per=2,
                  genome_len=50_000)
    index = _host.build_align_index(db)
    return np.asarray(index.tstart), index.text_len


def _tiny_starts(tmp_path):
    from pantax_tpu_torch import _host
    from pantax_tpu_torch.benchmarks import tiny_db

    index = _host.build_align_index(tiny_db(str(tmp_path / "tiny")))
    return np.asarray(index.tstart), index.text_len


def _crafted_starts(M):
    def make(tmp_path):
        tstart = chip_smoke._segments(M)[0]
        return tstart, int(tstart[-1]) + chip_smoke.SEG_LEN
    return make


_STARTS = {"tiny_db": _tiny_starts, "scale_db": _scale_slice,
           "m1": _crafted_starts(1), "m2": _crafted_starts(2),
           "m50": _crafted_starts(50)}


@pytest.mark.parametrize("name", sorted(_STARTS))
def test_segment_lookup_is_the_references_pos_lookup(one_thread, tmp_path,
                                                     name):
    """segment_lookup (torch.searchsorted of the bucket bounds, built
    where tstart lies) gives the reference's build_pos_lookup: pos_lo
    array-equal, win_shift and steps, on the tiny DB, a small scale_db,
    and 1, 2 and 50 crafted segments; pos_lo[b] counts the starts at or
    before b << win_shift."""
    from pantax_tpu.ops.fused import build_pos_lookup

    tstart, text_len = _STARTS[name](tmp_path)
    got = query.segment_lookup(_t(tstart.astype(np.int32)), text_len)
    pos_lo, win_shift, steps = build_pos_lookup(tstart.astype(np.int64),
                                                text_len)
    _eq(got.pos_lo, np.asarray(pos_lo, np.int32))
    assert (got.win_shift, got.steps) == (win_shift, steps)
    bounds = np.arange(len(pos_lo), dtype=np.int64) << win_shift
    _eq(got.pos_lo, np.searchsorted(tstart, bounds, side="right").astype(
        np.int32))


def test_fused_tables_share_the_aligners_bucket_table(one_thread,
                                                      tmp_path):
    """build_fused_tables given an Aligner's segment_lookup holds that very
    buffer (one copy on the device), with the win_shift and steps of the
    table it builds on its own."""
    from pantax_tpu_torch import _host
    from pantax_tpu_torch.benchmarks import tiny_db
    from pantax_tpu_torch.convert import aligner_from_reference
    from pantax_tpu_torch.ops.fused import build_fused_tables

    db = tiny_db(str(tmp_path))
    index = _host.build_align_index(db)
    al = aligner_from_reference(index, _host.AlignConfig(), "cpu")
    shared = build_fused_tables(db, index, "cpu", al.segment_lookup)
    own = build_fused_tables(db, index, "cpu")
    assert shared.pos_lo is al.pos_lo and own.pos_lo is not al.pos_lo
    assert torch.equal(own.pos_lo, al.pos_lo)
    assert (shared.win_shift, shared.pos_steps) == (own.win_shift,
                                                    own.pos_steps)


def test_segment_lookup_refuses_starts_outside_the_text():
    """K5 takes a ts before 0 as before every start and one past the last
    bucket as past every start: starts below 0, at or past the text's end
    or out of order are refused."""
    for tstart, text_len in (([-1, 5], 10), ([0, 10], 10), ([0, 7, 5], 10),
                             ([], 10)):
        with pytest.raises(ValueError, match="sorted"):
            query.segment_lookup(torch.tensor(tstart, dtype=torch.int32),
                                 text_len)


def _model_segment(tstart, pos_lo, win_shift, ts):
    """csrc/query_io.cu's segment_of in Python: a ts before 0 is segment 0,
    one past the last bucket segment M - 1, else the bisection inside its
    bucket [pos_lo[b], pos_lo[b + 1]), clipped into [0, M - 1]."""
    M, nb = len(tstart), len(pos_lo) - 1
    out = []
    for x in ts:
        x = int(x)
        if x < 0:
            out.append(0)
            continue
        b = x >> win_shift
        if b >= nb:
            out.append(M - 1)
            continue
        lo, hi = min(int(pos_lo[b]), M), min(int(pos_lo[b + 1]), M)
        while lo < hi:
            mid = (lo + hi) >> 1
            if tstart[mid] <= x:
                lo = mid + 1
            else:
                hi = mid
        out.append(min(max(lo - 1, 0), M - 1))
    return np.asarray(out, dtype=np.int64)


@pytest.mark.parametrize("name", sorted(_STARTS))
def test_bucketed_search_model_matches_project(one_thread, tmp_path, name):
    """The kernel's bucketed search, modelled in Python, gives project's
    node and offset on crafted ts: the int32 extremes, negative, below the
    first start, on every bucket boundary and beside it, at every start,
    at and past the text's end and the last bucket's bound."""
    tstart, text_len = _STARTS[name](tmp_path)
    tstart = tstart.astype(np.int32)
    tnode = (np.arange(len(tstart)) % 7 + 1).astype(np.int32)
    seg = query.segment_lookup(_t(tstart), text_len)
    pos_lo = seg.pos_lo.numpy()
    bounds = np.arange(len(pos_lo), dtype=np.int64) << seg.win_shift
    ts = np.unique(np.concatenate([
        [-2**31, -2**31 + 1, -7, -1, 0, 1, int(tstart[0]) - 1],
        bounds[::max(1, len(bounds) // 4096)], bounds[-3:],
        bounds[::max(1, len(bounds) // 4096)] - 1, bounds[-3:] + 1,
        tstart[::max(1, len(tstart) // 4096)],
        tstart[::max(1, len(tstart) // 4096)] + 1,
        [text_len - 1, text_len, text_len + 1, 2**31 - 2, 2**31 - 1]]))
    ts = ts[(ts >= -2**31) & (ts < 2**31)].astype(np.int32)
    i0 = _model_segment(tstart, pos_lo, seg.win_shift, ts)
    node, off = query.project(_t(ts), _t(tstart), _t(tnode))
    _eq(node, tnode[i0])
    _eq(off, (ts.astype(np.int64) - tstart[i0]).astype(np.int32))


_N4 = 0x04040404


def _byte_perm(x, y, s):
    v = (y << 32) | x
    return sum(((v >> (8 * ((s >> (4 * i)) & 7))) & 0xFF) << (8 * i)
               for i in range(4))


def _complement4(x):
    """Per byte, as an int8 code b: 3 - b (wrapping) where b < 4, else 4
    (__vcmplts4 and __vsub4)."""
    out = 0
    for i in range(4):
        b = (x >> (8 * i)) & 0xFF
        signed = b - 256 if b > 127 else b
        out |= ((3 - b) & 0xFF if signed < 4 else 4) << (8 * i)
    return out


def _keep_bytes(x, v):
    m = 0xFFFFFFFF if v >= 4 else 0 if v <= 0 else (1 << (8 * v)) - 1
    return (x & m) | (_N4 & ~m & 0xFFFFFFFF)


def _model_rows(fwd, lens, strand, width):
    """csrc/query_io.cu's K4b rows in Python, 16 columns at a time: the
    forward strand's words, 4 past the codes' width; the reverse strand's
    five aligned words up to the one of source byte l - 1 - c0, each
    output word a byte permute of two, complemented four bytes at a time,
    kept before read_len; a read_len past the width a byte at a time."""
    R, Lc = fwd.shape
    words = fwd.view(np.uint32).astype(np.int64)
    K = 1 if strand.ndim == 1 else strand.shape[1]
    st = strand.reshape(-1)
    rows = np.zeros((R * K, width), np.uint8)
    for n in range(R * K):
        r, l = n // K, int(lens[n // K])
        for c0 in range(0, width, 16):
            if st[n] != 1:
                out = [int(words[r, c0 // 4 + q]) if c0 + 4 * q < Lc else _N4
                       for q in range(4)]
            elif l <= Lc:
                hi = l - 1 - c0
                if hi < 0:
                    out = [_N4] * 4
                else:
                    top = hi >> 2
                    w = [int(words[r, top - 4 + i]) if top - 4 + i >= 0
                         else _N4 for i in range(5)]
                    s = (hi & 3) + 1
                    sel = (s + 3) | ((s + 2) << 4) | ((s + 1) << 8) | (s << 12)
                    out = [_keep_bytes(_complement4(_byte_perm(
                        w[3 - q], w[4 - q], sel)), l - c0 - 4 * q)
                        for q in range(4)]
            else:
                b = [4] * 16
                for j in range(16):
                    c = c0 + j
                    if c < Lc and c < l:
                        x = int(fwd[r, min(l - 1 - c, Lc - 1)])
                        b[j] = (3 - x) & 0xFF if x < 4 else 4
                out = [b[4 * q] | b[4 * q + 1] << 8 | b[4 * q + 2] << 16
                       | b[4 * q + 3] << 24 for q in range(4)]
            chunk = np.array(out, dtype=np.uint32).view(np.uint8)
            m = min(16, width - c0)
            rows[n, c0:c0 + m] = chunk[:m]
    return rows.view(np.int8)


@pytest.mark.parametrize("name", chip_smoke.K4B_CASES)
def test_k4b_word_model_matches_plain(one_thread, name):
    """K4b's word-wise arithmetic, modelled in Python, gives
    query_rows_plain's rows on k4b_cases: codes of widths 150-512 (K4a's,
    a multiple of 4), every read_len % 16, read_len 0, the width and past
    it, every byte value, the query's rows (K 2, padded to 16) and the
    extension's (K 1, int32 strands)."""
    args = chip_smoke.k4b_args(chip_smoke.k4b_cases()[name], "cpu")
    fwd, lens, strand, _diag, _pad, _w_hi, width = args
    want = query.query_rows_plain(*args)[0]
    _eq(_model_rows(fwd.numpy(), lens.numpy(), strand.numpy(), width), want)


def test_entry_points_take_the_plain_versions_on_the_cpu(one_thread):
    """The four entry points on CPU tensors: the plain versions' bits,
    counted as plain runs and never as launches."""
    codes, lens = _reads(3, 32, 150)
    c, n = _t(codes), _t(lens)
    paired, arrays = chip_smoke.pick_cases()["random_pairs_k2"]
    pa = chip_smoke.pick_args((paired, arrays), "cpu")
    sa = chip_smoke.pick_args(chip_smoke.pick_cases()["random_k2"], "cpu")
    strand = torch.zeros((32, 2), dtype=torch.int8)
    strand[::3] = 1
    diag = torch.arange(64, dtype=torch.int32).reshape(32, 2)
    extend.reset_launch_counts()
    fwd, _ = query.query_prologue(c, n)
    _eq(fwd, query.query_prologue_plain(c, n)[0].numpy())
    _eq(query.query_prologue(c, n, c, n)[0],
        query.query_prologue_plain(c, n, c, n)[0].numpy())
    for g, w in zip(query.query_rows(fwd, n, strand, diag, 4, 50, 160),
                    query.query_rows_plain(fwd, n, strand, diag, 4, 50, 160)):
        _eq(g, w.numpy())
    for g, w in zip(query.query_pick(*sa), query.query_pick_plain(*sa)):
        _eq(g, w.numpy())
    _eq(query.query_pick_paired(*pa, packed=True),
        query.query_pick_paired_plain(*pa, packed=True).numpy())
    assert {k: v for k, v in extend.LAUNCHES.items()
            if k.startswith("query_")} == {
        "query_prologue": 0, "query_prologue_plain": 2, "query_rows": 0,
        "query_rows_plain": 1, "query_pick": 0, "query_pick_plain": 1,
        "query_pick_paired": 0, "query_pick_paired_plain": 1}


def test_launch_wrappers_refuse_cpu_tensors():
    """The launch wrappers check their arguments before they touch a
    kernel library (none is given here): CPU tensors, a wrong dtype and
    an odd read count for the paired pick all raise ValueError."""
    codes, lens = _reads(4, 8, 32)
    c, n = _t(codes), _t(lens)
    sa = chip_smoke.pick_args(chip_smoke.pick_cases()["ties"], "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        query.launch_k4a(None, c, n)
    with pytest.raises(ValueError, match="CUDA"):
        query.launch_k4b(None, c, n, torch.zeros((8, 2), dtype=torch.int8),
                         torch.zeros((8, 2), dtype=torch.int32), 4, 10, 32)
    with pytest.raises(ValueError, match="CUDA"):
        query.launch_k5(None, *sa)
    with pytest.raises(ValueError, match="2B reads"):
        query.launch_k5p(None, *sa[:10], sa[10][:3], *sa[11:],
                         *chip_smoke.PAIR_CFG)


def test_paired_columns_are_the_two_mates_in_order(one_thread, tmp_path):
    """Aligner.query_paired_columns: mate 1's B rows then mate 2's, what
    query_paired returns as two tuples; the packed rows are theirs."""
    from pantax_tpu_torch import _host
    from pantax_tpu_torch.benchmarks import tiny_db
    from pantax_tpu_torch.convert import aligner_from_reference

    from _torch_helpers import simulate_pairs

    index = _host.build_align_index(tiny_db(str(tmp_path)))
    al = aligner_from_reference(index, _host.AlignConfig(), "cpu")
    c1, l1, c2, l2 = simulate_pairs(index, 48, seed=5)
    up = (*al.upload(c1, l1), *al.upload(c2, l2))
    cols = al.query_paired_columns(*up)
    r1, r2 = al.query_paired(*up)
    for a, m1, m2 in zip(cols, r1, r2):
        assert a.shape == (96,) and torch.equal(a, torch.cat([m1, m2]))
    packed = al.query_paired_packed(*up)
    assert torch.equal(packed, torch.cat([query.pack_result_rows(r1),
                                          query.pack_result_rows(r2)]))
    # a mesh's blocks join as every block's mate 1 rows, then mate 2's
    blocks = [tuple(torch.arange(8) + 100 * b for _ in range(7))
              for b in range(3)]
    joined = port._cat_mates(blocks, torch.device("cpu"))
    assert joined[0].tolist() == [0, 1, 2, 3, 100, 101, 102, 103, 200, 201,
                                  202, 203, 4, 5, 6, 7, 104, 105, 106, 107,
                                  204, 205, 206, 207]


def test_feed_split_reads_a_trace(tmp_path):
    """feed_split.trace_split on a small Chrome trace: the hand kernels
    by their names, another kernel by the outermost torch op around its
    launch, copies by kind, and the idle share of the window."""
    ev = [
        {"ph": "X", "cat": "cpu_op", "name": "aten::where", "pid": 1,
         "tid": 1, "ts": 0, "dur": 50},
        {"ph": "X", "cat": "cpu_op", "name": "aten::empty", "pid": 1,
         "tid": 1, "ts": 10, "dur": 5},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "pid": 1, "tid": 1, "ts": 20, "dur": 3, "args": {"correlation": 7}},
        {"ph": "X", "cat": "kernel", "name": "void at::native::elementwise",
         "pid": 0, "tid": 7, "ts": 30, "dur": 10, "args": {"correlation": 7}},
        {"ph": "X", "cat": "kernel", "name":
         "void (anonymous namespace)::query_pick_paired_kernel<2>(int)",
         "pid": 0, "tid": 7, "ts": 35, "dur": 20, "args": {"correlation": 9}},
        {"ph": "X", "cat": "kernel", "name": "banded_extend_kernel<4>",
         "pid": 0, "tid": 7, "ts": 70, "dur": 10, "args": {}},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD (Pinned)",
         "pid": 0, "tid": 8, "ts": 90, "dur": 10, "args": {}},
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    got = feed_split.trace_split(str(path), 2)
    assert got["device_ms_by_op"] == {"K5p": 0.01, "aten::where": 0.005,
                                      "K1": 0.005, "memcpy HtoD": 0.005}
    assert got["device_busy_ms"] == pytest.approx(0.0225)
    assert got["window_ms"] == pytest.approx(0.05)
    assert got["idle_share"] == pytest.approx(0.55)
    assert got["device_ops"] == 2
