"""K6 and K11, the fused step's classify + scatter (ops/scatter.py), on the
CPU: the plain versions bit-identical to the JAX package's
_classify_scatter_ranges and _classify_scatter on the crafted intervals of
``chip_smoke.scatter_cases`` (spans of one, two and three or more
segments, empty and reversed intervals, unaligned rows, reads in the
text's last segments, exactly L_cap and L_cap + 1 segments, reads across a
haplotype boundary), with the tables as built and with
``chip_smoke.masked_tables`` (a haplotype without a species range, so
ridx < 0, and trio matches of -1 at either end of a read): the five
accumulators (the range scatter) or three (the windowed), ridx and
overflow, on tiny_db and on a small dup-graph community at node windows of
4, 12, 16, 32 and 64.  K6's plain version also on its own cases
(``chip_smoke.K6_CASES``: reads from a segment's first base, reads ending
at a segment start, three segments, a haplotype's and the text's last
segment, the fullest buckets, an odd B) and with haplotype offsets
shifted into segments and buckets 32x wider; K6's records
(``scatter.scatter_records``) hold the separate arrays.  The dispatchers
take the plain version on CPU tensors and count it; the kernels' entries
refuse CPU tensors and tables without K6's records.  The kernels' bound
(chip_smoke.scatter_work) equals a count made one row at a time.  The
kernels themselves are
held to these plain versions on the card (tests/test_torch_cuda.py,
chip_smoke.py phase 3c)."""
from functools import partial
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import pantax_tpu.ops.fused as ref_fused
from pantax_tpu.align.aligner import Aligner as RefAligner
from pantax_tpu_torch import _host
from pantax_tpu_torch.benchmarks import dup_db, tiny_db
from pantax_tpu_torch.ops import extend, scatter
from pantax_tpu_torch.ops import fused as port_fused

from _torch_helpers import reference_on_one_device  # noqa: F401 (autouse)

F32_EXACT = 1 << 24
# the reference's functions jitted as its fused steps jit them (one compile
# per shape, where eager dispatch compiles each primitive)
REF_RANGES = partial(jax.jit, static_argnames=(
    "win_shift", "pos_steps", "total_bases"))(
        ref_fused._classify_scatter_ranges)
REF_WINDOWED = partial(jax.jit, static_argnames=(
    "win_shift", "pos_steps", "L_cap", "num_nodes", "total_bases",
    "num_trios", "trio_bits", "trio_steps", "trio_probes", "has_dups"))(
        ref_fused._classify_scatter)


class Setup:
    """Both packages' tables over one DB (the port's built by the port)."""

    def __init__(self, db):
        self.db = db
        self.index = _host.build_align_index(db)
        self.ref_aligner = RefAligner(self.index)
        self.ref_tables = ref_fused.build_fused_tables(db, self.index)
        self.tables = port_fused.build_fused_tables(db, self.index, "cpu")
        self.tstart = torch.from_numpy(self.index.tstart.astype(np.int32))
        self.tnode = torch.from_numpy(self.index.tnode.astype(np.int32))
        self.M = len(self.index.tstart)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return Setup(tiny_db(tmp_path_factory.mktemp("tiny")))


@pytest.fixture(scope="module")
def dup(tmp_path_factory):
    return Setup(dup_db(tmp_path_factory.mktemp("dup"), n_species=2,
                        strains=2, n_blocks=400))


def _tables(s, masked: bool):
    return chip_smoke.masked_tables(s.tables) if masked else s.tables


def _ref_tables(s, t):
    """The reference's device tables with the port's (maybe masked)
    hap_range and trio_seg."""
    return (s.ref_tables.hap_offsets_d, jnp.asarray(t.hap_range.numpy()),
            s.ref_tables.pos_lo_d, s.ref_aligner.tstart_d,
            s.ref_aligner.tnode_d, jnp.asarray(t.trio_seg.numpy()))


def _assert_equal(want, got, what):
    want = np.asarray(want)
    assert int(np.abs(got).max(initial=0)) < F32_EXACT, what
    np.testing.assert_array_equal(got.astype(want.dtype), want, err_msg=what)


def _hold_ranges(s, t, cols):
    """K6's plain version on ``cols`` over the tables ``t`` against
    _classify_scatter_ranges given t's haplotype offsets, buckets, ranges
    and trio matches: the five accumulators (the diff array's last slot
    included, the sinks aside) and ridx.  Returns ridx."""
    rt = s.ref_tables
    M = s.M
    ref_acc = (jnp.zeros(rt.N_pad, jnp.float32),
               jnp.zeros(rt.TB_pad + 1, jnp.int32),
               jnp.zeros(rt.U_pad, jnp.float32), jnp.zeros(M + 1, jnp.int32),
               jnp.zeros(M + 1, jnp.int32))
    _, hap_range, _, tstart, tnode, trio_seg = _ref_tables(s, t)
    ridx_w, want = REF_RANGES(
        *(jnp.asarray(a) for a in cols), jnp.asarray(t.hap_offsets.numpy()),
        hap_range, jnp.asarray(t.pos_lo.numpy()), tstart, tnode, trio_seg,
        rt.nodes_len_d, rt.base_offset_d, ref_acc,
        win_shift=int(t.win_shift), pos_steps=int(t.pos_steps),
        total_bases=rt.TB_pad)
    acc = chip_smoke.zero_accs(t, M, "cpu")
    ridx = scatter.classify_scatter_ranges_plain(
        *(torch.from_numpy(a) for a in cols), t, s.tstart, s.tnode, acc)
    sizes = (rt.N_pad, rt.TB_pad + 1, rt.U_pad, M, M)
    for i, (w, a, n) in enumerate(zip(want, acc, sizes)):
        _assert_equal(np.asarray(w)[:n], a[:n].numpy(), f"accumulator {i}")
    assert ridx.dtype == torch.int32
    np.testing.assert_array_equal(ridx.numpy(), np.asarray(ridx_w))
    return ridx


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("case",
                         chip_smoke.SCATTER_CASES + chip_smoke.K6_CASES)
@pytest.mark.parametrize("fixture", ["tiny", "dup"])
def test_ranges_crafted_bit_identical(fixture, case, masked, request):
    """K6's plain version against _classify_scatter_ranges: the five
    accumulators (the diff array's last slot included, the sinks aside)
    and ridx."""
    s = request.getfixturevalue(fixture)
    ridx = _hold_ranges(s, _tables(s, masked),
                        chip_smoke.scatter_cases(s.index, 32)[case])
    if masked and case != "unaligned":
        assert (ridx < 0).any() and (ridx >= 0).any()


@pytest.mark.parametrize("case",
                         chip_smoke.SCATTER_CASES + chip_smoke.K6_CASES)
@pytest.mark.parametrize("variant", ["shifted", "coarse"])
@pytest.mark.parametrize("fixture", ["tiny", "dup"])
def test_ranges_variant_tables_bit_identical(fixture, variant, case,
                                             request):
    """K6's plain version against _classify_scatter_ranges on
    chip_smoke.table_variants' other tables: haplotype offsets shifted one
    base into a segment (K6's records send those reads to the haplotype
    search) and buckets 32x wider (K6's scan and, past 7 segments, its
    bisection)."""
    s = request.getfixturevalue(fixture)
    t = chip_smoke.table_variants(s.tables, s.tstart, s.index.text_len)[
        ", " + variant]
    _hold_ranges(s, t, chip_smoke.scatter_cases(s.index, 32)[case])


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("case", chip_smoke.SCATTER_CASES)
@pytest.mark.parametrize("fixture,L_cap", [("tiny", 8), ("dup", 4),
                                           ("dup", 12), ("dup", 16),
                                           ("dup", 32), ("dup", 64)])
def test_windowed_crafted_bit_identical(fixture, L_cap, case, masked,
                                        request):
    """K11's plain version against _classify_scatter: the three
    accumulators (the diff array's last slot included, the sinks aside),
    ridx and overflow; on the dup community the first-occurrence dedup
    runs (its mask form at 4, 12 and 16, the sort form at 32 and 64).  The
    windows are K11's card cases (chip_smoke.K11_CRAFTED): every template
    width, 12 a window that leaves part of its lane tile empty."""
    s = request.getfixturevalue(fixture)
    t = _tables(s, masked)
    cols = chip_smoke.scatter_cases(s.index, L_cap)[case]
    rt = s.ref_tables
    ref_acc = (jnp.zeros(rt.N_pad, jnp.float32),
               jnp.zeros(rt.TB_pad + 1, jnp.int32),
               jnp.zeros(rt.U_pad, jnp.float32))
    hap_offsets, hap_range, pos_lo, tstart, tnode, trio_seg = _ref_tables(s, t)
    ridx_w, ov_w, want = REF_WINDOWED(
        *(jnp.asarray(a) for a in cols), hap_offsets, hap_range, pos_lo,
        tstart, tnode, trio_seg, rt.nodes_len_d, rt.base_offset_d,
        rt.trio_hash_d, rt.trio_order_d, rt.trio_abc_d, rt.trio_bucket_d,
        ref_acc, win_shift=rt.win_shift, pos_steps=rt.pos_steps, L_cap=L_cap,
        num_nodes=rt.N_pad, total_bases=rt.TB_pad, num_trios=rt.U_pad,
        trio_bits=rt.trio_bits, trio_steps=rt.trio_steps,
        trio_probes=rt.trio_probes, has_dups=rt.has_dups)
    acc = chip_smoke.zero_accs(t, s.M, "cpu")
    ridx, ov = scatter.classify_scatter_plain(
        *(torch.from_numpy(a) for a in cols), t, s.tstart, s.tnode, acc,
        L_cap)
    for i, (w, a, n) in enumerate(zip(want, acc, (rt.N_pad, rt.TB_pad + 1,
                                                  rt.U_pad))):
        _assert_equal(np.asarray(w)[:n], a[:n].numpy(), f"accumulator {i}")
    assert not acc[3].any() and not acc[4].any()
    assert ridx.dtype == torch.int32 and ov.dtype == torch.bool
    np.testing.assert_array_equal(ridx.numpy(), np.asarray(ridx_w))
    np.testing.assert_array_equal(ov.numpy(), np.asarray(ov_w))
    aligned = cols[2]
    if case == "cap":
        assert not ov.numpy()[aligned].any()
    if case == "cap_plus_one":
        assert ov.numpy()[aligned].all()


def test_crafted_cases_cover_their_edges(tiny, dup):
    """The crafted cases hold what their names say on both DBs: spans of 1
    and 2 segments, L_cap and L_cap + 1 (by searchsorted), te <= ts, every
    row unaligned, reads in the text's last segments, reads crossing a
    haplotype boundary, and, masked, trio matches of -1 at a read's first
    window (range scatter's m0) and last (m1).  On the dup community at
    windows of 12 and up, live rows inside the window revisit a node (the
    first-occurrence dedup runs); at 64 some revisit lies at position 32 or
    past it with its first occurrence below 32 (the second position of a
    lane's pair takes the first half's allocation)."""
    for s, L_cap in ((tiny, 8), *((dup, k) for k in (4, 12, 16, 32, 64))):
        cases = chip_smoke.scatter_cases(s.index, L_cap)
        tstart = s.index.tstart

        def span(ts, te):
            i0 = np.searchsorted(tstart, ts, side="right") - 1
            i1 = np.searchsorted(tstart, np.maximum(te - 1, ts),
                                 side="right") - 1
            return i1 - i0 + 1, i0

        for name, want in (("span_1", 1), ("span_2", 2), ("cap", L_cap),
                           ("cap_plus_one", L_cap + 1)):
            got, _ = span(*cases[name][:2])
            assert (got == want).mean() > 0.9, (name, L_cap)
        got, _ = span(*cases["span_3_up"][:2])
        assert (got >= 3).all()
        ts, te, _ = cases["empty"]
        assert (te == ts).any() and (te < ts).any()
        assert not cases["unaligned"][2].any()
        assert cases["span_1"][2].any() and not cases["span_1"][2].all()
        ts, te, _ = cases["text_end"]
        got, i0 = span(ts, te)
        assert (i0 + L_cap >= s.M).any() and (te == s.index.text_len).any()
        ts, te, _ = cases["hap_edges"]
        hap = np.searchsorted(s.index.hap_offsets, ts, side="right")
        assert (te > s.index.hap_offsets[np.minimum(
            hap, len(s.index.hap_offsets) - 1)]).any()
        t = chip_smoke.masked_tables(s.tables)
        seg = t.trio_seg.numpy()
        ts, te, al = cases["span_3_up"]
        got, i0 = span(ts, te)
        assert (seg[i0] < 0).any() and (seg[i0 + got - 3] < 0).any()
        if s is dup and L_cap >= 12:
            revisits = [_revisits(s, L_cap, *cases[name])
                        for name in ("span_3_up", "cap", "text_end")]
            assert all(len(r) for r in revisits), L_cap
            if L_cap == 64:
                assert any(f < 32 <= j for r in revisits for f, j in r)


def _locate(s, t, x):
    return scatter.locate_segment(s.tstart, t.pos_lo, t.win_shift,
                                  t.pos_steps, torch.from_numpy(x)).numpy()


def test_k6_cases_cover_their_edges(tiny, dup):
    """K6_CASES and the table variants hold what their names say on both
    DBs: reads from a segment's first base, reads ending at a segment's
    start, exactly three segments, reads in a haplotype's last segment and
    in the text's last, ends in the fullest buckets (on the dup community
    at 2^pos_steps - 1 segments), 255 rows; shifted tables send some
    reads to the haplotype search; coarse tables give buckets both inside
    K6's scan (up to 7 segments) and past it."""
    for s in (tiny, dup):
        cases = chip_smoke.scatter_cases(s.index, 32)
        tstart, t = s.index.tstart, s.tables
        ts, te, _ = cases["seg_start"]
        assert (ts == tstart[_locate(s, t, ts)]).all()
        ts, te, _ = cases["ends_at_start"]
        assert np.isin(te, tstart).all() and (te > ts).all()
        ts, te, _ = cases["span_3"]
        span = _locate(s, t, te - 1) - _locate(s, t, ts) + 1
        assert (span == 3).mean() > 0.9
        ts, te, _ = cases["hap_last"]
        i0 = _locate(s, t, ts)
        hap_end = s.index.hap_offsets[1:]
        last = np.searchsorted(tstart, hap_end - 1, side="right") - 1
        assert np.isin(i0, last).all() and (i0 == s.M - 1).any()
        assert (np.isin(te, hap_end) | (te == s.index.text_len)).any()
        ts, te, _ = cases["full_bucket"]
        occ = np.diff(t.pos_lo.numpy())
        assert (occ[ts >> t.win_shift] == occ.max()).all()
        assert (occ[(te - 1) >> t.win_shift] == occ.max()).mean() > 0.5
        if s is dup:
            assert occ.max() == 2 ** t.pos_steps - 1
        assert len(cases["odd_b"][0]) % 2 == 1
        variants = chip_smoke.table_variants(t, s.tstart, s.index.text_len)
        seg = variants[", shifted"].seg_rec.numpy()
        flagged = np.flatnonzero(seg[:, 4] == scatter.SEARCH_HAP)
        ts, te, al = cases["hap_edges"]
        assert np.isin(_locate(s, t, ts)[al], flagged).any()
        coarse = variants[", coarse"]
        occ = np.diff(coarse.pos_lo.numpy())
        ts = np.concatenate([c[0] for c in cases.values()])
        at = occ[np.minimum(ts >> coarse.win_shift, len(occ) - 1)]
        assert (at > 7).any() and ((at >= 2) & (at <= 7)).any()
        assert 2 ** coarse.pos_steps - 1 >= occ.max() > 7


@pytest.mark.parametrize("variant", ["", ", masked", ", shifted"])
@pytest.mark.parametrize("fixture", ["tiny", "dup"])
def test_scatter_records_equal_the_separate_arrays(fixture, variant,
                                                   request):
    """K6's records hold the separate arrays: each segment's tstart, tnode,
    trio_seg, the trio_seg of the segment two before (-1 for the first
    two), ridx (the haplotype range of every position the segment answers
    for; SEARCH_HAP where two haplotypes share them), its node's nodes_len
    and base_offset, and 0."""
    s = request.getfixturevalue(fixture)
    t = chip_smoke.table_variants(s.tables, s.tstart, s.index.text_len)[
        variant]
    seg = t.seg_rec.numpy()
    assert seg.dtype == np.int32 and seg.shape == (s.M, 8)
    trio = t.trio_seg.numpy()
    node = s.index.tnode - 1
    np.testing.assert_array_equal(seg[:, 0], s.index.tstart)
    np.testing.assert_array_equal(seg[:, 1], s.index.tnode)
    np.testing.assert_array_equal(seg[:, 2], trio)
    np.testing.assert_array_equal(seg[:, 3], np.append([-1, -1], trio[:-2]))
    np.testing.assert_array_equal(seg[:, 5], t.nodes_len.numpy()[node])
    np.testing.assert_array_equal(seg[:, 6], t.base_offset.numpy()[node])
    assert not seg[:, 7].any()
    offsets, hap_range = t.hap_offsets.numpy(), t.hap_range.numpy()

    def hap(x):
        h = np.searchsorted(offsets, x, side="right") - 1
        return np.clip(h, 0, len(hap_range) - 1)

    ends = np.append(s.index.tstart[1:], s.index.text_len)
    flagged = seg[:, 4] == scatter.SEARCH_HAP
    assert flagged.any() == (variant == ", shifted")
    for r in range(s.M):  # every position the segment answers for
        got = hap(np.arange(s.index.tstart[r], ends[r]))
        if flagged[r]:
            assert len(np.unique(got)) > 1
        else:
            assert (hap_range[got] == seg[r, 4]).all()
    assert hap(-1) == hap(0) or flagged[0]
    built = port_fused.build_fused_tables(s.db, s.index, "cpu")
    assert torch.equal(built.seg_rec, s.tables.seg_rec)


def test_k6_records_are_checked(tiny):
    """K6's wrapper takes only tables with records of their shape and
    type: none (tables from the reference without the index), int64, a
    row short, 4 columns, or a view off its 32-byte boundary raise
    ValueError."""
    s = tiny
    cpu = torch.device("cpu")
    scatter._check_records(s.tables, s.M, cpu)
    bad = {"none": None, "int64": s.tables.seg_rec.long(),
           "short": s.tables.seg_rec[1:],
           "half": s.tables.seg_rec[:, :4].contiguous(),
           "offset": torch.cat([torch.zeros(4, dtype=torch.int32),
                                s.tables.seg_rec.flatten()])[4:].view(s.M, 8)}
    for what, rec in bad.items():
        t = SimpleNamespace(**{k: getattr(s.tables, k)
                               for k in chip_smoke.SCATTER_FIELDS})
        t.seg_rec = rec
        with pytest.raises(ValueError):
            scatter._check_records(t, s.M, cpu)
    from pantax_tpu_torch.convert import fused_tables_from_reference
    ref = fused_tables_from_reference(s.ref_tables, "cpu")
    assert ref.seg_rec is None
    ref = fused_tables_from_reference(s.ref_tables, "cpu", s.index)
    assert torch.equal(ref.seg_rec, s.tables.seg_rec)


def _revisits(s, L_cap, ts, te, aligned):
    """(first position, repeat position) of every repeated node in the
    live rows of the intervals inside the node window, by searchsorted over
    the segment starts."""
    tstart, tnode = s.index.tstart, s.index.tnode
    hap_range = s.tables.hap_range.numpy()
    i0 = np.searchsorted(tstart, ts, side="right") - 1
    i1 = np.searchsorted(tstart, np.maximum(te - 1, ts), side="right") - 1
    hap = np.clip(np.searchsorted(s.index.hap_offsets, ts, side="right") - 1,
                  0, len(hap_range) - 1)
    live = aligned & (hap_range[hap] >= 0) & (i1 - i0 + 1 <= L_cap)
    out = []
    for r in np.flatnonzero(live):
        first = {}
        for j, node in enumerate(tnode[i0[r]:i1[r] + 1]):
            if node in first:
                out.append((first[node], j))
            else:
                first[node] = j
    return out


def test_dispatchers_take_the_plain_version_on_cpu(tiny):
    """On CPU tensors each dispatcher runs its plain version, bumps only its
    _plain count, and gives the plain version's outputs."""
    s = tiny
    cols = [torch.from_numpy(a) for a in
            chip_smoke.scatter_cases(s.index, 8)["span_3_up"]]
    for name, call in (
            ("classify_scatter_ranges",
             lambda f, acc: (f(*cols, s.tables, s.tstart, s.tnode, acc),)),
            ("classify_scatter",
             lambda f, acc: f(*cols, s.tables, s.tstart, s.tnode, acc, 8))):
        before = dict(extend.LAUNCHES)
        acc_d = chip_smoke.zero_accs(s.tables, s.M, "cpu")
        got = call(getattr(scatter, name), acc_d)
        assert extend.LAUNCHES == dict(before, **{
            name + "_plain": before[name + "_plain"] + 1})
        acc_p = chip_smoke.zero_accs(s.tables, s.M, "cpu")
        want = call(getattr(scatter, name + "_plain"), acc_p)
        for a, b in zip(got + acc_d, want + acc_p):
            assert torch.equal(a, b)
        assert acc_d[0].any() and acc_d[1].any()


def test_fused_step_tallies_its_scatter_dispatches(tiny):
    """FusedPipeline's scatter calls are tallied by formulation: a codes
    feed once per batch (range scatter on tiny_db; windowed at a forced
    window), an interval feed once per interval batch."""
    from pantax_tpu_torch.benchmarks import simulate_read_batch
    from pantax_tpu_torch.convert import aligner_from_reference

    s = tiny
    aligner = aligner_from_reference(s.index, _host.AlignConfig(), "cpu")
    codes, lens, _ = simulate_read_batch(s.index, 600, 150, 0.01, seed=3)
    for L_cap, key in ((None, "range"), (4, "window")):
        extend.reset_launch_counts()
        pipe = port_fused.FusedPipeline(aligner, s.tables, 256, L_cap)
        pipe.feed(codes, lens)
        n = pipe.n_batches
        assert n == 3
        plain = ("classify_scatter_ranges_plain" if key == "range"
                 else "classify_scatter_plain")
        assert extend.LAUNCHES[f"scatter_{key}_dispatch"] == n
        assert extend.LAUNCHES[plain] == n
    extend.reset_launch_counts()
    ts, te, _ = chip_smoke.interval_batch(s.index, 300, 40, seed_=1)
    pipe = port_fused.FusedPipeline(aligner, s.tables, 128)
    pipe.feed_intervals(ts, te, np.full(300, 60), te - ts)
    assert pipe.n_interval_batches == 3
    assert extend.LAUNCHES["scatter_range_dispatch"] == 3
    assert extend.LAUNCHES["classify_scatter_ranges_plain"] == 3
    assert extend.LAUNCHES["scatter_window_dispatch"] == 0


def test_kernel_entries_refuse_cpu_tensors(tiny):
    """The CUDA entries check their arguments before building anything: CPU
    tensors, a wrong dtype, a short accumulator or a node window past 64
    raise ValueError."""
    s = tiny
    cols = [torch.from_numpy(a) for a in
            chip_smoke.scatter_cases(s.index, 8)["span_2"]]
    acc = chip_smoke.zero_accs(s.tables, s.M, "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        scatter.classify_scatter_ranges_cuda(*cols, s.tables, s.tstart,
                                             s.tnode, acc)
    with pytest.raises(ValueError, match="CUDA"):
        scatter.classify_scatter_cuda(*cols, s.tables, s.tstart, s.tnode,
                                      acc, 8)
    with pytest.raises(ValueError, match="node window"):
        scatter.classify_scatter_cuda(*cols, s.tables, s.tstart, s.tnode,
                                      acc, 65)
    with pytest.raises(ValueError, match="accumulators"):
        scatter.classify_scatter_ranges_cuda(*cols, s.tables, s.tstart,
                                             s.tnode, acc[:3])
    before = dict(extend.LAUNCHES)
    with pytest.raises(ValueError):
        scatter.classify_scatter_ranges_cuda(cols[0].long(), *cols[1:],
                                             s.tables, s.tstart, s.tnode, acc)
    assert extend.LAUNCHES == before


def _work_by_rows(s, cols, L_cap):
    """chip_smoke.scatter_work of K6 (``L_cap`` None) or K11, counted one
    row at a time in Python: each table's sectors as sets over the launch,
    the accumulators' non-zero sectors after the plain version."""
    t = s.tables
    ts, te, aligned = (np.asarray(a) for a in cols)
    tstart, tnode = s.index.tstart, s.index.tnode
    nodes_len, base_offset = t.nodes_len.numpy(), t.base_offset.numpy()
    trio_seg, pos_lo = t.trio_seg.numpy(), t.pos_lo.numpy()
    M = s.M
    i0s = scatter.locate_segment(s.tstart, t.pos_lo, t.win_shift,
                                 t.pos_steps, torch.from_numpy(ts)).numpy()
    acc = chip_smoke.zero_accs(t, M, "cpu")
    tc = [torch.from_numpy(a) for a in (ts, te, aligned)]
    if L_cap is None:
        ridx = scatter.classify_scatter_ranges_plain(*tc, t, s.tstart,
                                                     s.tnode, acc).numpy()
        i1s = scatter.locate_segment(
            s.tstart, t.pos_lo, t.win_shift, t.pos_steps,
            torch.from_numpy(np.maximum(te - 1, ts))).numpy()
    else:
        ridx, overflow = (x.numpy() for x in scatter.classify_scatter_plain(
            *tc, t, s.tstart, s.tnode, acc, L_cap))
    sec = {k: set() for k in ("pos_lo", "tstart", "tnode", "nodes_len",
                              "base_offset", "trio_seg")}

    def bucket(x):
        b = min(max(int(x) >> int(t.win_shift), 0), len(pos_lo) - 2)
        sec["pos_lo"].update({b // 8, (b + 1) // 8})

    live = 0
    for r in range(len(ts)):
        i0, x1 = int(i0s[r]), max(int(te[r]) - 1, int(ts[r]))
        rs, tgt = int(ts[r]) - int(tstart[i0]), int(te[r]) - int(ts[r])
        if L_cap is None:
            if not (aligned[r] and ridx[r] >= 0 and te[r] > ts[r]):
                continue
            live += 1
            i1 = int(i1s[r])
            bucket(ts[r])
            bucket(x1)
            sec["tstart"].update(min(i, M - 1) // 8
                                 for i in (i0, i1, i0 + 1, i1 + 1))
            n0, n1 = tnode[i0] - 1, tnode[i1] - 1
            sec["tnode"].add(i0 // 8)
            sec["base_offset"].add(n0 // 8)
            if i1 > i0:
                sec["tnode"].add(i1 // 8)
                sec["nodes_len"].update({n0 // 8, n1 // 8})
                sec["base_offset"].add(n1 // 8)
            if i1 - i0 >= 2:
                sec["trio_seg"].update({i0 // 8, (i1 - 2) // 8})
            continue
        if not aligned[r]:
            continue
        bucket(ts[r])
        n_more = 0
        while (n_more < L_cap and i0 + n_more + 1 < M
               and tstart[i0 + n_more + 1] <= x1):
            n_more += 1
        span = n_more + 1
        sec["tstart"].update(i // 8 for i in range(
            i0, min(i0 + min(span, L_cap), M - 1) + 1))
        if ridx[r] < 0 or overflow[r] or (span == 1 and tgt < 0):
            continue
        live += 1
        nodes = [int(n) - 1 for n in tnode[i0:i0 + span]]
        nl = [int(nodes_len[n]) for n in nodes]
        alloc = [nl[0] - rs] + nl[1:-1]
        alloc = [tgt] if span == 1 else alloc + [max(tgt - sum(alloc), 0)]
        for j, n in enumerate(nodes):
            sec["tnode"].add((i0 + j) // 8)
            sec["nodes_len"].add(n // 8)
            if j + 2 < span:
                sec["trio_seg"].add((i0 + j) // 8)
            start = rs if j == 0 else 0
            lo = min(max(start, 0), nl[j])
            hi = min(max(start + alloc[j], lo), nl[j])
            in_b = 0 < tgt and rs + tgt <= nl[j]
            if (span > 1 or in_b) and lo != hi:
                sec["base_offset"].add(n // 8)
    gathers = sum(len(v) for v in sec.values())
    sinks = (t.N_pad, t.TB_pad + 1, t.U_pad, M, M)
    atomics = sum(len({int(i) * a.element_size() // 32
                       for i in np.flatnonzero(a[:n].numpy())})
                  for a, n in zip(acc[:5 if L_cap is None else 3], sinks))
    nbytes = (13 + (L_cap is not None)) * len(ts) + 4 * (
        len(s.index.hap_offsets) + t.hap_range.shape[0])
    return nbytes + 32 * gathers + 64 * atomics, live, gathers, atomics


@pytest.mark.parametrize("case", ["span_3_up", "cap", "text_end",
                                  "hap_edges"])
@pytest.mark.parametrize("fixture,L_cap", [("tiny", None), ("tiny", 8),
                                           ("dup", None), ("dup", 4),
                                           ("dup", 16), ("dup", 64)])
def test_scatter_work_counts_each_sector_once(fixture, L_cap, case,
                                              request):
    """K6's and K11's bound (chip_smoke.scatter_work) equals a count made
    one row at a time, with the tables masked so that rows classify to -1
    and trio matches are missing; doubling the rows adds only their
    per-read columns (each sector counts once a launch)."""
    s = request.getfixturevalue(fixture)
    t = chip_smoke.masked_tables(s.tables)
    masked = Setup.__new__(Setup)
    masked.__dict__.update(s.__dict__, tables=t)
    cols = chip_smoke.scatter_cases(s.index, L_cap or 32)[case]
    tc = [torch.from_numpy(a) for a in cols]
    got = chip_smoke.scatter_work(tc, t, s.tstart, s.tnode, L_cap)
    assert got == _work_by_rows(masked, cols, L_cap)
    assert got[1] and got[2] and got[3]
    twice = [torch.cat([a, a]) for a in tc]
    nbytes, *rest = chip_smoke.scatter_work(twice, t, s.tstart, s.tnode,
                                            L_cap)
    per_read = 13 + (L_cap is not None)
    assert (nbytes, *rest) == (got[0] + per_read * len(cols[0]),
                               2 * got[1], *got[2:])
