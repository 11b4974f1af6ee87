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
4 and 32.  The dispatchers take the plain version on CPU tensors and count
it; the kernels' entries refuse CPU tensors.  The kernels themselves are
held to these plain versions on the card (tests/test_torch_cuda.py,
chip_smoke.py phase 3c)."""
from functools import partial

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


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("case", chip_smoke.SCATTER_CASES)
@pytest.mark.parametrize("fixture", ["tiny", "dup"])
def test_ranges_crafted_bit_identical(fixture, case, masked, request):
    """K6's plain version against _classify_scatter_ranges: the five
    accumulators (the diff array's last slot included, the sinks aside)
    and ridx."""
    s = request.getfixturevalue(fixture)
    t = _tables(s, masked)
    cols = chip_smoke.scatter_cases(s.index, 32)[case]
    rt = s.ref_tables
    M = s.M
    ref_acc = (jnp.zeros(rt.N_pad, jnp.float32),
               jnp.zeros(rt.TB_pad + 1, jnp.int32),
               jnp.zeros(rt.U_pad, jnp.float32), jnp.zeros(M + 1, jnp.int32),
               jnp.zeros(M + 1, jnp.int32))
    hap_offsets, hap_range, pos_lo, tstart, tnode, trio_seg = _ref_tables(s, t)
    ridx_w, want = REF_RANGES(
        *(jnp.asarray(a) for a in cols), hap_offsets, hap_range, pos_lo,
        tstart, tnode, trio_seg, rt.nodes_len_d, rt.base_offset_d, ref_acc,
        win_shift=rt.win_shift, pos_steps=rt.pos_steps,
        total_bases=rt.TB_pad)
    acc = chip_smoke.zero_accs(t, M, "cpu")
    ridx = scatter.classify_scatter_ranges_plain(
        *(torch.from_numpy(a) for a in cols), t, s.tstart, s.tnode, acc)
    sizes = (rt.N_pad, rt.TB_pad + 1, rt.U_pad, M, M)
    for i, (w, a, n) in enumerate(zip(want, acc, sizes)):
        _assert_equal(np.asarray(w)[:n], a[:n].numpy(), f"accumulator {i}")
    assert ridx.dtype == torch.int32
    np.testing.assert_array_equal(ridx.numpy(), np.asarray(ridx_w))
    if masked and case != "unaligned":
        assert (ridx < 0).any() and (ridx >= 0).any()


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("case", chip_smoke.SCATTER_CASES)
@pytest.mark.parametrize("fixture,L_cap", [("tiny", 8), ("dup", 4),
                                           ("dup", 32)])
def test_windowed_crafted_bit_identical(fixture, L_cap, case, masked,
                                        request):
    """K11's plain version against _classify_scatter: the three
    accumulators (the diff array's last slot included, the sinks aside),
    ridx and overflow; on the dup community the first-occurrence dedup
    runs (its mask form at 4, the sort form at 32)."""
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
    window (range scatter's m0) and last (m1)."""
    for s, L_cap in ((tiny, 8), (dup, 4), (dup, 32)):
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
