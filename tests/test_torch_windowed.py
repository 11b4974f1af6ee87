"""Windowed / dup-graph coverage of the port (ROADMAP M9) against the JAX
package on the CPU: coverage_scatter and classify_scatter bit-identical to
_coverage_scatter / _classify_scatter, and the fused pipeline's codes,
paired and interval feeds bit-identical in na/ta/bc, the per-read columns
and the overflow count, at the automatic and at forced node windows (the
host residual included), on tiny_db and on a small dup-graph community;
with HiGHS the four output files byte-identical.  Integer-valued float32
accumulators are exact only below 2^24: every case asserts that bound."""
import filecmp

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pantax_tpu.ops.coverage_device as ref_cov
import pantax_tpu.ops.fused as ref_fused
from pantax_tpu.align.aligner import Aligner as RefAligner
from pantax_tpu_torch import _host
from pantax_tpu_torch.benchmarks import dup_db, simulate_read_batch, tiny_db
from pantax_tpu_torch.convert import aligner_from_reference
from pantax_tpu_torch.ops import coverage_device as port_cov
from pantax_tpu_torch.ops import fused as port_fused

from _torch_helpers import (  # noqa: F401 (autouse)
    random_intervals, reference_on_one_device, simulate_pairs,
)

F32_EXACT = port_cov.F32_EXACT
OUT_FILES = ("species_abundance.txt", "strain_abundance.txt",
             "ori_strain_abundance.txt", "reads_classification.tsv")
TABLE_BUFFERS = ("hap_offsets", "hap_range", "pos_lo", "nodes_len",
                 "base_offset", "trio_len", "trio_seg")


class Setup:
    """Both packages over one DB; the port's tables built by the port."""

    def __init__(self, db):
        self.db = db
        self.index = _host.build_align_index(db)
        self.ref_aligner = RefAligner(self.index)
        self.ref_tables = ref_fused.build_fused_tables(db, self.index)
        self.aligner = aligner_from_reference(self.index, _host.AlignConfig(),
                                              "cpu")
        self.tables = port_fused.build_fused_tables(db, self.index, "cpu")


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return Setup(tiny_db(tmp_path_factory.mktemp("tiny")))


@pytest.fixture(scope="module")
def dup(tmp_path_factory):
    return Setup(dup_db(tmp_path_factory.mktemp("dup"), n_species=2,
                        strains=2, n_blocks=400))


def _zero_accs(N, TB, U):
    """(reference accumulators, the port's with their sink slots)."""
    ref = (jnp.zeros(N, jnp.float32), jnp.zeros(TB + 1, jnp.int32),
           jnp.zeros(U, jnp.float32))
    port = (torch.zeros(N + 1, dtype=torch.int64),
            torch.zeros(TB + 1, dtype=torch.int32),
            torch.zeros(U + 1, dtype=torch.int64))
    return ref, port


def _assert_accs_equal(want, got, sizes):
    for i, (w, g, n) in enumerate(zip(want, got, sizes)):
        w = np.asarray(w)
        g = g[:n].numpy()
        assert int(np.abs(g).max(initial=0)) < F32_EXACT, i
        np.testing.assert_array_equal(g.astype(w.dtype), w,
                                      err_msg=f"accumulator {i}")


@pytest.mark.parametrize("L", [4, 8, 16, 64])
@pytest.mark.parametrize("has_dups", [True, False])
@pytest.mark.parametrize("trio", [True, False])
def test_coverage_scatter_bit_identical(L, has_dups, trio):
    """Random node rows drawn from a small pool (so rows repeat nodes),
    empty rows, single-node rows with negative and out-of-bounds spans.
    (Also called at widths over 64 by the next test.)"""
    rng = np.random.default_rng(L * 4 + 2 * has_dups + trio)
    N, R, U = 300, 512, 97
    t = port_cov.build_padded_tables(rng.integers(1, 120, size=N),
                                     rng.integers(3, 360, size=U))
    lengths = rng.integers(0, L + 1, size=R).astype(np.int32)
    lengths[:8] = 1
    nodes = np.where(np.arange(L)[None, :] < lengths[:, None],
                     rng.integers(0, 24, size=(R, L)), -1).astype(np.int32)
    rs = rng.integers(0, 60, size=R).astype(np.int32)
    re = (rs + rng.integers(-10, 400, size=R)).astype(np.int32)
    match = rng.integers(-1, U, size=(R, L - 2)).astype(np.int32)
    ref_acc, acc = _zero_accs(t.N_pad, t.TB_pad, t.U_pad)
    z = jnp.zeros(t.U_pad, jnp.int32)
    want = ref_cov._coverage_scatter(
        jnp.asarray(nodes), jnp.asarray(lengths), jnp.asarray(rs),
        jnp.asarray(re), jnp.asarray(t.nodes_len), jnp.asarray(t.base_offset),
        z.astype(jnp.uint32), z, jnp.zeros((t.U_pad, 3), jnp.int32),
        num_nodes=t.N_pad, total_bases=t.TB_pad,
        num_trios=t.U_pad if trio else 0, acc=ref_acc, has_dups=has_dups,
        trio_match=jnp.asarray(match) if trio else None)
    port_cov.coverage_scatter(
        torch.from_numpy(nodes), torch.from_numpy(lengths),
        torch.from_numpy(rs), torch.from_numpy(re),
        torch.from_numpy(t.nodes_len), torch.from_numpy(t.base_offset), acc,
        has_dups=has_dups,
        trio_match=torch.from_numpy(match) if trio else None)
    _assert_accs_equal(want, acc, (t.N_pad, t.TB_pad + 1, t.U_pad))
    assert (acc[2][:t.U_pad] != 0).any() == trio


def test_coverage_scatter_refuses_wide_dedup():
    """Rows wider than 64 nodes with repeats are no longer refused: they
    take the sort form of the first-occurrence dedup, whose accumulators
    equal the reference's (its sort + carry-scan branch) at widths 65 and
    128, as at 17 and 32, just past the port's switch (where the
    reference still takes its mask form)."""
    for L in (17, 32, 65, 128):
        test_coverage_scatter_bit_identical(L, True, True)


@pytest.mark.parametrize("fixture", ["tiny", "dup"])
@pytest.mark.parametrize("L_cap", [2, 3, 8])
def test_classify_scatter_bit_identical(fixture, L_cap, request):
    """One batch of the port's query output through the reference's
    _classify_scatter and the port's classify_scatter from zero
    accumulators: the three accumulators, ridx and the overflow mask."""
    s = request.getfixturevalue(fixture)
    codes, lens, _ = simulate_read_batch(s.index, 2048, 150, 0.01, seed=8,
                                         indel_rate=0.01)
    ts, te, _sc, _m, _mq, _st, aligned = s.aligner.query(
        *s.aligner.upload(codes, lens))
    a, t = s.ref_aligner, s.ref_tables
    ref_acc, acc = _zero_accs(t.N_pad, t.TB_pad, t.U_pad)
    ridx_w, ov_w, want = ref_fused._classify_scatter(
        *(jnp.asarray(x.numpy()) for x in (ts, te, aligned)),
        t.hap_offsets_d, t.hap_range_d, t.pos_lo_d, a.tstart_d, a.tnode_d,
        t.trio_seg_d, t.nodes_len_d, t.base_offset_d, t.trio_hash_d,
        t.trio_order_d, t.trio_abc_d, t.trio_bucket_d, ref_acc,
        win_shift=t.win_shift, pos_steps=t.pos_steps, L_cap=L_cap,
        num_nodes=t.N_pad, total_bases=t.TB_pad, num_trios=t.U_pad,
        trio_bits=t.trio_bits, trio_steps=t.trio_steps,
        trio_probes=t.trio_probes, has_dups=t.has_dups)
    ridx, ov = port_fused.classify_scatter(
        ts, te, aligned, s.tables, s.aligner.tstart, s.aligner.tnode, acc,
        L_cap)
    _assert_accs_equal(want, acc, (t.N_pad, t.TB_pad + 1, t.U_pad))
    np.testing.assert_array_equal(ridx.numpy(), np.asarray(ridx_w))
    np.testing.assert_array_equal(ov.numpy(), np.asarray(ov_w))
    # tiny_db's SNP bubbles make short segments, so some reads overflow
    # even an 8-segment window there; the dup community's 64 bp nodes give
    # a 150 bp read at most 4 segments
    n_ov = int(ov.sum())
    assert n_ov < int(aligned.sum()) or L_cap == 2
    assert (n_ov > 0) == (fixture == "tiny" or L_cap < 4)


def test_fused_tables_and_windows_equal_on_dup(dup):
    s = dup
    for name in TABLE_BUFFERS:
        np.testing.assert_array_equal(
            getattr(s.tables, name).numpy(),
            np.asarray(getattr(s.ref_tables, name + "_d")), err_msg=name)
    for name in ("has_dups", "win_shift", "pos_steps", "N_pad", "TB_pad",
                 "U_pad"):
        assert getattr(s.tables, name) == getattr(s.ref_tables, name), name
    np.testing.assert_array_equal(s.tables.hap_dup, s.ref_tables.hap_dup)
    assert s.tables.has_dups and s.tables.hap_dup.all()
    for pad, band in ((160, 4), (512, 8), (96, 0)):
        assert (port_fused.auto_node_window(s.index, pad, band)
                == ref_fused.auto_node_window(s.index, pad, band))
        for K in (2, 3, 4, 8):
            assert (port_fused.overflow_fraction(s.index, pad, K, band)
                    == ref_fused.overflow_fraction(s.index, pad, K, band))


def _assert_results_equal(want, got, pipe):
    for name, a, b in (("na", want.na_d, got.na_d), ("ta", want.ta_d, got.ta_d),
                       ("bc", want.bc_d, got.bc_d)):
        a = np.asarray(a)
        assert a.dtype == b.numpy().dtype, name
        np.testing.assert_array_equal(a, b.numpy(), err_msg=name)
    for k in ("mapq", "aligned", "ridx", "read_len"):
        assert want.reads[k].dtype == got.reads[k].dtype, k
        np.testing.assert_array_equal(want.reads[k], got.reads[k], err_msg=k)
    assert got.n_overflow == want.n_overflow
    for acc in (pipe.acc[0], pipe.acc[2]):
        assert int(acc.abs().max()) < F32_EXACT


@pytest.mark.parametrize("fixture,L_cap", [("tiny", 4), ("tiny", 2),
                                           ("dup", None), ("dup", 3)])
def test_feed_windowed_bit_identical(fixture, L_cap, request):
    """feed() through the windowed scatter: at a forced window (reads over
    it take the host residual) and, on the dup community, at the window the
    first feed picks."""
    s = request.getfixturevalue(fixture)
    n, batch = 3000, 1024
    codes, lens, _ = simulate_read_batch(s.index, n, 150, 0.01, seed=3,
                                         indel_rate=0.01)
    ids = [f"r{i}" for i in range(n)]
    jp = ref_fused.FusedPipeline(s.ref_aligner, s.ref_tables, batch, L_cap)
    jp.feed(codes, lens, ids=ids)
    want = jp.finish()
    pp = port_fused.FusedPipeline(s.aligner, s.tables, batch, L_cap)
    pp.feed(codes, lens, ids=ids)
    got = pp.finish()
    assert not jp.use_ranges and not pp.use_ranges
    assert pp.L_cap == jp.L_cap == (L_cap or 4)
    assert pp.n_batches == -(-n // batch)
    _assert_results_equal(want, got, pp)
    assert got.reads["ids"] == ids
    assert (got.n_overflow > 0) == (L_cap is not None)
    assert got.reads["aligned"].mean() > 0.9


@pytest.mark.parametrize("fixture,L_cap", [("tiny", 4), ("dup", None),
                                           ("dup", 3)])
def test_feed_paired_windowed_bit_identical(fixture, L_cap, request):
    """feed_paired() through the windowed scatter: rows as a mate-1 block
    then a mate-2 block per batch, one overflow record per dispatch."""
    s = request.getfixturevalue(fixture)
    n, batch = 1500, 512
    c1, l1, c2, l2 = simulate_pairs(s.index, n, seed=4)
    ids1 = [f"A{i}" for i in range(n)]
    ids2 = [f"B{i}" for i in range(n)]
    jp = ref_fused.FusedPipeline(s.ref_aligner, s.ref_tables, batch, L_cap)
    jp.feed_paired(c1, l1, c2, l2, ids1=ids1, ids2=ids2)
    want = jp.finish()
    pp = port_fused.FusedPipeline(s.aligner, s.tables, batch, L_cap)
    pp.feed_paired(c1, l1, c2, l2, ids1=ids1, ids2=ids2)
    got = pp.finish()
    assert not pp.use_ranges and pp.L_cap == jp.L_cap
    _assert_results_equal(want, got, pp)
    order = [i for lo in range(0, n, batch)
             for ids in (ids1, ids2) for i in ids[lo:lo + batch]]
    assert got.reads["ids"] == list(want.reads["ids"]) == order
    assert (got.n_overflow > 0) == (L_cap is not None)


def test_feed_intervals_on_dup_haplotypes_bit_identical(dup):
    """Interval rows on haplotypes that revisit a node: spans of at most 8
    segments through the windowed scatter, longer ones through the host
    residual (tails past the haplotype clamped), in two feeds."""
    s = dup
    ts, te, mapq, read_len = random_intervals(s.index, 700, seed=5)
    jp = ref_fused.FusedPipeline(s.ref_aligner, s.ref_tables, 128)
    pp = port_fused.FusedPipeline(s.aligner, s.tables, 128)
    for sl in (slice(0, 300), slice(300, None)):
        ids = [f"L{i}" for i in range(700)][sl]
        jp.feed_intervals(ts[sl], te[sl], mapq[sl], read_len[sl], ids=ids)
        pp.feed_intervals(ts[sl], te[sl], mapq[sl], read_len[sl], ids=ids)
    want, got = jp.finish(), pp.finish()
    _assert_results_equal(want, got, pp)
    assert got.reads["ids"] == [f"L{i}" for i in range(700)]
    rows = pp.interval_rows
    assert rows["range"] == 0 and rows["window"] > 64 and rows["residual"] > 64
    assert rows["window"] + rows["residual"] == 695  # five rows have te == ts
    assert pp.n_interval_batches >= -(-rows["window"] // 128)


def test_profile_highs_files_byte_identical_on_dup(dup, tmp_path):
    s = dup
    codes, lens, _ = simulate_read_batch(s.index, 4000, 150, 0.01, seed=3)
    cfg = _host.ProfilingConfig.for_read_type("short")
    cfg.solver, cfg.tail = "highs", "host"
    ref_fused.profile_fused(s.ref_aligner, codes, lens, s.index, s.db, cfg,
                            tmp_path / "ref", 1024, tables=s.ref_tables)
    stage = {}
    port_fused.profile_fused(s.aligner, codes, lens, s.index, s.db, cfg,
                             tmp_path / "port", 1024, tables=s.tables,
                             stage_out=stage)
    assert stage["L_cap"] == 4 and stage["n_batches"] == 4
    for name in OUT_FILES:
        assert filecmp.cmp(tmp_path / "ref" / name, tmp_path / "port" / name,
                           shallow=False), name
    rows = (tmp_path / "port" / "strain_abundance.txt").read_text()
    assert len(rows.splitlines()) == 5, rows
