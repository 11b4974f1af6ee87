"""Fused pipeline and profile tail of the PyTorch port against the JAX
reference (CPU, plain versions): host-side tables array-equal, na/ta/bc and
per-read columns bit-identical, HiGHS output files byte-identical, the
pandas-free writers byte-identical to pandas."""
import copy
import dataclasses
import filecmp

import numpy as np
import pytest
import torch

import pantax_tpu.ops.coverage_device as ref_cov
import pantax_tpu.ops.fused as ref_fused
from pantax_tpu.align.aligner import Aligner as RefAligner
from pantax_tpu.profile import report as ref_report
from pantax_tpu.profile import species as ref_species
from pantax_tpu_torch import _host
from pantax_tpu_torch.benchmarks import scale_db, simulate_read_batch, tiny_db
from pantax_tpu_torch.convert import (
    aligner_from_reference, fused_tables_from_reference,
)
from pantax_tpu_torch.ops import coverage_device as port_cov
from pantax_tpu_torch.ops import fused as port_fused
from pantax_tpu_torch.profile import report as port_report
from pantax_tpu_torch.profile import species as port_species
from pantax_tpu_torch.profile.pao import solve_pao_batch

from _torch_helpers import reference_on_one_device  # noqa: F401 (autouse)

OUT_FILES = ("species_abundance.txt", "strain_abundance.txt",
             "ori_strain_abundance.txt", "reads_classification.tsv")
TABLE_BUFFERS = ("hap_offsets", "hap_range", "pos_lo", "nodes_len",
                 "base_offset", "trio_len", "trio_seg")


class Setup:
    def __init__(self, db):
        self.db = db
        self.index = _host.build_align_index(db)
        self.ref_aligner = RefAligner(self.index)
        self.ref_tables = ref_fused.build_fused_tables(db, self.index)
        self.aligner = aligner_from_reference(self.index, _host.AlignConfig(),
                                              "cpu")
        self.tables = fused_tables_from_reference(self.ref_tables, "cpu")


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return Setup(tiny_db(tmp_path_factory.mktemp("tiny")))


@pytest.fixture(scope="module")
def scale(tmp_path_factory):
    return Setup(scale_db(tmp_path_factory.mktemp("scale"), n_species=3,
                          genome_len=50_000))


@pytest.fixture(scope="module")
def reads(tiny):
    return simulate_read_batch(tiny.index, 3000, 150, 0.01, seed=3)


def test_fused_tables_array_equal(tiny):
    s = tiny
    built = port_fused.build_fused_tables(s.db, s.index, "cpu")
    for name in TABLE_BUFFERS:
        assert torch.equal(getattr(built, name), getattr(s.tables, name)), name
    for name in ("has_dups", "win_shift", "pos_steps", "N_pad", "TB_pad",
                 "U_pad"):
        assert getattr(built, name) == getattr(s.ref_tables, name), name
    np.testing.assert_array_equal(built.hap_dup, s.ref_tables.hap_dup)
    tstart = s.index.tstart.astype(np.int64)
    for a, b in zip(port_fused.build_pos_lookup(tstart, s.index.text_len),
                    ref_fused.build_pos_lookup(tstart, s.index.text_len)):
        np.testing.assert_array_equal(a, b)
    for W in (3, 64):
        assert (port_fused._window_has_dup_nodes(s.index, W)
                == ref_fused._window_has_dup_nodes(s.index, W))
    assert (port_fused.node_span_bound(s.index, 160, 4)
            == ref_fused.node_span_bound(s.index, 160, 4))
    hap_range = s.tables.hap_range.numpy()
    np.testing.assert_array_equal(
        port_fused._build_trio_seg(s.index, built.species, hap_range),
        ref_fused._build_trio_seg(s.index, s.ref_tables.species, hap_range))
    nodes_len = np.concatenate([sp.nodes_len for sp in built.species])
    tl = np.concatenate([sp.trio_index.trio_len for sp in built.species])
    tn = np.concatenate([sp.trio_index.trio_nodes + sp.off
                         for sp in built.species])
    ours = port_cov.build_padded_tables(nodes_len, tl)
    theirs = ref_cov.build_padded_tables(nodes_len, tn, tl)
    for name in ("nodes_len", "base_offset", "trio_len", "N", "U", "N_pad",
                 "TB_pad", "U_pad"):
        np.testing.assert_array_equal(np.asarray(getattr(ours, name)),
                                      np.asarray(getattr(theirs, name)),
                                      err_msg=name)


def test_hap_dup_matches_reference_on_a_revisiting_hap(tiny):
    """A copy of the index in which one haplotype revisits a node (its
    second segment's node set to its first's): the port's hap_dup marks that
    haplotype, and only it, as the reference's does."""
    s = tiny
    h = 1
    lo, hi = s.index.hap_offsets[h], s.index.hap_offsets[h + 1]
    segs = np.flatnonzero((s.index.tstart >= lo) & (s.index.tstart < hi))
    assert len(segs) >= 2
    tnode = s.index.tnode.copy()
    tnode[segs[1]] = tnode[segs[0]]
    index = dataclasses.replace(s.index, tnode=tnode)
    built = port_fused.build_fused_tables(s.db, index, "cpu")
    want = ref_fused.build_fused_tables(s.db, index).hap_dup
    np.testing.assert_array_equal(built.hap_dup, want)
    assert np.flatnonzero(built.hap_dup).tolist() == [h]


def test_locate_segment_matches_searchsorted(tiny):
    t = tiny.tables
    tstart = tiny.aligner.tstart
    rng = np.random.default_rng(0)
    ts = torch.from_numpy(rng.integers(0, tiny.index.text_len - 2048,
                                       size=4096).astype(np.int32))
    got = port_fused.locate_segment(tstart, t.pos_lo, t.win_shift,
                                    t.pos_steps, ts)
    want = np.searchsorted(tiny.index.tstart, ts.numpy(), side="right") - 1
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("fixture,n,batch", [("tiny", 3000, 1024),
                                             ("scale", 2048, 1024)])
def test_pipeline_bit_identical(fixture, n, batch, request):
    s = request.getfixturevalue(fixture)
    codes, lens, _ = simulate_read_batch(s.index, n, 150, 0.01, seed=3,
                                         indel_rate=0.01)
    ids = [f"r{i}" for i in range(n)]
    jp = ref_fused.FusedPipeline(s.ref_aligner, s.ref_tables, batch=batch)
    jp.feed(codes, lens, ids=ids)
    want = jp.finish()
    assert jp.use_ranges
    pp = port_fused.FusedPipeline(s.aligner, s.tables, batch=batch)
    pp.feed(codes, lens, ids=ids)
    got = pp.finish()
    assert pp.n_batches == -(-n // batch)
    for name, a, b in (("na", want.na_d, got.na_d), ("ta", want.ta_d, got.ta_d),
                       ("bc", want.bc_d, got.bc_d)):
        a = np.asarray(a)
        assert a.dtype == b.numpy().dtype, name
        np.testing.assert_array_equal(a, b.numpy(), err_msg=name)
    for k in ("mapq", "aligned", "ridx", "read_len"):
        assert want.reads[k].dtype == got.reads[k].dtype, k
        np.testing.assert_array_equal(want.reads[k], got.reads[k], err_msg=k)
    assert got.reads["ids"] == ids
    assert got.reads["aligned"].mean() > 0.9


def test_fused_step_bit_identical(scale):
    """One batch through the reference's jitted _fused_step_ranges and the
    port's fused_step (the range scatter, no window) from zero
    accumulators: all five accumulators and all five narrow per-read
    columns agree."""
    import jax.numpy as jnp

    s = scale
    codes, lens, _ = simulate_read_batch(s.index, 1024, 150, 0.01, seed=8,
                                         indel_rate=0.01)
    a, t = s.ref_aligner, s.ref_tables
    M = len(s.index.tstart)
    zeros = (np.zeros(t.N_pad, np.float32), np.zeros(t.TB_pad + 1, np.int32),
             np.zeros(t.U_pad, np.float32), np.zeros(M + 1, np.int32),
             np.zeros(M + 1, np.int32))
    want = ref_fused._fused_step_ranges(
        a.text_d, a.run_table_d, a.seed_pos_d, a.bucket_lo_d, a.tstart_d,
        a.tnode_d, t.hap_offsets_d, t.hap_range_d, t.pos_lo_d, t.trio_seg_d,
        t.nodes_len_d, t.base_offset_d, *a.prep_codes(codes, lens),
        *(jnp.asarray(z) for z in zeros), cfg_static=a._static(),
        win_shift=t.win_shift, pos_steps=t.pos_steps, total_bases=t.TB_pad,
    )
    pipe = port_fused.FusedPipeline(s.aligner, s.tables, batch=1024)
    cols, overflow = port_fused.fused_step(
        s.aligner, s.tables, *s.aligner.upload(codes, lens), pipe.acc)
    assert overflow is None
    sizes = (t.N_pad, t.TB_pad + 1, t.U_pad, M, M)  # minus the sink slots
    for i, (w, acc, n) in enumerate(zip(want[:5], pipe.acc, sizes)):
        w = np.asarray(w)[:n]
        np.testing.assert_array_equal(acc[:n].numpy().astype(w.dtype), w,
                                      err_msg=f"accumulator {i}")
    for i, (w, g) in enumerate(zip(want[5:], cols)):
        w = np.asarray(w)
        assert w.dtype == g.numpy().dtype, i
        np.testing.assert_array_equal(g.numpy(), w, err_msg=f"column {i}")


def _profile_both(s, codes, lens, tmp_path, solver):
    cfg = _host.ProfilingConfig.for_read_type("short")
    cfg.solver = solver
    out_ref, out_port = tmp_path / "ref", tmp_path / "port"
    ref_fused.profile_fused(s.ref_aligner, codes, lens, s.index, s.db, cfg,
                            out_ref, 1024, tables=s.ref_tables)
    stage = {}
    port_fused.profile_fused(s.aligner, codes, lens, s.index, s.db, cfg,
                             out_port, 1024, tables=s.tables, stage_out=stage)
    assert stage["n_batches"] == -(-len(lens) // 1024)
    return out_ref, out_port


def test_profile_highs_files_byte_identical(tiny, reads, tmp_path):
    codes, lens, _ = reads
    out_ref, out_port = _profile_both(tiny, codes, lens, tmp_path, "highs")
    for name in OUT_FILES:
        assert filecmp.cmp(out_ref / name, out_port / name, shallow=False), name
    assert len((out_port / "strain_abundance.txt").read_text().splitlines()) == 5


def _rows(path):
    lines = path.read_text().splitlines()
    return lines[0], [ln.split("\t") for ln in lines[1:]]


def test_profile_admm_matches_reference(tiny, reads, tmp_path):
    """ADMM: the species table and classification are byte-identical; the
    strain rows are the same strains, with coverages inside the reference's
    own ADMM bar (0.05 absolute, tests/test_pao.py) -- the L1 fit's optimum
    can be a whole face, and two ADMM runs may stop at different points."""
    codes, lens, _ = reads
    out_ref, out_port = _profile_both(tiny, codes, lens, tmp_path, "admm")
    for name in ("species_abundance.txt", "reads_classification.tsv"):
        assert filecmp.cmp(out_ref / name, out_port / name, shallow=False), name
    for name in ("strain_abundance.txt", "ori_strain_abundance.txt"):
        head_r, rows_r = _rows(out_ref / name)
        head_p, rows_p = _rows(out_port / name)
        assert head_r == head_p
        assert sorted(r[:3] for r in rows_r) == sorted(r[:3] for r in rows_p)
        key = {tuple(r[:3]): r for r in rows_r}
        for r in rows_p:
            want = key[tuple(r[:3])]
            for col in (3, 8):  # predicted_coverage, first_sol
                assert abs(float(r[col]) - float(want[col])) <= 0.05, (name, r)


def test_admm_objective_within_reference_bar():
    """Port ADMM + polish reaches the HiGHS objective within the bar of the
    reference's test_device_solver_matches_host_pao (1e-4 relative)."""
    rng = np.random.default_rng(7)
    instances = []
    for p in (2, 3, 5):
        n = 300
        A = (rng.random((n, p)) < 0.7).astype(np.float64)
        x = rng.uniform(1, 8, size=p)
        b = np.maximum(A @ x + rng.normal(0, 0.5, size=n), 0)
        instances.append((A, b, 1.05 * b.max(), None))
    instances.append((instances[0][0], instances[0][1], instances[0][2],
                      np.array([False, True])))
    admm = solve_pao_batch(instances, "admm", device="cpu")
    exact = solve_pao_batch(instances, "highs", device="cpu")
    for a, e in zip(admm, exact):
        assert a.objective <= e.objective * (1 + 1e-4) + 1e-6
    assert admm[3].x[1] == 0.0


def _metrics():
    HM = _host.HapMetrics
    return [
        HM(otu="101", hap_id="GCF_101a.1", unique_trio_nodes_fraction=0.5,
           frequencies_mean=3.25, path_cov_ratio=0.9, first_sol=3.0,
           divergence=0.1, second_sol=3.0, total_cov_diff=0.05),
        HM(otu="101", hap_id="GCF_101b.1", unique_trio_nodes_fraction=None,
           frequencies_mean=None, path_cov_ratio=None, first_sol=None,
           divergence=None, second_sol=None, total_cov_diff=0.05),
        HM(otu="202", hap_id="GCF_202a.1", unique_trio_nodes_fraction=0.97,
           frequencies_mean=1 / 3, path_cov_ratio=0.123456789, first_sol=2.0,
           divergence=None, second_sol=2.0, total_cov_diff=0.3),
        HM(otu="303", hap_id="GCF_303a.1", unique_trio_nodes_fraction=0.4,
           frequencies_mean=1e-5, path_cov_ratio=1.0, first_sol=3.0,
           divergence=0.0, second_sol=3.0, total_cov_diff=0.01),
        HM(otu="303", hap_id="GCF_unknown", unique_trio_nodes_fraction=0.4,
           frequencies_mean=2.0, path_cov_ratio=1.0, first_sol=1e17,
           divergence=0.0, second_sol=0.0, total_cov_diff=0.01),
    ]


def _genomes():
    GI = _host.GenomeInfo
    return [GI("GCF_101a.1_x", "101.a", "101", "s", "GCF_101a.1_x_genomic.fna"),
            GI("GCF_101b.1_x", "101.b", "101", "s", "GCF_101b.1_x_genomic.fna"),
            GI("GCF_202a.1_x", "202.a", "202", "s", "GCF_202a.1_x.fna.gz"),
            GI("GCF_202a.1_y", "202.y", "202", "s", "GCF_202a.1_y.fna"),
            GI("GCF_303a.1_x", "303.a", "303", "s", "GCF_303a.1_x.fna")]


@pytest.mark.parametrize("full", [True, False])
def test_report_writer_byte_identical_to_pandas(full, tmp_path):
    cfg = _host.ProfilingConfig.for_read_type("short")
    cfg.full = full
    (tmp_path / "ref").mkdir()
    (tmp_path / "port").mkdir()
    ref_report.abundance_est(cfg, copy.deepcopy(_metrics()), _genomes(),
                             tmp_path / "ref")
    port_report.abundance_est(cfg, copy.deepcopy(_metrics()), _genomes(),
                              tmp_path / "port")
    for name in ("ori_strain_abundance.txt", "strain_abundance.txt"):
        assert ((tmp_path / "port" / name).read_text()
                == (tmp_path / "ref" / name).read_text()), name


@pytest.mark.parametrize("filtered", [True, False])
def test_species_writer_byte_identical_to_pandas(filtered, tmp_path):
    rng = np.random.default_rng(2)
    names = np.array(["11", "22", "33", "44"], dtype=object)
    codes = rng.integers(0, 4, size=500)
    read_len = rng.integers(100, 151, size=500)
    mapq = rng.choice([0, 1, 5, 30, 60], size=500)
    mean_len = {"11": 1e6, "22": 2.5e6, "44": 3e5}  # "33" missing -> NaN
    ours = port_species.species_profiling_codes(codes, names, read_len, mapq,
                                                mean_len, filtered)
    theirs = ref_species.species_profiling_codes(codes, names, read_len, mapq,
                                                 mean_len, filtered)
    ours.save(tmp_path / "port.txt")
    theirs.save(tmp_path / "ref.txt")
    assert (tmp_path / "port.txt").read_text() == (tmp_path / "ref.txt").read_text()
    for sp in ("11", "33", "99"):
        np.testing.assert_equal(ours.coverage_of(sp), theirs.coverage_of(sp))


def _dup_pipelines(s, **flags):
    """(reference, port) pipelines over copies of the tables with ``flags``
    set on both, batch 64."""
    ref_t, port_t = copy.copy(s.ref_tables), copy.copy(s.tables)
    for k, v in flags.items():
        setattr(ref_t, k, v)
        setattr(port_t, k, v)
    return (ref_fused.FusedPipeline(s.ref_aligner, ref_t, batch=64),
            port_fused.FusedPipeline(s.aligner, port_t, batch=64))


def _assert_finish_equal(jp, pp):
    want, got = jp.finish(), pp.finish()
    for a, b in ((want.na_d, got.na_d), (want.ta_d, got.ta_d),
                 (want.bc_d, got.bc_d)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    for k in ("mapq", "aligned", "ridx", "read_len"):
        np.testing.assert_array_equal(want.reads[k], got.reads[k], err_msg=k)
    assert got.n_overflow == want.n_overflow
    return got


def test_unported_paths_raise(tiny, reads, tmp_path):
    """The paths that raised before they were ported run and match the
    reference: the windowed / dup-graph coverage (M9) of codes, paired and
    interval feeds on tables marked as revisiting nodes, the paired feed,
    and the device tail (M5)."""
    codes, lens, _ = reads
    hap0 = tiny.index.hap_offsets[0]
    jp, pp = _dup_pipelines(tiny, hap_dup=np.ones_like(tiny.tables.hap_dup))
    for p in (jp, pp):
        p.feed_intervals([hap0 + 10, hap0 + 900], [hap0 + 5000, hap0 + 1100],
                         [60, 30], [4990, 200])
    _assert_finish_equal(jp, pp)
    assert pp.interval_rows["range"] == 0
    assert pp.interval_rows["window"] + pp.interval_rows["residual"] == 2
    for feed in ("feed", "feed_paired"):
        jp, pp = _dup_pipelines(tiny, has_dups=True)
        args = ((codes[:64], lens[:64]) if feed == "feed" else
                (codes[:64], lens[:64], codes[64:128], lens[64:128]))
        for p in (jp, pp):
            getattr(p, feed)(*args)
        got = _assert_finish_equal(jp, pp)
        assert not pp.use_ranges and pp.L_cap == jp.L_cap
        assert got.reads["aligned"].mean() > 0.9
    cfg = _host.ProfilingConfig.for_read_type("short")
    cfg.tail = "device"
    assert port_fused.profile_fused(tiny.aligner, codes[:256], lens[:256],
                                    tiny.index, tiny.db, cfg, tmp_path, 256,
                                    tables=tiny.tables)
    assert (tmp_path / "strain_abundance.txt").read_text().count("\n") > 1
    # 'auto' picks the device tail on a large DB
    cfg.tail = "auto"
    big = copy.copy(tiny.tables)
    assert port_fused._tail_mode(big, cfg) == "host"
    big.N_pad = 1 << 20
    assert port_fused._tail_mode(big, cfg) == "device"


def test_finalize_refuses_inexact_float32_sums():
    z = torch.zeros
    with pytest.raises(ValueError, match="2\\^24"):
        port_cov.coverage_finalize(
            torch.tensor([1 << 24, 0]), z(9, dtype=torch.int32),
            z(4, dtype=torch.int64), torch.ones(2, dtype=torch.int32),
            torch.tensor([0, 1, 2], dtype=torch.int32),
            torch.ones(4, dtype=torch.int32))
