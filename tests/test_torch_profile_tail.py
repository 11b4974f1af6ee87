"""Device profile tail of the PyTorch port (ops/profile_tail.py) against the
JAX reference and the host tail (CPU, plain torch): the reference's own
bars (tests/test_profile_tail.py) on in-repo fixtures.  Tail tables
array-equal; stats equal the reference's and the host filters' exact math
(counts and integer sums exactly, float32 means to 1e-5); the first filter
bit-identical to first_filter_paths on exact stats; A and b bit-identical
and the Cholesky factor within 1e-5; the polish bit-identical; the device
solver within 1e-4 of the host objective and of the reference's device
solver; and on paired reads over the scale slice, the device tail's files
agree with the host tail's and the JAX device tail's (species
byte-identical, the same strains, the stats columns within rtol 2e-4, the
solver's columns within the reference's ADMM bar; assert_tables_agree),
with equal strain sets across a borderline divergence sweep."""
import filecmp

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import pantax_tpu.ops.fused as ref_fused
import pantax_tpu.ops.profile_tail as ref_tail
from pantax_tpu.align.aligner import Aligner as RefAligner
from pantax_tpu.profile.filters import zscore_filter
from pantax_tpu_torch import _host
from pantax_tpu_torch.benchmarks import scale_db
from pantax_tpu_torch.convert import (
    aligner_from_reference, fused_tables_from_reference,
    tail_tables_from_reference,
)
from pantax_tpu_torch.ops import fused as port_fused
from pantax_tpu_torch.ops import profile_tail as port_tail
from pantax_tpu_torch.profile.pao import solve_pao

from _torch_helpers import reference_on_one_device  # noqa: F401 (autouse)
from _torch_helpers import assert_tables_agree, simulate_pairs, strain_rows

TAIL_FIELDS = ("hap_node_off", "trio_count", "path_len", "hap_species",
               "hap_local", "sp_hap_lo", "sp_all_same", "sp_m_size",
               "sp_nvert", "sp_off")


# ---------------------------------------------------------------------------
# fixtures and helpers
# ---------------------------------------------------------------------------
class Scale:
    """The 3-species scale slice, both packages' tables, and one paired
    read set fed through both packages' feed_paired."""

    def __init__(self, root):
        self.db = scale_db(root, n_species=3, genome_len=50_000)
        self.index = _host.build_align_index(self.db)
        self.ref_aligner = RefAligner(self.index)
        self.ref_tables = ref_fused.build_fused_tables(self.db, self.index)
        self.aligner = aligner_from_reference(self.index, _host.AlignConfig(),
                                              "cpu")
        self.tables = fused_tables_from_reference(self.ref_tables, "cpu")
        # an uneven mixture spreads the strains' divergences
        weights = np.tile([6.0, 2.0, 1.0], 3) * np.repeat([1.0, 1.5, 0.7], 3)
        pairs = simulate_pairs(self.index, 6000, seed=11, hap_weights=weights)
        jp = ref_fused.FusedPipeline(self.ref_aligner, self.ref_tables, 2048)
        jp.feed_paired(*pairs)
        self.ref_result = jp.finish()
        pp = port_fused.FusedPipeline(self.aligner, self.tables, 2048)
        pp.feed_paired(*pairs)
        self.result = pp.finish()

    def profile(self, out, tail, fc=None, ref=False, sample_nodes=None):
        cfg = _host.ProfilingConfig.for_read_type("short")
        cfg.tail = tail
        if fc is not None:
            cfg.unique_trio_nodes_mean_count_f = fc
        if sample_nodes is not None:
            cfg.sample_nodes = sample_nodes
        if ref:
            ref_fused.profile_from_fused_result(
                self.ref_result, self.ref_tables, self.index, self.db, cfg, out)
        else:
            port_fused.profile_from_fused_result(
                self.result, self.tables, self.index, self.db, cfg, out)
        return out


@pytest.fixture(scope="module")
def scale(tmp_path_factory):
    return Scale(tmp_path_factory.mktemp("scale"))


def _random_species(rng, n_haps=4, n_nodes=160):
    """Random chain-like paths sharing a node pool, each with a private
    detour so that it owns unique trios (the reference's fixture)."""
    nodes_len = rng.integers(1, 40, size=n_nodes).astype(np.int64)
    base = np.arange(n_nodes, dtype=np.int64)
    paths = {}
    for h in range(n_haps):
        p = base[rng.random(n_nodes) > 0.25]
        ins = rng.permutation(p[:max(len(p) // 4, 3)])
        paths[f"hap{h}"] = np.concatenate([p, ins])
    return nodes_len, paths, _host.build_trio_index(nodes_len, paths)


def _ref_single_species_tt(paths, trio_index, nodes_len):
    """The reference's TailTables for one species at node offset 0."""
    names = sorted(paths)
    G = len(names)
    parts = [np.asarray(paths[n], dtype=np.int32) for n in names]
    hm = trio_index.hap_matrix
    off = np.zeros(G + 1, dtype=np.int64)
    np.cumsum([len(p) for p in parts], out=off[1:])
    return ref_tail.TailTables(
        trio_hap_d=jnp.asarray(np.argmax(hm, axis=1).astype(np.int32)
                               if hm.size else np.zeros(0, np.int32)),
        path_node_d=jnp.asarray(np.concatenate(parts)),
        path_hap_d=jnp.asarray(np.repeat(np.arange(G, dtype=np.int32),
                                         [len(p) for p in parts])),
        node_species_d=jnp.asarray(np.zeros(len(nodes_len), np.int32)),
        hap_node_off=off,
        trio_count=np.array([(hm[:, h] > 0).sum() if hm.size else 0
                             for h in range(G)], dtype=np.int64),
        path_len=np.array([float(np.asarray(nodes_len, np.float32)[p]
                                 .sum(dtype=np.float32)) for p in parts]),
        hap_species=np.zeros(G, np.int32),
        hap_local=np.arange(G, dtype=np.int32),
        sp_hap_lo=np.array([0, G], dtype=np.int64),
        sp_all_same=np.array([all(np.array_equal(parts[0], q)
                                  for q in parts[1:])]),
        sp_m_size=np.array([hm.size], dtype=np.int64),
        sp_nvert=np.array([len(nodes_len)], dtype=np.int64),
        sp_off=np.array([0], dtype=np.int64),
        G=G, S=1,
    )


def _host_stats_single(paths, trio_index, ta, na, bc, min_depth):
    """TailStats of one species with the host filters' own float64 math."""
    names = sorted(paths)
    hm = trio_index.hap_matrix
    G = len(names)
    c1, freq, pcov = np.zeros(G), np.zeros(G), np.zeros(G)
    for h in range(G):
        vals = np.asarray(ta)[hm[:, h] > 0] if hm.size else np.zeros(0)
        nz = vals[vals > 0.0]
        c1[h] = len(nz)
        kept = zscore_filter(nz, 3.0) if len(nz) else np.zeros(0)
        freq[h] = float(kept.mean()) if kept.size else 0.0
        pcov[h] = float(np.asarray(bc, dtype=np.float32)[paths[names[h]]]
                        .sum(dtype=np.float32))
    na = np.asarray(na)
    na_opt = np.where(na > min_depth, na, 0.0)
    nz = na_opt[na_opt > 0.0]
    return port_tail.TailStats(
        c1=c1, freq_mean=freq, path_cov=pcov,
        sp_nz_mean=np.array([float(nz.mean()) if nz.size else 0.0]),
        sp_max=np.array([float(np.max(na)) if len(na) else 0.0]),
        sp_valid=np.array([float((na > 0).sum())]),
    )


def _stats_both(tt_ref, na, ta, bc, min_depth):
    """(port TailStats, reference TailStats) on the same float32 inputs."""
    tt = tail_tables_from_reference(tt_ref, "cpu")
    got = port_tail.compute_tail_stats(
        tt, torch.from_numpy(np.array(na, np.float32)),
        torch.from_numpy(np.array(ta, np.float32)),
        torch.from_numpy(np.array(bc, np.int32)), min_depth)
    want = ref_tail.compute_tail_stats(
        tt_ref, jnp.asarray(np.asarray(na, np.float32)),
        jnp.asarray(np.asarray(ta, np.float32)),
        jnp.asarray(np.asarray(bc, np.int32)), min_depth)
    return got, want


def _assert_stats_close(got, want):
    """The reference's bars: counts and integer sums exact, float32 means
    within 1e-5, the max within 1e-6."""
    np.testing.assert_array_equal(got.c1, want.c1)
    np.testing.assert_allclose(got.freq_mean, want.freq_mean, rtol=1e-5)
    np.testing.assert_array_equal(got.path_cov, want.path_cov)
    np.testing.assert_allclose(got.sp_nz_mean, want.sp_nz_mean, rtol=1e-5)
    np.testing.assert_allclose(got.sp_max, want.sp_max, rtol=1e-6)
    np.testing.assert_array_equal(got.sp_valid, want.sp_valid)


# ---------------------------------------------------------------------------
# tables and stats
# ---------------------------------------------------------------------------
def test_build_tail_tables_array_equal(scale):
    got = port_tail.build_tail_tables(
        port_fused.build_fused_tables(scale.db, scale.index, "cpu"))
    want = ref_tail.build_tail_tables(scale.ref_tables)
    for name in ("trio_hap", "path_node", "path_hap", "node_species"):
        a = np.asarray(getattr(want, name + "_d"))
        assert getattr(got, name).dtype == torch.int32, name
        np.testing.assert_array_equal(getattr(got, name).numpy(), a, err_msg=name)
    for name in TAIL_FIELDS:
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name),
                                      err_msg=name)
    assert (got.G, got.S) == (want.G, want.S) == (9, 3)
    # built once per FusedTables
    assert (port_fused._ensure_tail_tables(scale.tables)
            is port_fused._ensure_tail_tables(scale.tables))


def test_k9_order_tables_equal_from_both_table_sources(scale):
    """K9's slices (ORDER_FIELDS) equal whether build_tail_tables makes
    them from the port's FusedTables or tail_tables_from_reference derives
    them from the reference's TailTables, which lacks them; and they slice
    what the owner arrays say."""
    got = port_tail.build_tail_tables(
        port_fused.build_fused_tables(scale.db, scale.index, "cpu"))
    ref = tail_tables_from_reference(
        ref_tail.build_tail_tables(scale.ref_tables), "cpu")
    for name in port_tail.ORDER_FIELDS:
        assert getattr(got, name).dtype == torch.int32, name
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      getattr(ref, name).numpy(),
                                      err_msg=name)
    trio_hap = got.trio_hap.numpy()
    off = got.hap_trio_off.numpy()
    order = got.trio_order.numpy()
    for g in range(got.G):
        np.testing.assert_array_equal(order[off[g]:off[g + 1]],
                                      np.flatnonzero(trio_hap == g))
    np.testing.assert_array_equal(got.hap_path_off.numpy(), got.hap_node_off)
    span = got.sp_node_span.numpy()
    np.testing.assert_array_equal(span[:got.S], got.sp_off)
    np.testing.assert_array_equal(span[got.S:] - span[:got.S], got.sp_nvert)
    node_species = got.node_species.numpy()
    for s in range(got.S):
        assert (node_species[span[s]:span[got.S + s]] == s).all()


def test_tail_stats_match_reference_and_host_math():
    rng = np.random.default_rng(7)
    nodes_len, paths, ti = _random_species(rng, n_haps=5, n_nodes=200)
    n_nodes, U = len(nodes_len), ti.num_unique
    assert U > 10
    ta = np.where(rng.random(U) < 0.3, 0.0, rng.gamma(2.0, 4.0, size=U))
    na = np.where(rng.random(n_nodes) < 0.25, 0.0,
                  rng.gamma(2.0, 4.0, size=n_nodes))
    bc = rng.integers(0, 30, size=n_nodes)
    got, want = _stats_both(_ref_single_species_tt(paths, ti, nodes_len),
                            na, ta, bc, 0.5)
    _assert_stats_close(got, want)
    _assert_stats_close(got, _host_stats_single(paths, ti, ta, na, bc, 0.5))


def test_tail_stats_match_reference_on_scale(scale):
    """The stats over the scale slice's paired-read coverage (pad trios and
    pad nodes dropped) against the reference's on its own result."""
    tt_ref = ref_tail.build_tail_tables(scale.ref_tables)
    r = scale.ref_result
    got, want = _stats_both(tt_ref, np.asarray(r.na_d), np.asarray(r.ta_d),
                            np.asarray(r.bc_d), 0.0)
    _assert_stats_close(got, want)
    assert (got.c1 > 0).all() and (got.sp_valid > 0).all()


@pytest.mark.parametrize("shift", [False, True])
@pytest.mark.parametrize("case", ["multi", "same", "single", "notrio"])
def test_first_filter_from_stats_bit_parity(shift, case):
    rng = np.random.default_rng(42 + shift)
    for _trial in range(6):
        if case == "multi":
            nodes_len, paths, ti = _random_species(rng)
        else:
            if case == "notrio":  # distinct 2-node paths: no trio windows
                nodes_len = np.array([5, 7, 9, 11], dtype=np.int64)
                paths = {"a": np.array([0, 1]), "b": np.array([2, 3])}
            else:
                nodes_len = rng.integers(1, 20, size=64).astype(np.int64)
                p = np.arange(64)
                paths = ({"a": p, "b": p.copy(), "c": p.copy()}
                         if case == "same" else {"only": p})
            ti = _host.build_trio_index(nodes_len, paths)
        n_nodes, U = len(nodes_len), ti.num_unique
        ta = np.where(rng.random(U) < 0.35, 0.0, rng.gamma(2.0, 5.0, size=U))
        na = np.where(rng.random(n_nodes) < 0.3, 0.0,
                      rng.gamma(2.0, 5.0, size=n_nodes))
        bc = rng.integers(0, 20, size=n_nodes)
        cfg = _host.ProfilingConfig(shift=shift, min_depth=0.5)

        want = _host.OtuState(otu="x", hap_metrics=[_host.HapMetrics()
                                                    for _ in paths])
        _host.first_filter_paths(want, paths, ti.hap_matrix, ta,
                                 np.where(na > cfg.min_depth, na, 0.0), cfg)
        tt = tail_tables_from_reference(
            _ref_single_species_tt(paths, ti, nodes_len), "cpu")
        stats = _host_stats_single(paths, ti, ta, na, bc, cfg.min_depth)
        got = _host.OtuState(otu="x", hap_metrics=[_host.HapMetrics()
                                                   for _ in paths])
        port_tail.first_filter_from_stats(got, 0, tt, stats, sorted(paths), cfg)

        assert got.possible_paths_idx == want.possible_paths_idx
        assert got.same_path_flag == want.same_path_flag
        assert got.orign_n_haps == want.orign_n_haps
        assert got.hap2trio_nodes_m_size == want.hap2trio_nodes_m_size
        for g, w in zip(got.hap_metrics, want.hap_metrics):
            assert (g.otu, g.hap_id) == (w.otu, w.hap_id)
            assert g.unique_trio_nodes_fraction == w.unique_trio_nodes_fraction
            if w.frequencies_mean is None:
                assert g.frequencies_mean is None
            else:
                assert g.frequencies_mean == pytest.approx(w.frequencies_mean,
                                                           rel=1e-12)


# ---------------------------------------------------------------------------
# device PAO pieces
# ---------------------------------------------------------------------------
def test_build_A_b_and_factor_match_reference(scale):
    """A and b (every species of the slice, its paths in one bucket shape)
    bit-identical to the reference's; L within 1e-5."""
    tt_ref = ref_tail.build_tail_tables(scale.ref_tables)
    tt = tail_tables_from_reference(tt_ref, "cpu")
    S, p_pad = tt.S, 4
    node_off = tt.sp_off.astype(np.int32)
    nvert = tt.sp_nvert.astype(np.int32)
    g_off = np.zeros((S, p_pad), np.int32)
    g_len = np.zeros((S, p_pad), np.int32)
    for si in range(S):
        for j, g in enumerate(range(tt.sp_hap_lo[si], tt.sp_hap_lo[si + 1])):
            g_off[si, j] = tt.hap_node_off[g]
            g_len[si, j] = tt.hap_node_off[g + 1] - tt.hap_node_off[g]
    na = np.array(scale.ref_result.na_d)
    scale_v =np.array([na[o:o + n].max() for o, n in zip(node_off, nvert)],
                       np.float32)
    n_pad = 4096
    assert nvert.max() <= n_pad
    Lp = port_tail._pow2(int(g_len.max()))
    kw = dict(n_pad=n_pad, p_pad=p_pad, Lp=Lp)
    want = ref_tail._prepare_batch(
        jnp.asarray(na), tt_ref.path_node_d,
        *(jnp.asarray(a) for a in (node_off, nvert, g_off, g_len, scale_v)), **kw)
    A_ref, _b, _v = ref_tail._build_A_b(
        jnp.asarray(na), tt_ref.path_node_d,
        *(jnp.asarray(a) for a in (node_off, nvert, g_off, g_len)), **kw)
    got = port_tail.prepare_batch(
        torch.from_numpy(na), tt.path_node,
        *(torch.from_numpy(a) for a in (node_off, nvert, g_off, g_len, scale_v)),
        **kw)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(A_ref))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), atol=1e-5)
    assert got[0].sum() > 0 and got[0].max() == 1.0


def test_polish_batch_bit_identical():
    rng = np.random.default_rng(9)
    S, n, p = 3, 512, 4
    A = (rng.random((S, n, p)) < 0.6).astype(np.float32)
    A[:, rng.random(n) < 0.2, :] = 0.0  # masked rows
    A[1, :, 3] = 0.0                     # an empty column
    x_true = rng.gamma(2.0, 0.2, size=(S, p)).astype(np.float32)
    b = np.einsum("snp,sp->sn", A, x_true) + rng.normal(0, 0.05, (S, n))
    b = np.clip(b, 0, None).astype(np.float32)
    x = np.clip(x_true + rng.normal(0, 0.1, (S, p)), 0, None).astype(np.float32)
    ub = np.full((S, p), 1.05 * b.max(), np.float32)
    ub[2, 1] = 0.0  # a pinned path
    x[2, 1] = 0.0
    got = port_tail.polish_batch(*(torch.from_numpy(a) for a in (A, b, x, ub)))
    want = ref_tail._polish_batch(*(jnp.asarray(a) for a in (A, b, x, ub)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got[2, 1] == 0.0 and not np.array_equal(got.numpy(), x)


def _species_problem(rng, n_haps, n_nodes):
    nodes_len, paths, ti = _random_species(rng, n_haps=n_haps, n_nodes=n_nodes)
    names = sorted(paths)
    A_full = np.zeros((len(nodes_len), len(names)))
    for j, nm in enumerate(names):
        A_full[np.asarray(paths[nm]), j] = 1.0
    tt = tail_tables_from_reference(
        _ref_single_species_tt(paths, ti, nodes_len), "cpu")
    return tt, A_full, len(names)


def test_device_solver_matches_host_pao():
    rng = np.random.default_rng(3)
    for _trial in range(5):
        tt, A_full, p = _species_problem(rng, 3, 120)
        na = A_full @ rng.gamma(2.0, 3.0, size=p)
        na = np.clip(na + rng.normal(0, 0.3, size=len(na)), 0.0, None)
        na[rng.random(len(na)) < 0.1] = 0.0
        ub = 1.05 * float(na.max())
        solver = port_tail.DeviceTailSolver(
            tt, torch.from_numpy(na.astype(np.float32)),
            [(0, list(range(p)), ub)], sp_max=np.array([float(na.max())]))
        x_dev = solver.solve()[0]
        valid = na > 0
        A, b = A_full[valid], na[valid]
        x_host = solve_pao(A, b, ub, solver="admm", device="cpu").x

        def obj(x):
            return np.abs(A @ x - b).sum() / len(b)

        # both are polished LP vertices: the objectives agree tightly
        assert obj(x_dev) <= obj(x_host) * (1 + 1e-4) + 1e-6
        np.testing.assert_allclose(x_dev, x_host, rtol=2e-3, atol=2e-3)

        # the second solve, one path pinned to 0
        pins = np.zeros(p, bool)
        pins[0] = True
        ubv = np.where(pins, 0.0, ub)
        x_dev2 = solver.solve(ub_vec_of=lambda ji, n: ubv)[0]
        x_host2 = solve_pao(A, b, ub, solver="admm", fixed_zero=pins,
                            device="cpu").x
        assert obj(x_dev2) <= obj(x_host2) * (1 + 1e-4) + 1e-6
        assert x_dev2[0] == 0.0
        np.testing.assert_allclose(x_dev2, x_host2, rtol=2e-3, atol=2e-3)


def test_device_solver_only_jobs_skips_buckets():
    """solve(only_jobs=...) skips the buckets holding no listed job: their
    jobs return None, the listed ones match the unrestricted solve."""
    rng = np.random.default_rng(7)
    tt, A_full, p = _species_problem(rng, 6, 100)
    na = np.clip(A_full @ rng.gamma(2.0, 3.0, size=p), 0.0, None)
    ub = 1.05 * float(na.max())
    # job 0: 3 paths (p_pad 4); job 1: 6 paths (p_pad 8): two buckets
    solver = port_tail.DeviceTailSolver(
        tt, torch.from_numpy(na.astype(np.float32)),
        [(0, [0, 1, 2], ub), (0, list(range(6)), ub)],
        sp_max=np.array([float(na.max())]))
    assert len(solver.buckets) == 2
    full = solver.solve()
    part = solver.solve(only_jobs={1})
    assert part[0] is None
    np.testing.assert_allclose(part[1], full[1], rtol=1e-6, atol=1e-8)


def test_device_solver_warns_at_iteration_cap(caplog):
    """A bucket that stops at the iteration cap above the tolerance logs
    its residual (ROADMAP F2)."""
    rng = np.random.default_rng(5)
    tt, A_full, p = _species_problem(rng, 4, 150)
    na = np.clip(A_full @ rng.gamma(2.0, 3.0, size=p)
                 + rng.normal(0, 1.0, size=len(A_full)), 0.0, None)
    solver = port_tail.DeviceTailSolver(
        tt, torch.from_numpy(na.astype(np.float32)),
        [(0, list(range(p)), 1.05 * float(na.max()))],
        sp_max=np.array([float(na.max())]))
    with caplog.at_level("WARNING", logger="pantax_tpu_torch"):
        x = solver.solve(iters=20, chunk=10)[0]
    assert "iteration cap" in caplog.text and np.isfinite(x).all()


# ---------------------------------------------------------------------------
# end to end on the scale slice, paired reads
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("capped", [False, True])
def test_device_tail_matches_host_tail(scale, tmp_path, capped):
    """The port's two tails on one FusedResult: classification
    byte-identical, abundances within 2e-4.  Capped: a node-sampling cap
    below some species' valid-node count sends those species to the device
    tail's host-solve fallback (the sampling draws host rows) and leaves
    the others on the device solver."""
    cap = None
    if capped:
        r = scale.result
        valid = port_tail.compute_tail_stats(
            port_fused._ensure_tail_tables(scale.tables), r.na_d, r.ta_d,
            r.bc_d, 0.0).sp_valid
        cap = int(np.sort(valid)[1])
        assert (valid > cap).any() and (valid <= cap).any()
    host = scale.profile(tmp_path / "host", "host", sample_nodes=cap)
    dev = scale.profile(tmp_path / "device", "device", sample_nodes=cap)
    assert filecmp.cmp(host / "reads_classification.tsv",
                       dev / "reads_classification.tsv", shallow=False)
    assert_tables_agree(host, dev, abundance_tol=2e-4)


def test_device_tail_matches_reference_device_tail(scale, tmp_path):
    """The port's device tail against the JAX package's on the same
    coverage.  The port's ADMM iterates equal the JAX ADMM's run in
    float64; the JAX float32 run settles early on another point of the
    optimal face, so abundances are held to the coverage bar's scale
    (1e-3)."""
    assert_tables_agree(
        scale.profile(tmp_path / "ref_device", "device", ref=True),
        scale.profile(tmp_path / "device", "device"), abundance_tol=1e-3)


def test_device_solver_objective_matches_reference(scale):
    """Both packages' DeviceTailSolver on the slice's three species (all
    three strains each), identical tables and abundances: the polished L1
    objectives agree within 1e-4 relative, both ways."""
    tt_ref = ref_tail.build_tail_tables(scale.ref_tables)
    tt = tail_tables_from_reference(tt_ref, "cpu")
    na = np.asarray(scale.ref_result.na_d)
    sp_max = np.array([na[o:o + n].max() for o, n in zip(tt.sp_off, tt.sp_nvert)],
                      np.float64)
    jobs = [(si, [0, 1, 2], 1.05 * float(sp_max[si])) for si in range(tt.S)]
    got = port_tail.DeviceTailSolver(tt, torch.from_numpy(na.copy()), jobs,
                                     sp_max).solve()
    want = ref_tail.DeviceTailSolver(tt_ref, jnp.asarray(na), jobs,
                                     sp_max).solve()
    for si in range(tt.S):
        A = np.zeros((int(tt.sp_nvert[si]), 3))
        for j, g in enumerate(range(tt.sp_hap_lo[si], tt.sp_hap_lo[si + 1])):
            nodes = tt.path_node[tt.hap_node_off[g]:tt.hap_node_off[g + 1]]
            A[nodes.numpy() - tt.sp_off[si], j] = 1.0
        b = na[tt.sp_off[si]:tt.sp_off[si] + tt.sp_nvert[si]].astype(np.float64)
        A, b = A[b > 0], b[b > 0]

        def obj(x):
            return np.abs(A @ x - b).sum() / len(b)

        assert obj(got[si]) <= obj(want[si]) * (1 + 1e-4) + 1e-6
        assert obj(want[si]) <= obj(got[si]) * (1 + 1e-4) + 1e-6


def test_tail_modes_agree_on_borderline_divergence(scale, tmp_path):
    """The strain sets of the two tails are equal even where the divergence
    threshold fc sits exactly on a strain's rounded divergence
    round2(|first_sol - trio_mean| / (first_sol + trio_mean)), and one step
    below it: there each strain's keep / drop decision flips, and both
    tails must flip together."""
    base = scale.profile(tmp_path / "base", "host")
    divs = []
    for c in strain_rows(base / "ori_strain_abundance.txt")[1]:
        if c[7] and c[8]:
            m, s = float(c[7]), float(c[8])
            divs.append(abs(s - m) / (s + m) if s + m else 0.0)
    assert len(divs) >= 3, "the fixture must leave >= 3 strains"
    fcs = sorted({round(np.round(f, 2) - d, 2) for f in divs for d in (0, 0.01)})
    for fc in fcs:
        sets = {}
        for tail in ("host", "device"):
            out = scale.profile(tmp_path / f"fc{fc}_{tail}", tail, fc=fc)
            sets[tail] = {r[2] for r in strain_rows(
                out / "strain_abundance.txt")[1]}
        assert sets["host"] == sets["device"], (fc, sets)
