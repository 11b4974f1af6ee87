"""The port on a device mesh (pantax_tpu_torch.parallel) on the CPU: meshes
of 2 and 3 CPU replicas against no mesh and against the JAX package on one
device, bit for bit: the aligner's query rows (single-end, paired and
extend_packed; the DP launched once per row block), the FusedPipeline's
na/ta/bc and per-read columns (range scatter, and the windowed scatter at
L_cap=1 with its host residual), and node_abundances_device; a batch that
does not divide by the mesh size runs unsharded; a mesh of two distinct
device objects (``cpu`` and ``cpu:0``), which takes the per-device table
copies and the cross-device moves; the dry run (parallel/dryrun.py);
auto_mesh's flag values; and the port of interval_node_coverage
(ops/coverage.py, K12)."""
import logging

import numpy as np
import pytest
import torch

import pantax_tpu.align.aligner as ref_aligner
import pantax_tpu.ops.fused as ref_fused
from pantax_tpu_torch import _host, parallel
from pantax_tpu_torch.benchmarks import simulate_read_batch, tiny_db
from pantax_tpu_torch.convert import (
    aligner_from_reference, fused_tables_from_reference,
)
from pantax_tpu_torch.ops import extend
from pantax_tpu_torch.ops.coverage import interval_node_coverage
from pantax_tpu_torch.ops.coverage_device import node_abundances_device
from pantax_tpu_torch.ops.fused import FusedPipeline
from pantax_tpu_torch.parallel import make_mesh
from pantax_tpu_torch.parallel.dryrun import dryrun_multichip

from _torch_dist_worker import make_inputs
from _torch_helpers import (  # noqa: F401 (autouse)
    one_torch_thread, reference_on_one_device, simulate_pairs,
)

CPU = torch.device("cpu")
B = 768  # rows a batch: divisible by 2 and 3


class Setup:
    def __init__(self, root):
        self.db = tiny_db(root)
        self.index = _host.build_align_index(self.db)
        self.ref = ref_aligner.Aligner(self.index)
        self.ref_tables = ref_fused.build_fused_tables(self.db, self.index)
        self.jax = {}  # the JAX package's results, computed once

    def aligner(self, mesh):
        return aligner_from_reference(self.index, _host.AlignConfig(), CPU,
                                      mesh=mesh)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return Setup(tmp_path_factory.mktemp("tiny"))


def _extend_case(index, n, pad, seed):
    """Text windows of n 300-base chunks, half reverse-complemented, w0
    within +-3 of the chunk start minus ``pad``."""
    rng = np.random.default_rng(seed)
    start = rng.integers(0, len(index.text) - 1024, size=n)
    codes = index.text[start[:, None] + np.arange(300)].astype(np.int8)
    strand = (rng.random(n) < 0.5).astype(np.int8)
    rc = np.where(codes < 4, 3 - codes, 4)[:, ::-1]
    codes = np.where(strand[:, None] == 1, rc, codes).astype(np.int8)
    lens = np.full(n, 300, np.int64)
    w0 = (start - pad + rng.integers(-3, 4, size=n)).astype(np.int64)
    return codes, lens, w0, strand


ENTRIES = {
    "single": (lambda s: simulate_read_batch(s.index, B, 150, 0.01, seed=3)[:2],
               lambda al, c, n: al.query_packed(*al.upload(c, n)),
               lambda s, c, n: s.ref.dispatch_codes(c, n)),
    "paired": (lambda s: simulate_pairs(s.index, B, seed=4),
               lambda al, *a: al.query_paired_packed(
                   *al.upload(a[0], a[1]), *al.upload(a[2], a[3])),
               lambda s, *a: s.ref.dispatch_paired_codes(*a)),
    "extend": (lambda s: _extend_case(s.index, B, s.ref.cfg.extension_band, 1),
               lambda al, *a: al.extend_packed(*a),
               lambda s, *a: s.ref.dispatch_extend(*a)),
}


@pytest.mark.parametrize("n", [2, 3])
@pytest.mark.parametrize("entry", list(ENTRIES))
def test_query_rows_on_mesh(tiny, entry, n):
    make, port, ref = ENTRIES[entry]
    args = make(tiny)
    if entry not in tiny.jax:
        tiny.jax[entry] = np.asarray(ref(tiny, *args))
    one = port(tiny.aligner(None), *args)
    key = ("banded_extend_windows_plain" if entry == "extend"
           else "banded_extend_plain")
    before = extend.LAUNCHES[key]
    got = port(tiny.aligner(make_mesh([CPU] * n)), *args)
    assert extend.LAUNCHES[key] == before + n  # once per row block
    assert torch.equal(got, one)
    np.testing.assert_array_equal(got.numpy(), tiny.jax[entry])
    assert (got[3] & 1).float().mean() > 0.9


def test_indivisible_batch_runs_unsharded(tiny, caplog):
    codes, lens, _ = simulate_read_batch(tiny.index, 1000, 150, 0.01, seed=3)
    al = tiny.aligner(make_mesh([CPU] * 3))
    before = extend.LAUNCHES["banded_extend_plain"]
    with caplog.at_level(logging.WARNING, logger="pantax_tpu_torch"):
        rows = [al.query_packed(*al.upload(codes, lens)) for _ in range(2)]
    assert extend.LAUNCHES["banded_extend_plain"] == before + 2
    assert sum("not divisible" in r.message for r in caplog.records) == 1
    one = tiny.aligner(None)
    assert torch.equal(rows[0], one.query_packed(*one.upload(codes, lens)))


def test_default_mesh_and_its_primary(tiny):
    """Without ``mesh=`` the aligner has none (no process default), and a
    mesh whose primary is not the aligner's device is refused."""
    al = tiny.aligner(None)
    assert al.mesh is None and not al._replicas
    with pytest.raises(ValueError, match="primary"):
        aligner_from_reference(tiny.index, _host.AlignConfig(), CPU,
                               mesh=make_mesh(["meta", CPU]))


@pytest.mark.parametrize("entry", ["single", "extend"])
def test_mesh_of_distinct_devices(tiny, entry):
    """A mesh of ``cpu`` and ``cpu:0``: two device objects, so the aligner
    holds a copy of the index tables (and the segments' bucket table) for
    the second, moves its row block there and back, and the coverage sums
    its block's accumulators across; the rows and the coverage equal those
    without a mesh."""
    make, port, _ = ENTRIES[entry]
    args = make(tiny)
    mesh = make_mesh([CPU, torch.device("cpu", 0)])
    al = tiny.aligner(mesh)
    assert list(al._replicas) == [mesh[1]]
    assert len(al._replicas[mesh[1]]) == 7  # and K5's bucket table
    key = ("banded_extend_windows_plain" if entry == "extend"
           else "banded_extend_plain")
    before = extend.LAUNCHES[key]
    got = port(al, *args)
    assert extend.LAUNCHES[key] == before + 2
    assert torch.equal(got, port(tiny.aligner(None), *args))

    packed, nodes_len, paths = make_inputs(seed=3)
    ti = _host.build_trio_index(nodes_len, paths)
    for a, b in zip(node_abundances_device(packed, nodes_len, ti, device=CPU,
                                           mesh=mesh),
                    node_abundances_device(packed, nodes_len, ti,
                                           device=CPU)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n", [2, 3])
@pytest.mark.parametrize("L_cap", [None, 1])
def test_fused_pipeline_on_mesh(tiny, L_cap, n):
    codes, lens, _ = simulate_read_batch(tiny.index, 2048, 150, 0.01, seed=5,
                                         indel_rate=0.01)
    key = ("fused", L_cap)
    if key not in tiny.jax:
        jp = ref_fused.FusedPipeline(tiny.ref, tiny.ref_tables, batch=B,
                                     L_cap=L_cap)
        jp.feed(codes, lens)
        tiny.jax[key] = jp.finish()
    want = tiny.jax[key]
    tables = fused_tables_from_reference(tiny.ref_tables, CPU)
    got = []
    for mesh in (None, make_mesh([CPU] * n)):
        pipe = FusedPipeline(tiny.aligner(mesh), tables, B, L_cap=L_cap)
        pipe.feed(codes, lens)
        got.append(pipe.finish())
        assert pipe.use_ranges == (L_cap is None)
    one, on_mesh = got
    assert on_mesh.n_overflow == one.n_overflow == want.n_overflow
    assert (on_mesh.n_overflow > 0) == (L_cap is not None)
    for name, w in (("na_d", want.na_d), ("ta_d", want.ta_d),
                    ("bc_d", want.bc_d)):
        assert torch.equal(getattr(on_mesh, name), getattr(one, name)), name
        np.testing.assert_array_equal(getattr(on_mesh, name).numpy(),
                                      np.asarray(w), err_msg=name)
    for k in ("mapq", "aligned", "ridx", "read_len"):
        np.testing.assert_array_equal(on_mesh.reads[k], want.reads[k],
                                      err_msg=k)
    for k in ("mapq", "aligned", "ridx", "read_len", "ts", "te"):
        np.testing.assert_array_equal(on_mesh.reads[k], one.reads[k],
                                      err_msg=k)


@pytest.mark.parametrize("n", [2, 3])
def test_node_abundances_device_on_mesh(n):
    from _dist_worker import make_inputs as ref_inputs
    from pantax_tpu.graph.trio import build_trio_index as ref_trio_index
    from pantax_tpu.ops.coverage_device import (
        node_abundances_device as ref_node_abundances,
    )

    packed, nodes_len, paths = make_inputs(seed=3)
    ti = _host.build_trio_index(nodes_len, paths)
    one = node_abundances_device(packed, nodes_len, ti, device=CPU)
    got = node_abundances_device(packed, nodes_len, ti, device=CPU,
                                 mesh=make_mesh([CPU] * n))
    r_packed, r_len, r_paths = ref_inputs(seed=3)
    want = ref_node_abundances(r_packed, r_len, ref_trio_index(r_len, r_paths))
    for name, a, b, w in zip(("na", "ta", "bc"), got, one, want):
        w = np.asarray(w)
        assert a.dtype == w.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
        np.testing.assert_array_equal(a, w, err_msg=name)


@pytest.mark.parametrize("n", [2, 3])
def test_dryrun_multichip(n, tmp_path):
    s = dryrun_multichip(n, CPU, tmp_path)
    assert s["aligned"] > 0.99 * s["reads"] and s["n_overflow"] > 0
    assert len(s["strains"]) == 4


def test_auto_mesh_flag_values(monkeypatch):
    assert parallel.auto_mesh("auto", "cpu") is None
    assert parallel.auto_mesh("off", "cpu") is None
    assert parallel.auto_mesh("1", "cpu") is None
    assert parallel.auto_mesh("3", "cpu") == (CPU,) * 3
    cuda = [torch.device("cuda", i) for i in range(4)]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert parallel.auto_mesh("auto", "cuda") is None
    with pytest.raises(ValueError, match="need 2 local devices, have 1"):
        parallel.auto_mesh("2", "cuda")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert parallel.auto_mesh("auto", "cuda") == tuple(cuda)
    assert parallel.auto_mesh("2", cuda[0]) == tuple(cuda[:2])
    assert parallel.auto_mesh("off", "cuda") is None
    assert parallel.make_local_mesh(2, cuda[3]) == (cuda[3], cuda[0])
    assert make_mesh(["cuda", "cuda:0"]) == (cuda[0], cuda[0])


def test_interval_node_coverage_matches_jax(tiny):
    """K12 on the inputs of tests/test_parallel.py's coverage-totals test
    (the aligned intervals of 128 reads from the tiny DB's index), and on
    random intervals, some past the text's end: float32 node coverage
    equal to the JAX function's."""
    import __graft_entry__ as g
    from pantax_tpu.ops.coverage import (
        interval_node_coverage as ref_coverage,
    )

    index = tiny.index
    codes, lens = g._reads_from_index(index, 128, 128, seed=5)
    res = tiny.ref.align_codes(codes, lens)
    rng = np.random.default_rng(2)
    ts_r = rng.integers(0, index.text_len, size=200)
    cases = [(res.text_start, res.text_end, res.aligned),
             (ts_r, ts_r + rng.integers(0, 3000, size=200),
              rng.random(200) < 0.8)]
    tables = [a.astype(np.int32) for a in (index.tstart, index.tnode,
                                           index.tlen)]
    N = int(index.tnode.max())
    for ts, te, aligned in cases:
        ts, te = ts.astype(np.int32), te.astype(np.int32)
        for max_span in (4, 16):
            want = np.asarray(ref_coverage(*tables, ts, te, aligned, N,
                                           max_span))
            got = interval_node_coverage(
                *(torch.from_numpy(a) for a in (*tables, ts, te, aligned)),
                N, max_span)
            assert got.dtype == torch.float32
            np.testing.assert_array_equal(got.numpy(), want)
    total = int((res.text_end - res.text_start)[res.aligned].sum())
    got = interval_node_coverage(*(torch.from_numpy(a) for a in (
        *tables, res.text_start.astype(np.int32),
        res.text_end.astype(np.int32), res.aligned)), N, 16)
    assert abs(int(got.sum()) - total) <= int(res.aligned.sum())
