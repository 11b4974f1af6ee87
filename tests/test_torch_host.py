"""The port's own host layer against the JAX package's (CPU): the database
files that build_database writes byte-identical on tiny_db and on a small
dup-graph community (imported through gfa_dir), the dup community's inputs
byte-identical to tools/dup_bench.py's, the align index arrays equal, and
the strain filters and the residual coverage oracle equal on the same
inputs."""
import dataclasses
import filecmp
import importlib.util
import os

import numpy as np
import pytest

import pantax_tpu.utils
from pantax_tpu.align.index import build_align_index as ref_build_index
from pantax_tpu.config import ProfilingConfig as RefProfilingConfig
from pantax_tpu.db.construct import build_database as ref_build_database
from pantax_tpu.graph.trio import build_trio_index as ref_build_trio_index
from pantax_tpu.profile import coverage as ref_coverage
from pantax_tpu.profile import filters as ref_filters
from pantax_tpu_torch import _host
from pantax_tpu_torch.benchmarks import dup_db, tiny_db

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DUP = dict(n_species=2, strains=2, n_blocks=400)


def _tool(monkeypatch):
    """tools/dup_bench.py at DUP's size (its module constants patched; its
    import-time compilation-cache switch made a no-op)."""
    monkeypatch.setattr(pantax_tpu.utils, "enable_compilation_cache",
                        lambda *a, **k: None)
    spec = importlib.util.spec_from_file_location(
        "dup_bench", os.path.join(REPO, "tools", "dup_bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for name, key in (("N_SPECIES", "n_species"), ("STRAINS", "strains"),
                      ("N_BLOCKS", "n_blocks")):
        monkeypatch.setattr(mod, name, DUP[key])
    return mod


@pytest.fixture(scope="module")
def tiny_dbs(tmp_path_factory):
    """(port DB, JAX DB) built from the same tiny_db genomes."""
    root = tmp_path_factory.mktemp("tiny")
    port = tiny_db(root)
    ref = ref_build_database(root / "genomes_info.txt", root / "ref_db",
                             base_dir=root)
    return port, ref


@pytest.fixture(scope="module")
def dup_dbs(tmp_path_factory):
    """(port DB, JAX DB): the port's dup_db and tools/dup_bench.py's dup_db
    (which builds with the JAX package) at DUP's size."""
    mp = pytest.MonkeyPatch()
    try:
        tool = _tool(mp)
        tool_root = tmp_path_factory.mktemp("dup_tool")
        ref = tool.dup_db(str(tool_root))
    finally:
        mp.undo()
    port_root = tmp_path_factory.mktemp("dup_port")
    return dup_db(port_root, **DUP), ref


def _db_files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs
                  if f != "align_index.npz")


@pytest.mark.parametrize("which", ["tiny_dbs", "dup_dbs"])
def test_database_files_byte_identical(which, request):
    port, ref = request.getfixturevalue(which)
    names = _db_files(port.root)
    assert names == _db_files(ref.root)
    assert any(n.endswith(".graph.npz") for n in names)
    for name in names:
        a, b = port.root / name, ref.root / name
        if name == "finished_species.txt":  # build threads finish in any order
            assert sorted(a.read_text().split()) == sorted(b.read_text().split())
        else:
            assert filecmp.cmp(a, b, shallow=False), name


def test_dup_community_inputs_equal_tool(dup_dbs):
    """dup_db writes the GFAs, FASTAs and genomes_info of tools/dup_bench.py
    byte for byte."""
    port, ref = dup_dbs
    p_root, r_root = port.root.parent, ref.root.parent
    names = sorted(f for f in os.listdir(r_root) if f != "db")
    assert names == sorted(f for f in os.listdir(p_root) if f != "db")
    assert "gfa" in names and len(names) == DUP["n_species"] * DUP["strains"] + 2
    for name in names:
        a, b = p_root / name, r_root / name
        for x, y in (zip(sorted(a.iterdir()), sorted(b.iterdir()))
                     if a.is_dir() else [(a, b)]):
            assert x.name == y.name and filecmp.cmp(x, y, shallow=False), x


@pytest.mark.parametrize("which", ["tiny_dbs", "dup_dbs"])
def test_align_index_arrays_equal(which, request):
    port, ref = request.getfixturevalue(which)
    got = _host.build_align_index(port, save=False)
    want = ref_build_index(ref, save=False)
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name
    assert len(got.hap_names) == 4


def _filter_case(rng, n_haps, n_trios, shift):
    """Random filter inputs: a trio x hap membership matrix, trio and node
    abundances with zeros, and first solves for the second filter."""
    paths = {f"h{i}": rng.integers(0, 50, size=30) for i in range(n_haps)}
    if n_haps > 1 and n_trios == 0 and shift:
        paths = {k: paths["h0"] for k in paths}  # the same-path branch
    m = (rng.random((n_trios, n_haps)) < 0.5).astype(np.uint8)
    ta = np.where(rng.random(n_trios) < 0.4, 0.0, rng.gamma(2.0, 3.0, n_trios))
    na = np.where(rng.random(50) < 0.3, 0.0, rng.gamma(2.0, 3.0, 50))
    sols = rng.choice([0.0, 1.0, 3.0, 7.5], size=n_haps)
    return paths, m, ta, na, sols


@pytest.mark.parametrize("n_haps,n_trios", [(1, 0), (2, 0), (3, 0), (4, 40),
                                            (6, 200)])
@pytest.mark.parametrize("shift", [False, True])
def test_strain_filters_equal(n_haps, n_trios, shift):
    rng = np.random.default_rng(n_haps * 100 + n_trios + shift)
    paths, m, ta, na, sols = _filter_case(rng, n_haps, n_trios, shift)
    states = []
    for mod, cfg_cls in ((_host, _host.ProfilingConfig),
                         (ref_filters, RefProfilingConfig)):
        cfg = cfg_cls.for_read_type("short", shift=shift)
        state = mod.OtuState(otu="7", hap_metrics=[
            mod.HapMetrics() for _ in paths])
        mod.first_filter_paths(state, paths, m, ta, na, cfg)
        for h, sol in zip(state.hap_metrics, sols):
            h.first_sol, h.path_cov_ratio = float(sol), 0.9
        mod.second_filter_paths(state, cfg)
        states.append(dataclasses.asdict(state))
    assert states[0] == states[1]


@pytest.mark.parametrize("L", [1, 3, 8])
def test_raw_contributions_equal(L):
    """The residual oracle on rows with repeated nodes, single-node rows
    with negative and out-of-bounds spans, and empty rows."""
    rng = np.random.default_rng(L)
    N, R = 40, 300
    nodes_len = rng.integers(1, 80, size=N).astype(np.int64)
    paths = {f"h{i}": rng.integers(0, 12, size=60) for i in range(3)}
    ti = ref_build_trio_index(nodes_len, paths)
    lengths = rng.integers(0, L + 1, size=R)
    nodes = np.where(np.arange(L)[None, :] < lengths[:, None],
                     rng.integers(0, 12, size=(R, L)), -1)
    rs = rng.integers(0, 40, size=R)
    re = rs + rng.integers(-20, 300, size=R)
    want = ref_coverage.raw_contributions(
        ref_coverage.PackedReads(nodes, lengths, rs, re), nodes_len, ti)
    got = _host.raw_contributions(
        _host.PackedReads(nodes, lengths, rs, re), nodes_len,
        _host.build_trio_index(nodes_len, paths))
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == b.dtype, i
        np.testing.assert_array_equal(a, b, err_msg=str(i))
    assert len(want[0]) and (L < 3 or len(want[4]))
