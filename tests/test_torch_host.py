"""The port's own host layer against the JAX package's (CPU): the database
files that build_database writes byte-identical on tiny_db and on a small
dup-graph community (imported through gfa_dir), the dup community's inputs
byte-identical to tools/dup_bench.py's, the align index arrays equal, the
strain filters and the residual coverage oracle equal on the same inputs;
simulate_reads' reads and truth records equal for one seed, write_gfa's
files byte-identical, the FASTA/FASTQ readers, pansn_name,
PipelineConfig and from_gaf equal; and every public name of the JAX
package has a counterpart in the port or a stated reason it has none."""
import dataclasses
import filecmp
import importlib.util
import os

import numpy as np
import pytest

import pantax_tpu.utils
from pantax_tpu import config as ref_config
from pantax_tpu import sim as ref_sim
from pantax_tpu.align.index import build_align_index as ref_build_index
from pantax_tpu.config import ProfilingConfig as RefProfilingConfig
from pantax_tpu.db.construct import build_database as ref_build_database
from pantax_tpu.graph.trio import build_trio_index as ref_build_trio_index
from pantax_tpu.io import fastx as ref_fastx
from pantax_tpu.io import gfa as ref_gfa
from pantax_tpu.profile import coverage as ref_coverage
from pantax_tpu.profile import filters as ref_filters
from pantax_tpu.profile import records as ref_records
from pantax_tpu_torch import _host
from pantax_tpu_torch import config as port_config
from pantax_tpu_torch import sim as port_sim
from pantax_tpu_torch.benchmarks import dup_db, tiny_db
from pantax_tpu_torch.io import fastx as port_fastx
from pantax_tpu_torch.io import gfa as port_gfa
from pantax_tpu_torch.profile import records as port_records

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


# ---------------------------------------------------------------------------
# sim.py, io/gfa.write_gfa, io/fastx, config.PipelineConfig, records.from_gaf
# ---------------------------------------------------------------------------
SIM_WEIGHTS = (3.0, 1.0, 2.0, 1.0)


def _sim_weights(db):
    names = [gi.hap_id for gi in _host.read_genomes_info(db.genomes_info_file)]
    return dict(zip(names, SIM_WEIGHTS))


@pytest.mark.parametrize("error_rate", [0.0, 0.01])
def test_simulate_reads_equal(tiny_dbs, error_rate):
    """The same seed gives the same reads, species, haplotypes and truth
    GAF records (every field), with and without substitutions."""
    port, ref = tiny_dbs
    weights = _sim_weights(port)
    got = port_sim.simulate_reads(port, weights, n_reads=2000, read_len=150,
                                  seed=7, error_rate=error_rate)
    want = ref_sim.simulate_reads(ref, weights, n_reads=2000, read_len=150,
                                  seed=7, error_rate=error_rate)
    assert len(got) == len(want) == 2000
    for g, w in zip(got, want):
        assert (g.read_id, g.seq, g.species, g.hap_id) == (
            w.read_id, w.seq, w.species, w.hap_id)
        assert dataclasses.asdict(g.truth) == dataclasses.asdict(w.truth)
    assert len({r.hap_id for r in got}) == 4
    assert sum(r.truth.strand == "+" for r in got) == 2000
    mutated = sum(r.seq != port_sim.revcomp(r.seq) for r in got)
    assert mutated > 1900


def test_simulate_reads_unknown_haplotype(tiny_dbs):
    port, ref = tiny_dbs
    weights = dict(_sim_weights(port), GCF_999x=1.0)
    with pytest.raises(ValueError) as got:
        port_sim.simulate_reads(port, weights, 10, 150)
    with pytest.raises(ValueError) as want:
        ref_sim.simulate_reads(ref, weights, 10, 150)
    assert str(got.value) == str(want.value)
    assert "GCF_999x" in str(got.value) and "'GCF_101a.1'" in str(got.value)


def _gfa_case(rng, strands: str):
    nodes = [bytes(rng.choice(list(b"ACGT"), size=int(n)))
             for n in rng.integers(1, 40, size=30)]
    walks = [(f"h{i}", str(i), f"c{i}", 0, rng.integers(0, 30, size=25))
             for i in range(3)]
    walks = [(s, h, c, int(sum(len(nodes[j]) for j in ids)), ids)
             for s, h, c, _, ids in walks]
    if strands == "mixed":  # one all-forward walk, two with reverse steps
        return nodes, walks, [np.zeros(25, np.int8)] + [
            rng.integers(0, 2, size=25).astype(np.int8) for _ in range(2)]
    return nodes, walks, None


@pytest.mark.parametrize("case", ["edges", "no edges", "mixed strands"])
def test_write_gfa_byte_identical(case, tmp_path):
    rng = np.random.default_rng(len(case))
    nodes, walks, strands = _gfa_case(rng, "mixed" if "mixed" in case else "")
    edges = ([(int(a), int(b)) for a, b in rng.integers(0, 30, size=(20, 2))]
             if case == "edges" else None)
    kw = dict(edges=edges, previous=7, walk_strands=strands)
    port_gfa.write_gfa(tmp_path / "port.gfa", nodes, walks, **kw)
    ref_gfa.write_gfa(tmp_path / "ref.gfa", nodes, walks, **kw)
    assert filecmp.cmp(tmp_path / "port.gfa", tmp_path / "ref.gfa",
                       shallow=False)
    text = (tmp_path / "port.gfa").read_bytes()
    if case == "edges":
        assert text.count(b"\nL\t") == 20
    elif case == "no edges":  # the sorted set of the walks' steps
        assert text.count(b"\nL\t") == len({
            (a, b) for *_, ids in walks for a, b in zip(ids, ids[1:])})
    assert (b"<" in text) == ("mixed" in case)
    parsed = port_gfa.read_gfa(tmp_path / "port.gfa", previous=7)
    assert [bytes(s) for s in parsed.node_seqs] == nodes


def test_fastx_names_and_readers_equal(tmp_path):
    assert (port_fastx.pansn_name("GCF_1", "chr2", 3)
            == ref_fastx.pansn_name("GCF_1", "chr2", 3) == "GCF_1#3#chr2")
    assert port_fastx.pansn_name("g", "c") == ref_fastx.pansn_name("g", "c")
    recs = [("r1", b"ACGTN"), ("r2", b"acgtacgt" * 20)]
    fa = tmp_path / "a.fa.gz"
    port_fastx.write_fasta(fa, recs, width=60)
    fq = tmp_path / "a.fq"
    fq.write_text("@q1 x\nACGT\n+\nIIII\n@q2\nggca\n+\nIIII\n")
    assert port_fastx.read_fasta(fa) == ref_fastx.read_fasta(fa)
    assert port_fastx.read_fasta(fa)[1] == ("r2", b"ACGTACGT" * 20)
    assert port_fastx.read_fastq(fq) == ref_fastx.read_fastq(fq) == [
        ("q1", b"ACGT"), ("q2", b"GGCA")]


def test_pipeline_config_equal():
    got = dataclasses.asdict(port_config.PipelineConfig())
    want = dataclasses.asdict(ref_config.PipelineConfig())
    assert got == want and set(got) == {"profiling", "align"}


def test_from_gaf_equal(tiny_dbs):
    port, _ = tiny_dbs
    reads = port_sim.simulate_reads(port, _sim_weights(port), 200, 150,
                                    seed=3)
    for r in reads:
        got = port_records.from_gaf(r.truth, r.species)
        want = ref_records.from_gaf(r.truth, r.species)
        g, w = dataclasses.asdict(got), dataclasses.asdict(want)
        np.testing.assert_array_equal(g.pop("nodes"), w.pop("nodes"))
        assert g == w and got.nodes.dtype == want.nodes.dtype


# ---------------------------------------------------------------------------
# name parity: the port does what the JAX package does
# ---------------------------------------------------------------------------
# reference "file:name" -> the port's names ("file:name") that do its work
RENAMED = {
    "align/aligner.py:NEG": ("ops/extend.py:NEG",),
    "align/aligner.py:packed_layout": ("ops/extend.py:packed_layout",),
    "ops/extend_pallas.py:NEG": ("ops/extend.py:NEG",),
    "ops/extend_pallas.py:banded_extend_pallas": (
        "ops/extend.py:banded_extend",),
    "ops/extend_pallas.py:banded_extend_pallas_dponly": (
        "ops/extend.py:banded_extend_windows",),
    # the classify + scatter and its bisection live beside K6 and K11
    # (ops/fused.py imports locate_segment from there)
    "ops/fused.py:locate_segment": ("ops/scatter.py:locate_segment",),
    "profile/coverage.py:node_abundances": (
        "profile/coverage.py:raw_contributions",
        "profile/coverage.py:node_abundances_packed"),
    "ops/coverage_device.py:DeviceGraphCoverageTables": (
        "ops/coverage_device.py:PaddedCoverageTables",
        "ops/coverage_device.py:TrioLookup"),
    "ops/coverage_device.py:device_node_abundances": (
        "ops/coverage_device.py:species_accumulators",
        "ops/coverage_device.py:finalize_species"),
    # node_abundances_device(mesh=) shards the rows over a mesh
    "ops/coverage_device.py:sharded_node_abundances": (
        "ops/coverage_device.py:node_abundances_device",),
    "parallel/__init__.py:make_local_mesh": ("parallel/mesh.py:make_local_mesh",),
    # the processes of a run meet in a gloo group, not a JAX mesh
    "parallel/distributed.py:global_reads_mesh": (
        "parallel/distributed.py:init_distributed",
        "parallel/distributed.py:process_count"),
}
M14 = "M14: a TPU-tunnel workaround (ROADMAP Queue 1); the port uses CUDA streams"
F1 = "F1: reads the reference's example data, which the repository lacks"
NO_DEFAULT_MESH = ("dropped on review of the multi-device port: there is no "
                   "process default mesh; callers pass mesh=")
NOT_CARRIED = {
    "align/aligner.py:pack_codes": M14,
    "align/aligner.py:pack_codes2": M14,
    "utils/native.py:pack_codes2_native": M14,
    "utils/__init__.py:prefetched": M14,
    "utils/__init__.py:pipeline_depth": M14,
    "utils/cache.py:enable_compilation_cache": M14 + " (a JAX compile cache)",
    "ops/extend_pallas.py:FETCH": (
        "the Pallas kernel's per-candidate DMA size; K1 reads its window "
        "from the text in 16-byte loads"),
    "benchmarks.py:example_db": F1,
    "benchmarks.py:EXAMPLE_INFO": F1,
    "benchmarks.py:EXAMPLE_BASE": F1,
    "benchmarks.py:EXAMPLE_READS": F1,
    "bench.py:bench_example": F1,
    "bench.py:bench_example_e2e": F1,
    "parallel/__init__.py:set_default_mesh": NO_DEFAULT_MESH,
    "parallel/__init__.py:default_mesh": NO_DEFAULT_MESH,
    "fastpath.py:log": (
        "a module logger for info lines; the port's stage seconds go to "
        "stage_out"),
    "ops/fused.py:log": (
        "a module logger for the host residual's info lines; the port "
        "returns those counts (FusedResult.n_overflow, interval_rows)"),
}


def _public_names(path) -> set:
    """Public names a module defines at its top level (functions, classes,
    assignments; not imports)."""
    import ast

    if not os.path.exists(path):
        return set()
    names = set()
    for node in ast.parse(open(path).read()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets if isinstance(t, ast.Name))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                              ast.Name):
            names.add(node.target.id)
    return {n for n in names if not n.startswith("_")}


def test_every_reference_name_has_a_counterpart():
    """Each public top-level name of every pantax_tpu/**/*.py, and of the
    repository's bench.py, is in the port's file of the same path
    (pantax_tpu_torch/bench.py for bench.py), or renamed (its port names
    exist), or not carried for a stated reason; the two tables name only
    real gaps."""
    ref_root = os.path.join(REPO, "pantax_tpu")
    port_root = os.path.join(REPO, "pantax_tpu_torch")
    gaps = {f"bench.py:{n}" for n in
            _public_names(os.path.join(REPO, "bench.py"))
            - _public_names(os.path.join(port_root, "bench.py"))}
    for d, _, files in os.walk(ref_root):
        for f in files:
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(d, f), ref_root)
                port = _public_names(os.path.join(port_root, rel))
                gaps |= {f"{rel}:{n}" for n in
                         _public_names(os.path.join(ref_root, rel)) - port}
    assert gaps == set(RENAMED) | set(NOT_CARRIED)
    assert not set(RENAMED) & set(NOT_CARRIED)
    for targets in RENAMED.values():
        for t in targets:
            rel, name = t.split(":")
            assert name in _public_names(os.path.join(port_root, rel)), t
