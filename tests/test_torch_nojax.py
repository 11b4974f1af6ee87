"""The port on a machine without jax, pandas, pyarrow and the JAX package:
in a subprocess that blocks those imports (pantax_tpu by its top-level
name, so pantax_tpu_torch stays importable), pantax_tpu_torch builds a
complete database (no species silently dropped) and runs the short-read
slice, the per-species GAF flow from a FASTQ file with device coverage,
the paired slice with the device tail, the long-read slice and the
dup-graph community's windowed slice on the CPU to the four output
tables, the multi-device modules run (the shard reader, the mesh dry
run, a one-process gloo group's merge and gather,
interval_node_coverage), and so do accuracy_benchmark, simulate_reads,
entry() and the benchmark driver (pantax_tpu_torch.bench); and python -m
pantax_tpu_torch.cli runs (--help, the short-read fastpath, on one device
and on a mesh of two CPU replicas, and the long-read GAF flow) with the
same imports blocked."""
import os
import subprocess
import sys
import textwrap

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = textwrap.dedent("""
    import importlib.abc
    import os
    import sys

    BLOCKED = ("jax", "jaxlib", "pandas", "pyarrow", "pantax_tpu")

    class Blocker(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ModuleNotFoundError(f"blocked: {name}", name=name)
            return None

    for mod in list(sys.modules):
        if mod.split(".")[0] in BLOCKED:
            del sys.modules[mod]
    sys.meta_path.insert(0, Blocker())

    from pantax_tpu_torch import _host
    from pantax_tpu_torch.align.long_read import (
        LONG_READ_PRESETS, LONG_READ_SEED_STRIDE, align_long_reads,
    )
    from pantax_tpu_torch.benchmarks import (
        dup_db, simulate_long_reads, simulate_read_batch, tiny_db,
    )
    from pantax_tpu_torch.convert import aligner_from_reference
    from pantax_tpu_torch.ops.fused import (
        FusedPipeline, build_fused_tables, profile_from_fused_result,
        profile_fused,
    )

    db = tiny_db()
    species = [line.split()[0] for line in open(db.range_file)
               if line.strip() and not line.startswith("species")]
    assert sorted(species) == ["101", "202"], species
    index = _host.build_align_index(db)
    assert len(index.hap_names) == 4, index.hap_names
    aligner = aligner_from_reference(index, _host.AlignConfig(), "cpu")
    codes, lens, _ = simulate_read_batch(index, 1024, 150, 0.01, seed=3)
    cfg = _host.ProfilingConfig.for_read_type("short")
    cfg.tail = "host"
    out = sys.argv[1]
    assert profile_fused(aligner, codes, lens, index, db, cfg, out, 512)
    for name in ("species_abundance.txt", "strain_abundance.txt",
                 "ori_strain_abundance.txt", "reads_classification.tsv"):
        assert os.path.getsize(os.path.join(out, name)) > 0, name
    rows = open(os.path.join(out, "strain_abundance.txt")).read().splitlines()
    assert len(rows) == 5, rows

    # the per-species GAF flow: FASTQ -> align_file -> GAF -> profile_from_gaf
    from _torch_helpers import code_seqs, simulate_pairs, write_reads
    from pantax_tpu_torch.io.gaf import read_gaf, write_gaf
    from pantax_tpu_torch.pipeline import profile_from_gaf

    fq = os.path.join(os.environ["TMPDIR"], "reads.fq")
    write_reads(fq, [f"S{i}" for i in range(len(lens))],
                code_seqs(codes, lens), "fq")
    stage = {}
    records = aligner.align_file(fq, batch_size=512, stage_out=stage)
    assert stage["parser"] == "native" and len(records) > 1000, stage
    write_gaf(os.path.join(os.environ["TMPDIR"], "a.gaf"), records)
    records = read_gaf(os.path.join(os.environ["TMPDIR"], "a.gaf"))
    cfg = _host.ProfilingConfig.for_read_type("short")
    cfg.coverage = "device"
    gaf_out = sys.argv[1] + "_gaf"
    profile_from_gaf(records, db, cfg, gaf_out, device="cpu")
    rows = open(os.path.join(gaf_out, "strain_abundance.txt")).read()
    assert len(rows.splitlines()) == 5, rows


    pipe = FusedPipeline(aligner, build_fused_tables(db, index, "cpu"), 512)
    pipe.feed_paired(*simulate_pairs(index, 1024, seed=4))
    cfg = _host.ProfilingConfig.for_read_type("short")
    cfg.tail = "device"
    paired_out = sys.argv[1] + "_paired"
    assert profile_from_fused_result(pipe.finish(), pipe.tables, index, db,
                                     cfg, paired_out)
    rows = open(os.path.join(paired_out, "strain_abundance.txt")).read()
    assert len(rows.splitlines()) == 5, rows

    long_al = aligner_from_reference(
        index, _host.AlignConfig.for_read_type("long"), "cpu")
    reads, _ = simulate_long_reads(index, 16, 4096, seed=9)
    arr = align_long_reads(long_al, reads, chunk=LONG_READ_PRESETS["hifi"],
                           batch_size=256,
                           seed_stride=LONG_READ_SEED_STRIDE["hifi"],
                           as_arrays=True)
    assert len(arr.read_ids) >= 14, arr.read_ids
    pipe = FusedPipeline(long_al, build_fused_tables(db, index, "cpu"), 256)
    pipe.feed_intervals(arr.ts, arr.te, arr.mapq, arr.read_len,
                        ids=arr.read_ids)
    cfg = _host.ProfilingConfig.for_read_type("long")
    cfg.tail = "host"
    long_out = sys.argv[1] + "_long"
    assert profile_from_fused_result(pipe.finish(), pipe.tables, index, db,
                                     cfg, long_out)
    for name in ("species_abundance.txt", "strain_abundance.txt",
                 "ori_strain_abundance.txt", "reads_classification.tsv"):
        assert os.path.getsize(os.path.join(long_out, name)) > 0, name

    # the dup-graph community (imported through gfa_dir): the windowed
    # scatter at the window the first feed picks, paired and interval feeds
    # on haplotypes that revisit a node, host tail
    dup = dup_db(os.path.join(os.environ["TMPDIR"], "dup"), n_species=2,
                 strains=2, n_blocks=400)
    dup_index = _host.build_align_index(dup)
    assert len(dup_index.hap_names) == 4, dup_index.hap_names
    dup_al = aligner_from_reference(dup_index, _host.AlignConfig(), "cpu")
    dup_tables = build_fused_tables(dup, dup_index, "cpu")
    assert dup_tables.has_dups and dup_tables.hap_dup.all()
    pipe = FusedPipeline(dup_al, dup_tables, 512)
    pipe.feed(*simulate_read_batch(dup_index, 1024, 150, 0.01, seed=3)[:2])
    pipe.feed_paired(*simulate_pairs(dup_index, 512, seed=4))
    pipe.feed_intervals([dup_index.hap_offsets[0] + 10],
                        [dup_index.hap_offsets[0] + 3000], [60], [2990])
    assert not pipe.use_ranges and pipe.L_cap == 4
    assert pipe.interval_rows["residual"] == 1
    cfg = _host.ProfilingConfig.for_read_type("short")
    cfg.tail = "host"
    dup_out = sys.argv[1] + "_dup"
    assert profile_from_fused_result(pipe.finish(), dup_tables, dup_index,
                                     dup, cfg, dup_out)
    rows = open(os.path.join(dup_out, "strain_abundance.txt")).read()
    assert len(rows.splitlines()) == 5, rows

    # the multi-device and multi-process modules
    import socket

    import numpy as np
    import torch
    import torch.distributed as dist
    from pantax_tpu_torch.io.fastx import iter_fastx_shard
    from pantax_tpu_torch.ops.coverage import interval_node_coverage
    from pantax_tpu_torch.parallel import distributed
    from pantax_tpu_torch.parallel.dryrun import dryrun_multichip

    assert ([r for i in range(3) for r in iter_fastx_shard(fq, i, 3)]
            == list(_host.iter_fastx(fq)))
    dry = dryrun_multichip(2, "cpu", os.path.join(os.environ["TMPDIR"], "dry"))
    assert dry["n_overflow"] > 0 and len(dry["strains"]) == 4, dry
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    distributed.TIMEOUT_S = 60
    distributed.init_distributed(f"127.0.0.1:{port}", 1, 0, device="cpu")
    try:
        acc = torch.arange(7)
        assert torch.equal(distributed.cross_process_sum([acc])[0], acc)
        reads = {k: np.arange(3) for k in distributed.COLUMNS}
        reads["ids"] = ["a", "b", "c"]
        got = distributed.gather_read_rows(reads)
        assert got["ids"] == reads["ids"] and (got["ts"] == reads["ts"]).all()
    finally:
        dist.destroy_process_group()
    t = [torch.from_numpy(a.astype(np.int32))
         for a in (index.tstart, index.tnode, index.tlen)]
    ts = torch.tensor([0, 5000, 30000], dtype=torch.int32)
    cov = interval_node_coverage(*t, ts, ts + 150, torch.ones(3, dtype=bool),
                                 int(index.tnode.max()), 8)
    assert int(cov.sum()) == 450, cov.sum()

    # the benchmark runners (_strain_l1 reads the strain table without
    # pandas), simulate_reads and the single-device compile check
    from pantax_tpu_torch.benchmarks import accuracy_benchmark
    from pantax_tpu_torch.parallel.entry import entry
    from pantax_tpu_torch.sim import simulate_reads

    acc = accuracy_benchmark(db, n_reads=2048, batch=1024,
                             out_dir=sys.argv[1] + "_acc", device="cpu")
    assert acc["detected"] == acc["total"] == 4, acc
    assert 0 <= acc["l1_error"] < 0.5, acc
    hap_ids = [g.hap_id for g in _host.read_genomes_info(db.genomes_info_file)]
    sim = simulate_reads(db, dict.fromkeys(hap_ids, 1.0), 64, 150, seed=1)
    assert {r.hap_id for r in sim} <= set(hap_ids) and len(sim) == 64
    fn, args = entry("cpu", os.path.join(os.environ["TMPDIR"], "entry"))
    assert fn(*args)[6].float().mean() > 0.9

    # the benchmark driver (bench.py's counterpart), its read count cut,
    # over the tiny DB's cache
    import functools
    from pantax_tpu_torch import bench

    bench.CONFIGS["scale"] = functools.partial(bench.bench_scale,
                                               n_reads=2048)
    rec = bench.main(["--config", "scale", "--device", "cpu", "--batch",
                      "1024", "--db-dir", str(db.root.parent)])
    assert rec["metric"].endswith("_per_gpu") and rec["value"] > 0, rec
    leaked = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
    assert not leaked, leaked
    print("NOJAX_OK")
""")


def test_port_runs_without_jax_pandas_pyarrow(tmp_path):
    # one intra-op thread: the slices are small, and under a parallel test
    # run a thread per core in every process oversubscribes the CPU
    env = dict(os.environ, TMPDIR=str(tmp_path), OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([REPO, os.path.join(REPO, "tests"),
                                           os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT, str(tmp_path / "out")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "NOJAX_OK" in proc.stdout


CLI_SCRIPT = textwrap.dedent("""
    import importlib.abc
    import os
    import runpy
    import sys

    BLOCKED = ("jax", "jaxlib", "pandas", "pyarrow", "pantax_tpu")

    class Blocker(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ModuleNotFoundError(f"blocked: {name}", name=name)
            return None

    for mod in list(sys.modules):
        if mod.split(".")[0] in BLOCKED:
            del sys.modules[mod]
    sys.meta_path.insert(0, Blocker())

    argv = sys.argv[1:]
    if argv != ["--help"]:
        from _torch_helpers import code_seqs, write_reads
        from pantax_tpu_torch import _host
        from pantax_tpu_torch.benchmarks import (
            simulate_long_reads, simulate_read_batch, tiny_db,
        )

        db = tiny_db(os.path.join(os.environ["TMPDIR"], "tiny"))
        index = _host.build_align_index(db)
        if "-l" in argv:
            reads, _ = simulate_long_reads(index, 16, 4096, seed=9)
            ids, seqs = [r for r, _ in reads], [s for _, s in reads]
        else:
            codes, lens, _ = simulate_read_batch(index, 1024, 150, 0.01,
                                                 seed=3)
            ids, seqs = [f"S{i}" for i in range(1024)], code_seqs(codes, lens)
        write_reads("reads.fq", ids, seqs, "fq")
        argv = ["-d", str(db.root), *argv, "-r", "reads.fq", "--device",
                "cpu", "--batch-size", "256", "-o", "out", "-R", "cls.tsv"]
    sys.argv = ["pantax-gpu", *argv]
    try:
        runpy.run_module("pantax_tpu_torch.cli", run_name="__main__",
                         alter_sys=True)
    except SystemExit as e:
        assert e.code in (0, None), e.code
    if argv != ["--help"]:
        for name in ("out_species_abundance.txt", "out_strains_abundance.txt",
                     "cls.tsv"):
            assert os.path.getsize(name) > 0, name
    leaked = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
    assert not leaked, leaked
    print("NOJAX_CLI_OK")
""")


@pytest.mark.parametrize("argv", [["--help"], ["-s", "--fastpath"], ["-l"],
                                  ["-s", "--fastpath", "--mesh", "2"]])
def test_cli_runs_without_jax_pandas_pyarrow(argv, tmp_path):
    """python -m pantax_tpu_torch.cli on tiny_db with the same imports
    blocked: --help, the short-read fastpath (on one device and on a mesh
    of two CPU replicas) and the long-read GAF flow."""
    env = dict(os.environ, TMPDIR=str(tmp_path), OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([REPO, os.path.join(REPO, "tests"),
                                           os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run(
        [sys.executable, "-c", CLI_SCRIPT, *argv], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=600,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "NOJAX_CLI_OK" in proc.stdout


SEED_SCRIPT = textwrap.dedent("""
    import importlib.abc
    import sys

    BLOCKED = ("jax", "jaxlib", "pandas", "pyarrow", "pantax_tpu")

    class Blocker(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ModuleNotFoundError(f"blocked: {name}", name=name)
            return None

    for mod in list(sys.modules):
        if mod.split(".")[0] in BLOCKED:
            del sys.modules[mod]
    sys.meta_path.insert(0, Blocker())

    import numpy as np
    import torch
    from pantax_tpu_torch.ops import seed

    rng = np.random.default_rng(0)
    codes = torch.from_numpy(rng.integers(0, 5, size=(8, 64)).astype(np.int8))
    lens = torch.full((8,), 64, dtype=torch.int32)
    table = torch.zeros((1, 6), dtype=torch.int32)  # an empty CHD table
    diag, votes, strand = seed.seed_candidates(
        codes, lens, table, torch.zeros(1, dtype=torch.int32),
        torch.zeros(2, dtype=torch.int32), (21, 3, 1, -1, 16, 4, 2, 4))
    assert diag.shape == (8, 2) and not votes.any(), (diag, votes)
    leaked = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
    assert not leaked, leaked
    print("NOJAX_SEED_OK")
""")


def test_seed_stage_runs_without_jax(tmp_path):
    """pantax_tpu_torch.ops.seed (K3's module) imports and runs its plain
    version with jax, pandas, pyarrow and the JAX package blocked."""
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([REPO,
                                           os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run([sys.executable, "-c", SEED_SCRIPT], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "NOJAX_SEED_OK" in proc.stdout


SCATTER_SCRIPT = SEED_SCRIPT.split("    import numpy as np")[0] + textwrap.dedent("""
    from types import SimpleNamespace

    import numpy as np
    import torch
    from pantax_tpu_torch.ops import extend, scatter
    from pantax_tpu_torch.ops.fused import build_pos_lookup

    # 8 segments of 10 bases, one node each, two haplotypes of 4
    tstart = np.arange(0, 80, 10)
    pos_lo, win_shift, steps = build_pos_lookup(tstart, 80)

    def i32(a):
        return torch.tensor(np.asarray(a), dtype=torch.int32)

    t = SimpleNamespace(
        hap_offsets=i32([0, 40, 80]), hap_range=i32([0, 1]),
        pos_lo=i32(pos_lo), win_shift=win_shift, pos_steps=steps,
        nodes_len=i32(np.full(256, 10)),
        base_offset=i32(np.arange(257) * 10), trio_seg=i32(np.full(8, -1)),
        N_pad=256, TB_pad=4096, U_pad=64, has_dups=True)
    ts, te = i32([5, 15, 42]), i32([25, 18, 80])
    aligned = torch.tensor([True, True, False])

    def accs():
        return (torch.zeros(257, dtype=torch.int64),
                torch.zeros(4097, dtype=torch.int32),
                torch.zeros(65, dtype=torch.int64),
                torch.zeros(9, dtype=torch.int32),
                torch.zeros(9, dtype=torch.int32))

    a6, a11 = accs(), accs()
    ridx = scatter.classify_scatter_ranges(ts, te, aligned, t, i32(tstart),
                                           i32(np.arange(1, 9)), a6)
    ridx11, ov = scatter.classify_scatter(ts, te, aligned, t, i32(tstart),
                                          i32(np.arange(1, 9)), a11, 4)
    assert ridx.tolist() == ridx11.tolist() == [0, 0, -1], ridx
    assert not ov.any()
    # the first read's 20 bases: 5 + 10 + 5 by the window, 5 + 5 directly
    # and the middle node as a segment depth by the ranges
    assert a11[0][:3].tolist() == [5, 13, 5], a11[0][:3]
    assert a6[0][:3].tolist() == [5, 3, 5] and a6[3][1] == 1, a6
    assert extend.LAUNCHES["classify_scatter_ranges_plain"] == 1
    assert extend.LAUNCHES["classify_scatter_plain"] == 1
    assert extend.LAUNCHES["classify_scatter_ranges"] == 0
    leaked = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
    assert not leaked, leaked
    print("NOJAX_SCATTER_OK")
""")


def test_scatter_runs_without_jax(tmp_path):
    """pantax_tpu_torch.ops.scatter (K6's and K11's module) imports and runs
    its plain versions through the dispatchers with jax, pandas, pyarrow and
    the JAX package blocked."""
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([REPO,
                                           os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run([sys.executable, "-c", SCATTER_SCRIPT],
                          cwd=tmp_path, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "NOJAX_SCATTER_OK" in proc.stdout


ADMM_SCRIPT = SEED_SCRIPT.split("    import numpy as np")[0] + textwrap.dedent("""
    import torch
    from pantax_tpu_torch.ops import extend
    from pantax_tpu_torch.profile import pao

    # two instances of 4096 rows and 4 paths, the second path pinned
    g = torch.Generator().manual_seed(0)
    A = (torch.rand((2, 4096, 4), generator=g) < 0.6).float()
    b = A @ torch.tensor([0.5, 0.0, 0.3, 0.2])
    b = b / b.amax(dim=1, keepdim=True)
    ub = torch.tensor([[1.0, 0.0, 1.0, 1.0]] * 2)
    L = torch.linalg.cholesky(A.mT @ A + torch.eye(4))
    x0, z0 = torch.zeros((2, 4)), torch.zeros((2, 4096))
    state, res = pao._admm_chunk_batch(A, b, ub, 1.0, (x0, z0, x0, z0, x0),
                                       L, 25)
    assert [tuple(t.shape) for t in state] == [(2, 4), (2, 4096), (2, 4),
                                               (2, 4096), (2, 4)]
    assert res.shape == (2,) and bool(torch.isfinite(res).all()), res
    assert float(state[2][:, 1].abs().max()) == 0.0  # the pinned path
    assert extend.LAUNCHES["admm_chunk_plain"] == 1
    assert extend.LAUNCHES["admm_chunk"] == 0
    leaked = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
    assert not leaked, leaked
    print("NOJAX_ADMM_OK")
""")


def test_admm_chunk_runs_without_jax(tmp_path):
    """pantax_tpu_torch.ops.admm (K8's module), imported first, runs its
    plain version through the dispatcher with jax, pandas, pyarrow and the
    JAX package blocked."""
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([REPO,
                                           os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run([sys.executable, "-c", ADMM_SCRIPT], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "NOJAX_ADMM_OK" in proc.stdout


TAIL_SCRIPT = SEED_SCRIPT.split("    import numpy as np")[0] + textwrap.dedent("""
    import types

    import torch
    from pantax_tpu_torch.ops import tail_kernels
    from pantax_tpu_torch.ops import extend, profile_tail

    # two instances of 4096 rows and 4 paths, a path pinned
    g = torch.Generator().manual_seed(0)
    A = (torch.rand((2, 4096, 4), generator=g) < 0.6).float()
    b = A @ torch.tensor([0.5, 0.0, 0.3, 0.2])
    b = b / b.amax(dim=1, keepdim=True)
    ub = torch.tensor([[1.05, 0.0, 1.05, 1.05]] * 2)
    x = torch.tensor([[0.4, 0.0, 0.4, 0.1]] * 2)
    out = profile_tail.polish_batch(A, b, x, ub)
    assert out.shape == (2, 4) and float(out[:, 1].abs().max()) == 0.0
    assert tail_kernels.polish_plan(2, 4096, 4).cluster == 1
    # a species of 3 nodes and 2 haps over 5 trios (one a pad)
    tt = profile_tail.owner_tables(torch.tensor([1, 0, 2, 1, 0]).numpy(),
                                   torch.tensor([0, 2, 3]).numpy(),
                                   torch.tensor([0]).numpy(),
                                   torch.tensor([3]).numpy(), 2, "cpu")
    tables = types.SimpleNamespace(
        trio_hap=torch.tensor([1, 0, 2, 1, 0], dtype=torch.int32),
        path_node=torch.tensor([0, 1, 2], dtype=torch.int32),
        path_hap=torch.tensor([0, 0, 1], dtype=torch.int32),
        node_species=torch.tensor([0, 0, 0, 1], dtype=torch.int32),
        G=2, S=1, **tt)
    stats = profile_tail.dispatch_tail_stats(
        tables, torch.tensor([1.0, 2.0, 0.0, 0.0]),
        torch.tensor([1.0, 2.0, 3.0, 0.0, 5.0]),
        torch.tensor([10, 20, 30, 0], dtype=torch.int32), 0.0)
    assert [float(t[0]) for t in stats] == [2.0, 3.5, 30.0, 2.0, 3.0, 2.0,
                                            2.0], stats
    assert extend.LAUNCHES["tail_stats_plain"] == 1
    assert extend.LAUNCHES["polish_plain"] == 1
    assert extend.LAUNCHES["tail_stats"] == extend.LAUNCHES["polish"] == 0
    leaked = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
    assert not leaked, leaked
    print("NOJAX_TAIL_OK")
""")


def test_tail_kernels_run_without_jax(tmp_path):
    """pantax_tpu_torch.ops.tail_kernels (K9's and K10b's module), imported
    first, and the device tail's dispatchers run their plain versions with
    jax, pandas, pyarrow and the JAX package blocked."""
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([REPO,
                                           os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run([sys.executable, "-c", TAIL_SCRIPT], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "NOJAX_TAIL_OK" in proc.stdout


QUERY_SCRIPT = SEED_SCRIPT.split("    import numpy as np")[0] + textwrap.dedent("""
    import numpy as np
    import torch
    from pantax_tpu_torch.ops import extend, query

    rng = np.random.default_rng(0)
    i32 = torch.int32
    codes = torch.from_numpy(rng.integers(0, 5, size=(6, 150)).astype(np.int8))
    lens = torch.tensor([0, 150, 75, 149, 1, 150], dtype=i32)
    fwd, n = query.query_prologue(codes, lens, codes[:, :100], lens // 2)
    assert fwd.shape == (12, 152) and n.tolist()[6:] == (lens // 2).tolist()
    strand = torch.tensor([[0, 1]] * 12, dtype=torch.int8)
    diag = torch.arange(24, dtype=i32).reshape(12, 2) * 40
    rows, len_rep, w0 = query.query_rows(fwd, n, strand, diag, 4, 600, 160)
    assert rows.shape == (24, 160) and int(w0.max()) == 600
    tstart = torch.arange(0, 1000, 10, dtype=i32)
    tnode = torch.arange(100, dtype=i32) % 7
    dp = [torch.from_numpy(rng.integers(0, 150, size=24).astype(np.int32))
          for _ in range(4)]
    votes = torch.ones((12, 2), dtype=i32)
    seg = query.segment_lookup(tstart, 1000)
    cols = query.query_pick_paired(*dp, w0, votes, strand, tstart, tnode,
                                   seg, n, 10.0, 0.6, 1200, 4, 0.45)
    assert len(cols) == 7 and cols[0].shape == (12,)
    packed = query.query_pick(*dp, w0, votes, strand, tstart, tnode, seg, n,
                              10.0, 0.6, packed=True)
    assert packed.shape == (4, 12) and packed.dtype == i32
    assert extend.LAUNCHES["query_pick"] == 0
    leaked = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
    assert not leaked, leaked
    print("NOJAX_QUERY_OK")
""")


def test_query_io_runs_without_jax(tmp_path):
    """pantax_tpu_torch.ops.query (K4's and K5's module) imports and runs
    its plain versions through its four entry points with jax, pandas,
    pyarrow and the JAX package blocked."""
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([REPO,
                                           os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run([sys.executable, "-c", QUERY_SCRIPT], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "NOJAX_QUERY_OK" in proc.stdout
