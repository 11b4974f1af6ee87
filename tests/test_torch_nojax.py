"""The port on a machine without jax, pandas, pyarrow and the JAX package:
in a subprocess that blocks those imports (pantax_tpu by its top-level
name, so pantax_tpu_torch stays importable), pantax_tpu_torch builds a
complete database (no species silently dropped) and runs the short-read
slice, the per-species GAF flow from a FASTQ file with device coverage,
the paired slice with the device tail, the long-read slice and the
dup-graph community's windowed slice on the CPU to the four output
tables."""
import os
import subprocess
import sys
import textwrap

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
