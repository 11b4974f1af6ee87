"""The port's command line (pantax-gpu) and DB-curation tools against the
JAX package's on the CPU: --create, --export-gfa and the --fast / --qt
genome screen write the reference's bytes, --index --warm-kernels runs,
the error exits match the reference's, --mesh 2 on the CPU writes the
--mesh off tables while --mesh 2 with too few cards and a malformed
--distributed exit 1, --device cuda without a GPU fails without running
anything, and the
tools (pantax-gpu-rg, -md, -sketch) write the reference tools' bytes.
(tests/test_torch_cli.py holds the profiling flows.)"""
import filecmp
import os

import numpy as np
import pytest

from pantax_tpu.cli import main as ref_main
from pantax_tpu.db import md as ref_md
from pantax_tpu.db import rg as ref_rg
from pantax_tpu.db.sketch_cli import main as ref_sketch_main
from pantax_tpu_torch import _host, cli
from pantax_tpu_torch.db import md, rg
from pantax_tpu_torch.db.sketch_cli import main as sketch_main

from _torch_helpers import (  # noqa: F401 (autouse)
    assert_same_files, cli_community, one_torch_thread, quiet_cli,
    reference_on_one_device, run_both_clis,
)


def _db_files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def _assert_dbs_equal(a, b):
    names = _db_files(a)
    assert names == _db_files(b) and names
    for name in names:
        if name == "finished_species.txt":  # build threads finish in any order
            assert (sorted((a / name).read_text().split())
                    == sorted((b / name).read_text().split()))
        else:
            assert filecmp.cmp(a / name, b / name, shallow=False), name


def test_create_database_byte_identical(cli_community, tmp_path, monkeypatch):
    ref, port = run_both_clis(tmp_path, monkeypatch, [
        "-f", cli_community.info, "-d", "db", "--create", "--base-dir",
        str(cli_community.root)])
    _assert_dbs_equal(ref / "db", port / "db")
    assert any(n.endswith(".graph.npz") for n in _db_files(port / "db"))


def test_export_gfa_byte_identical(cli_community, tmp_path, monkeypatch):
    ref, port = run_both_clis(tmp_path, monkeypatch, [
        "-d", cli_community.db, "--export-gfa", "combined.gfa"])
    assert_same_files(ref, port, ("combined.gfa",))
    assert (port / "combined.gfa").read_text().startswith("H\tVN:Z:1.1\n")


@pytest.mark.parametrize("read_type", [[], ["-l", "--long-read-type", "hifi"]])
def test_index_warm_kernels(read_type, cli_community, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    assert cli.main(["-d", cli_community.db, "--index", "--warm-kernels",
                     "--batch-size", "256", "--device", "cpu",
                     *read_type]) == 0


def test_fast_genome_screen(cli_community, tmp_path, monkeypatch):
    """pantax-gpu-sketch pre-builds the --syldb cache (the same sketches as
    the reference tool's); --fast --qt writes the reference's filtered
    genomes_info and builds nothing; --fast --create builds the screened
    DB under <db>_fast.  The reads come from species 101 alone, so the
    screen drops species 202."""
    base = ["-f", cli_community.info, "--base-dir", str(cli_community.root)]
    for name, tool in (("ref", ref_sketch_main), ("port", sketch_main)):
        assert tool([*base, "-o", str(tmp_path / f"sk_{name}")]) == 0
    names = sorted(os.listdir(tmp_path / "sk_port"))
    assert len(names) == 4 and names == sorted(os.listdir(tmp_path / "sk_ref"))
    for n in names:
        with np.load(tmp_path / "sk_ref" / n) as a, \
                np.load(tmp_path / "sk_port" / n) as b:
            assert all(np.array_equal(a[k], b[k]) for k in ("hashes", "meta"))
    screen = [*base, "--fast", "-s", "-r", cli_community.screen]
    ref, port = run_both_clis(tmp_path, monkeypatch, [
        *screen, "-d", "dbqt", "--qt", "--create", "--syldb",
        str(tmp_path / "sk_port")])
    assert_same_files(ref, port, ("dbqt_fast/genomes_info_fast_input.txt",))
    kept = _host.read_genomes_info(port / "dbqt_fast"
                                   / "genomes_info_fast_input.txt")
    assert kept and {g.species_taxid for g in kept} == {"101"}
    assert not (port / "dbqt_fast" / "species_range.txt").exists()
    ref, port = run_both_clis(tmp_path, monkeypatch, [
        *screen, "-d", "dbfast", "--create", "--syldb",
        str(tmp_path / "sk_port")])
    _assert_dbs_equal(ref / "dbfast_fast", port / "dbfast_fast")
    assert (port / "dbfast_fast" / "species_range.txt").exists()


def test_error_exits(cli_community, tmp_path, monkeypatch):
    """The reference's error exits (no reads, no read type: 2; a missing
    read file: 1, in both flows) with the same codes; --device cpu --mesh 2
    (two CPU replicas) writes the --mesh off tables; --mesh 2 on cuda with
    one card and a malformed --distributed return 1 before they touch the
    DB or start a process group; --device cuda without a GPU returns 1
    before it touches the DB or the reads."""
    import torch
    import torch.distributed as dist

    monkeypatch.chdir(tmp_path)
    db = ["-d", cli_community.db]
    cases = [
        (2, [*db, "-s"]),
        (2, [*db, "-r", cli_community.short]),
        (1, [*db, "-s", "-r", "missing.fq", "-T", "t1"]),
        (1, [*db, "-s", "--fastpath", "-r", "missing.fq", "-T", "t2"]),
    ]
    for rc, argv in cases:
        assert ref_main([*argv, "--mesh", "off"]) == rc, argv
        assert cli.main([*argv, "--device", "cpu"]) == rc, argv
    run = [*db, "-s", "--fastpath", "-r", cli_community.short, "--device", "cpu"]
    out = ["--solver", "highs", "--batch-size", "1024", "-R"]
    for mesh in ("off", "2"):
        assert cli.main([*run, "--mesh", mesh, *out, f"cls_{mesh}.tsv", "-o",
                         f"mesh_{mesh}", "-T", f"t_{mesh}"]) == 0
    for a, b in (("mesh_off_species_abundance.txt",
                  "mesh_2_species_abundance.txt"),
                 ("mesh_off_strains_abundance.txt",
                  "mesh_2_strains_abundance.txt"),
                 ("cls_off.tsv", "cls_2.tsv")):
        assert (tmp_path / a).read_bytes() == (tmp_path / b).read_bytes(), b
    for spec in ("127.0.0.1:1,2", "127.0.0.1:1,two,0", "127.0.0.1:1,2,2",
                 "127.0.0.1,2,0"):
        assert cli.main([*run, "--distributed", spec, "-T", "t_dist"]) == 1
        assert not dist.is_initialized()
    with monkeypatch.context() as m:  # one visible card
        m.setattr(torch.cuda, "is_available", lambda: True)
        m.setattr(torch.cuda, "device_count", lambda: 1)
        m.setattr(torch.cuda, "get_device_name", lambda *a: "one card")
        assert cli.main([*run[:-1], "cuda", "--mesh", "2", "-T", "t4"]) == 1
    assert not (tmp_path / "t_dist").exists()
    assert not (tmp_path / "t4").exists()
    assert cli.main([*run[:-1], "cuda", "-T", "t3"]) == 1
    assert not (tmp_path / "t3").exists()
    assert not (tmp_path / "species_abundance.txt").exists()


def test_cuda_without_gpu_fails_in_a_fresh_process(cli_community, tmp_path):
    """python -m pantax_tpu_torch.cli with the default device exits
    non-zero where torch sees no GPU, and writes no output."""
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([repo,
                                           os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run(
        [sys.executable, "-m", "pantax_tpu_torch.cli", "-d", cli_community.db,
         "-s", "--fastpath", "-r", cli_community.short, "-T", "t"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr
    assert not os.listdir(tmp_path)


# --------------------------------------------------------------------------
# the DB-curation tools
# --------------------------------------------------------------------------
def _random_genome(rng, n):
    return np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, size=n)].tobytes()


def _mutate(seq, rng, rate):
    arr = np.frombuffer(seq, dtype=np.uint8).copy()
    m = rng.random(len(arr)) < rate
    arr[m] = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, size=int(m.sum()))]
    return arr.tobytes()


def _run_tool_twice(ref_tool, port_tool, argv, outputs):
    """Run the reference tool, keep the bytes of ``outputs`` (files, or
    every file under a directory), run the port's tool with the same argv
    over the same paths, and compare."""
    def snapshot():
        files = {}
        for out in outputs:
            paths = ([os.path.join(d, f) for d, _, fs in os.walk(out)
                      for f in fs] if os.path.isdir(out) else [out])
            for p in paths:
                with open(p, "rb") as f:
                    files[p] = f.read()
        return files

    assert ref_tool(argv) == 0
    ref = snapshot()
    for p in ref:
        os.remove(p)
    assert port_tool(argv) == 0
    port = snapshot()
    assert sorted(ref) == sorted(port) and ref
    for p in ref:
        assert ref[p] == port[p], p


@pytest.fixture()
def species_genomes(tmp_path):
    """5 genomes of one species: 3 near-duplicates (>= 99.9% ANI) and 2
    distinct strains (~97%)."""
    rng = np.random.default_rng(7)
    base = _random_genome(rng, 50000)
    seqs = {"a": base, "a2": _mutate(base, rng, 0.0002),
            "a3": _mutate(base, rng, 0.0003), "b": _mutate(base, rng, 0.02),
            "c": _mutate(base, rng, 0.025)}
    paths = {}
    for name, seq in seqs.items():
        p = tmp_path / f"GCF_{name}.1_x_genomic.fna"
        _host.write_fasta(p, [(name, seq)])
        paths[name] = str(p)
    return paths


@pytest.mark.parametrize("cluster", ["graph", "hcls"])
def test_rg_driver(cluster, tmp_path, species_genomes):
    src = tmp_path / "in_info.txt"
    _host.write_genomes_info(src, [
        _host.GenomeInfo(f"GCF_{k}.1_x", "77", "77", "org", p)
        for k, p in species_genomes.items()])
    out = tmp_path / "out_info.txt"
    _run_tool_twice(ref_rg.main, rg.main, [
        "-c", str(src), "-o", str(out), "--cluster", cluster,
        "--base-dir", str(tmp_path)], [str(out)])
    curated = _host.read_genomes_info(out)
    assert 2 <= len(curated) <= 4
    assert len({g.strain_taxid for g in curated}) == len(curated)


def test_rg_remove_plasmids(tmp_path):
    rng = np.random.default_rng(3)
    g1, g2 = tmp_path / "g1.fna", tmp_path / "g2.fna"
    _host.write_fasta(g1, [("chr1", _random_genome(rng, 1_200_000)),
                           ("plasmid pX", _random_genome(rng, 1_100_000)),
                           ("tiny", _random_genome(rng, 500))])
    _host.write_fasta(g2, [("only_small", _random_genome(rng, 2000))])
    src, out = tmp_path / "in_info.txt", tmp_path / "out_info.txt"
    _host.write_genomes_info(src, [
        _host.GenomeInfo("GCF_1.1_x", "71", "71", "org", str(g1)),
        _host.GenomeInfo("GCF_2.1_x", "72", "72", "org", str(g2))])
    filtered = tmp_path / "filtered"
    _run_tool_twice(ref_rg.main, rg.main, [
        "-c", str(src), "-o", str(out), "--cluster", "none", "--remove",
        "-rl", "1.0", "--filtered-dir", str(filtered), "--base-dir",
        str(tmp_path)], [str(out), str(filtered)])
    curated = _host.read_genomes_info(out)
    assert [g.genome_id for g in curated] == ["GCF_1.1_x"]
    assert [n for n, _ in _host.iter_fastx(curated[0].path)] == ["chr1"]


def test_rg_metadata_mode(tmp_path):
    gd = tmp_path / "genomes"
    gd.mkdir()
    rng = np.random.default_rng(1)
    _host.write_fasta(gd / "GCF_000001.1_ASM1v1_genomic.fna",
                      [("chr1", _random_genome(rng, 2000))])
    summary = tmp_path / "s.txt"
    summary.write_text("\t".join(
        ["GCF_000001.1"] + [""] * 4 + ["561", "562", "E coli X"]
        + [""] * 3 + ["Complete Genome"] + [""] * 7
        + ["ftp://x/GCF_000001.1_ASM1v1"]) + "\n")
    out = tmp_path / "gi.txt"
    _run_tool_twice(ref_rg.main, rg.main, [
        "-r", str(gd), "--summary", str(summary), "-o", str(out),
        "--cluster", "none"], [str(out)])
    infos = _host.read_genomes_info(out)
    assert [(i.species_taxid, i.strain_taxid) for i in infos] == [("562", "561")]


def test_rg_download_summary_offline_error(tmp_path, monkeypatch):
    """--download-summary where NCBI cannot be reached fails with an error
    naming the summary file (the fetch is replaced, nothing is sent)."""
    import urllib.error
    import urllib.request

    def no_net(*a, **k):
        raise urllib.error.URLError("no route to host")

    monkeypatch.setattr(urllib.request, "urlretrieve", no_net)
    with pytest.raises(SystemExit, match="assembly_summary"):
        rg.main(["-r", str(tmp_path), "--download-summary",
                 "-o", str(tmp_path / "o.txt")])


def test_md_merge_databases(tmp_path, monkeypatch):
    rng = np.random.default_rng(11)
    dbs = []
    for di in range(2):
        root = tmp_path / f"src{di}"
        root.mkdir()
        infos = []
        for gi in range(2):
            name = f"GCF_{di}{gi}.1_x_genomic.fna"
            _host.write_fasta(root / name, [("c", _random_genome(rng, 8000))])
            infos.append(_host.GenomeInfo(f"GCF_{di}{gi}.1_x", f"{di}{gi}.1",
                                          f"s{di}{gi}", "org", name))
        _host.write_genomes_info(root / "genomes_info.txt", infos)
        dbs.append(str(_host.build_database(root / "genomes_info.txt",
                                            tmp_path / f"db{di}",
                                            base_dir=root).root))
    merged = tmp_path / "merged"
    _run_tool_twice(ref_md.main, md.main, ["-i", *dbs, "-o", str(merged)],
                    [str(merged)])
    ranges = _host.load_species_range(merged / "species_range.txt")
    assert len(ranges) == 4 and ranges[0].start == 1
