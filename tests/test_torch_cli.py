"""The port's command line (pantax-gpu, pantax_tpu_torch/cli.py) against
the JAX package's (pantax-tpu) on the CPU: its profiling flows.

Each flow runs through pantax_tpu.cli.main(... --mesh off) and through
pantax_tpu_torch.cli.main(... --device cpu) on the same files, each package
in its own working directory, and under HiGHS the species, strain and
classification files are byte-identical: -s (GAF), -s --fastpath, -s -p
(two files and one interleaved file, both flows, the interleaved fastpath
also at a chunk size that splits mate pairs across buffers), -l (GAF),
-l --fastpath, and device coverage on a GAF flow.  Under ADMM (the
default solver, and the device tail's only solver) the classification
and species files stay byte-identical and the strains agree within the
solvers' bar.  The -n / --strain resume reuses the alignment artifact and
writes the reference's tables; the flags resolve to the reference's
ProfilingConfig; --trace-dir writes a torch.profiler trace.
(tests/test_torch_cli_db.py holds the DB commands, the error exits and
the tools.)"""
import os

import pytest

from pantax_tpu_torch import _host, cli

from _torch_helpers import (  # noqa: F401 (autouse)
    CLI_BATCH, assert_same_files, assert_tables_agree, cli_community,
    one_torch_thread, quiet_cli, reference_on_one_device, run_both_clis,
)

OUTPUTS = ("out_species_abundance.txt", "out_strains_abundance.txt",
           "cls.tsv")


FLOWS = {
    "short_gaf": ["-s", "-r", "{short}"],
    "short_fastpath": ["-s", "--fastpath", "-r", "{short}"],
    "paired_gaf_two_files": ["-s", "-p", "-r", "{r1}", "{r2}"],
    "paired_gaf_interleaved": ["-s", "-p", "-r", "{inter}"],
    "paired_fastpath_two_files": ["-s", "-p", "--fastpath", "-r", "{r1}",
                                  "{r2}"],
    "paired_fastpath_interleaved": ["-s", "-p", "--fastpath", "-r",
                                    "{inter}"],
    "long_gaf": ["-l", "-r", "{long}"],
    "long_fastpath": ["-l", "--fastpath", "-r", "{long}"],
    "short_gaf_device_coverage": ["-s", "--coverage", "device", "-r",
                                  "{short}"],
}


@pytest.mark.parametrize("flow", list(FLOWS))
def test_flow_tables_byte_identical(flow, cli_community, tmp_path, monkeypatch):
    argv = [a.format(**vars(cli_community)) for a in FLOWS[flow]]
    ref, port = run_both_clis(tmp_path, monkeypatch, [
        "-d", cli_community.db, *argv, "--species", "--strain", "--solver",
        "highs", "--batch-size", CLI_BATCH, "-o", "out", "-R", "cls.tsv",
        "-T", "tmp"])
    assert_same_files(ref, port, OUTPUTS)
    assert not (port / "tmp").exists()  # cleaned up without -n / --debug
    n_cls = len((port / "cls.tsv").read_text().splitlines())
    assert n_cls >= (14 if flow.startswith("long") else 4000)


@pytest.mark.parametrize("argv", [
    ["-s"], ["-l"], ["-s", "--fr", "0.0"], ["-l", "--shift", "true"],
    ["-s", "--shift", "false", "--ds", "101, 202", "--no_filter", "--smode",
     "1", "--solver", "highs", "--coverage", "device", "--tail", "host",
     "-a", "0.01", "--fc", "0.3", "--sr", "0.7", "--sd", "0.1", "--min_cov",
     "0.5", "--min_depth", "1", "--sample", "1000", "--sample_test"]])
def test_profiling_config_equal(argv, cli_community, tmp_path):
    """The flags resolve to the reference's ProfilingConfig, the --fr
    default by read type and the shift quirk included."""
    import dataclasses

    from pantax_tpu.cli import _profiling_config as ref_config
    from pantax_tpu.cli import build_parser as ref_parser
    from pantax_tpu.db.construct import load_database as ref_load

    read_type = "long" if "-l" in argv else "short"
    cfgs = []
    for parser, config, load in ((ref_parser, ref_config, ref_load),
                                 (cli.build_parser, cli._profiling_config,
                                  _host.load_database)):
        args = parser().parse_args(["-d", cli_community.db, *argv])
        cfgs.append(dataclasses.asdict(config(
            args, load(cli_community.db), tmp_path, read_type, species=True,
            strain=False)))
    assert cfgs[0] == cfgs[1]
    assert cfgs[1]["unique_trio_nodes_fraction"] == (
        0.0 if "--fr" in argv else 0.3 if read_type == "short" else 0.5)


def test_interleaved_pairs_across_chunks(cli_community, tmp_path, monkeypatch):
    """The interleaved fastpath over ~7 stream chunks, each ending on an
    odd record now and then, so mate pairs cross buffers."""
    from pantax_tpu_torch.io.fastx import stream_fastx_buffers

    chunk = 200_000
    counts = [buf.count(b"\n") // 4
              for buf in stream_fastx_buffers(cli_community.inter, chunk)]
    assert len(counts) >= 6 and any(c % 2 for c in counts), counts
    monkeypatch.setenv("PANTAX_TPU_CHUNK_BYTES", str(chunk))
    monkeypatch.setattr(cli, "CHUNK_BYTES", chunk)
    ref, port = run_both_clis(tmp_path, monkeypatch, [
        "-d", cli_community.db, "-s", "-p", "--fastpath", "-r", cli_community.inter,
        "--solver", "highs", "--batch-size", CLI_BATCH, "-o", "out", "-R",
        "cls.tsv", "-T", "tmp"])
    assert_same_files(ref, port, OUTPUTS)


@pytest.mark.parametrize("tail", ["auto", "device"])
def test_admm_tables_agree(tail, cli_community, tmp_path, monkeypatch):
    """Under ADMM, the default solver and the device tail's only one
    (float32 in the reference, float64 in the port), the classification
    and species tables stay byte-identical and the strain tables agree
    within the solvers' bar.  "auto" takes the host tail on this DB."""
    ref, port = run_both_clis(tmp_path, monkeypatch, [
        "-d", cli_community.db, "-s", "--fastpath", "-r", cli_community.short,
        "--tail", tail, "--batch-size", CLI_BATCH, "-o", "out", "-R", "cls.tsv",
        "-T", "tmp", "--debug"])
    assert_same_files(ref, port, ("out_species_abundance.txt", "cls.tsv"))
    assert_tables_agree(ref / "tmp", port / "tmp", abundance_tol=2e-4)


@pytest.mark.parametrize("flow,artifact", [
    ("gaf", "gfa_mapped.gaf"), ("fastpath", "alignment_arrays.npz")])
def test_resume_next_then_strain(flow, artifact, cli_community, tmp_path,
                                 monkeypatch):
    """-n keeps the tmp dir after a species run; the --strain run then
    reads the alignment artifact (left untouched) instead of realigning,
    and both packages write the same tables."""
    base = ["-d", cli_community.db, "-s", "-r", cli_community.short, "--solver",
            "highs", "--batch-size", CLI_BATCH, "-T", "t"]
    if flow == "fastpath":
        base.append("--fastpath")
    run_both_clis(tmp_path, monkeypatch, [*base, "--species", "-n"])
    mtimes = {name: os.stat(tmp_path / name / "t" / artifact).st_mtime_ns
              for name in ("ref", "port")}
    ref, port = run_both_clis(tmp_path, monkeypatch, [*base, "--strain", "-n"])
    for wd in (ref, port):
        assert os.stat(wd / "t" / artifact).st_mtime_ns == mtimes[wd.name]
    assert_same_files(ref, port, ("species_abundance.txt", "strain_abundance.txt"))


def test_trace_dir_writes_chrome_trace(cli_community, tmp_path, monkeypatch):
    """--trace-dir wraps the alignment stage in torch.profiler and writes
    its Chrome trace."""
    import json

    monkeypatch.chdir(tmp_path)
    assert cli.main(["-d", cli_community.db, "-s", "-r", cli_community.short,
                     "--device", "cpu", "--batch-size", CLI_BATCH, "--species",
                     "--trace-dir", "trace"]) == 0
    with open(tmp_path / "trace" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::" in e.get("name", "") for e in events)
