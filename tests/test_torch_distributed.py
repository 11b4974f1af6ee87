"""Multi-process runs of the port (pantax_tpu_torch.parallel.distributed,
pantax-gpu --distributed) on the CPU: two ranks of a torch.distributed gloo
group as subprocesses (tests/_torch_dist_worker.py), each with its own
timeout and kill, against the JAX package in one process.

distributed_node_abundances is bit-identical to the JAX
node_abundances_device over all the rows; the CLI's -s (one file, one
gzip file, two files), -s -p (two files and interleaved) and -l fastpaths
on two ranks write the files of pantax_tpu.cli.main(... --mesh off) under
HiGHS: the species and strain files byte-identical, the classification
rows byte-identical for one uncompressed single-end file (the byte-range
shard keeps file order) and equal as sorted lists elsewhere (gzip chunks,
files, paired chunks and read groups go round-robin over the ranks and
gather in rank order); rank 1 writes none.  A
rank that owns no read group (long reads in one group) completes with the
other.  --distributed without --fastpath is refused before any group
forms."""
import gzip
import os
import shutil
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

from _torch_helpers import (  # noqa: F401 (autouse)
    CLI_BATCH, cli_community, one_torch_thread, quiet_cli,
    reference_on_one_device,
)

HERE = os.path.dirname(os.path.abspath(__file__))
WORKER = os.path.join(HERE, "_torch_dist_worker.py")
OUTPUTS = ("out_species_abundance.txt", "out_strains_abundance.txt",
           "cls.tsv")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_ranks(mode: str, rank_args, log_dir, timeout: float = 240) -> list:
    """Two worker ranks (``rank_args(i)`` their trailing arguments) on one
    fresh port, each writing its output to ``log_dir``/rank<i>.log (a file,
    so a rank that writes much never blocks on a pipe the other's wait
    leaves undrained); both are waited for until one ``timeout`` deadline
    and killed past it.  Asserts both exit 0 and returns their output."""
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [os.path.dirname(HERE), HERE, os.environ.get("PYTHONPATH", "")]))
    port = str(_free_port())
    paths = [os.path.join(log_dir, f"rank{i}.log") for i in range(2)]
    procs = []
    for i, path in enumerate(paths):
        with open(path, "wb") as out:
            procs.append(subprocess.Popen(
                [sys.executable, WORKER, mode, str(i), "2", port,
                 *rank_args(i)], env=env, stdout=out,
                stderr=subprocess.STDOUT))
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 0.0))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    logs = [open(path, errors="replace").read() for path in paths]
    assert [p.returncode for p in procs] == [0, 0], "\n".join(logs)
    return logs


def test_two_rank_coverage_bitwise_matches_jax(tmp_path):
    from _dist_worker import make_inputs as ref_inputs
    from _torch_dist_worker import make_inputs
    from pantax_tpu.graph.trio import build_trio_index
    from pantax_tpu.ops.coverage_device import node_abundances_device

    packed, nodes_len, paths = ref_inputs()
    ours = make_inputs()
    for name in ("nodes", "lengths", "read_start", "read_end"):
        np.testing.assert_array_equal(getattr(packed, name),
                                      getattr(ours[0], name))
    np.testing.assert_array_equal(nodes_len, ours[1])
    want = node_abundances_device(packed, nodes_len,
                                  build_trio_index(nodes_len, paths))
    out = str(tmp_path / "cov")
    _run_ranks("cov", lambda i: [out], tmp_path)
    for i in range(2):  # every rank holds the merged result
        got = np.load(f"{out}.p{i}.npz")
        for w, name in zip(want, ("na", "ta", "bc")):
            w = np.asarray(w)
            assert got[name].dtype == w.dtype, name
            np.testing.assert_array_equal(got[name], w, err_msg=(i, name))


# flow -> (pantax-gpu read arguments, CHUNK_BYTES, GROUP_BASES)
FLOWS = {
    "short": (["-s", "--fastpath", "-r", "{short}"], 200_000, 1 << 30),
    # chunks dealt round-robin (about 7 of 200 kB), and two files each
    # sharded: the classification rows come out permuted
    "short_gzip": (["-s", "--fastpath", "-r", "{short_gz}"], 200_000,
                   1 << 30),
    "short_two_files": (["-s", "--fastpath", "-r", "{short}", "{r1}"],
                        200_000, 1 << 30),
    "paired_two_files": (["-s", "-p", "--fastpath", "-r", "{r1}", "{r2}"],
                         100_000, 1 << 30),
    "paired_interleaved": (["-s", "-p", "--fastpath", "-r", "{inter}"],
                           200_000, 1 << 30),
    "long": (["-l", "--fastpath", "-r", "{long}"], 200_000, 16_000),
    # all 16 reads in one group: rank 1 owns none
    "long_rank_without_reads": (["-l", "--fastpath", "-r", "{long}"],
                                200_000, 1 << 30),
}
COMMON = ["--species", "--strain", "--solver", "highs", "--batch-size",
          CLI_BATCH, "-o", "out", "-R", "cls.tsv", "-T", "tmp"]


@pytest.fixture(scope="module")
def read_files(cli_community, tmp_path_factory) -> dict:
    """cli_community's read files, plus ``short_gz``: the single-end reads
    gzipped."""
    gz = tmp_path_factory.mktemp("gz") / "short.fq.gz"
    with open(cli_community.short, "rb") as src, gzip.open(gz, "wb") as dst:
        shutil.copyfileobj(src, dst)
    return dict(vars(cli_community), short_gz=str(gz))


@pytest.fixture(scope="module")
def reference_runs(cli_community, tmp_path_factory):
    """The JAX package's CLI (--mesh off) per read arguments, run once."""
    from pantax_tpu.cli import main as ref_main

    runs = {}

    def get(argv):
        key = tuple(argv)
        if key not in runs:
            wd = tmp_path_factory.mktemp("ref")
            cwd = os.getcwd()
            os.chdir(wd)
            try:
                assert ref_main(["-d", cli_community.db, *argv, *COMMON,
                                 "--mesh", "off"]) == 0
            finally:
                os.chdir(cwd)
            runs[key] = wd
        return runs[key]

    return get


@pytest.mark.parametrize("flow", list(FLOWS))
def test_two_rank_cli_matches_reference(flow, cli_community, read_files,
                                        reference_runs, tmp_path):
    reads, chunk_bytes, group_bases = FLOWS[flow]
    argv = [a.format(**read_files) for a in reads]
    ref = reference_runs(argv)
    runs = [tmp_path / f"rank{i}" for i in range(2)]
    logs = _run_ranks("cli", lambda i: [
        str(runs[i]), str(chunk_bytes), str(group_bases), "-d",
        cli_community.db, *argv, *COMMON], tmp_path)
    assert not any((runs[1] / name).exists() for name in OUTPUTS), logs[1]
    assert "process 0 writes the outputs" in logs[1]
    same = OUTPUTS if flow == "short" else OUTPUTS[:2]
    for name in same:
        assert (runs[0] / name).read_bytes() == (ref / name).read_bytes(), name
    rows = [sorted((d / "cls.tsv").read_text().splitlines())
            for d in (runs[0], ref)]
    assert rows[0] == rows[1]
    assert len(rows[0]) >= (14 if flow.startswith("long") else 4000)
    shares = [ln for ln in logs[1].splitlines() if "reads in its share" in ln]
    owned = int(shares[0].split("process 1: ")[1].split()[0])
    assert (owned == 0) == (flow == "long_rank_without_reads"), shares


def test_distributed_requires_fastpath(cli_community, tmp_path, monkeypatch):
    """The reference's refusal, before any group forms: exit 2."""
    import torch.distributed as dist

    from pantax_tpu_torch import cli

    monkeypatch.chdir(tmp_path)
    assert cli.main(["-d", cli_community.db, "-s", "-r", cli_community.short,
                     "--device", "cpu", "--distributed",
                     "127.0.0.1:1,2,0"]) == 2
    assert not dist.is_initialized()
    assert not os.listdir(tmp_path)
