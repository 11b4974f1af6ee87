"""pantax_tpu_torch/bench.py against the repository's bench.py (CPU).

For each configuration both drivers run with the same recording stubs in
place of their runners and scale_db (bench.py loaded by path with its
PANTAX_TPU_BENCH_* environment): the port calls the same runners with the
same arguments (bound to the reference's signatures, defaults applied;
``device`` and ``stage_out`` are the port's own keywords), and its JSON
line equals bench.py's key for key but the metric's ``_per_chip``, which
reads ``_per_gpu``.  Then one real ``scale`` run on a small community
through the plain DPs, and the card required by default."""
import functools
import importlib.util
import inspect
import json
import os
import subprocess
import sys

import pytest
import torch

import pantax_tpu.benchmarks as ref_bench
import pantax_tpu.utils
import pantax_tpu.utils.logging
from pantax_tpu_torch import bench
from pantax_tpu_torch import benchmarks as port_bench

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
# PANTAX_TPU_BENCH_SCALE for each of the port's --config values
SCALE = {"scale": "1", "community102": "2", "mixed": "5", "long": "long"}
# the runners' dicts, with the keys bench.py reads (numbers of many digits,
# so that both drivers' rounding is seen)
RESULTS = {
    "run_alignment_benchmark": dict(
        reads_per_s=2393615.1234567, aligned_frac=0.99983123,
        species_acc=0.9999871, wall_s=9.5123456, wall_reads_per_s=103456.789,
        total_reads=983040),
    "run_e2e_benchmark": dict(
        e2e_reads_per_s=544218.44444, align_reads_per_s=2325581.3953,
        align_s=0.43012345, profile_s=1.40654321, wall_s=1.83666666,
        total_reads=1000000, aligned_frac=0.99981, strains_detected=30),
    "run_long_e2e_benchmark": dict(
        total_reads=100000, total_bases=819200000, wall_s=9.14456789,
        align_s=7.99012345, profile_s=1.15444444, reads_per_s=10935.3456789,
        bases_per_s=89583950.12345, aligned_frac=0.99999, strains_detected=30),
    "run_mixed_benchmark": dict(
        total_reads=10000000, reads_per_s=456789.0123456,
        short_reads_per_s=612345.6789012, long_reads_per_s=11111.1111111,
        short_s=16.1672345, long_s=8.99998765, short_aligned_frac=0.99978,
        long_aligned_frac=0.99995, strains_detected=102),
}
REF_SIGS = {name: inspect.signature(getattr(ref_bench, name))
            for name in (*RESULTS, "scale_db")}
DB = object()  # what both scale_db stubs return


class Recorder:
    """The same stubs for both drivers: each call is recorded as (name,
    arguments bound to the reference's signature with its defaults, the
    port's own keywords apart)."""

    def __init__(self):
        self.calls, self.port_kw = [], []

    def stub(self, name):
        def fn(*args, **kw):
            self.port_kw.append((name, {k: kw.pop(k) for k in
                                        ("device", "stage_out") if k in kw}))
            bound = REF_SIGS[name].bind(*args, **kw)
            bound.apply_defaults()
            self.calls.append((name, dict(bound.arguments)))
            return DB if name == "scale_db" else dict(RESULTS[name])
        return fn


def _reference_record(config, batch, db_dir, monkeypatch, capsys):
    rec = Recorder()
    for name in REF_SIGS:
        monkeypatch.setattr(ref_bench, name, rec.stub(name))
    monkeypatch.setattr(pantax_tpu.utils, "enable_compilation_cache",
                        lambda: None)
    monkeypatch.setattr(pantax_tpu.utils.logging, "setup_logging",
                        lambda *a, **k: None)
    monkeypatch.setenv("PANTAX_TPU_BENCH_SCALE", SCALE[config])
    monkeypatch.setenv("PANTAX_TPU_BENCH_BATCH", str(batch))
    monkeypatch.setenv("PANTAX_TPU_SCALE_DIR", db_dir)
    monkeypatch.setenv("PANTAX_TPU_SCALE2_DIR", db_dir)
    spec = importlib.util.spec_from_file_location(
        "_reference_bench", os.path.join(REPO, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.main()
    return rec, json.loads(capsys.readouterr().out.splitlines()[-1])


@pytest.mark.parametrize("config", list(SCALE))
def test_config_calls_bench_py_runners(config, monkeypatch, capsys, tmp_path):
    batch, db_dir = 4096, str(tmp_path / "db")
    ref_rec, want = _reference_record(config, batch, db_dir, monkeypatch,
                                      capsys)
    rec = Recorder()
    for name in REF_SIGS:
        monkeypatch.setattr(bench, name, rec.stub(name))
    got = bench.main(["--config", config, "--batch", str(batch),
                      "--db-dir", db_dir, "--device", "cpu"])
    out = capsys.readouterr()
    assert rec.calls == ref_rec.calls
    assert [c[0] for c in rec.calls][0] == "scale_db"
    # every runner on the CPU as asked; the timed profile's stage dict
    for name, kw in rec.port_kw[1:]:
        assert kw.pop("device") == CPU
        assert kw == ({} if name == "run_alignment_benchmark"
                      else {"stage_out": {}})
    assert out.out.splitlines() == [json.dumps(got)]
    assert got["metric"].endswith("_per_gpu")
    assert want["metric"].endswith("_per_chip")
    assert got == dict(want, metric=want["metric"][:-len("_per_chip")]
                       + "_per_gpu")
    assert list(got) == list(want)
    # bench.py's summary line, then the port's stderr lines
    summary = out.err.splitlines()[0]
    assert summary.startswith(("# scale:", "# mixed:", "# long e2e:"))
    assert "# launches: " in out.err and "# memory: " in out.err


def test_main_scale_on_cpu(tmp_path, monkeypatch, capsys):
    """One real scale run on a 2 species x 2 strains x 50 kb community
    (its cache at --db-dir), the read count cut: the plain DPs run, K1
    never; one stdout line, the record main returns."""
    port_bench.scale_db(tmp_path / "db", n_species=2, strains_per=2,
                        genome_len=50_000, snp_rate=0.01, seed=5)
    monkeypatch.setitem(bench.CONFIGS, "scale",
                        functools.partial(bench.bench_scale, n_reads=4096))
    rec = bench.main(["--config", "scale", "--device", "cpu", "--batch",
                      "1024", "--db-dir", str(tmp_path / "db")])
    out = capsys.readouterr()
    assert out.out.splitlines() == [json.dumps(rec)]
    assert rec["metric"] == "scale_1M_reads_aligned_per_sec_per_gpu"
    assert rec["value"] > 0 and rec["unit"] == "reads/s"
    assert abs(rec["vs_baseline"] - rec["value"] / 2500.0) < 1e-3
    lines = {ln.split(":", 1)[0]: ln.split(": ", 1)[1]
             for ln in out.err.splitlines() if ln.startswith("# ")}
    launches = json.loads(lines["# launches"])
    assert launches["banded_extend"] == 0
    assert launches["banded_extend_plain"] > 0
    results = json.loads(lines["# results"])
    assert results["alignment"]["aligned_frac"] > 0.99
    assert results["alignment"]["species_acc"] > 0.99
    assert results["e2e"]["strains_detected"] == 4
    splits = json.loads(lines["# splits"])
    assert {"align_cover_s", "species_s", "strain_s", "report_s",
            "classify_tsv_s", "n_batches", "n_aligned"} <= set(splits)
    assert splits["n_batches"] == 4 and splits["n_aligned"] > 4000


@pytest.mark.parametrize("config", list(SCALE))
def test_main_needs_a_card_by_default(config, monkeypatch, tmp_path):
    """Without --device the driver asks for the card and raises where there
    is none, before any work (no database is built); never a CPU run."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench.main(["--config", config, "--db-dir", str(tmp_path / "db")])
    assert not os.listdir(tmp_path)


def test_module_without_a_card_exits_non_zero(tmp_path):
    """python -m pantax_tpu_torch.bench where torch sees no GPU: a non-zero
    exit and no record on stdout."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([REPO,
                                           os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run(
        [sys.executable, "-m", "pantax_tpu_torch.bench", "--db-dir",
         str(tmp_path / "db")],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout == ""
    assert "CUDA is not available" in proc.stderr
    assert not os.path.exists(tmp_path / "db")
