"""The harness end to end on a tiny configuration, the port on the CPU
(``--device cpu`` in its argv), and the harness's refusals."""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest

from pantax_bench import run
from pantax_bench.tests.tiny import CELLS

REPO = Path(__file__).resolve().parents[2]
PER_LAYER_HOST = ("cli.prep_s", "cli.unstaged_s", "fused.align_cover_s",
                  "profile.profile_s")


def _result(capsys) -> dict:
    out = capsys.readouterr().out.strip().splitlines()
    return json.loads(out[-1])


@pytest.mark.parametrize("cell", [c[0] for c in CELLS])
def test_cell_end_to_end(tiny_root, capsys, cell):
    assert run.main(["--workload", cell, "--seed", str(2**31 + 12345),
                     "--seconds", "1", "--trace", "0"],
                    root=tiny_root, chip=False) == 0
    res = _result(capsys)
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] >= 1
    assert set(res["metrics"]) == {"profiled_Mb_per_s", "setup_s"}
    assert all(v["value"] > 0 for v in res["metrics"].values())
    assert list(res)[-1] == "checks"
    assert set(res["checks"]) == {"cls_mismatch", "species_cov_gap",
                                  "strain_cov_gap"}


def test_traced_run_reports_per_layer(tiny_root, capsys):
    assert run.main(["--workload", "tinyscale.short", "--seed", "7",
                     "--seconds", "1", "--trace", "1"],
                    root=tiny_root, chip=False) == 0
    res = _result(capsys)
    assert res["correct"] is True
    # no card: the trace's metrics find nothing to read and are left out
    assert set(res["metrics"]) == set(PER_LAYER_HOST)
    assert all(v["value"] > 0 for v in res["metrics"].values())


def test_same_seed_same_inputs(tiny_root, tmp_path):
    from pantax_bench import gen

    spec = run.load_cell(tiny_root, "tinyscale.short")
    com = gen.community(spec["config"])
    files = []
    for d in ("a", "b"):
        (tmp_path / d).mkdir()
        s = gen.make_sample(spec["traffic"], com, 2**33 + 5, 500,
                            tmp_path / d, "s")
        files.append(s.files[0].read_bytes())
    assert files[0] == files[1]


def test_refuses_without_a_card():
    """No CUDA device: a non-zero exit and no result line."""
    p = subprocess.run(
        [sys.executable, "-m", "pantax_bench.run", "--workload",
         "ecoli9.short", "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert p.returncode != 0
    assert not p.stdout.strip()
    assert "CUDA" in p.stderr


def test_unknown_workload_refused(tiny_root):
    with pytest.raises(SystemExit):
        run.main(["--workload", "nope", "--seed", "1", "--seconds", "1"],
                 root=tiny_root, chip=False)


@pytest.mark.cuda
def test_cell_on_the_card(cuda_card, tmp_path):
    """One short run of the headline cell through the benchmark's command,
    from the repository root."""
    p = subprocess.run(
        [sys.executable, "-m", "pantax_bench.run", "--workload",
         "ecoli9.short", "--seed", "99", "--seconds", "5", "--trace", "0"],
        cwd=REPO, capture_output=True, text=True, timeout=1200)
    assert p.returncode == 0, p.stderr[-4000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"] is True
    assert res["device"]["platform"] == "gpu"
