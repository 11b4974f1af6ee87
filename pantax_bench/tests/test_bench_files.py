"""A cell and a per-layer metric added as files and BENCHMARK.json
entries only: the harness finds both by name."""
from __future__ import annotations

import json

from pantax_bench import run
from pantax_bench.tests.tiny import LIMITS, write_tree


def test_added_cell_and_metric(tmp_path, capsys):
    root = write_tree(tmp_path)
    pkg = root / "pantax_bench"
    (pkg / "metrics" / "cli.samples_n.py").write_text(
        "def read(run):\n    return float(len(run.samples))\n")
    (pkg / "workloads" / "tinyscale.short2.json").write_text(
        json.dumps({"em_sample": 2000, "limits": LIMITS}))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "tinyscale.short2", "config": "tinyscale",
                               "traffic": "short", "chips": 1, "why": "added"})
    bench["per_layer"].append({
        "name": "cli.samples_n", "unit": "n", "better": "higher",
        "source": "program_counter", "layer": "CLI driver",
        "moves": "profiled_Mb_per_s", "workloads": ["tinyscale.short2"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    assert run.main(["--workload", "tinyscale.short2", "--seed", "11",
                     "--seconds", "1", "--trace", "1"], root=root,
                    chip=False) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["metrics"]["cli.samples_n"]["value"] >= 1
    assert res["correct"] is True
