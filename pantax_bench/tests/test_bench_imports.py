"""Nothing the harness or its reference loads is JAX or the JAX package
(top-level names compared whole), and the reference loads nothing of the
port."""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
FORBIDDEN = {"jax", "jaxlib", "flax", "pantax_tpu"}


def _top_level(code: str) -> set[str]:
    p = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert p.returncode == 0, p.stderr[-3000:]
    return set(json.loads(p.stdout.strip().splitlines()[-1]))


def test_reference_loads_nothing_of_the_port():
    mods = _top_level("import pantax_bench.reference, pantax_bench.check")
    assert not mods & (FORBIDDEN | {"pantax_tpu_torch", "torch"})


def test_a_harness_run_loads_no_jax(tmp_path):
    code = (
        "from pathlib import Path\n"
        "from pantax_bench import run, control, sets, trace\n"
        "from pantax_bench.tests.tiny import write_tree\n"
        f"root = write_tree(Path({str(tmp_path)!r}))\n"
        "rc = run.main(['--workload', 'tinyscale.short', '--seed', '3',"
        " '--seconds', '1', '--trace', '1'], root=root, chip=False)\n"
        "assert rc == 0\n")
    mods = _top_level(code)
    assert "pantax_tpu_torch" in mods
    assert not mods & FORBIDDEN


def test_a_reader_that_loads_jax_refuses_the_result(tmp_path):
    """A per-layer reader that imports a module named jax: the run exits
    non-zero, prints no result, and names the module."""
    from pantax_bench.tests.tiny import write_tree

    stub = tmp_path / "stub"
    (stub / "jax").mkdir(parents=True)
    (stub / "jax" / "__init__.py").write_text("")
    root = write_tree(tmp_path / "tree")
    (root / "pantax_bench" / "metrics" / "stub.loads_jax.py").write_text(
        f"import sys\nsys.path.insert(0, {str(stub)!r})\nimport jax\n\n\n"
        "def read(run):\n    return 1.0\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["per_layer"].append({
        "name": "stub.loads_jax", "unit": "s", "better": "lower",
        "source": "program_span", "layer": "Stub",
        "moves": "profiled_Mb_per_s", "workloads": ["tinyscale.short"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    code = ("import sys\nfrom pathlib import Path\nfrom pantax_bench import run\n"
            "sys.exit(run.main(['--workload', 'tinyscale.short', '--seed', '3',"
            f" '--seconds', '1', '--trace', '1'], root=Path({str(root)!r}),"
            " chip=False))\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=600,
                       env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert p.returncode != 0
    assert '"correct"' not in p.stdout
    assert "the run loaded jax" in p.stderr.splitlines()[-1]
