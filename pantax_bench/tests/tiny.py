"""A tiny benchmark tree for the CPU tests: BENCHMARK.json and the data
files of small cells, beside copies of the package's metric readers and
peaks table, under a directory that run.main takes as its root."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

PKG = Path(__file__).resolve().parents[1]

CONFIGS = {
    "tinyscale": {"genomes": {"generator": "snp", "n_species": 3,
                              "strains_per": 3, "genome_len": 40000,
                              "snp_rate": 0.01, "seed": 7},
                  "align_short": {"max_candidates": 2, "extension_band": 4}},
}
TRAFFIC = {
    "short": {"kind": "short", "n_reads": 24000, "read_len": 150,
              "sub_rate": 0.01, "indel_rate": 0.0005,
              "strain_weights": [1, 3, 9], "warm_reads": 2048,
              "argv": ["-s", "--fastpath", "--species", "--strain",
                       "--batch-size", "4096"],
              "warm_kernels_argv": ["--batch-size", "4096"]},
    "paired": {"kind": "paired", "n_reads": 6000, "mate_len": 150,
               "sub_rate": 0.01, "indel_rate": 0.0005,
               "strain_weights": [1, 3, 9], "warm_reads": 1024,
               "argv": ["-s", "-p", "--fastpath", "--batch-size", "2048"],
               "warm_kernels_argv": ["--batch-size", "2048"]},
    "hifi": {"kind": "long", "n_reads": 300, "read_len": 4096,
             "sub_rate": 0.004, "ins_rate": 0.003, "del_rate": 0.003,
             "strain_weights": [1, 3, 9], "warm_on_sample": True,
             "argv": ["-l", "--long-read-type", "hifi", "--fastpath",
                      "--batch-size", "1024"],
             "warm_kernels_argv": ["-l", "--long-read-type", "hifi",
                                   "--batch-size", "1024"]},
}
LIMITS = {"cls_mismatch": 0.01, "species_cov_gap": 0.05,
          "strain_cov_gap": 0.1}
# the short cell's sound runs read strain_cov_gap 0.016-0.072 on five
# seeds and 0.16 with its minor strains swapped; the tiny HiFi and paired
# cells' coverage is lower
LONG_LIMITS = {**LIMITS, "strain_cov_gap": 0.2}
CELLS = [("tinyscale.short", "tinyscale", "short"),
         ("tinyscale.paired", "tinyscale", "paired"),
         ("tinyscale.hifi", "tinyscale", "hifi")]


def write_tree(root: Path, cells=CELLS) -> Path:
    """The tiny tree under ``root``; returns root."""
    pkg = root / "pantax_bench"
    for sub in ("configs", "traffic", "workloads"):
        (pkg / sub).mkdir(parents=True, exist_ok=True)
    shutil.copytree(PKG / "metrics", pkg / "metrics", dirs_exist_ok=True)
    shutil.copy(PKG / "peaks.json", pkg / "peaks.json")
    for name, cfg in CONFIGS.items():
        (pkg / "configs" / f"{name}.json").write_text(json.dumps(cfg))
    for name, tr in TRAFFIC.items():
        (pkg / "traffic" / f"{name}.json").write_text(json.dumps(tr))
    for name, _, traffic in cells:
        em = 200 if traffic == "hifi" else 3000
        (pkg / "workloads" / f"{name}.json").write_text(
            json.dumps({"em_sample": em,
                        "limits": LIMITS if traffic == "short" else LONG_LIMITS}))
    bench = json.loads((PKG.parent / "BENCHMARK.json").read_text())
    bench["configs"] = [{"name": n, "source": "tiny", "reduced": [],
                         "file": f"pantax_bench/configs/{n}.json", "why": "tiny"}
                        for n in CONFIGS]
    bench["workloads"] = [{"name": n, "config": c, "traffic": t, "chips": 1,
                           "why": "tiny"} for n, c, t in cells]
    names = [n for n, _, _ in cells]
    for m in bench["per_layer"]:
        m["workloads"] = names
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root
