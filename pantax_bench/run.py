"""One run of one benchmark cell.

    python -m pantax_bench.run --workload ecoli9.short --seed 7 \\
        --seconds 51 --trace 0

From the root of a checkout.  Data: the configuration's genomes from its
fixed seed, then this run's two sample files and a warm-up sample from
``--seed`` (for long reads the first sample serves as the warm-up),
written under TMPDIR (timed apart from the set-up).  Set-up
(``setup_s``): the port's import and CUDA's start, the database (built
with ``pantax-gpu --create`` and ``--index`` into a fixed directory of the
checkout on the first run there, opened after), ``--index
--warm-kernels``, and one invocation on the warm-up sample.  Window: the
cell's ``pantax-gpu`` invocation, sample after sample, the two files in
turn, until ``--seconds`` have passed; the sample running then finishes
and counts.  Then each invocation's tables are held against the plain
reference (check.py), and the last line of standard output is the
result: with ``--trace 0`` the cell's end-to-end metrics, with ``--trace
1`` its per-layer metrics, read from a torch.profiler trace of the window
and from the port's stage log lines by the readers under ``metrics/``.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import logging
import os
import shutil
import sys
import tempfile
import time
import traceback
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from . import check, gen
from .reference.profile import KmerIndex, reference_profile

PKG = "pantax_bench"
CACHE = ".bench_cache"
# the port's stage_timer line (utils/logging.stage_timer)
STAGE_MSG = "- %s: %.2fs wall, %.2fs cpu"
FORBIDDEN = ("jax", "jaxlib", "flax", "pantax_tpu")


@dataclass
class SampleRun:
    """One timed invocation."""
    index: int
    file_set: int
    start: float
    end: float
    rc: int
    n_reads: int
    bases: int
    read_len: int
    stages: list = field(default_factory=list)  # (name, start, end, seconds)
    launches: dict = field(default_factory=dict)
    out: dict = field(default_factory=dict)

    @property
    def wall(self) -> float:
        return self.end - self.start


@dataclass
class RunRecord:
    """What a per-layer metric's reader reads."""
    samples: list
    trace: object            # trace.TraceResult, or None
    config: dict
    traffic: dict
    peaks: dict | None       # this card's row of peaks.json, or None


class StageLog(logging.Handler):
    """The port's stage_timer records: (name, start, end, seconds)."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.stages = []

    def emit(self, record):
        if record.msg == STAGE_MSG and isinstance(record.args, tuple) \
                and len(record.args) == 3:
            name, wall = record.args[0], float(record.args[1])
            self.stages.append((name, record.created - wall, record.created,
                                wall))


def _load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(root: Path, workload: str) -> dict:
    """The cell's entries and files, found by name."""
    bench = _load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json "
                         f"has {sorted(cells)}")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    e2e = [m for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if workload in m.get("workloads", [workload])
                 and m["moves"] in moved]
    return {
        "cell": cell,
        "config": _load_json(root / configs[cell["config"]]["file"]),
        "traffic": _load_json(root / PKG / "traffic" / f"{cell['traffic']}.json"),
        "workload": _load_json(root / PKG / "workloads" / f"{workload}.json"),
        "end_to_end": e2e,
        "per_layer": per_layer,
    }


def load_reader(root: Path, name: str):
    """metrics/<name>.py's ``read``."""
    path = root / PKG / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"{PKG}_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _cache_env(root: Path) -> None:
    """Every build and kernel cache of the program at a fixed path inside
    the checkout."""
    cache = root / CACHE
    os.environ["PANTAX_TORCH_BUILD"] = str(cache / "build")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "nv")


def forbidden_modules() -> list[str]:
    """Modules in sys.modules whose top-level name is JAX's or the JAX
    package's (compared whole: the port's name begins with the latter)."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def _cli(argv: list[str]) -> int:
    from pantax_tpu_torch import cli

    return cli.main(argv)


def ensure_db(root: Path, name: str, com: gen.Community, dev: list[str],
              say) -> tuple[Path, float]:
    """The configuration's database in the checkout's cache, built on first
    use with the command line's --create and --index; (path, seconds spent
    building, 0 when it was there)."""
    db = root / CACHE / "db" / name
    if (db / "species_range.txt").exists() and (db / "align_index.npz").exists():
        return db, 0.0
    t0 = time.perf_counter()
    part = root / CACHE / "db" / f"{name}.partial"
    shutil.rmtree(part, ignore_errors=True)
    genomes = root / CACHE / "db" / f"{name}.genomes"
    shutil.rmtree(genomes, ignore_errors=True)
    info, gfa = com.write_files(genomes)
    argv = ["-f", str(info), "-d", str(part), "--create", "--base-dir",
            str(genomes), *dev]
    if gfa is not None:
        argv += ["--gfa-dir", str(gfa)]
    for a in (argv, ["-d", str(part), "--index", *dev]):
        rc = _cli(a)
        if rc != 0:
            raise RuntimeError(f"pantax-gpu {' '.join(a)} exited {rc}")
    shutil.rmtree(db, ignore_errors=True)
    os.replace(part, db)
    shutil.rmtree(genomes, ignore_errors=True)
    seconds = time.perf_counter() - t0
    say(f"first run in this checkout: built database {name} in {seconds:.3f} s")
    return db, seconds


def _sync(chip: bool) -> None:
    if chip:
        import torch

        torch.cuda.synchronize()


def _launches() -> dict:
    from pantax_tpu_torch.ops import extend

    return dict(extend.LAUNCHES)


def _outputs(out_dir: Path) -> dict[str, Path]:
    return {"cls": out_dir / "cls.tsv",
            "species": out_dir / "s_species_abundance.txt",
            "strain": out_dir / "s_strains_abundance.txt"}


def invoke(argv: list[str], k: int, fs: int, sample: gen.Sample, tmp: Path,
           db: Path, chip: bool, stage_log: StageLog) -> SampleRun:
    """One timed ``pantax-gpu`` invocation over ``sample``."""
    out_dir = tmp / f"out{k}"
    out_dir.mkdir()
    full = [*argv, "-d", str(db), "-r", *map(str, sample.files),
            "-T", str(tmp / f"T{k}"), "-o", str(out_dir / "s"),
            "-R", str(out_dir / "cls.tsv")]
    before = _launches()
    n0 = len(stage_log.stages)
    start = time.time()
    try:
        rc = _cli(full)
    except Exception:  # the run goes on; the sample counts as failed
        traceback.print_exc()
        rc = -1
    _sync(chip)
    end = time.time()
    after = _launches()
    return SampleRun(
        index=k, file_set=fs, start=start, end=end, rc=rc,
        n_reads=sample.n_reads, bases=sample.bases,
        read_len=sample.bases // max(sample.n_reads, 1),
        stages=list(stage_log.stages[n0:]),
        launches={n: after[n] - before.get(n, 0) for n in after
                  if after[n] - before.get(n, 0)},
        out=_outputs(out_dir))


def device_info(chip: bool) -> dict:
    if not chip:
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(0))}


def origin_gap(strain_cov: dict, species_cov: dict, sample: gen.Sample,
               com: gen.Community) -> float:
    """The widest gap between a strain's coverage over its species' (both
    from ``species_cov``'s side: the reference's) and the share of its
    species' reads the simulator drew from it: the simulated truth, which
    no metric reads."""
    gap = 0.0
    for sp in sorted(set(com.hap_species)):
        haps = [h for h, s in enumerate(com.hap_species) if s == sp]
        drawn = sample.origins[haps].sum()
        if not drawn or not species_cov.get(sp):
            continue
        for h in haps:
            got = strain_cov.get(com.hap_names[h], 0.0) / species_cov[sp]
            gap = max(gap, abs(got - sample.origins[h] / drawn))
    return gap


def _breakdown(tr, samples: list[SampleRun]) -> dict:
    ops = sorted(tr.by_name.items(), key=lambda kv: -kv[1])[:10]
    labelled = []
    for start, g in sorted(tr.gaps, key=lambda x: -x[1])[:10]:
        labelled.append([stage_at(start + g / 2, samples), g])
    return {"device_ops": [[n[:160], s] for n, s in ops],
            "idle_gaps": labelled}


def stage_at(t: float, samples: list[SampleRun]) -> str:
    """The innermost command-line stage running at host time t."""
    for s in samples:
        if s.start <= t <= s.end:
            inside = [st for st in s.stages if st[1] <= t <= st[2]]
            if inside:
                return min(inside, key=lambda st: st[3])[0]
            return "pantax-gpu outside its stages"
    return "harness between samples"


def main(argv: list[str] | None = None, *, root: Path | None = None,
         chip: bool = True) -> int:
    p = argparse.ArgumentParser(prog="python -m pantax_bench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    root = Path(root or os.getcwd()).resolve()

    def say(msg: str) -> None:
        print(msg, flush=True)

    spec = load_cell(root, args.workload)
    if chip:
        import torch

        need = spec["cell"]["chips"]
        if not torch.cuda.is_available() or torch.cuda.device_count() < need:
            print(f"pantax_bench: needs {need} CUDA device(s); found "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2
    if importlib.util.find_spec("pantax_tpu_torch") is None:
        print("pantax_bench: the port (pantax_tpu_torch) is not importable "
              f"from {root}", file=sys.stderr)
        return 2
    _cache_env(root)
    dev = [] if chip else ["--device", "cpu"]
    tmp = Path(tempfile.mkdtemp(prefix="pantax_bench_"))
    try:
        return _run(args, spec, root, tmp, chip, dev, say)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _run(args, spec, root: Path, tmp: Path, chip: bool, dev: list[str],
         say) -> int:
    config, traffic, wl = spec["config"], spec["traffic"], spec["workload"]
    # data: genomes from the configuration's seed, samples from the run's
    t0 = time.perf_counter()
    com = gen.community(config)
    seeds = np.random.SeedSequence(args.seed).spawn(3)
    samples = [gen.make_sample(traffic, com, seeds[i], traffic["n_reads"],
                               tmp, f"sample{i}") for i in range(2)]
    # the warm-up sample: a draw of its own of warm_reads reads, or, where
    # the traffic sets warm_on_sample, the window's first sample (a long
    # read sample's first full-size pass pays for first use of its size)
    warm = samples[0] if traffic.get("warm_on_sample") else gen.make_sample(
        traffic, com, seeds[2], traffic["warm_reads"], tmp, "warm")
    say(f"data: genomes and samples made in {time.perf_counter() - t0:.3f} s "
        f"({samples[0].n_reads} reads, {samples[0].bases} bases a sample)")

    # set-up
    t_setup = time.perf_counter()
    t0 = time.perf_counter()
    from pantax_tpu_torch import cli  # noqa: F401  (the port's import)

    if chip:
        import torch

        torch.cuda.init()
        torch.zeros(1, device="cuda")
        torch.cuda.synchronize()
    t_import = time.perf_counter() - t0
    db, t_build = ensure_db(root, spec["cell"]["config"], com, dev, say)
    t0 = time.perf_counter()
    rc = _cli(["-d", str(db), "--index", "--warm-kernels", *dev,
               *traffic.get("warm_kernels_argv", [])])
    if rc != 0:
        print(f"pantax_bench: --warm-kernels exited {rc}", file=sys.stderr)
        return 1
    t_warm_kernels = time.perf_counter() - t0
    stage_log = StageLog()
    plog = logging.getLogger("pantax_tpu_torch")
    plog.addHandler(stage_log)
    argv = [*traffic["argv"], *dev]
    t0 = time.perf_counter()
    w = invoke(argv, -1, 2, warm, tmp, db, chip, stage_log)
    if w.rc != 0:
        print(f"pantax_bench: the warm-up invocation exited {w.rc}",
              file=sys.stderr)
        return 1
    shutil.rmtree(tmp / "out-1", ignore_errors=True)
    t_warm = time.perf_counter() - t0
    setup_s = time.perf_counter() - t_setup
    say(f"set-up {setup_s:.3f} s: import and device {t_import:.3f}, database "
        f"build {t_build:.3f}, --warm-kernels {t_warm_kernels:.3f}, warm-up "
        f"invocation {t_warm:.3f}")

    # the window
    runs: list[SampleRun] = []
    tracer = None
    if args.trace:
        if chip:
            from .trace import DeviceTrace

            tracer = DeviceTrace(tmp)
            tracer.__enter__()
    w0 = time.time()
    try:
        k = 0
        while True:
            runs.append(invoke(argv, k, k % 2, samples[k % 2], tmp, db, chip,
                               stage_log))
            k += 1
            if runs[-1].end - w0 >= args.seconds:
                break
    finally:
        if tracer is not None:
            try:
                tracer.__exit__(*sys.exc_info())
            except ValueError as e:
                print(f"pantax_bench: {e}", file=sys.stderr)
                return 1
    w1 = runs[-1].end
    plog.removeHandler(stage_log)
    device = device_info(chip)
    for r in runs:
        stages = "; ".join(f"{n} {s:.3f}" for n, _, _, s in r.stages)
        say(f"sample {r.index} (file {r.file_set}): {r.wall:.3f} s, rc "
            f"{r.rc}; {stages}; launches {r.launches}")
    walls = [r.wall for r in runs]
    say(f"window {w1 - w0:.3f} s, {len(runs)} samples, largest sample "
        f"{max(walls):.3f} s")

    # the outputs against the reference
    t0 = time.perf_counter()
    hap_species = dict(zip(com.hap_names, com.hap_species))
    genomes = [com.genome(h) for h in range(len(com.hap_names))]
    index = KmerIndex(genomes)
    long_reads = traffic["kind"] == "long"
    refs = {}
    for fs in sorted({r.file_set for r in runs}):
        refs[fs] = reference_profile(
            samples[fs].files, com.hap_names, com.hap_species, genomes,
            long_reads=long_reads, em_sample=wl["em_sample"],
            seed=np.random.SeedSequence([args.seed, 7, fs]), index=index)
    for fs, ref in refs.items():
        say(f"file {fs}: the reference's widest strain gap against the "
            f"simulated origins {origin_gap(ref.strain_cov, ref.species_cov, samples[fs], com):.6g} "
            "(not a metric)")
    worst = {n: 0.0 for n in check.NUMBERS}
    for r in runs:
        got = check.compare_outputs(refs[r.file_set], r.out, hap_species)
        for n in check.NUMBERS:
            worst[n] = max(worst[n], got[n])
        try:
            prog = check.read_table(r.out["strain"], "genome_ID")
            say(f"sample {r.index}: {len(prog)} strains reported, widest "
                "strain gap against the simulated origins "
                f"{origin_gap(prog, refs[r.file_set].species_cov, samples[r.file_set], com):.6g}"
                " (not a metric); "
                + ", ".join(f"{n} {got[n]:.6g}" for n in check.NUMBERS))
        except (OSError, KeyError, ValueError) as e:
            say(f"sample {r.index}: no strain table ({e})")
        shutil.rmtree(r.out["cls"].parent, ignore_errors=True)
    say(f"reference and comparison {time.perf_counter() - t0:.3f} s; "
        + "; ".join(f"file {fs}: {p.n_placed} of {p.n_reads} reads placed"
                    for fs, p in refs.items()))
    limits = wl["limits"]
    failed = sum(r.rc != 0 for r in runs)
    correct = failed == 0 and all(worst[n] <= limits[n] for n in check.NUMBERS)

    result = {"correct": bool(correct), "attempted": len(runs),
              "failed": failed}
    if args.trace:
        tr = tracer.result if tracer is not None else None
        peaks = _load_json(root / PKG / "peaks.json").get(device["kind"])
        rec = RunRecord(runs, tr, config, traffic, peaks)
        metrics = {}
        for m in spec["per_layer"]:
            v = load_reader(root, m["name"])(rec)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        if tr is not None:
            device["busy_s"] = tr.busy_s
            device["window_s"] = tr.window_s
            say(f"trace: {tr.n_events} device events, {tr.extra}")
            result["breakdown"] = _breakdown(tr, runs)
    else:
        bases = sum(r.bases for r in runs if r.rc == 0)
        metrics = {"profiled_Mb_per_s": {"value": bases / (w1 - w0) / 1e6,
                                         "unit": "Mb/s"},
                   "setup_s": {"value": setup_s, "unit": "s"}}
        metrics = {m["name"]: metrics[m["name"]] for m in spec["end_to_end"]
                   if m["name"] in metrics}
    # last before the result: whatever the port, the harness or a reader
    # loaded in this process
    loaded = forbidden_modules()
    if loaded:
        print(f"pantax_bench: the run loaded {', '.join(loaded)}",
              file=sys.stderr)
        return 3
    result["metrics"] = metrics
    result["device"] = device
    result["checks"] = {n: {"value": worst[n], "limit": limits[n]}
                        for n in check.NUMBERS}
    for n in check.NUMBERS:
        print(f"check {n}: {worst[n]!r} limit {limits[n]!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
