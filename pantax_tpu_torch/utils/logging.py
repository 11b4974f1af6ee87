"""Logging, stage timing, device tracing and progress reporting, the port's
counterpart of pantax_tpu/utils/logging.py.

Parity with the reference's observability (SURVEY.md §5):
  - flexi_logger-style dual sink: log file ``pantax_tpu_<discriminant>.log``
    (the reference's name, so users' scripts still find it) plus stderr
    (main.rs:278-296);
  - wall + CPU time per stage (profile.rs:3326-3433);
  - percentage progress during long loops (task_scheduling.rs:1045-1089:
    every 5% for builds; profile.rs:3310-3315: every 10 species).
``device_trace`` writes a torch.profiler Chrome trace of a stage.
"""
from __future__ import annotations

import logging
import os
import sys
import time
from contextlib import contextmanager

log = logging.getLogger("pantax_tpu_torch")


def setup_logging(
    log_dir: str | os.PathLike | None = None,
    discriminant: str | None = None,
    verbose: bool = False,
) -> None:
    root = logging.getLogger()
    root.setLevel(logging.DEBUG if verbose else logging.INFO)
    fmt = logging.Formatter("%(asctime)s [%(levelname)s] %(name)s: %(message)s")
    for h in list(root.handlers):
        root.removeHandler(h)
    sh = logging.StreamHandler(sys.stderr)
    sh.setFormatter(fmt)
    root.addHandler(sh)
    if log_dir is not None:
        os.makedirs(log_dir, exist_ok=True)
        name = f"pantax_tpu_{discriminant}.log" if discriminant else "pantax_tpu.log"
        fh = logging.FileHandler(os.path.join(os.fspath(log_dir), name))
        fh.setFormatter(fmt)
        fh.setLevel(logging.DEBUG)
        root.addHandler(fh)


@contextmanager
def stage_timer(name: str, logger: logging.Logger = log):
    """Log wall-clock and CPU time of a pipeline stage."""
    t0 = time.time()
    c0 = time.process_time()
    try:
        yield
    finally:
        logger.info(
            "- %s: %.2fs wall, %.2fs cpu", name, time.time() - t0,
            time.process_time() - c0,
        )


@contextmanager
def device_trace(trace_dir: str | os.PathLike | None):
    """torch.profiler over the CPU and, where there is a card, CUDA
    activities; writes ``trace.json`` (Chrome trace format) into
    ``trace_dir``.  ``with device_trace('/tmp/trace'): ...``"""
    if trace_dir is None:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    path = os.path.join(os.fspath(trace_dir), "trace.json")
    prof.export_chrome_trace(path)
    log.info("device trace written to %s", path)


class ProgressMonitor:
    """Log 'x% (done/total)' every `step_pct` percent."""

    def __init__(self, total: int, name: str, step_pct: float = 5.0,
                 logger: logging.Logger = log):
        self.total = max(total, 1)
        self.name = name
        self.step = step_pct
        self.done = 0
        self.failed = 0
        self._next = step_pct
        self.logger = logger

    def update(self, ok: bool = True) -> None:
        self.done += 1
        if not ok:
            self.failed += 1
        pct = 100.0 * self.done / self.total
        if pct >= self._next or self.done == self.total:
            self.logger.info(
                "%s: %.0f%% (%d/%d%s)", self.name, pct, self.done, self.total,
                f", {self.failed} failed" if self.failed else "",
            )
            while self._next <= pct:
                self._next += self.step
