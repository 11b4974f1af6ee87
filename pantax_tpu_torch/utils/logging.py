"""Progress reporting, the port's copy of ``ProgressMonitor`` from
pantax_tpu/utils/logging.py: log 'x% (done/total)' during long loops
(PanTax's src/task_scheduling.rs:1045-1089 logs every 5% of a build)."""
from __future__ import annotations

import logging

log = logging.getLogger("pantax_tpu_torch")


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
