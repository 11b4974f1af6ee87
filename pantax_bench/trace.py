"""The device trace of a measured window: torch.profiler with CUDA activity
only, read back from its Chrome trace.

Two marker kernels (``torch.cuda._sleep``'s ``spin_kernel``), each
launched right after a synchronize whose host time is taken, tie the
trace's clock to the host's, so that an idle gap can be labelled with the
command-line stage that was running.
"""
from __future__ import annotations

import gzip
import json
import os
import time
from dataclasses import dataclass, field
from pathlib import Path

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
MARKER = "spin_kernel"


@dataclass
class TraceResult:
    window_s: float                    # host seconds between the markers
    busy_s: float                      # union of device intervals
    by_name: dict[str, float]          # device seconds by operation name
    gaps: list[tuple[float, float]]    # idle gaps (host start, seconds)
    n_events: int = 0
    extra: dict = field(default_factory=dict)


class DeviceTrace:
    """``with DeviceTrace(tmp) as t: ...`` profiles the block; ``t.result``
    is its TraceResult after the block."""

    def __init__(self, tmp: Path):
        self.tmp = Path(tmp)
        self.result: TraceResult | None = None

    def _mark(self) -> float:
        import torch

        torch.cuda.synchronize()
        t = time.time()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        return t

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.h0 = self._mark()
        return self

    def __exit__(self, *exc):
        self.h1 = self._mark()
        self.prof.__exit__(*exc)
        if exc[0] is not None:
            return False
        path = self.tmp / "trace.json"
        self.prof.export_chrome_trace(str(path))
        try:
            self.result = read_trace(path, self.h0, self.h1)
        finally:
            os.unlink(path)
        return False


def _load(path: Path) -> dict:
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "rt") as f:
        return json.load(f)


def read_trace(path: Path, h0: float, h1: float) -> TraceResult:
    """Busy time, time by operation and idle gaps of the device events
    between the two markers (whose host times are h0 and h1); a trace
    without both markers is refused (ValueError)."""
    data = _load(path)
    ev = [e for e in data.get("traceEvents", [])
          if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    marks = sorted(e["ts"] for e in ev if MARKER in e.get("name", ""))
    if len(marks) < 2 or marks[-1] <= marks[0]:
        raise ValueError(f"the device trace holds {len(marks)} of its two "
                         f"{MARKER} markers: its clock cannot be tied to "
                         "the host's")
    d0, d1 = marks[0], marks[-1]
    scale = (h1 - h0) / ((d1 - d0) * 1e-6)
    spans, by_name = [], {}
    for e in ev:
        if MARKER in e.get("name", ""):
            continue
        s, d = float(e["ts"]), float(e.get("dur", 0.0))
        if s + d < d0 or s > d1:
            continue
        spans.append((max(s, d0), min(s + d, d1)))
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + d * 1e-6
    spans.sort()
    busy, gaps, cur = 0.0, [], d0
    for s, e in spans:
        if s > cur:
            gaps.append((cur, s - cur))
        if e > cur:
            busy += e - max(s, cur)
            cur = e
    if d1 > cur:
        gaps.append((cur, d1 - cur))

    def host(t_us: float) -> float:
        return h0 + (t_us - d0) * 1e-6 * scale

    return TraceResult(
        window_s=h1 - h0, busy_s=busy * 1e-6 * scale, by_name=by_name,
        gaps=[(host(s), g * 1e-6 * scale) for s, g in gaps],
        n_events=len(spans),
        extra={"device_span_s": (d1 - d0) * 1e-6, "clock_scale": scale})
