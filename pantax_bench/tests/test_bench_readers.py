"""The per-layer readers and the trace reduction on canned records."""
from __future__ import annotations

import json
from pathlib import Path

import pytest

from pantax_bench import run, trace

PKG = Path(__file__).resolve().parents[1]


def _sample(start, stages, **kw):
    base = dict(index=0, file_set=0, start=start, end=start + 10.0, rc=0,
                n_reads=1000, bases=150000, read_len=150)
    base.update(kw)
    return run.SampleRun(stages=stages, **base)


def _stages(t0):
    # (name, start, end, seconds) as run.StageLog records them
    return [("aligner (seed lookup, index tables on the device)", t0 + 0.5, t0 + 1.0, 0.5),
            ("fused tables", t0 + 1.0, t0 + 3.0, 2.0),
            ("alignment+coverage (fused)", t0 + 3.0, t0 + 6.0, 3.0),
            ("profiling", t0 + 6.0, t0 + 9.0, 3.0)]


def _reader(name):
    return run.load_reader(PKG.parent, name)


def test_stage_readers():
    rec = run.RunRecord([_sample(0.0, _stages(0.0)), _sample(20.0, _stages(20.0))],
                        None, {}, {}, None)
    assert _reader("cli.prep_s")(rec) == pytest.approx(2.5)
    assert _reader("fused.align_cover_s")(rec) == pytest.approx(3.0)
    assert _reader("profile.profile_s")(rec) == pytest.approx(3.0)
    # 10 s of wall, 8.5 covered by the stage lines
    assert _reader("cli.unstaged_s")(rec) == pytest.approx(1.5)
    # nothing to read: no value, never 0
    empty = run.RunRecord([_sample(0.0, [])], None, {}, {}, None)
    assert _reader("cli.prep_s")(empty) is None
    assert _reader("device.idle_share")(empty) is None
    assert _reader("kernel.k1_roofline")(empty) is None


def test_stage_log_takes_the_port_stage_lines():
    import logging

    from pantax_tpu_torch.utils.logging import stage_timer

    h = run.StageLog()
    log = logging.getLogger("pantax_tpu_torch")
    level = log.level
    log.setLevel(logging.INFO)  # as the command line's setup_logging does
    log.addHandler(h)
    try:
        with stage_timer("fused tables"):
            pass
        log.info("- Aligned %d reads", 5)
    finally:
        log.removeHandler(h)
        log.setLevel(level)
    assert [s[0] for s in h.stages] == ["fused tables"]
    name, start, end, secs = h.stages[0]
    assert end - start == pytest.approx(secs)


def _chrome(tmp_path, events, base=None):
    data = {"traceEvents": events}
    if base is not None:
        data["baseTimeNanoseconds"] = base
    path = tmp_path / "t.json"
    path.write_text(json.dumps(data))
    return path


def _k(name, ts, dur, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_trace_busy_gaps_and_markers(tmp_path):
    ev = [_k("spin_kernel", 1000.0, 1.0),
          _k("banded_extend_kernel<4>", 2000.0, 500.0),
          _k("banded_extend_kernel<4>", 2300.0, 500.0),   # overlaps the first
          _k("Memcpy HtoD", 5000.0, 1000.0, "gpu_memcpy"),
          _k("cpu_op", 5000.0, 9000.0, "cpu_op"),         # not a device event
          _k("spin_kernel", 11000.0, 1.0)]
    tr = trace.read_trace(_chrome(tmp_path, ev), 100.0, 100.01)
    assert tr.window_s == pytest.approx(0.01)
    assert tr.busy_s == pytest.approx(800e-6 + 1000e-6)
    assert tr.by_name["banded_extend_kernel<4>"] == pytest.approx(1000e-6)
    assert "spin_kernel" not in tr.by_name
    gaps = sorted(tr.gaps, key=lambda g: -g[1])
    assert gaps[0][1] == pytest.approx(5000e-6)       # 6000 .. 11000 us
    assert gaps[0][0] == pytest.approx(100.005)       # in host seconds
    idle = _reader("device.idle_share")(run.RunRecord([], tr, {}, {}, None))
    assert idle == pytest.approx(100 * (1 - 1800e-6 / 0.01))


@pytest.mark.parametrize("marks", [0, 1])
def test_trace_without_markers_is_refused(tmp_path, marks):
    ev = [_k("k", 500.0, 100.0)] + [_k("spin_kernel", 0.0, 1.0)] * marks
    with pytest.raises(ValueError, match="markers"):
        trace.read_trace(_chrome(tmp_path, ev, base=int(10.0 * 1e9)),
                         10.0, 10.001)


def test_k1_roofline_arithmetic(tmp_path):
    ev = [_k("spin_kernel", 0.0, 1.0),
          _k("void (anonymous namespace)::banded_extend_kernel<8>(signed char "
             "const*, long long)", 10.0, 2000.0),
          _k("void (anonymous namespace)::banded_extend_windows_kernel<8>(int)",
             3000.0, 9000.0),
          _k("spin_kernel", 20000.0, 1.0)]
    tr = trace.read_trace(_chrome(tmp_path, ev), 0.0, 0.02)
    peaks = json.loads((PKG / "peaks.json").read_text())["NVIDIA H100 80GB HBM3"]
    rec = run.RunRecord([_sample(0.0, [], n_reads=131072)], tr,
                        {"align_short": {"max_candidates": 2, "extension_band": 4}},
                        {}, peaks)
    issue = 132 * 128 * 1980e6
    want = 131072 * 2 * 150 * 8 * 5 / issue / 2000e-6 * 100
    assert _reader("kernel.k1_roofline")(rec) == pytest.approx(want)


def test_breakdown_labels_gaps_by_stage():
    s = _sample(0.0, _stages(0.0))
    tr = trace.TraceResult(window_s=30.0, busy_s=1.0,
                           by_name={"a": 0.5, "b": 0.25},
                           gaps=[(1.2, 0.4), (3.5, 2.0), (12.0, 5.0), (9.2, 0.5)])
    b = run._breakdown(tr, [s])
    assert b["device_ops"] == [["a", 0.5], ["b", 0.25]]
    assert b["idle_gaps"] == [["harness between samples", 5.0],
                              ["alignment+coverage (fused)", 2.0],
                              ["pantax-gpu outside its stages", 0.5],
                              ["fused tables", 0.4]]
