"""kernel.k1_roofline: K1's (banded_extend_kernel, csrc/banded_extend.cu)
share of its bound over the window, in %.

The bound counts the band cells of every read sent in the window times
its K candidates: reads x K x read length x 2 x the half band, at
DP_OPS_PER_CELL instructions a cell, over the card's issue peak (SMs x
128 lanes x the maximum SM clock, peaks.json), the arithmetic of
chip_smoke.dp_bound; the bytes bound lies far below it.  The time is the
device time of every banded_extend_kernel launch in the traced window
(not K2's banded_extend_windows_kernel)."""
import re

DP_OPS_PER_CELL = 5
# the trace names a launch by its demangled signature:
# "void (anonymous namespace)::banded_extend_kernel<8>(...)"
NAME = re.compile(r"(^|::)banded_extend_kernel<")


def read(run):
    tr, peaks = run.trace, run.peaks
    align = run.config.get("align_short")
    if tr is None or not peaks or not align:
        return None
    seconds = sum(s for name, s in tr.by_name.items() if NAME.search(name))
    if seconds <= 0:
        return None
    cells = sum(r.n_reads * r.read_len for r in run.samples) \
        * align["max_candidates"] * 2 * align["extension_band"]
    peak = peaks["sm_count"] * peaks["lanes_per_sm"] \
        * peaks["max_sm_clock_mhz"] * 1e6
    return 100.0 * cells * DP_OPS_PER_CELL / peak / seconds
