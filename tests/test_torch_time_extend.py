"""The K1 timing tools on the CPU: the ablated sources of
``scripts/time_extend.py`` and the SASS loop reader of ``chip_smoke.py``
(the card runs them; here only their text handling is held)."""
import importlib.util
import os
import stat
from pathlib import Path

import pytest

import chip_smoke
from pantax_tpu_torch.ops import extend

_SCRIPT = Path(__file__).resolve().parent.parent / "scripts" / "time_extend.py"
_spec = importlib.util.spec_from_file_location("time_extend", _SCRIPT)
time_extend = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(time_extend)

# a cuobjdump listing of two kernels: K2's, then K1<8>'s with an outer loop
# (0x0010-0x0080) around the step loop (0x0020-0x0060), two steps of 2 * 7
# maxes each, two of them in one three-input max
_SASS = "\n".join(
    ["\tcode for sm_90a",
     "\t\tFunction : _ZN12_GLOBAL__N_128banded_extend_windows_kernelILi8EEvPKai",
     "        /*0000*/                   LDC R1, c[0x0][0x28] ;",
     "\t\tFunction : _ZN12_GLOBAL__N_120banded_extend_kernelILi8EEvPKax",
     "        /*0000*/                   LDC R1, c[0x0][0x28] ;",
     ".L_x_1:",
     "        /*0010*/                   IADD3 R2, R3, R4, RZ ;",
     ".L_x_2:",
     "        /*0020*/                   VIADDMNMX R2, R3, R4, R5, !PT ;"]
    + ["        /*0030*/                   VIADDMNMX R2, R3, R4, R5, !PT ;"] * 25
    + ["        /*0040*/                   VIMNMX3 R2, R3, R4, R5, !PT ;",
       "        /*0050*/                   PRMT R6, R7, 0x4440, RZ ;",
       "        /*0060*/              @P0  BRA `(.L_x_2) ;",
       "        /*0070*/                   IADD3 R2, R3, R4, RZ ;",
       "        /*0080*/              @!P1 BRA `(.L_x_1) ;",
       "        /*0090*/                   EXIT ;"])


@pytest.mark.parametrize("name", sorted(time_extend.ABLATIONS))
def test_ablations_apply_to_the_current_source(name, tmp_path, monkeypatch):
    monkeypatch.setenv("PANTAX_TORCH_BUILD", str(tmp_path))
    src = time_extend.ablated_source(name).read_text()
    current = extend._SRC.read_text()
    assert src != current
    for old, new in time_extend.ABLATIONS[name]:
        assert old in current and new in src


def test_k1_step_sass_reads_the_innermost_loop(tmp_path, monkeypatch):
    tool = tmp_path / "cuobjdump"
    tool.write_text("#!/bin/sh\ncat <<'EOF'\n" + _SASS + "\nEOF\n")
    tool.chmod(tool.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", f"{tmp_path}{os.pathsep}{os.environ['PATH']}")
    got = chip_smoke.k1_step_sass("lib.so", 8)
    assert got == {"instructions": 29, "steps": 2, "per_step": 14.5,
                   "viaddmnmx": 26, "max_ops": 28}
    assert chip_smoke.k1_step_sass("lib.so", 4) == "kernel not found"


def test_ptxas_lines_name_each_instantiation():
    log = ("ptxas info    : Compiling entry function "
           "'_ZN12_GLOBAL__N_120banded_extend_kernelILi16EEvPKax' for 'sm_90a'\n"
           "ptxas info    : Used 80 registers, used 0 barriers\n")
    assert chip_smoke.ptxas_lines(log) == [
        "banded_extend_kernel<16>: Used 80 registers, used 0 barriers"]
