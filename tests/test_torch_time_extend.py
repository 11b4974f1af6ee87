"""The K1 / K2 / K3 / K6 / K11 / K8 / K9 / K10b / K4b / K5 timing tools on
the CPU: the arguments, shapes and ablated sources of
``scripts/time_extend.py`` and the SASS loop readers of ``chip_smoke.py``
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

# a cuobjdump listing of two kernels: K2's (no loop), then K1<8>'s with an
# outer loop (0x0010-0x0080) around the step loop (0x0020-0x0060), two
# steps of 2 * 7 maxes each, two of them in one three-input max
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


@pytest.mark.parametrize("name", sorted(time_extend.K3_ABLATIONS))
def test_k3_ablations_apply_to_the_current_source(name, tmp_path,
                                                   monkeypatch):
    from pantax_tpu_torch.ops import seed
    monkeypatch.setenv("PANTAX_TORCH_BUILD", str(tmp_path))
    path = time_extend.ablated_source(name)
    src, current = path.read_text(), seed._SRC.read_text()
    assert path.name == f"seed_stage_no_{name}.cu" and src != current
    for old, new in time_extend.K3_ABLATIONS[name]:
        assert old in current and (new in src if new else old not in src)


@pytest.mark.parametrize("name", sorted(time_extend.K11_ABLATIONS))
def test_k11_ablations_apply_to_the_current_source(name, tmp_path,
                                                    monkeypatch):
    """Each of K11's levers comes out of csrc/classify_scatter.cu as its
    text says, into a source of its own under the build directory."""
    from pantax_tpu_torch.ops import scatter
    monkeypatch.setenv("PANTAX_TORCH_BUILD", str(tmp_path))
    path = time_extend.ablated_source(name)
    src, current = path.read_text(), scatter._SRC.read_text()
    assert path.name == f"classify_scatter_no_{name}.cu" and src != current
    for old, new in time_extend.K11_ABLATIONS[name]:
        assert current.count(old) == 1 and old not in src and new in src


@pytest.mark.parametrize("name", sorted(time_extend.K6_ABLATIONS))
def test_k6_ablations_apply_to_the_current_source(name, tmp_path,
                                                   monkeypatch):
    """Each of K6's levers comes out of csrc/classify_scatter.cu as its
    text says (each text once in the source), into a source of its own
    under the build directory; K11's kernel is left as it is."""
    from pantax_tpu_torch.ops import scatter
    monkeypatch.setenv("PANTAX_TORCH_BUILD", str(tmp_path))
    path = time_extend.ablated_source(name)
    src, current = path.read_text(), scatter._SRC.read_text()
    assert path.name == f"classify_scatter_no_{name}.cu" and src != current
    for old, new in time_extend.K6_ABLATIONS[name]:
        assert current.count(old) == 1 and new in src
        assert old not in src or old in new
    k11 = current.index("// K11: a tile of G lanes a read")
    assert src.endswith(current[k11:])


def test_k6_shapes_are_phase_3c():
    """K6's shapes: phase 3c's three batches on the smoke DB, in
    chip_smoke.k6_cases' order."""
    import inspect
    assert time_extend.SHAPES["k6"] == ("main", "paired", "intervals")
    assert time_extend.KERNELS["k6"] == "classify_scatter_ranges_kernel"
    body = inspect.getsource(chip_smoke.k6_cases)
    tags = [body.index(f'("{tag}",') for tag in time_extend.SHAPES["k6"]]
    assert tags == sorted(tags)


def test_k11_shapes_are_phase_3c_and_the_wide_rows():
    """K11's shapes: phase 3c's (the dup batch at its automatic window and
    at 3, intervals at 8) and interval rows at each wider template width."""
    assert time_extend.SHAPES["k11"] == (
        ("main", None), ("L3", 3), ("intervals", 8), ("intervals", 16),
        ("intervals", 32), ("intervals", 64))
    assert time_extend.KERNELS["k11"] == "classify_scatter_kernel"


def test_k3_shapes_are_phase_3b():
    """K3's shapes: the main path's batch at widths 160 and 152, the
    paired query's rows and the long-read chunks at pad 8."""
    from pantax_tpu_torch.align.long_read import LONG_READ_PRESETS
    assert time_extend.SHAPES["k3"] == (
        (chip_smoke.BATCH, 160, 4, "short"), (chip_smoke.BATCH, 152, 4, "short"),
        (2 * chip_smoke.BATCH, 160, 4, "paired"),
        (chip_smoke.LONG_BATCH, LONG_READ_PRESETS["hifi"], 8, "long"))


def test_vote_sass_reads_the_broadcast_loops(tmp_path, monkeypatch):
    """K3's vote loops are the innermost loops with 16-byte shared loads,
    told apart by their band test; a kernel without one says so."""
    listing = "\n".join(
        ["\tcode for sm_90a",
         "\t\tFunction : _ZN12_GLOBAL__N_117seed_stage_kernelILi2EEvPKaii",
         "        /*0000*/                   LDC R1, c[0x0][0x28] ;",
         ".L_x_5:",
         "        /*0010*/                   LDS.128 R4, [R2] ;",
         "        /*0020*/                   IADD3 R8, R4, -R9, RZ ;",
         "        /*0030*/                   ISETP.GE.U32.AND P0, PT, R8, R3, PT ;",
         "        /*0040*/                   IADD3.X R10, RZ, RZ, R10, P0, P2 ;",
         "        /*0050*/              @P1  BRA `(.L_x_5) ;",
         ".L_x_6:",
         "        /*0060*/                   LDS.U8 R4, [R2] ;",
         "        /*0070*/              @P1  BRA `(.L_x_6) ;",
         "        /*0080*/                   EXIT ;"])
    tool = tmp_path / "cuobjdump"
    tool.write_text("#!/bin/sh\ncat <<'EOF'\n" + listing + "\nEOF\n")
    tool.chmod(tool.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", f"{tmp_path}{os.pathsep}{os.environ['PATH']}")
    assert chip_smoke.vote_sass("lib.so", 2) == [
        {"test": "carry", "instructions": 5, "hits": 2, "per_hit": 2.5,
         "IMAD": 0, "IADD3": 2, "ISETP": 1, "IADD3.X": 1}]
    assert chip_smoke.vote_sass("lib.so", 4) == "kernel not found"


@pytest.mark.parametrize("rl,positions", [(21, 1), (30, 10), (50, 20)])
def test_seed_bound_counts_positions_inside_read_len_and_pairs(rl,
                                                               positions):
    """K3's bound: HASH_OPS_PER_POS for each k-mer position inside read_len
    (clamped to the width) and VOTE_OPS_PER_PAIR for each pair of a row's
    valid hits on each strand.  Row 0 (width 40, k 21, density 0) finds 3
    hits at its first seed, row 1 (read_len 0, all N) nothing."""
    import numpy as np
    import torch
    k, L = 21, 40
    codes = np.random.default_rng(5).integers(0, 4, size=(2, L)).astype(
        np.int8)
    codes[0, min(rl, L):] = 4
    codes[1] = 4
    _, sh, sv = chip_smoke._selected_seeds(codes, k, 0, 16)
    assert sv[0, 0] and not sv[1].any()
    table, bits, disp = chip_smoke.chd_table(
        {int(sh[0, 0]): (3, [100, 200, 300])}, 4)
    args = (torch.from_numpy(codes), torch.tensor([rl, 0], dtype=torch.int32),
            torch.from_numpy(table), torch.zeros(1, dtype=torch.int32),
            torch.from_numpy(disp), (k, 0, bits, -1, 16, 4, 2, 4))
    assert chip_smoke.valid_hits(args).tolist() == [3, 0]
    ms, by = chip_smoke.seed_bound(args, 1e3)  # ops/s: operations bound it
    assert by == "operations"
    assert ms == pytest.approx(positions * chip_smoke.HASH_OPS_PER_POS
                               + 2 * 3 * 3 * chip_smoke.VOTE_OPS_PER_PAIR)


def test_k1_step_sass_reads_the_innermost_loop(tmp_path, monkeypatch):
    tool = tmp_path / "cuobjdump"
    tool.write_text("#!/bin/sh\ncat <<'EOF'\n" + _SASS + "\nEOF\n")
    tool.chmod(tool.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", f"{tmp_path}{os.pathsep}{os.environ['PATH']}")
    got = chip_smoke.step_sass("lib.so", 8)
    assert got == {"instructions": 29, "steps": 2, "per_step": 14.5,
                   "viaddmnmx": 26, "max_ops": 28}
    assert chip_smoke.step_sass("lib.so", 4) == "kernel not found"


def test_step_sass_reads_the_named_kernel(tmp_path, monkeypatch):
    """K2's instantiation is found by its own name, not K1's (whose
    mangled name does not contain it), and one without a loop says so."""
    listing = _SASS.replace("windows_kernelILi8E", "windows_kernelILi4E")
    tool = tmp_path / "cuobjdump"
    tool.write_text("#!/bin/sh\ncat <<'EOF'\n" + listing + "\nEOF\n")
    tool.chmod(tool.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", f"{tmp_path}{os.pathsep}{os.environ['PATH']}")
    k2 = "banded_extend_windows_kernel"
    assert chip_smoke.step_sass("lib.so", 4, k2) == "no loop found"
    assert chip_smoke.step_sass("lib.so", 8, k2) == "kernel not found"
    assert chip_smoke.step_sass("lib.so", 8)["steps"] == 2


@pytest.mark.parametrize("argv,kernel", [
    (["base.cu"], "k1"), (["--kernel", "k2", "base.cu"], "k2"),
    (["--kernel", "k2", "--ablate", "unroll"], "k2"),
])
def test_parse_args_takes_the_kernel(argv, kernel):
    args = time_extend.parse_args(argv)
    assert args.kernel == kernel
    assert (args.baseline is None) != (args.ablate is None)


def test_parse_args_k3_takes_a_baseline_and_its_ablations():
    args = time_extend.parse_args(["--kernel", "k3", "base.cu", "--ablate",
                                   "rehash", "--ablate", "exact_band"])
    assert (args.kernel, args.baseline) == ("k3", "base.cu")
    assert args.ablate == ["rehash", "exact_band"]
    assert time_extend.parse_args(["--kernel", "k3", "b.cu"]).ablate is None


def test_parse_args_k11_takes_a_baseline_and_its_ablations():
    args = time_extend.parse_args(["--kernel", "k11", "base.cu", "--ablate",
                                   "ballot_scan"])
    assert (args.kernel, args.baseline) == ("k11", "base.cu")
    assert args.ablate == ["ballot_scan"]
    assert time_extend.parse_args(["--kernel", "k11", "b.cu"]).ablate is None


def test_parse_args_k8_takes_no_baseline():
    """K8 given no baseline is refused, as K3, K6 and K11 are: it takes a
    baseline source (an earlier admm_chunk.cu) and its own ablations."""
    args = time_extend.parse_args(["--kernel", "k8", "base.cu", "--ablate",
                                   "regs", "--ablate", "mbar", "--ablate",
                                   "push", "--ablate", "cluster"])
    assert (args.kernel, args.baseline) == ("k8", "base.cu")
    assert args.ablate == ["regs", "mbar", "push", "cluster"]
    assert time_extend.parse_args(["--kernel", "k8", "b.cu"]).ablate is None
    for argv in (["--kernel", "k8"],
                 ["--kernel", "k8", "--ablate", "unroll", "base.cu"],
                 ["--kernel", "k3", "--ablate", "push", "base.cu"]):
        with pytest.raises(SystemExit):
            time_extend.parse_args(argv)


@pytest.mark.parametrize("name", sorted(time_extend.K8_ABLATIONS))
def test_k8_ablations_apply_to_the_current_source(name, tmp_path,
                                                   monkeypatch):
    """Each of K8's levers comes out of csrc/admm_chunk.cu as its text
    says (each text once in the source), into a source of its own under
    the build directory; the float plan's kernel is left as it is."""
    from pantax_tpu_torch.ops import admm
    monkeypatch.setenv("PANTAX_TORCH_BUILD", str(tmp_path))
    path = time_extend.ablated_source(name)
    src, current = path.read_text(), admm._SRC.read_text()
    assert path.name == f"admm_chunk_no_{name}.cu" and src != current
    for old, new in time_extend.K8_ABLATIONS[name]:
        assert current.count(old) == 1 and old not in src and new in src
    bits = current.index("// The bits plan: A known to be 0/1")
    assert src.startswith(current[:bits])


def test_k8_bits_shapes_take_the_bits_plan():
    """K8_BITS and the smoke's bucket take the bits plan on 0/1 A: 8 CTAs
    at 65536 rows and at (1, 4096, 4), the wide 0/1 rows at width 32;
    K8_STREAMED's (1, 65536, 32) as a non-0/1 A keeps the float plan."""
    from pantax_tpu_torch.ops import admm
    assert time_extend.K8_BITS == ((1, 4096, 4), (1, 65536, 32))
    plans = [admm.launch_plan(*shape, binary=True)
             for shape in (*time_extend.SHAPES["k8"], *time_extend.K8_BITS)]
    assert all(pl.bits and pl.on_chip for pl in plans)
    assert [pl.cluster for pl in plans] == [8, 8, 8, 8]
    assert not admm.launch_plan(*time_extend.K8_STREAMED[1]).bits
    assert not admm.launch_plan(*time_extend.K8_STREAMED[0], True).bits


def test_k8_shapes_are_the_smoke_bucket():
    """K8's shapes: the smoke DB's device-tail bucket (10 species of
    65536 padded rows, 4 paths) and one of its instances alone, at the
    solvers' chunk of 250 steps; K8 has a plan at both."""
    from pantax_tpu_torch.ops import admm
    assert time_extend.SHAPES["k8"] == ((10, 65536, 4), (1, 65536, 4))
    assert time_extend.K8_STEPS == 250
    for shape in time_extend.SHAPES["k8"]:
        assert admm.launch_plan(*shape).on_chip


def test_k8_streamed_shapes_take_the_streamed_plan():
    """The streamed plan's timings: the host tail's largest singleton
    bucket (500,000 sampled nodes pad to 524288 rows) and 32 paths at
    65536 rows; neither fits on chip."""
    from pantax_tpu_torch.ops import admm
    assert time_extend.K8_STREAMED == ((1, 524288, 4), (1, 65536, 32))
    for shape in time_extend.K8_STREAMED:
        assert not admm.launch_plan(*shape).on_chip


def test_parse_args_k6_takes_a_baseline_and_its_ablations():
    args = time_extend.parse_args(["--kernel", "k6", "base.cu", "--ablate",
                                   "pair", "--ablate", "scan"])
    assert (args.kernel, args.baseline) == ("k6", "base.cu")
    assert args.ablate == ["pair", "scan"]
    assert time_extend.parse_args(["--kernel", "k6", "b.cu"]).ablate is None


@pytest.mark.parametrize("argv", [
    ["--kernel", "k6"], ["--kernel", "k6", "--ablate", "ballot_scan",
                         "base.cu"],
    ["--kernel", "k11", "--ablate", "pair", "base.cu"],
])
def test_parse_args_refuses_k6_mixups(argv):
    with pytest.raises(SystemExit):
        time_extend.parse_args(argv)


@pytest.mark.parametrize("argv", [
    [], ["--kernel", "k2"], ["--kernel", "k3", "--ablate", "unroll", "base.cu"],
    ["--ablate", "unroll", "base.cu"], ["--kernel", "k11"],
    ["--kernel", "k11", "--ablate", "rehash", "base.cu"],
    ["--kernel", "k3", "--ablate", "ballot_scan", "base.cu"],
])
def test_parse_args_refuses(argv):
    with pytest.raises(SystemExit):
        time_extend.parse_args(argv)


def test_k2_shapes_are_the_rescue_pass():
    """K2's shapes: the rescue pass's (16384 chunks of the hifi preset's
    512 bases, pad 8) with ragged and with full read lengths, and one whose
    windows (Lr + 2*pad bytes) put rows off 16-byte boundaries."""
    from pantax_tpu_torch.align.long_read import LONG_READ_PRESETS
    k2 = time_extend.SHAPES["k2"]
    rescue = (16384, LONG_READ_PRESETS["hifi"], 8)
    assert [s[:3] for s in k2[:2]] == [rescue, rescue]
    assert [s[4] for s in k2[:2]] == [None, 512]
    assert any((Lr + 2 * pad) % 16 for _, Lr, pad, _, _ in k2)
    for N, Lr, pad, _seed, fixed in k2 + time_extend.SHAPES["k1"]:
        assert 1 <= pad <= 8 and Lr % 16 == 0 and N > 0
        assert fixed is None or fixed <= Lr
    assert set(time_extend.KERNELS) == set(time_extend.SHAPES)


def test_ptxas_lines_read_the_scatter_kernels_and_their_frames():
    """K11's two template arguments and K6 (no template) are named (not the
    file's name that an anonymous namespace mangles in before them), each
    with the stack frame and spills ptxas reports before its registers."""
    log = "\n".join([
        "ptxas info    : Compiling entry function '_ZN47_GLOBAL__N__"
        "classify_scatter_cu_c1be1fb523classify_scatter_kernelILi32ELi2EEEv"
        "PKiS2_PKhiNS_6TablesEiiPxPiS6_S7_Ph' for 'sm_90a'",
        "ptxas info    : Function properties for _ZN12_GLOBAL__N_123"
        "classify_scatter_kernelILi32ELi2EEEvPKiS2_PKhiNS_6TablesEiiPxPiS6_"
        "S7_Ph",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 40 registers, used 0 barriers",
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_130"
        "classify_scatter_ranges_kernelEPKiS2_PKhiNS_6TablesEPxPiS6_S7_S7_"
        "S7_' for 'sm_90a'",
        "ptxas info    : Used 28 registers, used 0 barriers"])
    assert chip_smoke.ptxas_lines(log) == [
        "classify_scatter_kernel<32,2>: Used 40 registers, used 0 barriers; "
        "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "classify_scatter_ranges_kernel: Used 28 registers, used 0 barriers"]


def test_ptxas_lines_name_k8s_instantiations():
    log = ("ptxas info    : Compiling entry function "
           "'_ZN12_GLOBAL__N_117admm_chunk_kernelILi8EEEvNS_4ArgsE' for "
           "'sm_90a'\n"
           "ptxas info    : Used 40 registers, used 1 barriers\n")
    assert chip_smoke.ptxas_lines(log) == [
        "admm_chunk_kernel<8>: Used 40 registers, used 1 barriers"]


def test_ptxas_lines_name_k8s_bits_instantiations():
    """The bits plan's kernel and its two template arguments (rows a
    thread, width) are named, with the frame and spills before them."""
    log = ("ptxas info    : Compiling entry function "
           "'_ZN12_GLOBAL__N_122admm_chunk_bits_kernelILi8ELi32EEEvNS_4"
           "ArgsEi' for 'sm_90a'\n"
           "ptxas info    : Function properties for _ZN12_GLOBAL__N_122"
           "admm_chunk_bits_kernelILi8ELi32EEEvNS_4ArgsEi\n"
           "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
           "loads\n"
           "ptxas info    : Used 56 registers, used 1 barriers\n")
    assert chip_smoke.ptxas_lines(log) == [
        "admm_chunk_bits_kernel<8,32>: Used 56 registers, used 1 barriers; "
        "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads"]


def test_ptxas_lines_name_each_instantiation():
    log = ("ptxas info    : Compiling entry function "
           "'_ZN12_GLOBAL__N_120banded_extend_kernelILi16EEvPKax' for 'sm_90a'\n"
           "ptxas info    : Used 80 registers, used 0 barriers\n")
    assert chip_smoke.ptxas_lines(log) == [
        "banded_extend_kernel<16>: Used 80 registers, used 0 barriers"]


@pytest.mark.parametrize("kernel,other", [("k9", "stop"),
                                          ("k10b", "regs")])
def test_parse_args_k9_k10b_take_a_baseline_and_no_ablation(kernel, other):
    """K9 and K10b are timed against a baseline source (an earlier
    profile_tail.cu) and take no other kernel's lever to ablate (K9's own
    are K9_ABLATIONS, K10b's K10B_ABLATIONS): K9 refuses K10b's "stop",
    K10b K8's and K9's "regs"."""
    args = time_extend.parse_args(["--kernel", kernel, "base.cu"])
    assert (args.kernel, args.baseline, args.ablate) == (kernel, "base.cu",
                                                         None)
    mine = {"k9": time_extend.K9_ABLATIONS,
            "k10b": time_extend.K10B_ABLATIONS}[kernel]
    assert other not in mine
    for argv in (["--kernel", kernel],
                 ["--kernel", kernel, "--ablate", other, "base.cu"]):
        with pytest.raises(SystemExit):
            time_extend.parse_args(argv)


def test_k9_k10b_shapes_are_the_smoke_tail():
    """K9 first at the smoke DB's size (30 haps, 10 species with nodes,
    N_pad 524288), then community102-like (the smoke DB's counts scaled by
    34/10: 102 haps of 34 species, 4 CTAs a hap), then on the smoke DB's
    paired device tail; K10b at the smoke's device-tail bucket, the
    smallest, wide rows and a bucket whose residuals sit in global
    memory."""
    from pantax_tpu_torch.ops import tail_kernels
    smoke, community, paired = time_extend.SHAPES["k9"]
    G, S, nodes, _trios = smoke
    assert (G, S - 1, nodes + 96) == (30, 10, 524288)
    G, S, nodes, trios = community
    assert (G, S - 1) == (102, 34) and trios == 34 * 500_000 // 10
    assert nodes == pytest.approx(34 / 10 * 524192, rel=1e-3)
    assert tail_kernels.stats_plan(G, S, trios).cluster == 4
    assert paired == "paired"
    shapes = time_extend.SHAPES["k10b"]
    assert shapes[0] == (10, 65536, 4)
    plans = [tail_kernels.polish_plan(*shape) for shape in shapes]
    assert [pl.on_chip for pl in plans] == [True, True, True, False]


def test_ptxas_lines_name_the_tail_kernels():
    log = ("ptxas info    : Compiling entry function '_ZN48_GLOBAL__N__54b5"
           "94ff_15_profile_tail_cu_4496dc4213polish_kernelENS_10PolishArgsE'"
           " for 'sm_90a'\n"
           "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
           "loads\n"
           "ptxas info    : Used 64 registers, used 1 barriers\n"
           "ptxas info    : Compiling entry function '_ZN48_GLOBAL__N__54b5"
           "94ff_15_profile_tail_cu_4496dc4217tail_stats_kernelENS_9StatsArgs"
           "E' for 'sm_90a'\n"
           "ptxas info    : Used 32 registers, used 1 barriers, 768 bytes "
           "smem\n")
    assert chip_smoke.ptxas_lines(log) == [
        "polish_kernel: Used 64 registers, used 1 barriers; 0 bytes stack "
        "frame, 0 bytes spill stores, 0 bytes spill loads",
        "tail_stats_kernel: Used 32 registers, used 1 barriers, 768 bytes "
        "smem"]


@pytest.mark.parametrize("name", sorted(time_extend.K10B_ABLATIONS))
def test_k10b_ablations_apply_to_the_current_source(name, tmp_path,
                                                    monkeypatch):
    """Each of K10b's levers comes out of csrc/profile_tail.cu as its text
    says (each text once in the source), into a source of its own under
    the build directory, and --kernel k10b takes it; K9's kernel is left
    as it is."""
    from pantax_tpu_torch.ops import tail_kernels
    monkeypatch.setenv("PANTAX_TORCH_BUILD", str(tmp_path))
    path = time_extend.ablated_source(name)
    src, current = path.read_text(), tail_kernels._SRC.read_text()
    assert path.name == f"profile_tail_no_{name}.cu" and src != current
    for old, new in time_extend.K10B_ABLATIONS[name]:
        assert current.count(old) == 1 and old not in src and new in src
    polish = current.index("// K10b, the coordinate-median polish")
    assert src.startswith(current[:polish])
    args = time_extend.parse_args(["--kernel", "k10b", "base.cu",
                                   "--ablate", name])
    assert args.ablate == [name]


@pytest.mark.parametrize("name", sorted(time_extend.K9_ABLATIONS))
def test_k9_ablations_apply_to_the_current_source(name, tmp_path,
                                                  monkeypatch):
    """Each of K9's levers comes out of csrc/profile_tail.cu as its text
    says (each text once in the source), into a source of its own under
    the build directory, and --kernel k9 takes it; K10b's kernel is left
    as it is.  K8 has levers of the same names: K9's are taken where the
    kernel is k9."""
    from pantax_tpu_torch.ops import tail_kernels
    monkeypatch.setenv("PANTAX_TORCH_BUILD", str(tmp_path))
    path = time_extend.ablated_source(name, "k9")
    src, current = path.read_text(), tail_kernels._SRC.read_text()
    assert path.name == f"profile_tail_no_{name}.cu" and src != current
    for old, new in time_extend.K9_ABLATIONS[name]:
        assert current.count(old) == 1 and old not in src and new in src
    k9 = current.index("// K9, the tail stats")
    polish = current.index("// K10b, the coordinate-median polish")
    assert src.startswith(current[:k9])
    assert src[src.index("// K10b, the coordinate-median polish"):] == (
        current[polish:])
    args = time_extend.parse_args(["--kernel", "k9", "base.cu",
                                   "--ablate", name])
    assert args.ablate == [name]


def test_ptxas_lines_name_k9s_instantiations():
    """K9's kernel is a template on its trio values and its path nodes a
    thread in registers: both arguments are printed."""
    log = ("ptxas info    : Compiling entry function '_ZN48_GLOBAL__N__54b5"
           "94ff_15_profile_tail_cu_4496dc4217tail_stats_kernelILi8ELi16EEEv"
           "NS_9StatsArgsE' for 'sm_90a'\n"
           "ptxas info    : Used 48 registers, used 1 barriers, 1152 bytes "
           "smem\n")
    assert chip_smoke.ptxas_lines(log) == [
        "tail_stats_kernel<8,16>: Used 48 registers, used 1 barriers, 1152 "
        "bytes smem"]


def test_ptxas_lines_name_k10bs_instantiations():
    """K10b's kernel is a template on the cluster (bool) and the rows a
    thread holds in registers (int): both arguments are printed."""
    log = ("ptxas info    : Compiling entry function '_ZN48_GLOBAL__N__54b5"
           "94ff_15_profile_tail_cu_4496dc4213polish_kernelILb1ELi8EEEvNS_10"
           "PolishArgsE' for 'sm_90a'\n"
           "ptxas info    : Used 56 registers, used 1 barriers\n"
           "ptxas info    : Compiling entry function '_ZN48_GLOBAL__N__54b5"
           "94ff_15_profile_tail_cu_4496dc4213polish_kernelILb0ELi0EEEvNS_10"
           "PolishArgsE' for 'sm_90a'\n"
           "ptxas info    : Used 40 registers, used 1 barriers\n")
    assert chip_smoke.ptxas_lines(log) == [
        "polish_kernel<1,8>: Used 56 registers, used 1 barriers",
        "polish_kernel<0,0>: Used 40 registers, used 1 barriers"]


@pytest.mark.parametrize("kernel,name", [
    *(("k4b", n) for n in sorted(time_extend.K4B_ABLATIONS)),
    *(("k5", n) for n in sorted(time_extend.K5_ABLATIONS))])
def test_query_ablations_apply_to_the_current_source(kernel, name, tmp_path,
                                                     monkeypatch):
    """Each of K4b's and K5's levers comes out of csrc/query_io.cu as its
    text says (each text once in the source), into a source of its own
    under the build directory, and --kernel k4b (or k5) takes it; the
    other kernel refuses it, and both refuse to run without a
    baseline."""
    from pantax_tpu_torch.ops import query
    monkeypatch.setenv("PANTAX_TORCH_BUILD", str(tmp_path))
    path = time_extend.ablated_source(name, kernel)
    src, current = path.read_text(), query._SRC.read_text()
    assert path.name == f"query_io_no_{name}.cu" and src != current
    table = {"k4b": time_extend.K4B_ABLATIONS,
             "k5": time_extend.K5_ABLATIONS}[kernel]
    for old, new in table[name]:
        assert current.count(old) == 1 and old not in src and new in src
    args = time_extend.parse_args(["--kernel", kernel, "base.cu",
                                   "--ablate", name])
    assert (args.kernel, args.baseline, args.ablate) == (kernel, "base.cu",
                                                         [name])
    other = "k5" if kernel == "k4b" else "k4b"
    for argv in (["--kernel", other, "base.cu", "--ablate", name],
                 ["--kernel", kernel, "--ablate", name]):
        with pytest.raises(SystemExit):
            time_extend.parse_args(argv)


def test_query_shapes_are_phase_3f():
    """K4b at phase 3f's three cases (phase 5's batch, the paired query's,
    the long chunks' extension rows), K5 at the single-end and the paired
    pick; the kernels' names are the source's."""
    from pantax_tpu_torch.ops import query
    assert time_extend.SHAPES["k4b"] == ("main", "paired", "long")
    assert time_extend.SHAPES["k5"] == ("main", "paired")
    src = query._SRC.read_text()
    for k in ("k4b", "k5"):
        assert f"__global__ void {time_extend.KERNELS[k]}(" in src


def test_an_earlier_sources_picks_take_no_bucket_table(tmp_path,
                                                      monkeypatch):
    """compile_query gives a baseline without pos_lo in its text (an
    earlier query_io.cu) as EarlierPicks: its K5 and K5p entries get their
    own argument types and the C arguments that launch_k5 / launch_k5p
    pass, less the bucket table's three after M; its other entries and
    attributes are the build's.  The current source's picks take the
    table, and its build comes back as it is."""
    from pantax_tpu_torch.ops import query

    calls = []

    class Entry:
        def __init__(self, name):
            self.name = name

        def __call__(self, *a):
            calls.append((self.name, a))
            return 0

    class Build:
        build_log = "ptxas"
        query_rows_launch = Entry("query_rows_launch")

        def __getitem__(self, name):
            return Entry(name)

    built = []
    monkeypatch.setattr(query, "build_query_kernels",
                        lambda src: built.append(src) or Build())
    base = tmp_path / "query_io_base.cu"
    base.write_text('extern "C" int query_pick_launch(const void* tstart);')
    lib = time_extend.compile_query(base)
    assert isinstance(lib, time_extend.EarlierPicks) and built == [base]
    assert lib.build_log == "ptxas"
    assert lib.query_rows_launch is Build.query_rows_launch
    args = tuple(range(30))
    for name, n in (("query_pick_launch", 27), ("query_pick_paired_launch",
                                                30)):
        getattr(lib, name)(*args[:n])
        assert calls[-1] == (name, args[:10] + args[13:n])
    assert type(time_extend.compile_query(None)) is Build
    src = query._SRC.read_text()
    for entry in ("query_pick_launch", "query_pick_paired_launch"):
        head = src[src.index(f'extern "C" int {entry}('):]
        assert "const void* pos_lo, int n_pos, int win_shift" in head[
            :head.index("{")]


def test_ptxas_lines_name_the_query_kernels():
    """K4b's kernel is a template on its strands' type and K5's on K: each
    instantiation is named."""
    log = ("ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_117"
           "query_rows_kernelIaEEvNS_8RowsArgsE' for 'sm_90a'\n"
           "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
           "loads\n"
           "ptxas info    : Used 30 registers, used 0 barriers\n"
           "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_117"
           "query_rows_kernelIiEEvNS_8RowsArgsE' for 'sm_90a'\n"
           "ptxas info    : Used 31 registers, used 0 barriers\n"
           "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_117"
           "query_pick_kernelILi2EEEvNS_6PickInENS_8SegmentsEiff3Out' "
           "for 'sm_90a'\n"
           "ptxas info    : Used 40 registers, used 0 barriers\n")
    assert chip_smoke.ptxas_lines(log) == [
        "query_rows_kernel<int8>: Used 30 registers, used 0 barriers; 0 "
        "bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "query_rows_kernel<int>: Used 31 registers, used 0 barriers",
        "query_pick_kernel<2>: Used 40 registers, used 0 barriers"]
