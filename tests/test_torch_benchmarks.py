"""The port's benchmark runners, fused_alignment_coverage and entry()
against the JAX package's (CPU, plain versions), on the same databases at
the reference's own CPU test sizes (tests/test_pipeline_e2e.py: scale_db
with 2-3 species x 2-3 strains x 50-60 kb): every dict key that is not a
time equal, the four output tables byte-identical, the L1 error within
1e-9 and the same predicted and true abundances.

Both packages' runners profile with the HiGHS solver here (their
ProfilingConfig.for_read_type patched to it): the reference's float32 ADMM
stops early on a flat L1 optimum, so ADMM tables agree only within the
solver's tolerance (ROADMAP, reference behaviours); HiGHS gives both
packages the same optimum, to the byte."""
import filecmp
import os

import numpy as np
import pytest
import torch

import pantax_tpu.benchmarks as ref_bench
import pantax_tpu.config as ref_config
import pantax_tpu.ops.fused as ref_fused
from pantax_tpu.align.aligner import Aligner as RefAligner
from pantax_tpu_torch import _host
from pantax_tpu_torch import benchmarks as port_bench
from pantax_tpu_torch import config as port_config
from pantax_tpu_torch.convert import aligner_from_reference
from pantax_tpu_torch.ops import fused as port_fused
from pantax_tpu_torch.parallel.entry import entry

from _torch_helpers import reference_on_one_device  # noqa: F401 (autouse)

CPU = torch.device("cpu")
OUT_FILES = ("species_abundance.txt", "strain_abundance.txt",
             "ori_strain_abundance.txt", "reads_classification.tsv")
# the runners' keys that hold seconds or rates
TIME_KEYS = {"reads_per_s", "wall_s", "wall_reads_per_s", "e2e_reads_per_s",
             "align_reads_per_s", "align_s", "profile_s", "bases_per_s",
             "short_reads_per_s", "long_reads_per_s", "short_s", "long_s"}

# (runner, database, keyword arguments, writes tables): the sizes of the
# reference's tests (accuracy, mixed) and of the same order for the rest
RUNS = {
    "alignment": ("run_alignment_benchmark", "scale2",
                  dict(n_reads=8192, batch=2048), False),
    "e2e": ("run_e2e_benchmark", "scale2",
            dict(n_reads=4096, batch=1024), True),
    "long_e2e": ("run_long_e2e_benchmark", "scale2",
                 dict(n_long=64, long_len=4096, long_batch=256), True),
    "mixed": ("run_mixed_benchmark", "scale2",
              dict(n_short=4096, n_long=64, batch=1024, long_len=4096,
                   long_batch=256), True),
    "accuracy": ("accuracy_benchmark", "scale3",
                 dict(n_reads=16384, batch=2048), True),
    "long_accuracy": ("long_read_accuracy_benchmark", "scale2",
                      dict(n_reads=256, read_len=4096, batch=256), True),
}


@pytest.fixture(scope="module")
def dbs(tmp_path_factory):
    """test_mixed_benchmark_smoke's and test_small_community_accuracy's
    communities, built by the port (both packages read the same files)."""
    return {
        "scale2": port_bench.scale_db(
            tmp_path_factory.mktemp("scale2"), n_species=2, strains_per=2,
            genome_len=50_000, snp_rate=0.01, seed=5),
        "scale3": port_bench.scale_db(
            tmp_path_factory.mktemp("scale3"), n_species=3, strains_per=3,
            genome_len=60_000, snp_rate=0.01, seed=3),
    }


@pytest.fixture
def highs(monkeypatch):
    """Both packages' ProfilingConfig.for_read_type with solver "highs"."""
    for cls in (ref_config.ProfilingConfig, port_config.ProfilingConfig):
        orig = cls.for_read_type.__func__
        monkeypatch.setattr(cls, "for_read_type", classmethod(
            lambda c, rt, _orig=orig, **kw: _orig(
                c, rt, **{"solver": "highs", **kw})))


@pytest.mark.parametrize("run", list(RUNS))
def test_runner_matches_reference(run, dbs, highs, tmp_path):
    name, which, kw, tables = RUNS[run]
    db = dbs[which]
    if tables:
        kw = dict(kw, out_dir=str(tmp_path / "ref"))
    want = getattr(ref_bench, name)(db, **kw)
    if tables:
        kw = dict(kw, out_dir=str(tmp_path / "port"))
    got = getattr(port_bench, name)(db, **kw, device=CPU)
    assert got.keys() == want.keys()
    for key in want.keys() - TIME_KEYS - {"l1_error", "pred", "truth"}:
        assert got[key] == want[key], key
    if "l1_error" in want:
        assert got["detected"] == got["total"]
        assert abs(got["l1_error"] - want["l1_error"]) <= 1e-9
        assert got["truth"] == want["truth"]
        # the same text: the port parses it with float() (correctly
        # rounded), the reference with pandas' default reader, which is off
        # by up to a few ulp (0.21428571428571427 reads 0.2142857142857142)
        assert got["pred"].keys() == want["pred"].keys()
        keys = sorted(want["pred"])
        np.testing.assert_allclose([got["pred"][k] for k in keys],
                                   [want["pred"][k] for k in keys],
                                   rtol=1e-14, atol=0)
    if tables:
        for f in OUT_FILES:
            assert filecmp.cmp(tmp_path / "ref" / f, tmp_path / "port" / f,
                               shallow=False), f
    else:
        assert got["aligned_frac"] > 0.99 and got["species_acc"] > 0.99


def test_strain_l1_reads_tables_as_reference(dbs, tmp_path):
    """_strain_l1 without pandas on a strain table with a strain missing,
    one the truth does not hold and an empty abundance: the reference's
    l1_error, counts and truth."""
    db = dbs["scale2"]
    index = _host.build_align_index(db)
    weights = np.arange(1.0, len(index.hap_names) + 1)
    infos = _host.read_genomes_info(db.genomes_info_file)
    rows = ["species_taxid\tstrain_taxid\tgenome_ID\tpredicted_abundance"]
    rows += [f"{g.species_taxid}\t{g.strain_taxid}\t{g.genome_id}\t{ab}"
             for g, ab in zip(infos[1:], ("0.125", "0.5", ""))]
    rows.append("999\t999.1\tGCF_extra\t0.0625")
    (tmp_path / "strain_abundance.txt").write_text("\n".join(rows) + "\n")
    want = ref_bench._strain_l1(db, index, weights, str(tmp_path))
    got = port_bench._strain_l1(db, index, weights, str(tmp_path))
    assert got["detected"] == want["detected"] == 4
    assert got["total"] == want["total"] and got["truth"] == want["truth"]
    assert np.isnan(got["l1_error"]) and np.isnan(want["l1_error"])
    assert [k for k in got["pred"]] == [k for k in want["pred"]]
    rows[3] += "0.25"  # every abundance given: a number
    (tmp_path / "strain_abundance.txt").write_text("\n".join(rows) + "\n")
    want = ref_bench._strain_l1(db, index, weights, str(tmp_path))
    got = port_bench._strain_l1(db, index, weights, str(tmp_path))
    assert abs(got["l1_error"] - want["l1_error"]) <= 1e-9
    assert got["pred"] == want["pred"]


@pytest.mark.parametrize("run", list(RUNS))
def test_runner_needs_a_card_by_default(run, monkeypatch):
    """Without device= a runner asks for the card and raises where there is
    none, before any work (its database is never read); it never runs on
    the CPU."""
    name, _, kw, _ = RUNS[run]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        getattr(port_bench, name)(None, **kw)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("indel_rate", [0.0, 0.02])
@pytest.mark.parametrize("error_rate", [0.0, 0.01])
def test_simulate_read_batch_blocks_bit_identical(dbs, monkeypatch, weighted,
                                                  indel_rate, error_rate):
    """simulate_read_batch in row blocks of 1000 (fewer than the 4100
    reads, and not dividing them) gives the reference's one-shot reads:
    codes, lens and haplotypes equal, with and without hap weights,
    indels and substitutions."""
    index = _host.build_align_index(dbs["scale2"])
    weights = (np.arange(1.0, len(index.hap_names) + 1) if weighted else None)
    monkeypatch.setattr(port_bench, "_SIM_ROWS", 1000)
    kw = dict(seed=4, hap_weights=weights, indel_rate=indel_rate)
    want = ref_bench.simulate_read_batch(index, 4100, 150, error_rate, **kw)
    got = port_bench.simulate_read_batch(index, 4100, 150, error_rate, **kw)
    for name, g, w in zip(("codes", "lens", "hap"), got, want):
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, name)


@pytest.mark.parametrize("L_cap", [None, 3])
def test_fused_alignment_coverage_bit_identical(dbs, L_cap):
    """The one-shot wrapper's na / ta / bc and per-read columns equal the
    reference's on the same reads, at the range scatter and a forced
    window."""
    db = dbs["scale2"]
    index = _host.build_align_index(db)
    codes, lens, _ = port_bench.simulate_read_batch(index, 3000, 150, 0.01,
                                                    seed=3)
    want = ref_fused.fused_alignment_coverage(
        RefAligner(index), codes, lens, ref_fused.build_fused_tables(db, index),
        1024, L_cap)
    got = port_fused.fused_alignment_coverage(
        aligner_from_reference(index, _host.AlignConfig(), CPU), codes, lens,
        port_fused.build_fused_tables(db, index, CPU), 1024, L_cap)
    for name in ("na_d", "ta_d", "bc_d"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), name)
    for k in ("mapq", "aligned", "ridx", "read_len"):
        np.testing.assert_array_equal(got.reads[k], want.reads[k], k)
    assert got.n_overflow == want.n_overflow
    assert got.reads["aligned"].mean() > 0.99


def test_entry_query_matches_reference(tmp_path):
    """entry()'s query step on the CPU gives the reference entry()'s rows
    (the same tiny_db genomes, reads and aligner parameters)."""
    import __graft_entry__

    ref_fn, ref_args = __graft_entry__.entry()
    want = ref_fn(*ref_args)
    fn, args = entry("cpu", tmp_path / "tiny")
    assert all(a.device == CPU for a in args)
    assert args[6].shape == (256, 128)
    got = fn(*args)
    assert len(got) == len(want) == 7
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), str(i))
    assert got[6].float().mean() > 0.95


def test_entry_needs_a_card_by_default(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        entry(root=tmp_path)
    assert not os.listdir(tmp_path)
