"""The long-read slice of the PyTorch port against the JAX reference (CPU,
plain versions): window extraction, the seed-free extension rows, the long
read simulator, align_long_reads (arrays and GAF records, against both of
the reference's read wires), the interval feeds of the fused pipeline, and
the long-read profile's output files."""
import dataclasses
import filecmp

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import pantax_tpu.align.aligner as ref_aligner
import pantax_tpu.align.long_read as ref_long
import pantax_tpu.ops.fused as ref_fused
from pantax_tpu.benchmarks import simulate_long_reads as ref_simulate_long
from pantax_tpu_torch import _host
from pantax_tpu_torch.align import aligner as port_aligner
from pantax_tpu_torch.align import long_read as port_long
from pantax_tpu_torch.benchmarks import (
    scale_db, simulate_long_reads, simulate_read_batch, tiny_db,
)
from pantax_tpu_torch.convert import (
    aligner_from_reference, fused_tables_from_reference,
)
from pantax_tpu_torch.ops import extend
from pantax_tpu_torch.ops import fused as port_fused

from _torch_helpers import reference_on_one_device  # noqa: F401 (autouse)

OUT_FILES = ("species_abundance.txt", "strain_abundance.txt",
             "ori_strain_abundance.txt", "reads_classification.tsv")
CHUNK, BATCH = 512, 512


class Setup:
    def __init__(self, db, n_reads):
        self.db = db
        self.index = _host.build_align_index(db)
        cfg = _host.AlignConfig.for_read_type("long")
        self.ref_aligner = ref_aligner.Aligner(self.index, cfg)
        self.aligner = aligner_from_reference(self.index, cfg, "cpu")
        self.ref_tables = ref_fused.build_fused_tables(db, self.index)
        self.tables = fused_tables_from_reference(self.ref_tables, "cpu")
        self.reads, self.hap = simulate_long_reads(self.index, n_reads, 4096,
                                                   seed=9)
        self._arrays = None

    def arrays(self):
        """The port's stride-2 alignment arrays of self.reads (cached)."""
        if self._arrays is None:
            self._arrays = port_long.align_long_reads(
                self.aligner, self.reads, chunk=CHUNK, batch_size=BATCH,
                seed_stride=2, as_arrays=True)
        return self._arrays


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return Setup(tiny_db(tmp_path_factory.mktemp("tiny")), 48)


@pytest.fixture(scope="module")
def scale(tmp_path_factory):
    return Setup(scale_db(tmp_path_factory.mktemp("scale"), n_species=3,
                          genome_len=50_000), 64)


@pytest.mark.parametrize("W", [168, 528])
def test_extract_windows_matches_reference(tiny, W):
    text = tiny.index.text
    rng = np.random.default_rng(W)
    T = len(text) - (W + 255) // 256 * 256
    w0 = rng.integers(0, T - W + 1, size=300).astype(np.int32)
    w0[:2] = (0, T - W)
    want = ref_aligner._extract_windows(
        jnp.asarray(ref_aligner.pack_text2d(text)), jnp.asarray(w0), W)
    got = port_aligner.extract_windows(torch.from_numpy(text),
                                       torch.from_numpy(w0), W)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _extend_case(index, B, pad, seed):
    """Chunks cut from the text with 2% substitutions (reverse-complemented
    on strand 1), at w0 near their true start; rows with w0 below 0 and
    past T - W, empty and short rows."""
    rng = np.random.default_rng(seed)
    text = index.text
    start = rng.integers(0, len(text) - 2048, size=B)
    codes = text[start[:, None] + np.arange(CHUNK)].copy()
    noise = rng.random(codes.shape) < 0.02
    codes[noise] = rng.integers(0, 4, size=int(noise.sum()))
    strand = (rng.random(B) < 0.5).astype(np.int8)
    rc = np.where(codes < 4, 3 - codes, 4)[:, ::-1]
    codes = np.where(strand[:, None] == 1, rc, codes).astype(np.int8)
    lens = np.full(B, CHUNK, dtype=np.int64)
    lens[:4] = (0, 1, 100, 300)
    for i in range(4):
        codes[i, lens[i]:] = 4
    w0 = (start - pad + rng.integers(-3, 4, size=B)).astype(np.int64)
    w0[4:8] = (-50, -1, len(text), len(text) + 10_000)  # clipped by extend
    return codes, lens, w0, strand


def test_extend_packed_rows_bit_identical(tiny):
    s = tiny
    codes, lens, w0, strand = _extend_case(s.index, 256,
                                           s.aligner.cfg.extension_band, 1)
    want = np.asarray(s.ref_aligner.dispatch_extend(codes, lens, w0, strand))
    before = extend.LAUNCHES["banded_extend_windows_plain"]
    rows = s.aligner.extend_packed(codes, lens, w0, strand)
    assert extend.LAUNCHES["banded_extend_windows_plain"] == before + 1
    np.testing.assert_array_equal(rows.numpy(), want)
    res = port_aligner.unpack_result_rows(rows)
    ref_res = ref_aligner.Aligner.collect(want)
    for name in ("text_start", "text_end", "score", "matches", "mapq",
                 "strand", "aligned"):
        a, b = getattr(res, name), getattr(ref_res, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert res.aligned[8:].mean() > 0.9  # the real rows aligned
    assert set(res.strand.tolist()) == {0, 1}


def test_simulate_long_reads_matches_reference(tiny):
    ours, hap = simulate_long_reads(tiny.index, 40, 3000, seed=4)
    theirs, ref_hap = ref_simulate_long(tiny.index, 40, 3000, seed=4)
    np.testing.assert_array_equal(hap, ref_hap)
    assert ours == theirs


def _assert_arrays_equal(got, want):
    assert got.read_ids == want.read_ids
    for name in ("ts", "te", "mapq", "read_len"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("fixture", ["tiny", "scale"])
def test_align_long_reads_bit_identical(fixture, stride, request,
                                        monkeypatch):
    """Arrays and GAF records equal the reference's, with its default
    (read-group buffer) wire and with its codes wire."""
    s = request.getfixturevalue(fixture)
    kw = dict(chunk=CHUNK, batch_size=BATCH, seed_stride=stride)
    extend.reset_launch_counts()
    got = port_long.align_long_reads(s.aligner, s.reads, as_arrays=True, **kw)
    if stride == 2:
        assert extend.LAUNCHES["banded_extend_windows_plain"] > 0
    got_gaf = port_long.align_long_reads(s.aligner, s.reads, **kw)
    assert len(got.read_ids) >= 0.9 * len(s.reads)
    for wire in ("buffer", "codes"):
        if wire == "codes":
            monkeypatch.setenv("PANTAX_TPU_READ_BUFFER", "0")
        want = ref_long.align_long_reads(s.ref_aligner, s.reads,
                                         as_arrays=True, **kw)
        _assert_arrays_equal(got, want)
        # each package has its own GafRecord class: compare the fields
        want_gaf = ref_long.align_long_reads(s.ref_aligner, s.reads, **kw)
        assert ([dataclasses.astuple(r) for r in got_gaf]
                == [dataclasses.astuple(r) for r in want_gaf]), wire


def test_read_groups_and_concat_match_reference(tiny, tmp_path):
    """Streamed read groups from a FASTA, aligned group by group and
    concatenated, equal the reference's, and the whole-list call."""
    path = tmp_path / "long.fa"
    _host.write_fasta(path, tiny.reads[:24])
    ours = list(port_long.iter_read_groups([str(path)], group_bases=20_000))
    theirs = list(ref_long.iter_read_groups([str(path)], group_bases=20_000))
    assert ours == theirs and len(ours) > 2
    kw = dict(chunk=CHUNK, batch_size=BATCH, seed_stride=2, as_arrays=True)
    parts = [port_long.align_long_reads(tiny.aligner, g, **kw) for g in ours]
    got = port_long.concat_arrays(parts)
    _assert_arrays_equal(got, ref_long.concat_arrays(
        [ref_long.align_long_reads(tiny.ref_aligner, g, **kw)
         for g in theirs]))
    _assert_arrays_equal(got, port_long.align_long_reads(
        tiny.aligner, tiny.reads[:24], **kw))
    _assert_arrays_equal(port_long.concat_arrays([]),
                         ref_long.concat_arrays([]))


def _split_feeds(arr, mode):
    """The interval feeds of one run: two halves (the second with a few
    unaligned rows), as the CLI feeds one read group after another."""
    n = len(arr.read_ids)
    h = n // 2
    al2 = np.ones(n - h, dtype=bool)
    al2[::7] = False
    if mode == "one":
        return [(arr.ts, arr.te, arr.mapq, arr.read_len, arr.read_ids, None)]
    return [(arr.ts[:h], arr.te[:h], arr.mapq[:h], arr.read_len[:h],
             arr.read_ids[:h], None),
            (arr.ts[h:], arr.te[h:], arr.mapq[h:], arr.read_len[h:],
             arr.read_ids[h:], al2)]


def _run_pipelines(s, mode, codes=None):
    batch = 16
    jp = ref_fused.FusedPipeline(s.ref_aligner, s.ref_tables, batch=batch)
    pp = port_fused.FusedPipeline(s.aligner, s.tables, batch=batch)
    feeds = _split_feeds(s.arrays(), "two" if mode != "one" else "one")
    for pipe in (jp, pp):
        if codes is not None:
            pipe.feed(codes[0], codes[1], ids=[f"c{i}" for i in
                                               range(len(codes[1]))])
        for ts, te, mapq, rl, ids, al in feeds:
            pipe.feed_intervals(ts, te, mapq, rl, ids=ids, aligned=al)
    assert pp.n_interval_batches >= len(feeds)
    return jp.finish(), pp.finish()


@pytest.mark.parametrize("mode", ["one", "two", "codes_then_two"])
@pytest.mark.parametrize("fixture", ["tiny", "scale"])
def test_feed_intervals_bit_identical(fixture, mode, request):
    s = request.getfixturevalue(fixture)
    codes = None
    if mode == "codes_then_two":
        c, lens, _ = simulate_read_batch(s.index, 40, 150, 0.01, seed=2)
        codes = (c, lens)
    want, got = _run_pipelines(s, mode, codes)
    for name, a, b in (("na", want.na_d, got.na_d), ("ta", want.ta_d, got.ta_d),
                       ("bc", want.bc_d, got.bc_d)):
        a = np.asarray(a)
        assert a.dtype == b.numpy().dtype, name
        np.testing.assert_array_equal(a, b.numpy(), err_msg=name)
        assert b.numpy().any(), name
    for k in ("mapq", "aligned", "ridx", "read_len"):
        assert want.reads[k].dtype == got.reads[k].dtype, k
        np.testing.assert_array_equal(want.reads[k], got.reads[k], err_msg=k)
    assert got.reads["ids"] == want.reads["ids"]


def _long_profile(s, tmp_path, solver):
    cfg = _host.ProfilingConfig.for_read_type("long")
    assert cfg.unique_trio_nodes_fraction == 0.5
    cfg.tail = "host"
    cfg.solver = solver
    out_ref, out_port = tmp_path / "ref", tmp_path / "port"
    arr = s.arrays()
    for mod, aligner, tables, out in (
            (ref_fused, s.ref_aligner, s.ref_tables, out_ref),
            (port_fused, s.aligner, s.tables, out_port)):
        pipe = mod.FusedPipeline(aligner, tables, batch=BATCH)
        pipe.feed_intervals(arr.ts, arr.te, arr.mapq, arr.read_len,
                            ids=arr.read_ids)
        assert mod.profile_from_fused_result(pipe.finish(), tables, s.index,
                                             s.db, cfg, out)
    return out_ref, out_port


def test_long_profile_highs_files_byte_identical(tiny, tmp_path):
    out_ref, out_port = _long_profile(tiny, tmp_path, "highs")
    for name in OUT_FILES:
        assert filecmp.cmp(out_ref / name, out_port / name, shallow=False), name
    assert len((out_port / "strain_abundance.txt").read_text().splitlines()) == 5


def _rows(path):
    lines = path.read_text().splitlines()
    return lines[0], [ln.split("\t") for ln in lines[1:]]


def test_long_profile_admm_matches_reference(tiny, tmp_path):
    """ADMM: species table and classification byte-identical; the same
    strains, coverages within the reference's ADMM bar (0.05)."""
    out_ref, out_port = _long_profile(tiny, tmp_path, "admm")
    for name in ("species_abundance.txt", "reads_classification.tsv"):
        assert filecmp.cmp(out_ref / name, out_port / name, shallow=False), name
    for name in ("strain_abundance.txt", "ori_strain_abundance.txt"):
        head_r, rows_r = _rows(out_ref / name)
        head_p, rows_p = _rows(out_port / name)
        assert head_r == head_p
        assert sorted(r[:3] for r in rows_r) == sorted(r[:3] for r in rows_p)
        key = {tuple(r[:3]): r for r in rows_r}
        for r in rows_p:
            want = key[tuple(r[:3])]
            for col in (3, 8):  # predicted_coverage, first_sol
                assert abs(float(r[col]) - float(want[col])) <= 0.05, (name, r)
