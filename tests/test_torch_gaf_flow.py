"""The per-species GAF flow of the port (ROADMAP M11a/M11b) against the JAX
package on the CPU: FASTA/FASTQ streaming (plain and gzip, several chunks)
and the paired block reader (two files, and one interleaved file whose
chunks end on an odd record) give equal codes, offsets and ids; GAF lines
byte-equal and round-tripped; the long-read best-alignment filter equal;
align_file / align_paired_files GafRecords field-equal; and with HiGHS,
profile_from_gaf and profile_from_alignments write the four output files
byte-identical to the JAX run, with host and with device coverage, on
tiny_db and on a small dup-graph community (whose long reads' node rows
are wider than 64 nodes, where the reference's device coverage switches
to its sort dedup)."""
import dataclasses
import filecmp

import numpy as np
import pytest

import pantax_tpu.align.long_read as ref_long
import pantax_tpu.fastpath as ref_fastpath
import pantax_tpu.io.fastx as ref_fastx
import pantax_tpu.io.gaf as ref_gaf
import pantax_tpu.pipeline as ref_pipeline
from pantax_tpu.align.aligner import Aligner as RefAligner
from pantax_tpu.utils.native import fastx_parse_native as ref_parse
from pantax_tpu_torch import _host, fastpath, pipeline
from pantax_tpu_torch.align.long_read import align_long_reads
from pantax_tpu_torch.benchmarks import (
    dup_db, simulate_long_reads, simulate_read_batch, tiny_db,
)
from pantax_tpu_torch.convert import aligner_from_reference
from pantax_tpu_torch.io import fastx, gaf
from pantax_tpu_torch.utils import native

from _torch_helpers import (  # noqa: F401 (autouse)
    code_seqs, reference_on_one_device, simulate_pairs, write_reads,
)

OUT_FILES = ("species_abundance.txt", "strain_abundance.txt",
             "ori_strain_abundance.txt", "reads_classification.tsv")


class Setup:
    """Both packages' aligners over one DB (the port's on the CPU)."""

    def __init__(self, db, read_type="short"):
        self.db = db
        self.index = _host.build_align_index(db)
        cfg = _host.AlignConfig.for_read_type(read_type)
        self.ref_aligner = RefAligner(self.index, cfg)
        self.aligner = aligner_from_reference(self.index, cfg, "cpu")


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return Setup(tiny_db(tmp_path_factory.mktemp("tiny")))


@pytest.fixture(scope="module")
def dup(tmp_path_factory):
    return Setup(dup_db(tmp_path_factory.mktemp("dup"), n_species=2,
                        strains=2, n_blocks=400))


def _fastq(s, tmp_path, n, seed, name="r.fq"):
    codes, lens, _ = simulate_read_batch(s.index, n, 150, 0.01, seed=seed)
    lens = lens - np.arange(n) % 7  # ragged lengths
    path = tmp_path / name
    write_reads(path, [f"S{i}" for i in range(n)], code_seqs(codes, lens), "fq")
    return path


def _fields(records):
    return [dataclasses.astuple(r) for r in records]


def _assert_dirs_equal(a, b):
    for name in OUT_FILES:
        assert filecmp.cmp(a / name, b / name, shallow=False), name


@pytest.mark.parametrize("fmt", ["fq", "fa"])
@pytest.mark.parametrize("gz", [False, True])
def test_stream_fastx_buffers_equal(fmt, gz, tmp_path):
    """Record-aligned chunks, their native parse, and the record readers."""
    rng = np.random.default_rng(3)
    n = 300
    lens = rng.integers(1, 400, size=n)
    codes = rng.integers(0, 5, size=(n, 400)).astype(np.int8)
    path = tmp_path / (f"r.{fmt}" + (".gz" if gz else ""))
    seqs = [q.lower() if i % 5 == 0 else q  # the parsers uppercase
            for i, q in enumerate(code_seqs(codes, lens))]
    write_reads(path, [f"q{i}" for i in range(n)], seqs, fmt)
    want = list(ref_fastx.stream_fastx_buffers(path, 4096))
    got = list(fastx.stream_fastx_buffers(path, 4096))
    assert got == want and len(got) > 5
    for buf in got:
        for w, g in zip(ref_parse(buf), native.fastx_parse_native(buf)):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    name = "read_fastq" if fmt == "fq" else "read_fasta"
    assert list(fastx.iter_fastx(path)) == getattr(ref_fastx, name)(path)


def test_classify_reads_equal(tiny):
    """Node paths inside one species range, straddling two, outside every
    range, and empty: the same labels as the reference's."""
    from pantax_tpu.profile.rcls import classify_reads as ref_classify
    from pantax_tpu_torch.profile.rcls import classify_reads

    ranges = _host.load_species_range(tiny.db.range_file)
    rng = np.random.default_rng(4)
    hi = max(r.end for r in ranges)
    paths = [rng.integers(1, hi + 3, size=int(rng.integers(0, 4)))
             for _ in range(300)]
    paths += [np.arange(r.start, r.end + 1) for r in ranges]
    got = classify_reads(paths, ranges)
    assert got == ref_classify(paths, ranges)
    assert {"U", *(r.species for r in ranges)} == set(got)


@pytest.mark.parametrize("dups", [False, True])
def test_group_reads_by_species_equal(dups):
    """Without duplicate read ids, and with duplicates that agree on the
    species (renamed _2, _3) or disagree (dropped)."""
    from pantax_tpu.profile.records import ReadRecord as RefReadRecord
    from pantax_tpu.profile.records import (
        group_reads_by_species as ref_group,
    )
    from pantax_tpu_torch.profile.records import (
        ReadRecord, group_reads_by_species,
    )

    rng = np.random.default_rng(5)
    rows = [(f"r{int(rng.integers(40)) if dups else i}",
             np.arange(i, i + 3), 100, 1, 90, f"s{int(rng.integers(3))}")
            for i in range(120)]
    want = ref_group([RefReadRecord(*x) for x in rows])
    got = group_reads_by_species([ReadRecord(*x) for x in rows])
    assert list(got) == list(want)
    for sp in want:
        assert [(r.read_id, r.nodes.tolist(), r.species) for r in got[sp]] == [
            (r.read_id, r.nodes.tolist(), r.species) for r in want[sp]]
    n = sum(len(v) for v in got.values())
    assert (n < len(rows)) == dups


@pytest.mark.parametrize("interleaved", [False, True])
def test_stream_paired_parsed_equal(interleaved, tmp_path):
    """Two mate files, or one interleaved file whose chunks end on an odd
    record (the dangling mate is carried into the next chunk)."""
    rng = np.random.default_rng(5)
    n = 301 if interleaved else 150
    lens = rng.integers(50, 300, size=n)
    seqs = code_seqs(rng.integers(0, 5, size=(n, 300)).astype(np.int8), lens)
    ids = [f"p{i}" for i in range(n)]
    if interleaved:
        paths = (tmp_path / "i.fq", None)
        write_reads(paths[0], ids[:300], seqs[:300], "fq")
        odd = [len(ref_parse(b)[2]) % 2
               for b in ref_fastx.stream_fastx_buffers(paths[0], 3000)]
        assert any(odd)
    else:
        paths = (tmp_path / "1.fq", tmp_path / "2.fq")
        write_reads(paths[0], ids, seqs, "fq")
        # mates of equal length, so the two files' chunks hold equal counts
        write_reads(paths[1], ids, [q.translate(bytes.maketrans(
            b"ACGTN", b"TGCAN")) for q in seqs], "fq")

    def parse(path, buf):
        return ref_parse(buf)

    want = list(ref_fastx.stream_paired_parsed(*paths, parse, 3000))
    got = list(fastx.stream_paired_parsed(*paths, parse, 3000))
    assert len(got) == len(want) > 2
    for w, g in zip(want, got):
        for a, b in zip(w, g):
            if isinstance(a, list):
                assert a == b
            else:
                np.testing.assert_array_equal(b, a)
    if interleaved:  # an odd record count is refused
        write_reads(paths[0], ids, seqs, "fq")
        with pytest.raises(ValueError, match="odd read count"):
            list(fastx.stream_paired_parsed(*paths, parse, 3000))


def test_gaf_lines_and_round_trip(tiny, tmp_path):
    path = _fastq(tiny, tmp_path, 600, seed=6)
    records = tiny.aligner.align_file(path, batch_size=256)
    assert len(records) > 500
    ref_records = [ref_gaf.GafRecord(*dataclasses.astuple(r)) for r in records]
    assert [r.to_line() for r in records] == [r.to_line() for r in ref_records]
    gaf.write_gaf(tmp_path / "p.gaf", records)
    ref_gaf.write_gaf(tmp_path / "r.gaf", ref_records)
    assert filecmp.cmp(tmp_path / "p.gaf", tmp_path / "r.gaf", shallow=False)
    with open(tmp_path / "p.gaf", "a") as f:  # header and unaligned rows
        f.write("@HD\tVN:1\n")
        f.write("u\t150\t*\t*\t*\t*\t*\t*\t*\t0\t0\t255\n")
        f.write("short\t1\t2\n")
    back = gaf.read_gaf(tmp_path / "p.gaf")
    assert _fields(back) == _fields(ref_gaf.read_gaf(tmp_path / "p.gaf"))
    assert [b.to_line() for b in back] == [r.to_line() for r in records]
    assert [(b.read_id, b.path, b.matches) for b in back] == [
        (r.read_id, r.path, r.matches) for r in records]


def test_filter_best_long_read_alignments_equal():
    rng = np.random.default_rng(8)
    recs = [gaf.GafRecord(
        read_id=f"L{int(rng.integers(40))}", read_len=9000,
        query_start=int(rng.integers(0, 400)),
        query_end=int(rng.integers(800, 9000)), strand="+", path=">1>2",
        path_len=100, path_start=0, path_end=90,
        matches=int(rng.integers(500, 520)), block_len=9000,
        mapq=int(rng.integers(0, 61)),
        identity=float(rng.integers(0, 3)) / 4) for _ in range(400)]
    want = ref_gaf.filter_best_long_read_alignments(
        [ref_gaf.GafRecord(*dataclasses.astuple(r)) for r in recs])
    got = gaf.filter_best_long_read_alignments(recs)
    assert _fields(got) == _fields(want) and 10 < len(got) < 40


def test_align_file_records_equal(tiny, tmp_path, monkeypatch):
    """Several chunks, a ragged tail batch, gzip FASTA; and the Python
    reader gives the same records as the native parser."""
    path = _fastq(tiny, tmp_path, 1100, seed=7)
    want = tiny.ref_aligner.align_file(path, batch_size=256,
                                       chunk_bytes=40_000)
    stage = {}
    got = tiny.aligner.align_file(path, batch_size=256, chunk_bytes=40_000,
                                  stage_out=stage)
    assert _fields(got) == _fields(want) and len(got) > 1000
    assert stage["parser"] == "native" and stage["n_batches"] >= 5
    fa = tmp_path / "r.fa.gz"
    write_reads(fa, [r[0] for r in fastx.iter_fastx(path)],
                [r[1] for r in fastx.iter_fastx(path)], "fa")
    assert _fields(tiny.aligner.align_file(fa, batch_size=256)) == _fields(
        tiny.ref_aligner.align_file(fa, batch_size=256))
    monkeypatch.setattr(native, "load_native", lambda: None)
    stage = {}
    py = tiny.aligner.align_file(path, batch_size=256, stage_out=stage)
    assert stage["parser"] == "python" and _fields(py) == _fields(want)


def test_align_file_refuses_long_reads(tiny, tmp_path):
    write_reads(tmp_path / "l.fq", ["x"], [b"A" * 1200], "fq")
    with pytest.raises(ValueError, match="long-read path"):
        tiny.aligner.align_file(tmp_path / "l.fq")


@pytest.mark.parametrize("interleaved", [False, True])
def test_align_paired_files_records_equal(tiny, tmp_path, interleaved):
    c1, l1, c2, l2 = simulate_pairs(tiny.index, 700, seed=9)
    s1, s2 = code_seqs(c1, l1), code_seqs(c2, l2)
    ids = [f"P{i}" for i in range(700)]
    if interleaved:
        paths = (tmp_path / "i.fq", None)
        write_reads(paths[0], [x for i in ids for x in (i, i)],
                    [x for pair in zip(s1, s2) for x in pair], "fq")
    else:
        paths = (tmp_path / "1.fq", tmp_path / "2.fq")
        write_reads(paths[0], ids, s1, "fq")
        write_reads(paths[1], ids, s2, "fq")
    kw = dict(batch_size=256, chunk_bytes=50_000)
    want = tiny.ref_aligner.align_paired_files(*paths, **kw)
    stage = {}
    got = tiny.aligner.align_paired_files(*paths, **kw, stage_out=stage)
    assert _fields(got) == _fields(want) and len(got) > 1300
    assert stage["n_batches"] >= 3


def _profile_gaf_both(s, records, ref_records, tmp_path, coverage,
                      read_type="short"):
    cfg = _host.ProfilingConfig.for_read_type(read_type)
    # "auto" takes the device coverage for species of >= 1400 reads
    cfg.solver, cfg.coverage, cfg.auto_device_reads = "highs", coverage, 1400
    out_ref, out_port = tmp_path / f"ref_{coverage}", tmp_path / f"port_{coverage}"
    ref_pipeline.profile_from_gaf(ref_records, s.db, cfg, out_ref)
    stage = {}
    pipeline.profile_from_gaf(records, s.db, cfg, out_port, device="cpu",
                              stage_out=stage)
    _assert_dirs_equal(out_ref, out_port)
    assert set(stage) == {"classify_s", "species_s", "group_s", "coverage_s",
                          "pao_s", "report_s"}
    return out_port


@pytest.mark.parametrize("fixture", ["tiny", "dup"])
def test_profile_from_gaf_byte_identical(fixture, tmp_path, request):
    """FASTQ -> align_file -> write_gaf -> read_gaf -> profile_from_gaf,
    host, device and "auto" coverage; the coverages' tables agree too."""
    s = request.getfixturevalue(fixture)
    path = _fastq(s, tmp_path, 3000, seed=10)
    records = s.aligner.align_file(path, batch_size=1024)
    gaf.write_gaf(tmp_path / "a.gaf", records)
    records = gaf.read_gaf(tmp_path / "a.gaf")
    ref_records = ref_gaf.read_gaf(tmp_path / "a.gaf")
    outs = [_profile_gaf_both(s, records, ref_records, tmp_path, cov)
            for cov in ("host", "device", "auto")]
    for name in ("species_abundance.txt", "reads_classification.tsv"):
        for out in outs[1:]:
            assert filecmp.cmp(outs[0] / name, out / name, shallow=False)
    rows = (outs[1] / "strain_abundance.txt").read_text().splitlines()
    assert len(rows) == 5


def test_profile_from_gaf_resumes_species(tiny, tmp_path):
    """An existing species_abundance.txt is read back (SpeciesProfile.load)
    and gives the same strain tables."""
    path = _fastq(tiny, tmp_path, 2000, seed=11)
    records = tiny.aligner.align_file(path, batch_size=1024)
    cfg = _host.ProfilingConfig.for_read_type("short")
    cfg.solver = "highs"
    first, again = tmp_path / "a", tmp_path / "b"
    pipeline.profile_from_gaf(records, tiny.db, cfg, first, device="cpu")
    again.mkdir()
    (again / "species_abundance.txt").write_bytes(
        (first / "species_abundance.txt").read_bytes())
    pipeline.profile_from_gaf(records, tiny.db, cfg, again, device="cpu")
    _assert_dirs_equal(first, again)


def test_profile_from_gaf_long_reads_on_dup(tmp_path_factory, tmp_path):
    """Long reads on the dup community: align_long_reads GafRecords (equal
    to the reference's), the best-alignment filter, profile_from_gaf with
    both coverages.  The packed rows are wider than 64 nodes."""
    s = Setup(dup_db(tmp_path_factory.mktemp("dupl"), n_species=2,
                     strains=2, n_blocks=400), "long")
    reads, _ = simulate_long_reads(s.index, 12, 6000, seed=12)
    kw = dict(chunk=512, batch_size=256, seed_stride=2)
    records = align_long_reads(s.aligner, reads, **kw)
    ref_records = ref_long.align_long_reads(s.ref_aligner, reads, **kw)
    assert _fields(records) == _fields(ref_records)
    records = gaf.filter_best_long_read_alignments(records)
    ref_records = ref_gaf.filter_best_long_read_alignments(ref_records)
    assert len(records) >= 10
    assert max(len(r.path_nodes()) for r in records) > 64
    for cov in ("host", "device"):
        _profile_gaf_both(s, records, ref_records, tmp_path, cov, "long")


@pytest.mark.parametrize("fixture", ["tiny", "dup"])
def test_profile_from_alignments_byte_identical(fixture, tmp_path, request):
    """collect_alignment_arrays equal to the reference's, then
    profile_from_alignments with host and device coverage."""
    s = request.getfixturevalue(fixture)
    codes, lens, _ = simulate_read_batch(s.index, 3000, 150, 0.01, seed=13)
    want = ref_fastpath.collect_alignment_arrays(s.ref_aligner, codes, lens,
                                                 1024)
    stage = {}
    arrays = fastpath.collect_alignment_arrays(s.aligner, codes, lens, 1024,
                                               stage_out=stage)
    assert arrays.read_ids == want.read_ids and stage["n_batches"] == 3
    for k in ("ts", "te", "mapq", "read_len"):
        np.testing.assert_array_equal(getattr(arrays, k), getattr(want, k))
    for cov in ("host", "device"):
        cfg = _host.ProfilingConfig.for_read_type("short")
        cfg.solver, cfg.coverage = "highs", cov
        out_ref, out_port = tmp_path / f"r_{cov}", tmp_path / f"p_{cov}"
        ref_fastpath.profile_from_alignments(want, s.index, s.db, cfg, out_ref)
        fastpath.profile_from_alignments(arrays, s.index, s.db, cfg, out_port,
                                         device="cpu")
        _assert_dirs_equal(out_ref, out_port)


def test_collect_paired_alignment_arrays_equal(tiny):
    pairs = simulate_pairs(tiny.index, 1500, seed=14)
    want = ref_fastpath.collect_paired_alignment_arrays(
        tiny.ref_aligner, *pairs, 512)
    got = fastpath.collect_paired_alignment_arrays(tiny.aligner, *pairs, 512)
    for w, g in zip(want, got):
        assert g.read_ids == w.read_ids and len(g.read_ids) > 1400
        for k in ("ts", "te", "mapq", "read_len"):
            np.testing.assert_array_equal(getattr(g, k), getattr(w, k))


def test_auto_coverage_rule():
    """'auto' takes the device coverage at auto_device_reads reads of one
    species or more (the reference's prepare_otu / _prepare_packed rule)."""
    from pantax_tpu_torch.profile.engine import use_device_coverage

    cfg = _host.ProfilingConfig.for_read_type("short")
    assert cfg.coverage == "auto" and cfg.auto_device_reads == 500_000
    assert use_device_coverage(cfg, 500_000)
    assert not use_device_coverage(cfg, 499_999)
    cfg.coverage = "host"
    assert not use_device_coverage(cfg, 10**7)
    cfg.coverage = "device"
    assert use_device_coverage(cfg, 1)


@pytest.mark.parametrize("coverage", ["host", "device"])
def test_optimize_otu_equal(tiny, tmp_path, coverage):
    """optimize_otu for one species (HiGHS) against the reference's: every
    path's HapMetrics equal."""
    from pantax_tpu.profile.engine import optimize_otu as ref_optimize_otu
    from pantax_tpu.profile.records import ReadRecord as RefReadRecord
    from pantax_tpu_torch.profile.engine import optimize_otu
    from pantax_tpu_torch.profile.records import ReadRecord

    records = tiny.aligner.align_file(_fastq(tiny, tmp_path, 1500, seed=15),
                                      batch_size=512)
    species, paths = pipeline.classify_gaf(records, tiny.db)
    r = _host.load_species_range(tiny.db.range_file)[0]
    rows = [(g.read_id, p, g.path_len, g.path_start, g.path_end, s)
            for g, p, s in zip(records, paths, species) if s == r.species]
    assert len(rows) > 500
    cfg = _host.ProfilingConfig.for_read_type("short")
    cfg.solver, cfg.coverage = "highs", coverage
    graph = tiny.db.load_graph(r.species)
    want = ref_optimize_otu(cfg, r.species, graph, r.start, r.end,
                            [RefReadRecord(*x) for x in rows])
    got = optimize_otu(cfg, r.species, graph, r.start, r.end,
                       [ReadRecord(*x) for x in rows], device="cpu")
    assert [vars(m) for m in got] == [vars(m) for m in want]
    assert any(m.second_sol for m in got)
