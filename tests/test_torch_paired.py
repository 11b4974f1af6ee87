"""Paired-end reads in the PyTorch port against the JAX reference (CPU,
plain versions): the joint mate query's packed [8, B] rows bit-identical to
``_query_batch_paired_packed``, ``feed_paired`` coverage and per-read
columns bit-identical to the reference's ``FusedPipeline.feed_paired`` (row
order included), and with HiGHS the four output files byte-identical."""
import dataclasses
import filecmp

import numpy as np
import pytest

import pantax_tpu.ops.fused as ref_fused
from pantax_tpu.align.aligner import Aligner as RefAligner
from pantax_tpu_torch import _host
from pantax_tpu_torch.benchmarks import scale_db, tiny_db
from pantax_tpu_torch.convert import (
    aligner_from_reference, fused_tables_from_reference,
)
from pantax_tpu_torch.ops import fused as port_fused

from _torch_helpers import reference_on_one_device  # noqa: F401 (autouse)
from _torch_helpers import simulate_pairs

OUT_FILES = ("species_abundance.txt", "strain_abundance.txt",
             "ori_strain_abundance.txt", "reads_classification.tsv")


def _codes(seqs, L):
    codes = np.full((len(seqs), L), 4, dtype=np.int8)
    lens = np.zeros(len(seqs), dtype=np.int64)
    for i, s in enumerate(seqs):
        codes[i, :len(s)] = _host.encode_seq(s)
        lens[i] = len(s)
    return codes, lens


class Setup:
    def __init__(self, db):
        self.db = db
        self.index = _host.build_align_index(db)
        self.ref_aligner = RefAligner(self.index)
        self.aligner = aligner_from_reference(self.index, _host.AlignConfig(),
                                              "cpu")


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return Setup(tiny_db(tmp_path_factory.mktemp("tiny")))


@pytest.fixture(scope="module")
def scale(tmp_path_factory):
    return Setup(scale_db(tmp_path_factory.mktemp("scale"), n_species=3,
                          genome_len=50_000))


@pytest.fixture(scope="module")
def repeat(tmp_path_factory):
    """One genome holding an exact 400 bp repeat twice, 6 kb apart (the
    reference's paired_setup, tests/test_aligner.py)."""
    rng = np.random.default_rng(77)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    u1, rep, u2, u3 = (bases[rng.integers(0, 4, k)].tobytes()
                       for k in (6000, 400, 6000, 6000))
    genome = u1 + rep + u2 + rep + u3
    root = tmp_path_factory.mktemp("paired")
    _host.write_fasta(root / "GCF_p.1_g_genomic.fna", [("c", genome)])
    _host.write_genomes_info(root / "info.txt", [_host.GenomeInfo(
        "GCF_p.1_g", "88.1", "88", "org", "GCF_p.1_g_genomic.fna")])
    s = Setup(_host.build_database(root / "info.txt", root / "db",
                                   base_dir=root))
    s.genome, s.rep1 = genome, len(u1)
    return s


def _repeat_pairs(s):
    """Mate 1 inside the first repeat copy, mate 2 in unique sequence."""
    m1, m2 = [], []
    for i in range(8):
        st = s.rep1 + 40 + i
        m1.append(s.genome[st:st + 150])
        m2.append(_host.revcomp(s.genome[st + 420 - 150:st + 420]))
    return (*_codes(m1, 160), *_codes(m2, 160))


def _junk_pairs(s):
    """Mate 1: 100 clean bases and a 50-base junk tail (a score between the
    rescue and the normal threshold); mate 2 clean."""
    rng = np.random.default_rng(5)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    m1, m2 = [], []
    for i in range(8):
        st = 1000 + 37 * i
        m1.append(s.genome[st:st + 100] + bases[rng.integers(0, 4, 50)].tobytes())
        m2.append(_host.revcomp(s.genome[st + 400 - 150:st + 400]))
    return (*_codes(m1, 160), *_codes(m2, 160))


def _rows(s, c1, l1, c2, l2):
    """(port rows, reference rows), packed int32 [8, B]."""
    got = s.aligner.query_paired_packed(*s.aligner.upload(c1, l1),
                                        *s.aligner.upload(c2, l2)).numpy()
    want = np.asarray(s.ref_aligner.dispatch_paired_codes(c1, l1, c2, l2))
    return got, want


@pytest.mark.parametrize("case", ["tiny", "scale", "repeat", "junk"])
def test_paired_rows_bit_identical(case, request):
    """Bit-identical rows on the tiny DB and the 3-species scale slice (1%
    substitutions, empty and short mates), on the repeat fixture (exact
    score ties between candidate pairs) and on junk-tail mates (rescue)."""
    if case in ("tiny", "scale"):
        s = request.getfixturevalue(case)
        c1, l1, c2, l2 = simulate_pairs(s.index, 1024, seed=3)
        l2[:4] = (0, 30, 90, 149)
    else:
        s = request.getfixturevalue("repeat")
        c1, l1, c2, l2 = (_repeat_pairs if case == "repeat" else _junk_pairs)(s)
    got, want = _rows(s, c1, l1, c2, l2)
    assert got.shape == (8, len(l1))
    np.testing.assert_array_equal(got, want)
    al1, al2 = got[3] & 1, got[7] & 1
    if case in ("tiny", "scale"):
        assert al1.mean() > 0.95 and al2[4:].mean() > 0.95
    elif case == "repeat":
        # ambiguous alone, placed (and confident) through its mate
        assert al1.all() and al2.all() and (got[3] >> 2 > 0).all()
        hap_off = int(s.index.hap_offsets[0])
        np.testing.assert_array_equal(got[0], hap_off + s.rep1 + 40 + np.arange(8))
    else:
        single = s.aligner.query_packed(*s.aligner.upload(c1, l1)).numpy()
        assert al1.sum() > (single[3] & 1).sum()  # rescued mates
        assert al2.all()


def test_align_paired_codes_unequal_widths(tiny):
    """Mates of different code widths are padded with 4 to the wider: the
    same BatchResults as on equal widths."""
    c1, l1, c2, l2 = simulate_pairs(tiny.index, 256, seed=8)
    r1, r2 = tiny.aligner.align_paired_codes(c1, l1, c2, l2)
    w1, w2 = tiny.aligner.align_paired_codes(c1[:, :152], l1, c2, l2)
    for a, b in ((r1, w1), (r2, w2)):
        for f in dataclasses.fields(a):
            np.testing.assert_array_equal(getattr(a, f.name),
                                          getattr(b, f.name), err_msg=f.name)
    assert r1.aligned.mean() > 0.95


def _feed_both(s, n, batch, seed=4):
    c1, l1, c2, l2 = simulate_pairs(s.index, n, seed=seed)
    ids1 = [f"A{i}" for i in range(n)]
    ids2 = [f"B{i}" for i in range(n)]
    ref_tables = ref_fused.build_fused_tables(s.db, s.index)
    jp = ref_fused.FusedPipeline(s.ref_aligner, ref_tables, batch=batch)
    jp.feed_paired(c1, l1, c2, l2, ids1=ids1, ids2=ids2)
    want = jp.finish()
    assert jp.use_ranges
    tables = fused_tables_from_reference(ref_tables, "cpu")
    pp = port_fused.FusedPipeline(s.aligner, tables, batch=batch)
    pp.feed_paired(c1, l1, c2, l2, ids1=ids1, ids2=ids2)
    got = pp.finish()
    assert pp.n_batches == -(-n // batch)
    return ref_tables, tables, want, got, (ids1, ids2)


@pytest.mark.parametrize("fixture,n,batch", [("tiny", 1500, 512),
                                             ("scale", 1024, 384)])
def test_feed_paired_bit_identical(fixture, n, batch, request):
    """na/ta/bc and the per-read columns, in the reference's row order
    (a mate-1 block, then a mate-2 block, per batch; the last batch
    padded), bit-identical to the reference's feed_paired."""
    s = request.getfixturevalue(fixture)
    _rt, _t, want, got, (ids1, ids2) = _feed_both(s, n, batch)
    for name, a, b in (("na", want.na_d, got.na_d), ("ta", want.ta_d, got.ta_d),
                       ("bc", want.bc_d, got.bc_d)):
        a = np.asarray(a)
        assert a.dtype == b.numpy().dtype, name
        np.testing.assert_array_equal(a, b.numpy(), err_msg=name)
    for k in ("mapq", "aligned", "ridx", "read_len"):
        assert want.reads[k].dtype == got.reads[k].dtype, k
        np.testing.assert_array_equal(want.reads[k], got.reads[k], err_msg=k)
    order = [i for lo in range(0, n, batch)
             for ids in (ids1, ids2) for i in ids[lo:lo + batch]]
    assert got.reads["ids"] == list(want.reads["ids"]) == order
    assert got.reads["aligned"].mean() > 0.95


def test_paired_highs_host_tail_files_byte_identical(tiny, tmp_path):
    ref_tables, tables, want, got, _ids = _feed_both(tiny, 1500, 512, seed=6)
    cfg = _host.ProfilingConfig.for_read_type("short")
    cfg.solver, cfg.tail = "highs", "host"
    ref_fused.profile_from_fused_result(want, ref_tables, tiny.index, tiny.db,
                                        cfg, tmp_path / "ref")
    port_fused.profile_from_fused_result(got, tables, tiny.index, tiny.db, cfg,
                                         tmp_path / "port")
    for name in OUT_FILES:
        assert filecmp.cmp(tmp_path / "ref" / name, tmp_path / "port" / name,
                           shallow=False), name
    assert len((tmp_path / "port" / "strain_abundance.txt").read_text()
               .splitlines()) == 5


def test_feed_paired_raises_on_revisiting_hap(tiny):
    """A haplotype that revisits a node (its second segment's node set to
    its first's) takes the windowed coverage (ROADMAP M9): the same
    na/ta/bc, per-read columns and overflow count as the reference's
    feed_paired on that index.  Unequal mate counts are refused."""
    s = tiny
    lo, hi = s.index.hap_offsets[1], s.index.hap_offsets[2]
    segs = np.flatnonzero((s.index.tstart >= lo) & (s.index.tstart < hi))
    tnode = s.index.tnode.copy()
    tnode[segs[1]] = tnode[segs[0]]
    index = dataclasses.replace(s.index, tnode=tnode)
    tables = port_fused.build_fused_tables(s.db, index, "cpu")
    assert tables.has_dups
    aligner = aligner_from_reference(index, _host.AlignConfig(), "cpu")
    c1, l1, c2, l2 = simulate_pairs(index, 192, seed=1)
    jp = ref_fused.FusedPipeline(RefAligner(index),
                                 ref_fused.build_fused_tables(s.db, index), 64)
    jp.feed_paired(c1, l1, c2, l2)
    want = jp.finish()
    pp = port_fused.FusedPipeline(aligner, tables, 64)
    pp.feed_paired(c1, l1, c2, l2)
    got = pp.finish()
    assert not jp.use_ranges and not pp.use_ranges and pp.L_cap == jp.L_cap
    for a, b in ((want.na_d, got.na_d), (want.ta_d, got.ta_d),
                 (want.bc_d, got.bc_d)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    for k in ("mapq", "aligned", "ridx", "read_len"):
        np.testing.assert_array_equal(want.reads[k], got.reads[k], err_msg=k)
    assert got.n_overflow == want.n_overflow
    assert got.reads["aligned"].mean() > 0.9
    pp = port_fused.FusedPipeline(s.aligner, port_fused.build_fused_tables(
        s.db, s.index, "cpu"), 64)
    with pytest.raises(ValueError, match="equal mate counts"):
        pp.feed_paired(c1, l1, c2[:10], l2[:10])
