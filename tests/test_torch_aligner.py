"""Aligner port against the JAX reference: host-side tables array-equal,
hashes equal to the numpy oracle, and the packed [4, B] query rows
bit-identical to ``_query_batch_packed`` (CPU, plain versions)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import pantax_tpu.align.aligner as ref
from pantax_tpu.align.encode import kmer_hashes as np_kmer_hashes
from pantax_tpu.benchmarks import scale_db as ref_scale_db
from pantax_tpu.benchmarks import simulate_read_batch as ref_simulate
from pantax_tpu_torch import _host
from pantax_tpu_torch.align import aligner as port
from pantax_tpu_torch.benchmarks import scale_db, simulate_read_batch, tiny_db
from pantax_tpu_torch.convert import aligner_from_reference

from _torch_helpers import reference_on_one_device  # noqa: F401 (autouse)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    db = tiny_db(tmp_path_factory.mktemp("tiny"))
    return db, _host.build_align_index(db)


@pytest.fixture(scope="module")
def scale(tmp_path_factory):
    db = scale_db(tmp_path_factory.mktemp("scale"), n_species=3,
                  genome_len=50_000)
    return db, _host.build_align_index(db)


def _ref_rows(index, codes, lens):
    return np.asarray(ref.Aligner(index).dispatch_codes(codes, lens))


def _port_rows(index, codes, lens):
    al = aligner_from_reference(index, _host.AlignConfig(), "cpu")
    return al.query_packed(*al.upload(codes, lens)).numpy()


def test_host_tables_array_equal(tiny):
    _db, index = tiny
    np.testing.assert_array_equal(port.pack_text2d(index.text),
                                  ref.pack_text2d(index.text))
    keys = index.seed_keys
    assert port.build_bucket_table(keys)[0] == ref.build_bucket_table(keys)[0]
    np.testing.assert_array_equal(port.build_bucket_table(keys)[1],
                                  ref.build_bucket_table(keys)[1])
    ours = port.build_seed_lookup(keys, index.seed_pos, 4)
    theirs = ref.build_seed_lookup(keys, index.seed_pos, 4)
    assert ours[4] == theirs[4] == -1 and ours[2] == theirs[2]
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_chd_numpy_fallback_matches_reference(tiny, monkeypatch):
    """Without the native library both CHD placements take their numpy
    rounds."""
    _db, index = tiny
    keys = np.unique(index.seed_keys).astype(np.uint32)
    monkeypatch.setattr(_host, "chd_build_native", lambda *a: None)
    monkeypatch.setattr("pantax_tpu.utils.native.chd_build_native",
                        lambda *a: None)
    ours, theirs = port._build_chd(keys), ref._build_chd(keys)
    assert ours[2:] == theirs[2:]
    np.testing.assert_array_equal(ours[0], theirs[0])
    np.testing.assert_array_equal(ours[1], theirs[1])


def test_kmer_hashes_match_numpy_oracle():
    rng = np.random.default_rng(0)
    codes = rng.integers(0, 5, size=(6, 96)).astype(np.int8)
    h, v = port.kmer_hashes(torch.from_numpy(codes), 21)
    for i in range(len(codes)):
        hn, vn = np_kmer_hashes(codes[i], 21)
        np.testing.assert_array_equal(h[i].numpy(), hn.astype(np.int64))
        np.testing.assert_array_equal(v[i].numpy(), vn)


def test_unpack_and_revcomp_match_reference():
    rng = np.random.default_rng(1)
    codes = rng.integers(0, 5, size=(16, 30)).astype(np.int8)
    lens = rng.integers(0, 31, size=16).astype(np.int32)
    lens[:2] = (0, 30)
    fwd = port.unpack_reads(torch.from_numpy(codes), torch.from_numpy(lens))
    assert fwd.shape == (16, 32)
    want = np.full((16, 32), 4, np.int8)
    for i, n in enumerate(lens):
        want[i, :n] = codes[i, :n]
    np.testing.assert_array_equal(fwd.numpy(), want)
    rev = port.rev_codes(fwd, torch.from_numpy(lens))
    np.testing.assert_array_equal(
        rev.numpy(), np.asarray(ref._rev_codes_j(jnp.asarray(want),
                                                 jnp.asarray(lens))))


def test_simulator_matches_reference(tiny):
    _db, index = tiny
    for a, b in zip(simulate_read_batch(index, 200, 150, 0.02, seed=4,
                                        indel_rate=0.01),
                    ref_simulate(index, 200, 150, 0.02, seed=4,
                                 indel_rate=0.01)):
        np.testing.assert_array_equal(a, b)


def test_scale_db_matches_reference(scale, tmp_path):
    db, index = scale
    ref_db = ref_scale_db(tmp_path / "ref", n_species=3, genome_len=50_000)
    for name in ("genomes_info_file", "range_file"):
        a = open(getattr(db, name)).read().replace(str(db.root.parent), "")
        b = open(getattr(ref_db, name)).read().replace(str(ref_db.root.parent), "")
        assert a == b, name
    np.testing.assert_array_equal(index.text,
                                  _host.build_align_index(ref_db).text)


def test_query_rows_bit_identical_tiny(tiny):
    _db, index = tiny
    codes, lens, _ = simulate_read_batch(index, 1024, 150, 0.01, seed=3)
    lens[:3] = (0, 40, 149)  # empty and short reads
    np.testing.assert_array_equal(_port_rows(index, codes, lens),
                                  _ref_rows(index, codes, lens))


def test_query_rows_bit_identical_scale(scale):
    """1% substitutions and 1% indels on a 3-species scale_db slice."""
    _db, index = scale
    codes, lens, _ = simulate_read_batch(index, 2048, 150, 0.01, seed=5,
                                         indel_rate=0.01)
    rows = _port_rows(index, codes, lens)
    np.testing.assert_array_equal(rows, _ref_rows(index, codes, lens))
    assert (rows[3] & 1).mean() > 0.9  # the reads really aligned


@pytest.mark.parametrize("width", [150, 100, 120, 250])
def test_query_rows_bit_identical_odd_width(tiny, width):
    """Code matrices of a width that is no multiple of 16, which the port
    pads for K1 (its rows are loaded 16 bytes at a time).  At 120 and 250
    the padding (to 128 and 256) would change the packed cell layout, which
    shows in the read of length 0: the DP keeps the unpadded width's."""
    _db, index = tiny
    codes, lens, _ = simulate_read_batch(index, 512, width, 0.01, seed=7)
    codes = np.ascontiguousarray(codes[:, :width])
    lens[:3] = (0, 40, width - 1)
    rows = _port_rows(index, codes, lens)
    np.testing.assert_array_equal(rows, _ref_rows(index, codes, lens))
    assert (rows[3] & 1).mean() > 0.9


def test_bisection_lookup_bit_identical(tiny, monkeypatch):
    """Force the bucketed-bisection seed lookup in both packages."""
    _db, index = tiny
    monkeypatch.setattr(ref, "_build_chd", lambda keys: None)
    monkeypatch.setattr(port, "_build_chd", lambda keys: None)
    lookup = port.build_seed_lookup(index.seed_keys, index.seed_pos, 4)
    assert lookup[4] >= 0
    codes, lens, _ = simulate_read_batch(index, 512, 150, 0.01, seed=6)
    np.testing.assert_array_equal(_port_rows(index, codes, lens),
                                  _ref_rows(index, codes, lens))
