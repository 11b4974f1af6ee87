"""The seed stage (K3's plain version, ops/seed.py) against the JAX
package's: seed_candidates_plain bit for bit against the composition of
_kmer_hashes_j, _select_seeds, _lookup_hits, _vote_diagonals on each strand
and the strand union of _all_candidates, on the same unpacked codes and
seed tables (CPU).  The kernel itself is held to the plain version on the
card (tests/test_torch_cuda.py, chip_smoke.py)."""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pantax_tpu.align.aligner as ref
from pantax_tpu_torch import _host
from pantax_tpu_torch.align import aligner as port
from pantax_tpu_torch.benchmarks import scale_db, simulate_read_batch, tiny_db
from pantax_tpu_torch.ops import extend, seed


@pytest.fixture(scope="module")
def dbs(tmp_path_factory):
    return {"tiny": tiny_db(tmp_path_factory.mktemp("tiny")),
            "scale": scale_db(tmp_path_factory.mktemp("scale"), n_species=2,
                              strains_per=2, genome_len=30_000)}


def _tables(db, density_bits: int, lookup: str, monkeypatch):
    """(index, cfg_static, run_table, seed_pos, bucket_lo) for ``db`` at
    ``density_bits``; ``lookup`` "bisect" forces the bucketed bisection."""
    index = _host.build_align_index(db, density_bits=density_bits,
                                    save=False)
    if lookup == "bisect":
        monkeypatch.setattr(port, "_build_chd", lambda keys: None)
    run_table, seed_pos, bits, bucket_lo, steps = port.build_seed_lookup(
        index.seed_keys, index.seed_pos, 4)
    assert (steps >= 0) == (lookup == "bisect")
    return index, (index.k, index.density_bits, bits, steps, 16, 4, 2, 4), \
        run_table, seed_pos, bucket_lo


@partial(jax.jit, static_argnames=("cfg",))
def _jax_seed_stage(codes_fwd, read_len, run_table, seed_pos, bucket_lo,
                    cfg):
    """The reference's seed stage: _all_candidates up to its union."""
    k, density_bits, bucket_bits, steps, s_max, hits, K, pad = cfg
    B = codes_fwd.shape[0]
    hashes, valid = ref._kmer_hashes_j(codes_fwd, k)
    sel_pos, sel_hash, sel_valid = ref._select_seeds(hashes, valid,
                                                     density_bits, s_max)
    hit_pos, hit_valid = ref._lookup_hits(
        run_table, seed_pos, bucket_lo, bucket_bits, steps, sel_hash,
        sel_valid, hits)
    p = sel_pos[..., None]
    d_fwd = (hit_pos - p).reshape(B, -1)
    d_rev = (hit_pos - (read_len[:, None, None] - k - p)).reshape(B, -1)
    hv = hit_valid.reshape(B, -1)
    cd_f, cv_f = ref._vote_diagonals(d_fwd, hv, band=pad, top_k=K)
    cd_r, cv_r = ref._vote_diagonals(d_rev, hv, band=pad, top_k=K)
    # the union, as _all_candidates (:537-549) takes it
    diag_u = jnp.concatenate([cd_f, cd_r], axis=1)
    vote_u = jnp.concatenate([cv_f, cv_r], axis=1)
    cols2k = jnp.arange(2 * K, dtype=jnp.int32)[None, :]
    sel_cols = []
    v = vote_u
    for _ in range(K):
        b = jnp.argmax(v, axis=1).astype(jnp.int32)
        sel_cols.append(b)
        v = jnp.where(cols2k == b[:, None], -1, v)
    sel = jnp.stack(sel_cols, axis=1)
    return (jnp.take_along_axis(diag_u, sel, axis=1),
            jnp.take_along_axis(vote_u, sel, axis=1),
            (sel >= K).astype(jnp.int8))


def _reads(index, n: int, width: int, seed_: int):
    """Simulated reads cut to ``width`` columns, unpacked as the query
    unpacks them; rows of length 0, 15 (< k), 40 and all-N among them."""
    codes, lens, _ = simulate_read_batch(index, n, width, 0.01, seed=seed_,
                                         indel_rate=0.01)
    codes = np.ascontiguousarray(codes[:, :width])
    lens[:4] = (0, 15, 40, width)
    codes[3] = 4
    lens_t = torch.from_numpy(lens.astype(np.int32))
    return port.unpack_reads(torch.from_numpy(codes), lens_t), lens_t


CASES = [  # (db, lookup, width, density bits)
    ("tiny", "chd", 150, 3), ("tiny", "chd", 100, 3), ("tiny", "chd", 120, 3),
    ("tiny", "chd", 250, 3), ("tiny", "bisect", 150, 3),
    ("tiny", "bisect", 250, 4), ("tiny", "chd", 150, 4),
    ("scale", "chd", 150, 3), ("scale", "bisect", 120, 3),
    ("scale", "chd", 100, 4),
]


@pytest.mark.parametrize("db_name,lookup,width,density_bits", CASES)
def test_seed_stage_matches_jax(dbs, monkeypatch, db_name, lookup, width,
                                density_bits):
    index, cfg, run_table, seed_pos, bucket_lo = _tables(
        dbs[db_name], density_bits, lookup, monkeypatch)
    codes_fwd, lens = _reads(index, 256, width, seed_=width + density_bits)
    ours = seed.seed_candidates_plain(
        codes_fwd, lens, *(torch.from_numpy(np.asarray(a))
                           for a in (run_table, seed_pos, bucket_lo)), cfg)
    theirs = _jax_seed_stage(jnp.asarray(codes_fwd.numpy()),
                             jnp.asarray(lens.numpy()), jnp.asarray(run_table),
                             jnp.asarray(seed_pos), jnp.asarray(bucket_lo),
                             cfg)
    for a, b, name in zip(ours, theirs, ("cand_diag", "cand_votes",
                                         "strand")):
        assert a.numpy().dtype == b.dtype, name
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
    diag, votes, strand = (a.numpy() for a in ours)
    # the empty, too-short and all-N rows: no seed, cand_diag BIG, 0 votes
    assert (votes[[0, 1, 3]] == 0).all() and (diag[[0, 1, 3]] == seed.BIG).all()
    assert (votes[4:, 0] > 0).mean() > 0.9  # the reads really seeded
    assert 0.2 < strand[4:, 0].mean() < 0.8  # both strands win


def test_seed_candidates_takes_the_plain_version_on_cpu(dbs, monkeypatch):
    index, cfg, *tables = _tables(dbs["tiny"], 3, "chd", monkeypatch)
    codes_fwd, lens = _reads(index, 64, 150, seed_=9)
    tables = [torch.from_numpy(np.asarray(a)) for a in tables]
    before = dict(extend.LAUNCHES)
    got = seed.seed_candidates(codes_fwd, lens, *tables, cfg)
    assert extend.LAUNCHES["seed_stage_plain"] == before["seed_stage_plain"] + 1
    assert extend.LAUNCHES["seed_stage"] == before["seed_stage"]
    for a, b in zip(got, seed.seed_candidates_plain(codes_fwd, lens, *tables,
                                                    cfg)):
        assert torch.equal(a, b)
    run_table = tables[0][:, :5].contiguous()  # a CHD row of 2 + 3 columns
    with pytest.raises(ValueError):
        seed.seed_candidates(codes_fwd, lens, run_table, *tables[1:], cfg)
