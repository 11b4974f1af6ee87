"""The frozen generators give their sources' outputs for a seed."""
from __future__ import annotations

import numpy as np
import pytest

from pantax_bench import gen


@pytest.fixture(scope="module")
def scale(tmp_path_factory):
    from pantax_tpu_torch import _host, benchmarks

    db = benchmarks.scale_db(tmp_path_factory.mktemp("scale"), n_species=2,
                             strains_per=3, genome_len=20000, seed=7)
    return gen.scale_community(2, 3, 20000, 0.01, 7), _host.build_align_index(db)


def test_scale_genomes_are_scale_db(scale):
    com, index = scale
    assert np.array_equal(com.text, index.text)
    assert np.array_equal(com.hap_offsets, index.hap_offsets)
    assert [n.rsplit("_", 1)[0] for n in com.hap_names] == list(index.hap_names)


@pytest.mark.parametrize("weights", [None, [1, 3, 9] * 2])
def test_short_reads(scale, weights):
    from pantax_tpu_torch import benchmarks

    com, index = scale
    want = benchmarks.simulate_read_batch(index, 3000, 150, 0.01, seed=2**32 + 3,
                                          hap_weights=weights)
    got = gen.simulate_read_batch(com, 3000, 150, 0.01, seed=2**32 + 3,
                                  hap_weights=weights)
    for a, b in zip(want, got):
        assert np.array_equal(a, b)


def test_long_reads(scale):
    from pantax_tpu_torch import benchmarks

    com, index = scale
    want = benchmarks.simulate_long_reads(index, 20, 2048, seed=5,
                                          hap_weights=[1, 3, 9] * 2)
    got = gen.simulate_long_reads(com, 20, 2048, seed=5,
                                  hap_weights=[1, 3, 9] * 2)
    assert want[0] == got[0] and np.array_equal(want[1], got[1])


def test_pairs(scale):
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "chip_smoke_src", Path(__file__).resolve().parents[2] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    com, index = scale
    want = smoke.simulate_pairs(index, 2000, seed=13)
    got = gen.simulate_pairs(com, 2000, seed=13)
    for a, b in zip(want[0], got[0]):
        assert np.array_equal(a, b)
    assert np.array_equal(want[1], got[1])


def test_fastq_records(tmp_path):
    codes = np.array([[0, 1, 2, 3, 4, 4], [3, 3, 0, 0, 4, 4]], np.int8)
    gen.write_fastq_codes(tmp_path / "r.fq", "r", codes, 4)
    assert (tmp_path / "r.fq").read_bytes() == (
        b"@r00000000\nACGT\n+\nIIII\n@r00000001\nTTAA\n+\nIIII\n")


@pytest.mark.parametrize("max_node", [7, 1024])
def test_variation_graph_walks_spell_the_genomes(max_node):
    """The snp configuration's graphs: scale_db's genomes, every walk spells
    its genome, every node is on some walk, at most max_node bases, and a
    node an allele where the strains differ."""
    import re

    com = gen.snp_community(2, 3, 5000, 0.01, 7, max_node=max_node)
    ref = gen.scale_community(2, 3, 5000, 0.01, 7)
    assert np.array_equal(com.text, ref.text)
    for sp, data in com.make_gfa().items():
        seqs, walks = {}, {}
        for line in data.splitlines():
            f = line.split(b"\t")
            if f[0] == b"S":
                seqs[int(f[1])] = f[2]
            elif f[0] == b"W":
                walks[f[1].decode()] = [int(x) for x in re.findall(rb">(\d+)", f[6])]
        assert sorted(seqs) == list(range(1, len(seqs) + 1))
        assert max(map(len, seqs.values())) <= max_node
        used = set()
        haps = [h for h, s in enumerate(com.hap_species) if s == sp]
        for h in haps:
            walk = walks["_".join(com.hap_names[h].split("_")[:2])]
            spelled = b"".join(seqs[i] for i in walk)
            assert spelled == gen.CODE2BASE[com.genome(h)].tobytes()
            used |= set(walk)
        assert used == set(seqs)
        g = np.stack([com.genome(h) for h in haps])
        n_var = int((g != g[0]).any(axis=0).sum())
        alleles = sum(len(set(g[:, c])) for c in
                      np.flatnonzero((g != g[0]).any(axis=0)))
        assert sum(len(s) == 1 for s in seqs.values()) >= alleles > n_var
