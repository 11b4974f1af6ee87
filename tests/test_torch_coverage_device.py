"""The per-species device coverage of the port (ops/coverage_device.py:
node_abundances_device, the sort dedup of rows that revisit nodes and the
trio hash lookup) against the JAX package's node_abundances_device on the
CPU: na and ta bit-identical (float32 in both, widened to float64), bc
equal, on rows of width 63, 64, 65 and 1024 that revisit nodes, and on
trios found by hash, with two unique trios whose hashes collide.  The
host coverage (float64) is held to the same inputs within 1e-6."""
import numpy as np
import pytest
import torch

from pantax_tpu.graph.trio import build_trio_index as ref_build_trio_index
from pantax_tpu.ops.coverage_device import _mix3 as ref_mix3
from pantax_tpu.ops.coverage_device import build_hash_lookup as ref_lookup
from pantax_tpu.ops.coverage_device import (
    node_abundances_device as ref_node_abundances_device,
)
from pantax_tpu.profile.coverage import node_abundances as ref_node_abundances
from pantax_tpu.profile.coverage import pack_reads as ref_pack_reads
from pantax_tpu.profile.records import ReadRecord as RefReadRecord
from pantax_tpu_torch import _host
from pantax_tpu_torch.ops import coverage_device as port_cov
from pantax_tpu_torch.profile.coverage import (
    node_abundances_packed, pack_reads,
)
from pantax_tpu_torch.profile.records import ReadRecord

from _torch_helpers import (  # noqa: F401 (autouse)
    COLLIDING_TRIOS, coverage_case, reference_on_one_device,
)

def _both(nodes_len, paths, reads, range_start):
    """(reference na, ta, bc; port na, ta, bc; port host na, ta, bc)."""
    ref_ti = ref_build_trio_index(nodes_len, paths)
    ti = _host.build_trio_index(nodes_len, paths)
    ref_recs = [RefReadRecord(r, n, 0, rs, re, "s") for r, n, rs, re in reads]
    recs = [ReadRecord(r, n, 0, rs, re, "s") for r, n, rs, re in reads]
    want = ref_node_abundances_device(ref_pack_reads(ref_recs, range_start),
                                      nodes_len, ref_ti)
    got = port_cov.node_abundances_device(pack_reads(recs, range_start),
                                          nodes_len, ti, device="cpu")
    host = node_abundances_packed(pack_reads(recs, range_start), nodes_len,
                                  ti)
    np.testing.assert_array_equal(
        host[2], ref_node_abundances(ref_recs, nodes_len, ref_ti,
                                     range_start)[2])
    return want, got, host, ti


def _assert_equal(want, got, host):
    for name, w, g in zip(("na", "ta", "bc"), want, got):
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    np.testing.assert_allclose(got[0], host[0], rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(got[1], host[1], rtol=1e-6, atol=1e-9)
    np.testing.assert_array_equal(got[2], host[2])


@pytest.mark.parametrize("width", [63, 64, 65, 1024])
def test_node_abundances_device_wide_rows(width):
    """Either side of the reference's switch from its mask dedup (rows up to
    64 nodes) to its sort dedup; the port's switch sits at 16, so its sort
    form matches both (the packed width is padded to a power of two: 63
    and 64 give 64, 65 gives 128)."""
    rng = np.random.default_rng(width)
    want, got, host, ti = _both(*coverage_case(rng, width))
    _assert_equal(want, got, host)
    assert (got[1] > 0).sum() > 10 and (got[0] > 0).sum() > 100


def test_node_abundances_device_colliding_trios():
    """Two unique trios with one hash: the linear probe must credit each
    window to its own trio (the first hit wins), forward and reversed."""
    a, c = COLLIDING_TRIOS
    assert ref_mix3(*(np.uint32(x) for x in a)) == ref_mix3(
        *(np.uint32(x) for x in c))
    rng = np.random.default_rng(7)
    extra = [[5, 6, *a, 9, 10], [11, 12, *c, 13, 14]]
    nodes_len, paths, reads, rs0 = coverage_case(rng, 16, n_nodes=5000,
                                         n_reads=200, extra_paths=extra)
    for i, p in enumerate(extra):
        for nodes in (np.array(p), np.array(p[::-1])):
            reads.append((f"c{i}{len(reads)}", nodes + rs0, 0, 40))
    want, got, host, ti = _both(nodes_len, paths, reads, rs0)
    t = port_cov.build_padded_tables(np.ones(len(nodes_len), np.int64),
                                     ti.trio_len, ti.trio_nodes)
    probes = t.trio_hash[-1]
    assert probes == 2  # the probe runs past the first slot
    _assert_equal(want, got, host)
    idx = [int(np.flatnonzero((ti.trio_nodes == x).all(axis=1))[0])
           for x in COLLIDING_TRIOS]
    assert all(got[1][i] > 0 for i in idx)


@pytest.mark.parametrize("n_live", [0, 1, 300])
def test_hash_lookup_tables_equal(n_live):
    """build_hash_lookup and the padded trio hash table against the
    reference (sentinel pad, bucket bits, bisection steps, probe depth)."""
    rng = np.random.default_rng(n_live)
    trio_nodes = rng.integers(0, 400, size=(n_live, 3))
    trio_nodes[:, [0, 2]] = np.sort(trio_nodes[:, [0, 2]], axis=1)
    trio_nodes = np.unique(trio_nodes, axis=0)
    trio_nodes = np.concatenate([trio_nodes, np.array(COLLIDING_TRIOS)])
    t = port_cov.build_padded_tables(np.ones(400, np.int64),
                                     np.full(len(trio_nodes), 3), trio_nodes)
    h, order, abc, bucket, bits, steps, probes = t.trio_hash
    want_h = np.asarray(ref_mix3(*(trio_nodes[:, i].astype(np.uint32)
                                   for i in range(3))))
    np.testing.assert_array_equal(h[:t.U], np.sort(want_h, kind="stable"))
    assert (h[t.U:] == np.iinfo(np.uint32).max).all()
    want = ref_lookup(h, t.U)
    np.testing.assert_array_equal(bucket, want[0])
    assert (bits, steps, probes) == want[1:] and probes == 2
    np.testing.assert_array_equal(abc[:t.U], trio_nodes[order[:t.U]])
    lk = t.trio_lookup("cpu")
    got = port_cov.lookup_trios(torch.from_numpy(np.concatenate(
        [trio_nodes[:, ::-1], trio_nodes]).reshape(1, -1)), lk)
    # every window (a, b, c) | (c', b', a') of the concatenated rows that is
    # a trio row itself finds it
    found = got[0, 0::3].numpy()
    np.testing.assert_array_equal(
        found, np.concatenate([np.arange(len(trio_nodes))] * 2))
