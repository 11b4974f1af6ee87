"""K9 and K10b's module (ops/tail_kernels.py), the device tail's dispatchers
and the smoke's phase 3e helpers on the CPU: the dispatchers take the plain
versions' bits and counts on CPU tensors; the wrappers refuse CPU tensors
before they build anything; K10b's plan by bucket; K9's owner tables; the
crafted cases reach the edges they name; the bounds count their work.
The kernels themselves run in tests/test_torch_cuda.py (marker ``cuda``)."""
import numpy as np
import pytest
import torch

import chip_smoke
from pantax_tpu_torch.ops import extend, profile_tail, tail_kernels


def _polish_args(shape, crafted=False):
    return [torch.from_numpy(a) for a in chip_smoke.polish_case(
        sum(shape), *shape, crafted)]


def test_dispatchers_take_the_plain_versions_on_the_cpu():
    """tail_stats and polish_batch on CPU tensors: the plain versions'
    bits, counted as plain runs, whatever ``order`` holds."""
    args, kw = chip_smoke.k9_case(9, "cpu")
    pargs = _polish_args((3, 4096, 4))
    extend.reset_launch_counts()
    got = profile_tail.tail_stats(*args, **kw)
    want = profile_tail.tail_stats_plain(*args, G=kw["G"], S=kw["S"])
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert torch.equal(profile_tail.polish_batch(*pargs),
                       profile_tail.polish_batch_plain(*pargs))
    assert extend.LAUNCHES["tail_stats_plain"] == 1
    assert extend.LAUNCHES["polish_plain"] == 1
    assert extend.LAUNCHES["tail_stats"] == extend.LAUNCHES["polish"] == 0


def test_wrappers_refuse_cpu_tensors_before_building(monkeypatch):
    """On a CPU tensor K9's and K10b's wrappers raise ValueError before
    they build anything (this machine has no nvcc)."""
    def no_build(src=None):
        raise AssertionError("built before the checks")

    monkeypatch.setattr(tail_kernels, "build_tail_kernels", no_build)
    args, kw = chip_smoke.k9_case(9, "cpu")
    na, ta, bc, _trio_hap, path_node = args[:5]
    with pytest.raises(ValueError):
        tail_kernels.tail_stats_cuda(na, ta, bc, path_node, kw["order"],
                                     args[7], G=kw["G"], S=kw["S"])
    with pytest.raises(ValueError):
        tail_kernels.polish_cuda(*_polish_args((1, 4096, 4)))
    assert extend.LAUNCHES["tail_stats"] == extend.LAUNCHES["polish"] == 0


@pytest.mark.parametrize("shape,plan", [
    ((1, 4096, 4), (1, 4096, True)), ((1, 8192, 8), (1, 8192, True)),
    ((3, 16384, 4), (2, 8192, True)), ((10, 65536, 4), (8, 8192, True)),
    ((2, 262144, 32), (8, 32768, True)), ((1, 524288, 4), (8, 65536, False)),
    ((1, 12288, 4), (1, 12288, True)), ((1, 24576, 4), (2, 12288, True)),
])
def test_polish_plan_by_bucket(shape, plan):
    """1 CTA up to 8192 rows, one more for each 8192 up to 8, cutting n_pad
    into whole blocks of 1024 rows; the residuals on chip up to 32768 rows
    a CTA; the shared memory as the source counts it."""
    got = tail_kernels.polish_plan(*shape)
    assert (got.cluster, got.rows, got.on_chip) == plan
    assert got.smem_bytes == tail_kernels.polish_smem_bytes(
        got.rows, shape[2], got.on_chip) <= tail_kernels.MAX_SMEM


@pytest.mark.parametrize("shape", [(1, 1000, 4), (1, 0, 4), (0, 4096, 4),
                                   (1, 4096, 0)])
def test_polish_plan_refuses(shape):
    with pytest.raises(ValueError):
        tail_kernels.polish_plan(*shape)


def test_owner_tables_order_the_real_trios_by_owner():
    """trio_order: the trios owned by a hap (pads, owner G, left out),
    sorted by owner, stable; the offsets slice it by hap; sp_node_span
    holds each species' node slice, starts then ends, and the nodes
    outside every slice are pads."""
    args, kw = chip_smoke.k9_case(10, "cpu")
    trio_hap = args[3].numpy()
    G, S = kw["G"], kw["S"]
    order, hto, hpo, spo = (t.numpy() for t in kw["order"])
    owners = trio_hap[order]
    assert (np.diff(owners) >= 0).all() and (owners < G).all()
    assert len(order) == (trio_hap < G).sum() and (trio_hap == G).any()
    for g in range(G):
        sl = order[hto[g]:hto[g + 1]]
        np.testing.assert_array_equal(sl, np.flatnonzero(trio_hap == g))
    node_species = args[6].numpy()
    assert spo.shape == (2 * S,) and hpo[-1] == len(args[4])
    in_span = np.zeros(len(node_species), bool)
    for s in range(S):
        np.testing.assert_array_equal(np.flatnonzero(node_species == s),
                                      np.arange(spo[s], spo[S + s]))
        in_span[spo[s]:spo[S + s]] = True
    assert (node_species[~in_span] == S).all()


def test_k9_case_interleaves_owners_and_reaches_its_edges():
    """k9_case's owners vary within a species; hap 0 owns no trio, hap 1
    only zero trios, hap 2 one nonzero trio (sigma 0: mean 0); the last
    species has no node (max -inf)."""
    args, kw = chip_smoke.k9_case(9, "cpu")
    trio_hap = args[3].numpy()
    assert (np.diff(trio_hap) < 0).any()
    c1, freq, _pc, nz_cnt, _nz_sum, sp_max, valid = (
        t.numpy() for t in profile_tail.tail_stats_plain(
            *args, G=kw["G"], S=kw["S"]))
    assert (trio_hap == 0).sum() == 0 and c1[0] == 0
    assert (trio_hap == 1).sum() > 0 and c1[1] == 0 and freq[1] == 0
    assert c1[2] == 1 and freq[2] == 0
    assert (freq[3:] > 0).all()
    assert sp_max[-1] == -np.inf and valid[-1] == nz_cnt[-1] == 0
    assert (valid[:-1] > 0).all()


def test_polish_case_crafted_edges_reach_their_cases():
    """polish_case's crafted instances through the plain polish: ties at
    the median, zeros of both signs in r, a column with no live row left
    alone, t* past the upper clip (x at ub 0.01) and the lower (x from 0.5
    to 0), a dead instance left as it was."""
    A, b, x, ub = _polish_args((5, 4096, 4), crafted=True)
    out = profile_tail.polish_batch_plain(A, b, x, ub)
    r = profile_tail.exact_residual(A, x) - b
    live0 = A[0, :, 0] > 0
    assert torch.unique(-r[0][live0]).numel() < live0.sum() // 100  # ties
    live1 = A[1].sum(-1) > 0
    zeros = r[1][live1 & (r[1] == 0)]
    assert (torch.signbit(zeros).any() and (~torch.signbit(zeros)).any())
    assert (A[2, :, 3] == 0).all() and out[2, 3] == x[2, 3]
    assert out[2, 0] == ub[2, 0] == np.float32(0.01)
    assert x[3, 0] == 0.5 and out[3, 0] == 0.0
    assert (A[4] == 0).all() and torch.equal(out[4], x[4] + 0.0)


def test_k9_k10b_counts_are_held_by_path():
    """check_k9_k10b records a path's launches and refuses a kernel count
    other than its dispatches, or any plain run."""
    ok = dict(extend.LAUNCHES, tail_stats=1, tail_stats_dispatch=1,
              tail_stats_plain=0, polish=2, polish_dispatch=2, polish_plain=0)
    chip_smoke.check_k9_k10b(ok, "cpu test path")
    assert chip_smoke.TAIL_BY_PATH["tail_stats"]["cpu_test_path"] == 1
    assert chip_smoke.TAIL_BY_PATH["polish"]["cpu_test_path"] == 2
    for bad in ({"polish": 1}, {"tail_stats_plain": 1}, {"tail_stats": 0}):
        with pytest.raises(AssertionError):
            chip_smoke.check_k9_k10b(dict(ok, **bad), "cpu test path")
    for d in chip_smoke.TAIL_BY_PATH.values():
        d.pop("cpu_test_path")


def test_bounds_count_their_work():
    """polish_bound: 6 instructions a row of a column of a sweep against A,
    b, x and ub in and x out; tail_stats_bound: the bytes K9 reads once,
    na over the species' spans only (not the pads, not node_species), a
    path node's bc once however many paths hold it."""
    ms, by, work = chip_smoke.polish_bound(10, 65536, 4, 8, 33.45e12)
    assert work["ops"] == 6 * 8 * 4 * 65536 * 10
    assert work["bytes"] == 4 * (10 * 65536 * 4 + 10 * 65536 + 3 * 10 * 4)
    assert by == "bytes" and ms == pytest.approx(
        work["bytes"] / chip_smoke.HBM_BYTES_PER_S * 1e3)
    path_node = torch.tensor([3, 4, 3, 5], dtype=torch.int32)
    span = torch.tensor([0, 300, 700, 300, 700, 700], dtype=torch.int32)
    order = (torch.zeros(70, dtype=torch.int32), None, None, span)
    ms, by, work = chip_smoke.tail_stats_bound(path_node, order, 2, 3)
    assert by == "bytes"
    assert work["bytes"] == 4 * (700 + 2 * 70 + 4 + 3 + 2 * 3 + 2 * 3
                                 + 3 * 2 + 4 * 3)
