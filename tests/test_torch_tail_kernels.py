"""K9 and K10b's module (ops/tail_kernels.py), the device tail's dispatchers
and the smoke's phase 3e helpers on the CPU: the dispatchers take the plain
versions' bits and counts on CPU tensors; the wrappers refuse CPU tensors
before they build anything; K9's plan by shape and K10b's by bucket; a
numpy model of K9's sums (each thread's slots, the CTA trees, the ranks in
order) held to the plain stats and the JAX package's; a numpy model of
K10b's selection and early stop held to the plain polish bit for bit; K9's
owner tables; the crafted cases reach the edges they name; the bounds count
their work.  The kernels themselves run in tests/test_torch_cuda.py
(marker ``cuda``)."""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import chip_smoke
from pantax_tpu_torch.ops import extend, profile_tail, tail_kernels


def _polish_args(shape, crafted=False):
    return [torch.from_numpy(a) for a in chip_smoke.polish_case(
        sum(shape), *shape, crafted)]


def _tail_tables(args, kw):
    """The TailTables fields dispatch_tail_stats reads, from k9_case."""
    return SimpleNamespace(
        trio_hap=args[3], path_node=args[4], path_hap=args[5],
        node_species=args[6], G=kw["G"], S=kw["S"],
        **dict(zip(profile_tail.ORDER_FIELDS, kw["order"])))


def test_dispatchers_take_the_plain_versions_on_the_cpu():
    """dispatch_tail_stats and polish_batch on CPU tensors: the plain
    versions' bits, counted as plain runs and dispatches."""
    args, kw = chip_smoke.k9_case(9, "cpu")
    pargs = _polish_args((3, 4096, 4))
    extend.reset_launch_counts()
    got = profile_tail.dispatch_tail_stats(_tail_tables(args, kw), *args[:3],
                                           args[7])
    want = profile_tail.tail_stats_plain(*args, G=kw["G"], S=kw["S"])
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert torch.equal(profile_tail.polish_batch(*pargs),
                       profile_tail.polish_batch_plain(*pargs))
    assert extend.LAUNCHES["tail_stats_plain"] == 1
    assert extend.LAUNCHES["tail_stats_dispatch"] == 1
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
    ((1, 4096, 4), (1, 4096, 4, True, True, 4096)),
    ((1, 8192, 8), (1, 8192, 8, True, True, 8192)),
    ((3, 16384, 4), (2, 8192, 8, True, True, 16384)),
    ((10, 65536, 4), (8, 8192, 8, True, True, 16384)),
    ((2, 262144, 32), (8, 32768, 0, False, True, 16384)),
    ((1, 524288, 4), (8, 65536, 0, False, True, 16384)),
    ((1, 12288, 4), (1, 12288, 0, True, True, 12288)),
    ((1, 24576, 4), (2, 12288, 0, True, True, 16384)),
    ((1, 262144, 4), (8, 32768, 0, True, True, 15742)),
    ((1, 524288, 32), (8, 65536, 0, False, False, 16384)),
    ((1, 65536, 36), (8, 8192, 0, True, True, 16384)),
])
def test_polish_plan_by_bucket(shape, plan):
    """1 CTA up to 8192 rows, one more for each 8192 up to 8, cutting n_pad
    into whole blocks of 1024 rows; a CTA's 4096 or 8192 rows in registers
    up to p_pad 32; else the live bits on chip where MIN_CAP candidates
    still fit beside them, the residuals too where they also fit; the
    candidates in the room left, at most MAX_CAP and n_pad; the scratch
    holds what is not on chip; the shared memory as the source counts
    it."""
    S, n, p = shape
    got = tail_kernels.polish_plan(*shape)
    assert (got.cluster, got.rows, got.reg_rows, got.on_chip,
            got.bits_on_chip, got.cap) == plan
    assert got.smem_bytes == tail_kernels.polish_smem_bytes(
        got.rows, p, got.on_chip, got.bits_on_chip, got.cap
    ) <= tail_kernels.MAX_SMEM
    assert got.scratch == (0 if got.on_chip else S * n + (
        0 if got.bits_on_chip else S * p * n // 32))
    if got.cap < min(tail_kernels.MAX_CAP, n):  # the room is used up
        assert got.smem_bytes > tail_kernels.MAX_SMEM - 4


@pytest.mark.parametrize("shape", [(1, 1000, 4), (1, 0, 4), (0, 4096, 4),
                                   (1, 4096, 0)])
def test_polish_plan_refuses(shape):
    with pytest.raises(ValueError):
        tail_kernels.polish_plan(*shape)


@pytest.mark.parametrize("shape,plan", [
    ((30, 10, 488_636), (4, 16)),      # the smoke DB's paired tail
    ((30, 11, 500_000), (4, 16)),      # k9_case at the smoke DB's size
    ((102, 34, 1_700_000), (4, 16)),   # community102-like
    ((102, 34, 800_000), (1, 16)),
    ((12, 4, 9000), (8, 4)),           # k9_case's default
    ((8, 2, 120_000), (8, 8)),         # K9_EDGES
    ((70, 6, 200_000), (2, 8)),
    ((140, 12, 60_000), (1, 4)),
    ((66, 1, 4096), (2, 4)),
    ((1, 1, 0), (8, 4)),
    ((1, 1, 1_000_000), (8, 16)),      # past every register tier
])
def test_stats_plan_by_shape(shape, plan):
    """The smallest cluster whose (G + S) x cluster CTAs fill the 132 SMs
    (4 at the smoke DB's 40 items, 1 from 132 items), doubled while a hap
    of the mean size would not fit 16 trios a thread (community102's ~16,700
    trios a hap: 4); the fewest of 4, 8 and 16 trios a thread that hold a
    hap of twice the mean."""
    got = tail_kernels.stats_plan(*shape)
    assert (got.cluster, got.regs) == plan
    G, S, trios = shape
    T, C, R = tail_kernels.STATS_THREADS, got.cluster, got.regs
    assert C in (1, 2, 4, 8) and R in tail_kernels.STATS_REGS
    assert (G + S) * C >= tail_kernels.SMS or C == tail_kernels.MAX_CLUSTER
    assert R * T * C >= 2 * -(-trios // G) or R == 16
    assert -(-trios // G) <= 16 * T * C or C == 8


@pytest.mark.parametrize("shape", [(0, 1, 0), (1, 0, 0), (1, 1, -1)])
def test_stats_plan_refuses(shape):
    with pytest.raises(ValueError):
        tail_kernels.stats_plan(*shape)


# ---------------------------------------------------------------------------
# a numpy model of K9's sums (csrc/profile_tail.cu's tail_stats_kernel):
# element j of a hap's trios (of a species' float4s) belongs to rank (j //
# T) % C, thread j % T, slot j // (T C); each thread adds its slots in
# order, a CTA its threads in the warps' shfl_down trees, every CTA the
# ranks in order, all in float64; the float32 steps between, rounded alone
K9_T = tail_kernels.STATS_THREADS


def _by_slot(vals, C: int):
    """vals [n] (or [n, 4]) as [slot, rank, thread (, 4)], zeros past n."""
    TC = K9_T * C
    m = -(-len(vals) // TC)
    out = np.zeros((m * TC,) + vals.shape[1:], vals.dtype)
    out[:len(vals)] = vals
    return out.reshape((m, C, K9_T) + vals.shape[1:])


def _tree(v):
    """The shfl_down tree over the last axis of 32 lanes: lane l adds lane
    l + o for o = 16, 8, 4, 2, 1; lane 0's sum."""
    o = 16
    while o:
        v = v[..., :o] + v[..., o:2 * o]
        o //= 2
    return v[..., 0]


def _k9_sum(acc) -> float:
    """[C, T] float64 thread sums: each CTA's warps' trees, warp 0's tree
    over them (zeros past the warps), then the ranks in order from 0."""
    C = acc.shape[0]
    lanes = np.zeros((C, 32))
    lanes[:, :K9_T // 32] = _tree(acc.reshape(C, K9_T // 32, 32))
    tot = 0.0
    for part in _tree(lanes):
        tot = tot + part
    return tot


def _slot_sums(grid):
    """[slot, C, T] float64 values: each thread's sum over its slots in
    order."""
    acc = np.zeros(grid.shape[1:])
    for k in range(len(grid)):
        acc = acc + grid[k]
    return acc


def model_tail_stats(na, ta, bc, path_node, order, min_depth: float, G: int,
                     S: int, C: int, na_offset: int = 0):
    """K9's seven float32 outputs at clusters of C CTAs, from numpy
    inputs; ``na_offset``: na's first element's place in a 16-byte word
    (the species' heads and tails follow the address)."""
    f32 = np.float32
    trio_order, hto, hpo, span = order
    c1, freq, pcov = (np.zeros(G, f32) for _ in range(3))
    for g in range(G):
        grid = _by_slot(ta[trio_order[hto[g]:hto[g + 1]]].astype(f32), C)
        pos = grid > 0
        c1[g] = f32(pos.sum())
        cm = max(c1[g], f32(1))
        mu = f32(_k9_sum(_slot_sums(np.where(pos, grid, f32(0)).astype(
            np.float64)))) / cm
        d = grid - mu
        sigma = np.sqrt(f32(_k9_sum(_slot_sums(np.where(
            pos, d * d, f32(0)).astype(np.float64)))) / cm)
        kept = pos & (np.abs(d) < f32(3) * sigma)
        kc = f32(kept.sum())
        ks = f32(_k9_sum(_slot_sums(np.where(kept, grid, f32(0)).astype(
            np.float64))))
        freq[g] = ks / max(kc, f32(1)) if sigma > 0 and kc > 0 else f32(0)
        pcov[g] = f32(bc[path_node[hpo[g]:hpo[g + 1]]].astype(np.int64).sum())
    nz, nz_sum, sp_max, valid = (np.zeros(S, f32) for _ in range(4))
    for s in range(S):
        lo, hi = int(span[s]), int(span[S + s])
        v = na[lo:hi].astype(f32)
        opt = np.where(v > f32(min_depth), v, f32(0))
        w = np.where(opt > 0, opt, f32(0)).astype(np.float64)
        nz[s], valid[s] = (opt > 0).sum(), (v > 0).sum()
        sp_max[s] = v.max() if len(v) else -np.inf
        head = min(hi - lo, -(na_offset + lo) % 4)
        nq = (hi - lo - head) // 4
        acc = np.zeros((C, K9_T))
        acc[0, :head] = w[:head]                      # rank 0's threads 0-3
        tail = w[head + 4 * nq:]
        acc[0, 4:4 + len(tail)] = tail                # and 4-7
        body = _by_slot(w[head:head + 4 * nq].reshape(nq, 4), C)
        for k in range(len(body)):
            for comp in range(4):
                acc = acc + body[k, :, :, comp]
        nz_sum[s] = f32(_k9_sum(acc))
    return c1, freq, pcov, nz, nz_sum, sp_max, valid


def _k9_model_holds(args, kw, want, na_offset: int = 0) -> None:
    """The model at the plan's cluster against ``want`` (seven outputs):
    the counts, path_cov, sp_max and sp_valid exact, freq_mean and
    sp_nz_sum within chip_smoke.K9_RTOL."""
    G, S, order = kw["G"], kw["S"], kw["order"]
    C = tail_kernels.stats_plan(G, S, order[0].numel()).cluster
    got = model_tail_stats(*(a.numpy() for a in args[:3]), args[4].numpy(),
                           [t.numpy() for t in order], args[7], G, S, C,
                           na_offset)
    for name, g, w in zip(chip_smoke.K9_OUTPUTS, got, want):
        w = np.asarray(w, np.float32)
        if name in ("freq_mean", "sp_nz_sum"):
            np.testing.assert_allclose(g, w, rtol=chip_smoke.K9_RTOL, atol=0,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)


K9_MODEL_CASES = [("default", 9, (), 1.5), ("default", 10, (), 0.0),
                  ("default", 11, (), 2.5)] + [
    (what, 12 + i, shape, 1.5)
    for i, (what, *shape) in enumerate(chip_smoke.K9_EDGES)]


@pytest.mark.parametrize("what,seed,shape,min_depth", K9_MODEL_CASES,
                         ids=[f"{c[0]}-{c[1]}" for c in K9_MODEL_CASES])
def test_k9_model_matches_plain(what, seed, shape, min_depth, one_thread):
    """The model of K9's sums at the plan's cluster against the plain
    stats on k9_case's tables (hap 0 without trios, hap 1 of zero trios
    only, hap 2 of one nonzero trio, the last species without nodes) and,
    in float64 (chip_smoke.k9_want), on K9_EDGES (a hap past the registers
    beside a species of 600,000 nodes, clusters of 2, G + S past 132), at
    three min_depths."""
    args, kw = chip_smoke.k9_case(seed, "cpu", *shape)
    args = (*args[:7], min_depth)
    want = chip_smoke.k9_want(args, kw, exact=bool(shape))
    _k9_model_holds(args, kw, [w.numpy() for w in want])


def test_k9_edges_need_the_float64_plain_sums(one_thread):
    """Why K9_EDGES are held to the plain version in float64: its float32
    sum over the 600,000-node species (index_put_'s, serial on one thread)
    is more than K9_RTOL off the exact sum, which the float64 plain version
    gives to float32 rounding."""
    args, kw = chip_smoke.k9_case(12, "cpu", *chip_smoke.K9_EDGES[0][1:])
    f32 = chip_smoke.k9_want(args, kw)[4][0]
    f64 = chip_smoke.k9_want(args, kw, exact=True)[4][0]
    na, span = args[0].numpy(), kw["order"][3].numpy()
    v = na[span[0]:span[kw["S"]]].astype(np.float64)
    exact = v[v > args[7]].sum()
    assert abs(float(f32) - exact) > chip_smoke.K9_RTOL * exact
    assert float(f64) == np.float32(exact)


@pytest.mark.parametrize("na_offset", [1, 2, 3])
def test_k9_model_cuts_species_at_any_offset(na_offset, one_thread):
    """na off a 16-byte boundary: every species' head and tail, 1-3 nodes
    each, taken apart from its float4s, the sums still the plain
    version's."""
    args, kw = chip_smoke.k9_case(9, "cpu")
    want = profile_tail.tail_stats_plain(*args, G=kw["G"], S=kw["S"])
    _k9_model_holds(args, kw, [w.numpy() for w in want], na_offset)


def test_k9_model_matches_the_jax_stats(one_thread):
    """The model against the JAX package's _tail_stats on the CPU, on
    k9_case's tables, under the JAX stats' own bars."""
    import jax.numpy as jnp

    from pantax_tpu.ops.profile_tail import _tail_stats

    args, kw = chip_smoke.k9_case(9, "cpu")
    want = _tail_stats(*(jnp.asarray(a.numpy()) for a in args[:7]),
                       args[7], G=kw["G"], S=kw["S"])
    _k9_model_holds(args, kw, [np.asarray(w) for w in want])


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


# ---------------------------------------------------------------------------
# a numpy model of K10b (csrc/profile_tail.cu's polish_kernel): the same
# steps in the same order, per instance, with the plan's cluster and
# candidate cap (or a smaller cap, to reach the rounds over all rows)
def _order_keys(v):
    u = np.ascontiguousarray(v, np.float32).view(np.uint32)
    return np.where(u & 0x80000000, ~u, u | 0x80000000).astype(np.uint32)


def _key_value(k: int) -> np.float32:
    u = k & 0x7FFFFFFF if k & 0x80000000 else ~k & 0xFFFFFFFF
    return np.array([u], np.uint32).view(np.float32)[0]


def _digit(shift: int) -> tuple[int, int]:
    """The next digit below ``shift``: (its lowest bit, its width), 11, 11
    and 10 bits."""
    lo = max(shift - 11, 0)
    return lo, shift - lo


def _count(keys, shift: int, prefix: int, k: int):
    """One radix round: the keys matching ``prefix`` above ``shift``
    counted by the next digit; (bin, k within it, its count, lo, width)."""
    lo, width = _digit(shift)
    hit = keys if shift == 32 else keys[(keys >> np.uint32(shift)) == prefix]
    hist = np.bincount(((hit >> np.uint32(lo)) & ((1 << width) - 1))
                       .astype(np.int64), minlength=1 << width)
    cum = np.cumsum(hist)
    d = int(np.searchsorted(cum, k, side="right"))
    return d, k - int(cum[d] - hist[d]), int(hist[d]), lo, width


def _select(keys_by_cta, k: int, cap: int, seen: dict) -> int:
    """The k-th smallest key (from 0) of the cluster's live rows: rounds
    over every CTA's rows (their histograms added) until the bin fits the
    cap, the bin's keys pushed in rank order, then rounds over the
    candidates until at most RANK_SELECT are left, which are ranked."""
    keys = np.concatenate(keys_by_cta)
    prefix, shift = 0, 32
    while True:
        d, k, c, lo, width = _count(keys, shift, prefix, k)
        prefix, shift = (prefix << width) | d, lo
        if shift == 0:
            seen["all_rows_to_the_end"] += 1
            return prefix
        if c <= cap:
            break
        seen["over_cap"] += 1
    seen["under_cap"] += 1
    cand = np.concatenate([ks[(ks >> np.uint32(shift)) == prefix]
                           for ks in keys_by_cta])
    assert len(cand) == c
    while c > tail_kernels.RANK_SELECT:
        seen["candidate_rounds"] += 1
        d, k, c, lo, width = _count(cand, shift, prefix, k)
        prefix, shift = (prefix << width) | d, lo
        if shift == 0:
            return prefix
    seen["rank"] += 1
    last = cand[(cand >> np.uint32(shift)) == prefix]
    assert len(last) == c
    return int(np.sort(last)[k])


def model_polish(A, b, x, ub, sweeps: int, cluster: int, cap: int,
                 seen: dict):
    """K10b's x for numpy (A, b, x, ub), and the sweeps each instance ran;
    ``seen`` counts the branches taken."""
    S, n, p = A.shape
    out, runs = x.copy(), []
    rows = n // cluster
    for s in range(S):
        if ((A[s] != 0) & (A[s] != 1)).any():
            out[s] = np.nan
            runs.append(0)
            continue
        xs = x[s].copy()
        r = A[s, :, 0] * xs[0]
        for j in range(1, p):
            r = r + A[s, :, j] * xs[j]
        r = (r - b[s]).astype(np.float32)
        live = A[s] > 0
        cnt = live.sum(0)
        kth = np.maximum((cnt - 1) // 2, 0)
        ran = 0
        for _ in range(sweeps):
            ran += 1
            moved = False
            for j in range(p):
                if cnt[j] == 0:
                    seen["empty"] += 1
                    continue
                keys = [_order_keys(-r[q * rows:(q + 1) * rows][
                    live[q * rows:(q + 1) * rows, j]]) for q in range(cluster)]
                every = np.concatenate(keys)
                if (every == 0x80000000).any() and (every == 0x7FFFFFFF).any():
                    seen["signed_zeros"] += 1
                v = _key_value(_select(keys, int(kth[j]), cap, seen))
                xj = xs[j]
                t = np.float32(min(max(v, -xj), np.float32(ub[s, j] - xj)))
                xs[j] = np.float32(xj + t)
                if t != 0:
                    moved = True
                    r[live[:, j]] = r[live[:, j]] + t
            if not moved:
                seen["early_stop"] += 1
                break
        runs.append(ran)
        out[s] = xs
    return out, runs


BRANCHES = ("empty", "early_stop", "over_cap", "under_cap", "signed_zeros",
            "rank", "candidate_rounds", "all_rows_to_the_end")
# (S, n_pad, p_pad): the plan's one-CTA buckets and a cluster of 2
MODEL_SHAPES = ((3, 4096, 4), (6, 8192, 8), (6, 16384, 4))


@pytest.fixture
def one_thread():
    """One torch thread: the model's cases run many small sorts, which
    threads only slow down when the test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _model_holds(shape, crafted: bool, sweeps: int, seen: dict) -> None:
    """The model at the plan's cluster and cap (and, on the crafted edges,
    at a cap of 64) against the plain polish's x and the sweeps counted on
    it as chip_smoke.sweeps_run counts them."""
    args = _polish_args(shape, crafted)
    moved: list = []
    want = profile_tail.polish_batch_plain(*args, sweeps,
                                           moved=moved).numpy() + 0.0
    runs = [next((i + 1 for i, m in enumerate(moved) if not m[s]), sweeps)
            for s in range(shape[0])]
    plan = tail_kernels.polish_plan(*shape)
    for cap in (plan.cap, 64) if crafted else (plan.cap,):
        got, ran = model_polish(*(a.numpy() for a in args), sweeps,
                                plan.cluster, cap, seen)
        assert np.array_equal(got + 0.0, want), (cap, got, want)
        assert ran == runs


@pytest.mark.parametrize("sweeps", [0, 1, 3, 8, 20])
@pytest.mark.parametrize("crafted", [False, True], ids=["plain", "crafted"])
@pytest.mark.parametrize("shape", MODEL_SHAPES,
                         ids=[f"{s}x{n}x{p}" for s, n, p in MODEL_SHAPES])
def test_k10b_model_matches_plain_bit_for_bit(shape, crafted, sweeps,
                                              one_thread):
    """The model of K10b at the plan's cluster and cap gives the plain
    polish's x bit for bit (the sign of a zero aside) and runs the sweeps
    the plain polish's steps say it runs; on the crafted edges again at a
    cap of 64, which sends their medians' bins through the rounds over
    all rows."""
    _model_holds(shape, crafted, sweeps, {name: 0 for name in BRANCHES})


def test_k10b_model_reaches_every_branch(one_thread):
    """The model's crafted cases (and the smallest plain one) at 8 sweeps
    reach every branch: a column with no live row, an instance stopped
    early, candidates over the cap and under it, rounds over the
    candidates, the last candidates ranked, a bin resolved to every bit
    over all rows, and ties of -0.0 and +0.0."""
    seen = {name: 0 for name in BRANCHES}
    _model_holds(MODEL_SHAPES[0], False, 8, seen)
    for shape in MODEL_SHAPES:
        _model_holds(shape, True, 8, seen)
    missing = [name for name in BRANCHES if not seen[name]]
    assert not missing, (missing, seen)


def test_sweeps_run_counts_up_to_the_first_still_sweep():
    """chip_smoke.sweeps_run: the crafted edges stop early (the dead
    instance after one sweep), a plain case runs every sweep, 0 sweeps
    run none."""
    args = _polish_args((6, 4096, 4), crafted=True)
    runs = chip_smoke.sweeps_run(args, 8)
    assert runs[4] == 1 and max(runs) <= 8 and min(runs) >= 1
    assert any(r < 8 for r in runs)
    assert chip_smoke.sweeps_run(args, 0) == [0] * 6


def test_k10b_model_marks_an_a_other_than_zero_one():
    """An instance whose A holds a value other than 0 and 1 gets NaN x, as
    the kernel gives it; the others are polished."""
    A, b, x, ub = (a.numpy() for a in _polish_args((2, 4096, 4)))
    A[1, 7, 2] = 0.5
    got, runs = model_polish(A, b, x, ub, 8, 1, 4096,
                             {name: 0 for name in BRANCHES})
    assert np.isnan(got[1]).all() and runs[1] == 0
    want = profile_tail.polish_batch_plain(
        *(torch.from_numpy(a[:1]) for a in (A, b, x, ub))).numpy()
    assert np.array_equal(got[:1] + 0.0, want + 0.0)


def test_polish_case_edge_5_overfills_the_first_digit():
    """Crafted edge 5: the first column's live rows all in one bin of
    K10b's first digit, more of them than MAX_CAP at 65536 rows, and over
    MIN_CAP at 16384."""
    for n_pad, over in ((16384, tail_kernels.MIN_CAP),
                        (65536, tail_kernels.MAX_CAP)):
        A, b, x, ub = chip_smoke.polish_case(n_pad, 6, n_pad, 4, True)
        live = A[5, :, 0] > 0
        r = A[5] @ x[5] - b[5]
        top = _order_keys(-r[live]) >> 21
        assert (top == top[0]).all() and live.sum() > over
