"""K8's module on the CPU: the port's plain ADMM chunk against the JAX
package's ``_admm_chunk_batch`` on the same numpy-seeded instances
(``chip_smoke.admm_case``, which the card tests and phase 3d use too), the
dispatcher and its counts, and K8's launch plan (the kernel itself runs
only on the card: tests/test_torch_cuda.py, chip_smoke.py phase 3d)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke
from pantax_tpu.profile import pao as ref_pao
from pantax_tpu_torch.ops import admm, extend
from pantax_tpu_torch.profile import pao


def _torch(A, b, ub, state, L):
    return (torch.from_numpy(A), torch.from_numpy(b), torch.from_numpy(ub),
            tuple(torch.from_numpy(a) for a in state), torch.from_numpy(L))


# (S, n_pad, p_pad, iters) and the bar on every state vector and res.
# One step: the two packages' sums differ only in order (float32
# rounding of sums over a few thousand rows; 1.5e-5 seen).  25 steps:
# the rounding differences are carried and amplified by the iteration
# (2.4e-4 seen, in uw), well short of the solver's plateau.
CASES = [((3, 4096, 4, 1), 5e-5), ((3, 4096, 4, 25), 1e-3),
         ((2, 8192, 12, 25), 1e-3), ((1, 4096, 132, 1), 5e-5)]


@pytest.mark.parametrize("seeded", [False, True], ids=["zero", "seeded"])
@pytest.mark.parametrize("shape,bar", CASES, ids=[
    f"{s}x{n}x{p}_it{i}" for (s, n, p, i), _ in CASES])
def test_plain_chunk_matches_reference(shape, bar, seeded):
    S, n_pad, p_pad, iters = shape
    A, b, ub, state, L = chip_smoke.admm_case(n_pad + p_pad + iters, S,
                                              n_pad, p_pad, seeded)
    want_state, want_res = ref_pao._admm_chunk_batch(
        jnp.asarray(A), jnp.asarray(b), jnp.asarray(ub), 1.0,
        tuple(jnp.asarray(a) for a in state), jnp.asarray(L), iters)
    tA, tb, tub, tstate, tL = _torch(A, b, ub, state, L)
    got_state, got_res = pao._admm_chunk_batch_plain(tA, tb, tub, 1.0,
                                                     tstate, tL, iters)
    for name, w, g in zip(("x", "z", "w", "uz", "uw", "res"),
                          (*want_state, want_res), (*got_state, got_res)):
        assert g.shape == tuple(w.shape), name
        err = float(np.abs(np.asarray(w) - g.numpy()).max())
        assert err <= bar, (name, err)


def test_dispatcher_runs_the_plain_chunk_on_cpu():
    """On CPU tensors the dispatcher is the plain version bit for bit,
    counted as a plain run; K8 is not counted."""
    A, b, ub, state, L = _torch(*chip_smoke.admm_case(1, 2, 4096, 8, True))
    extend.reset_launch_counts()
    got_state, got_res = pao._admm_chunk_batch(A, b, ub, 1.0, state, L, 3)
    want_state, want_res = pao._admm_chunk_batch_plain(A, b, ub, 1.0, state,
                                                       L, 3)
    for g, w in zip((*got_state, got_res), (*want_state, want_res)):
        assert torch.equal(g, w)
    assert extend.LAUNCHES["admm_chunk_plain"] == 1
    assert extend.LAUNCHES["admm_chunk"] == 0


def test_solve_stack_counts_its_dispatches():
    """_admm_solve_stack counts each chunk it dispatches; on the CPU each
    is a plain chunk."""
    A, b, ub, _state, _L = chip_smoke.admm_case(2, 3, 4096, 4, False)
    extend.reset_launch_counts()
    X = pao._admm_solve_stack(A, b, ub, "cpu", iters=750, chunk=250, tol=0.0)
    assert X.shape == (3, 4)
    assert extend.LAUNCHES["admm_chunk_dispatch"] == 3
    assert extend.LAUNCHES["admm_chunk_plain"] == 3
    assert extend.LAUNCHES["admm_chunk"] == 0


def test_wrapper_refuses_tensors_off_the_card():
    """Anything but all-CPU or all-CUDA tensors goes to K8's checks, which
    raise before building: mixed devices (a meta tensor stands in for a
    card), and CPU tensors handed to the kernel's entry."""
    A, b, ub, state, L = _torch(*chip_smoke.admm_case(3, 1, 4096, 4, False))
    with pytest.raises(ValueError, match="CUDA"):
        pao._admm_chunk_batch(A, b.to("meta"), ub, 1.0, state, L, 1)
    with pytest.raises(ValueError, match="CUDA"):
        admm.admm_chunk_cuda(A, b, ub, 1.0, state, L, 1)


N_PADS = [4096 * 2 ** k for k in range(10)]  # 4096 .. 2^21
P_PADS = [4, 8, 32, 36, 132, 260, 516]


@pytest.mark.parametrize("p_pad", P_PADS)
def test_launch_plan_covers_every_row(p_pad):
    """Every row of every n_pad once, within the card's limits; on chip
    exactly where 1, 2, 4 or 8 rows a thread and the slice's A and b
    fit."""
    for n_pad in N_PADS:
        plan = admm.launch_plan(5, n_pad, p_pad)
        assert plan.cluster * plan.threads * plan.rows_per_thread == n_pad
        assert 1 <= plan.cluster <= 16
        assert 32 <= plan.threads <= 1024 and plan.threads % 32 == 0
        assert plan.smem_bytes <= 232_448
        fits = admm.smem_bytes(plan.threads, plan.rows_per_thread, p_pad,
                               True) <= admm.MAX_SMEM
        assert plan.on_chip == (plan.rows_per_thread in (1, 2, 4, 8)
                                and fits)
        assert plan.smem_bytes == admm.smem_bytes(
            plan.threads, plan.rows_per_thread, p_pad, plan.on_chip)


def _documented(n_pad, p_pad, on_chip, rows, threads, binary=False,
                cluster=8):
    """A row of test_launch_plan_at_documented_shapes: the float plan's
    rows keep their ids, the bits plan's end in "-bits"."""
    return pytest.param(
        n_pad, p_pad, on_chip, rows, threads, binary, cluster,
        id=f"{n_pad}-{p_pad}-{on_chip}-{rows}-{threads}"
           + ("-bits" if binary else ""))


@pytest.mark.parametrize("n_pad,p_pad,on_chip,rows,threads,binary,cluster", [
    _documented(65536, 4, True, 8, 1024),     # the smoke's buckets
    _documented(4096, 4, True, 1, 512),       # the smallest bucket
    _documented(8192, 36, True, 1, 1024),
    _documented(4096, 132, False, 1, 512),    # the wide rows: A past shared
    _documented(4096, 260, False, 1, 512),    # memory
    _documented(131072, 4, False, 16, 1024),  # 16 rows a thread: streamed
    _documented(1048576, 4, False, 128, 1024),
    # the bits plan (A 0/1): the smoke's buckets, small buckets spread
    # over 4-8 CTAs, 0/1 wide rows on chip; past its reach, the float plan
    _documented(65536, 4, True, 8, 1024, True, 8),
    _documented(4096, 4, True, 1, 512, True, 8),
    _documented(8192, 4, True, 2, 1024, True, 4),
    _documented(65536, 32, True, 8, 1024, True, 8),
    _documented(8192, 36, True, 4, 1024, True, 2),
    _documented(131072, 4, False, 16, 1024, True, 8),
    _documented(4096, 132, False, 1, 512, True, 8),
])
def test_launch_plan_at_documented_shapes(n_pad, p_pad, on_chip, rows,
                                          threads, binary, cluster):
    plan = admm.launch_plan(10, n_pad, p_pad, binary)
    assert (plan.on_chip, plan.rows_per_thread, plan.threads) == (
        on_chip, rows, threads)
    assert (plan.bits, plan.cluster) == (binary and on_chip, cluster)


# the bits plan's CTAs an instance at p_pad 4, as BITS_CLUSTER's measured
# table sets them: 4-8 CTAs at every bucket, 1-8 rows a thread
BITS_P4 = [(4096, 8, 512, 1), (8192, 4, 1024, 2), (16384, 8, 1024, 2),
           (32768, 8, 1024, 4), (65536, 8, 1024, 8)]


@pytest.mark.parametrize("n_pad,cluster,threads,rows", BITS_P4,
                         ids=[str(r[0]) for r in BITS_P4])
def test_bits_plan_sizes_the_cluster_to_the_bucket(n_pad, cluster, threads,
                                                   rows):
    plan = admm.launch_plan(3, n_pad, 4, binary=True)
    assert plan.bits and plan.on_chip
    assert (plan.cluster, plan.threads, plan.rows_per_thread) == (
        cluster, threads, rows)
    assert plan.smem_bytes == admm.bits_smem_bytes(threads, rows, 4)


@pytest.mark.parametrize("p_pad", [8, 12, 16, 32, 36, 64])
def test_bits_plan_reach(p_pad):
    """0/1 A of p_pad 8-64 takes the bits plan on chip at every bucket up
    to 65536 rows (4 or 8 rows a thread, the widths' instantiations),
    within shared memory; A that is not 0/1 takes the float plan exactly
    as before; past 65536 rows or 64 paths 0/1 A takes it too."""
    for n_pad in N_PADS:
        plan = admm.launch_plan(2, n_pad, p_pad, binary=True)
        float_plan = admm.launch_plan(2, n_pad, p_pad)
        assert not float_plan.bits and float_plan.cluster == admm.CLUSTER
        if n_pad > 65536:
            assert plan == float_plan
            continue
        assert plan.bits and plan.on_chip
        assert plan.rows_per_thread in (4, 8)
        assert plan.smem_bytes == admm.bits_smem_bytes(
            plan.threads, plan.rows_per_thread, admm.bits_width(p_pad))
        assert plan.smem_bytes <= admm.MAX_SMEM
    assert admm.bits_width(p_pad) == next(
        w for w in (4, 8, 16, 32, 64) if w >= p_pad)
    wider = admm.launch_plan(2, 65536, p_pad + 64, binary=True)
    assert wider == admm.launch_plan(2, 65536, p_pad + 64)


@pytest.mark.parametrize("p_pad", [4, 8, 32, 64])
def test_bits_plan_covers_every_row(p_pad):
    """Every row of every bucket once: cluster x threads x rows a thread is
    n_pad, a whole number of warps, at most 8 rows a thread and 8 CTAs."""
    for n_pad in N_PADS[:5]:
        plan = admm.launch_plan(5, n_pad, p_pad, binary=True)
        assert plan.bits
        assert plan.cluster * plan.threads * plan.rows_per_thread == n_pad
        assert plan.cluster in (1, 2, 4, 8) and plan.rows_per_thread <= 8
        assert 32 <= plan.threads <= 1024 and plan.threads % 32 == 0


def test_solve_stack_flags_zero_one_a(monkeypatch):
    """_admm_solve_stack tests its host A once a solve: 0/1 A goes to the
    chunk as binary (K8's bits plan), A with a 2.0 (a path that revisits
    a node) or a 0.5 does not; every chunk of the solve gets the flag."""
    A, b, ub, _state, _L = chip_smoke.admm_case(4, 2, 4096, 4, False)
    seen = []
    chunk = pao._admm_chunk_batch

    def recorded(*args, **kw):
        seen.append(args[7] if len(args) > 7 else kw.get("binary", False))
        return chunk(*args, **kw)

    monkeypatch.setattr(pao, "_admm_chunk_batch", recorded)
    for value, binary in ((1.0, True), (2.0, False), (0.5, False)):
        A2 = A.copy()
        A2[1, 7, 2] = value
        seen.clear()
        pao._admm_solve_stack(A2, b, ub, "cpu", iters=500, chunk=250,
                              tol=0.0)
        assert seen == [binary, binary], value
        assert pao._zero_one(A2) == binary


@pytest.mark.parametrize("S,n_pad,p_pad", [
    (0, 4096, 4), (1, 4096, 6), (1, 4096, 0), (1, 12288, 4), (1, 100, 4),
    (1, 65536, admm.P_PAD_MAX + 4)])
def test_launch_plan_refuses_what_does_not_fit(S, n_pad, p_pad):
    with pytest.raises(ValueError):
        admm.launch_plan(S, n_pad, p_pad)


@pytest.mark.parametrize("n_pad", N_PADS)
def test_launch_plan_fits_every_p_pad_up_to_its_limit(n_pad):
    """A CTA's shared memory does not grow with p_pad times its warps
    (the warps' sums are added 4 columns at a time), so every bucket has a
    plan up to P_PAD_MAX paths (6424), streamed past a few dozen."""
    assert admm.P_PAD_MAX == 6424
    for p_pad in (2048, admm.P_PAD_MAX):
        plan = admm.launch_plan(1, n_pad, p_pad)
        assert not plan.on_chip and plan.smem_bytes <= admm.MAX_SMEM


def test_admm_bound_counts_rows_and_bytes():
    """chip_smoke.admm_bound at the smoke's bucket: 22 instructions a row
    a step at p_pad 4 over the issue peak, against the bytes of one read
    of the inputs and one write of the outputs."""
    peak = 33.45e12
    ms, by, work = chip_smoke.admm_bound(10, 65536, 4, 250, peak)
    ops = 22 * 65536 * 250 * 10
    assert work["ops"] == ops and by == "operations"
    assert ms == pytest.approx(ops / peak * 1e3)
    n_bytes = 4 * (10 * 65536 * 4 + 10 * 65536 + 10 * 4 + 10 * 16
                   + 2 * (3 * 10 * 4 + 2 * 10 * 65536) + 10)
    assert work["bytes"] == n_bytes
