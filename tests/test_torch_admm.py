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


@pytest.mark.parametrize("n_pad,p_pad,on_chip,rows,threads", [
    (65536, 4, True, 8, 1024),      # the smoke's buckets
    (4096, 4, True, 1, 512),        # the smallest bucket
    (8192, 36, True, 1, 1024),
    (4096, 132, False, 1, 512),     # the wide rows: A past shared memory
    (4096, 260, False, 1, 512),
    (131072, 4, False, 16, 1024),   # 16 rows a thread: streamed
    (1048576, 4, False, 128, 1024),
])
def test_launch_plan_at_documented_shapes(n_pad, p_pad, on_chip, rows,
                                          threads):
    plan = admm.launch_plan(10, n_pad, p_pad)
    assert (plan.on_chip, plan.rows_per_thread, plan.threads) == (
        on_chip, rows, threads)


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
