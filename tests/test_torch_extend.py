"""K1 and K2 (banded DP extension) in the PyTorch port against the JAX
reference: the plain torch versions must equal the Pallas kernels
(interpret mode) and the XLA DP bit for bit (the CUDA kernels are held to
the plain versions in test_torch_cuda.py, on the card)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pantax_tpu.align.aligner import _banded_extend
from pantax_tpu.align.aligner import packed_layout as ref_packed_layout
from pantax_tpu.ops.extend_pallas import (
    banded_extend_pallas, banded_extend_pallas_dponly,
)
from pantax_tpu_torch.ops.extend import (
    LAUNCHES, banded_extend, banded_extend_plain, banded_extend_windows,
    packed_layout,
)

MATCH, MIS, GAP = 1, -1, -2
NAMES = ["score", "start", "end", "matches"]


def _case(rng, pad, N=64, Lr=96, T=8192):
    """test_extend_pallas-style case, plus rows with read_len 0 and 1."""
    text = rng.integers(0, 4, size=T).astype(np.int8)
    text = np.concatenate([text, np.full(1024, 4, dtype=np.int8)])
    w0 = rng.integers(0, T - (Lr + 2 * pad) - 1, size=N).astype(np.int32)
    reads = np.empty((N, Lr), dtype=np.int8)
    lens = rng.integers(Lr // 2, Lr + 1, size=N).astype(np.int32)
    lens[:2] = (0, 1)
    for i in range(N):
        start = w0[i] + pad + rng.integers(-4, 5)
        seg = text[start : start + Lr].copy()
        m = rng.random(Lr) < 0.05
        seg[m] = rng.integers(0, 4, size=int(m.sum()))
        reads[i] = seg[:Lr]
        reads[i, lens[i]:] = 4
    return text, w0, reads, lens


@pytest.mark.parametrize("pad", [4, 8])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plain_matches_pallas_and_xla(seed, pad):
    rng = np.random.default_rng(seed)
    text, w0, reads, lens = _case(rng, pad)
    W = reads.shape[1] + 2 * pad
    windows = np.stack([text[s : s + W] for s in w0])
    xla = _banded_extend(jnp.asarray(windows), jnp.asarray(reads),
                         jnp.asarray(lens), pad, MATCH, MIS, GAP)
    pallas = banded_extend_pallas(
        jnp.asarray(text), jnp.asarray(w0), jnp.asarray(reads),
        jnp.asarray(lens), pad, MATCH, MIS, GAP, block=32, interpret=True,
    )
    before = LAUNCHES["banded_extend_plain"]
    port = banded_extend(torch.from_numpy(text), torch.from_numpy(w0),
                         torch.from_numpy(reads), torch.from_numpy(lens),
                         pad, MATCH, MIS, GAP)
    assert LAUNCHES["banded_extend_plain"] == before + 1
    for x, p, o, name in zip(xla, pallas, port, NAMES):
        assert o.dtype == torch.int32, name
        np.testing.assert_array_equal(np.asarray(x), o.numpy(), err_msg=name)
        np.testing.assert_array_equal(np.asarray(p), o.numpy(), err_msg=name)


@pytest.mark.parametrize("N,Lr,pad", [(64, 96, 4), (64, 96, 8), (32, 512, 8)])
def test_windows_plain_matches_pallas_dponly_and_xla(N, Lr, pad):
    """K2's plain version against the DP-only Pallas kernel and the XLA DP,
    with N bases in reads and windows and rows of read_len 0 and 1."""
    rng = np.random.default_rng(N + Lr + pad)
    text, w0, reads, lens = _case(rng, pad, N=N, Lr=Lr)
    reads[rng.random(reads.shape) < 0.01] = 4
    W = Lr + 2 * pad
    windows = np.stack([text[s : s + W] for s in w0])
    windows[rng.random(windows.shape) < 0.01] = 4
    args = (jnp.asarray(windows), jnp.asarray(reads), jnp.asarray(lens))
    xla = _banded_extend(*args, pad, MATCH, MIS, GAP)
    pallas = banded_extend_pallas_dponly(*args, pad, MATCH, MIS, GAP,
                                         block=32, interpret=True)
    before = dict(LAUNCHES)
    port = banded_extend_windows(torch.from_numpy(windows),
                                 torch.from_numpy(reads),
                                 torch.from_numpy(lens), pad, MATCH, MIS, GAP)
    assert LAUNCHES["banded_extend_windows_plain"] == (
        before["banded_extend_windows_plain"] + 1)
    assert LAUNCHES["banded_extend_plain"] == before["banded_extend_plain"]
    for x, p, o, name in zip(xla, pallas, port, NAMES):
        assert o.dtype == torch.int32, name
        np.testing.assert_array_equal(np.asarray(x), o.numpy(), err_msg=name)
        np.testing.assert_array_equal(np.asarray(p), o.numpy(), err_msg=name)


@pytest.mark.parametrize("Lr", [32, 96, 160, 1024])
def test_packed_layout_matches_reference(Lr):
    assert packed_layout(Lr) == ref_packed_layout(Lr)


def test_band_limit_raises():
    t = torch.zeros(64, dtype=torch.int8)
    r = torch.zeros((1, 8), dtype=torch.int8)
    with pytest.raises(ValueError):
        banded_extend_plain(t, torch.zeros(1, dtype=torch.int32), r,
                            torch.ones(1, dtype=torch.int32), 16, 1, -1, -2)



@pytest.mark.parametrize("Lr,pad", [(120, 4), (250, 8), (96, 4)])
def test_plain_on_padded_rows_with_lr_equals_unpadded(Lr, pad):
    """Read rows padded with N to a multiple of 16, given with ``lr`` = the
    unpadded width: the same four outputs as the unpadded call, read_len 0
    rows included (their NEG cell unpacks in width lr's layout)."""
    rng = np.random.default_rng(Lr + pad)
    text, w0, reads, lens = _case(rng, pad, N=48, Lr=Lr)
    padded = np.pad(reads, ((0, 0), (0, -Lr % 16 or 16)), constant_values=4)
    t, w, rl = (torch.from_numpy(a) for a in (text, w0, lens))
    want = banded_extend_plain(t, w, torch.from_numpy(reads), rl, pad, MATCH,
                               MIS, GAP)
    got = banded_extend(t, w, torch.from_numpy(padded), rl, pad, MATCH, MIS,
                        GAP, lr=Lr)
    for x, o, name in zip(want, got, NAMES):
        assert torch.equal(x, o), name
    with pytest.raises(ValueError):
        banded_extend_plain(t, w, torch.from_numpy(reads), rl, pad, MATCH,
                            MIS, GAP, lr=Lr + 1)
