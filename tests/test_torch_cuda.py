"""Tests of the port that need the card (marker ``cuda``; they skip where
torch sees no GPU).  jax-free, so they run on the GPU machine:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

import chip_smoke
from pantax_tpu_torch import _host
from pantax_tpu_torch.align.long_read import align_long_reads
from pantax_tpu_torch.benchmarks import (
    dup_db, simulate_long_reads, simulate_read_batch, tiny_db,
)
from pantax_tpu_torch.convert import aligner_from_reference
from pantax_tpu_torch.align import aligner as aligner_mod
from pantax_tpu_torch.align.aligner import unpack_reads
from pantax_tpu_torch.ops import extend, query, seed
from pantax_tpu_torch.ops.fused import (
    FusedPipeline, build_fused_tables, profile_from_fused_result,
)

from pantax_tpu_torch.ops.coverage_device import node_abundances_device
from pantax_tpu_torch.profile.coverage import pack_reads
from pantax_tpu_torch.profile.records import ReadRecord

from _torch_helpers import (
    COLLIDING_TRIOS, assert_tables_agree, code_seqs, coverage_case,
    random_intervals, simulate_pairs, write_reads,
)

pytestmark = pytest.mark.cuda
MATCH, MIS, GAP = 1, -1, -2
# the launch counts of K6 and K11 and the fused pipeline's scatter tally
NO_SCATTER = {"classify_scatter_ranges": 0, "classify_scatter_ranges_plain": 0,
              "classify_scatter": 0, "classify_scatter_plain": 0,
              "scatter_range_dispatch": 0, "scatter_window_dispatch": 0,
              # and K8's, the ADMM chunk's
              "admm_chunk": 0, "admm_chunk_plain": 0,
              "admm_chunk_dispatch": 0,
              # and K9's and K10b's, the device tail's stats and polish
              "tail_stats": 0, "tail_stats_plain": 0,
              "tail_stats_dispatch": 0, "polish": 0, "polish_plain": 0,
              "polish_dispatch": 0,
              # and K4's and K5's, the query's prologue and epilogue
              **{k + tail: 0 for k in chip_smoke.QUERY_KERNELS
                 for tail in ("", "_plain")}}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _case(rng, pad, N, Lr, T=8192):
    text = np.concatenate([rng.integers(0, 4, size=T).astype(np.int8),
                           np.full(1024, 4, dtype=np.int8)])
    w0 = rng.integers(0, T - (Lr + 2 * pad) - 8, size=N).astype(np.int32)
    start = w0 + pad + rng.integers(-4, 5, size=N)
    reads = text[start[:, None] + np.arange(Lr)]
    noise = rng.random((N, Lr)) < 0.05
    reads = np.where(noise, rng.integers(0, 4, size=(N, Lr)), reads).astype(np.int8)
    reads[rng.random((N, Lr)) < 0.01] = 4  # ambiguous bases
    lens = rng.integers(Lr // 2, Lr + 1, size=N).astype(np.int32)
    lens[:2] = (0, 1)
    reads[np.arange(Lr)[None, :] >= lens[:, None]] = 4
    return text, w0, reads, lens


@pytest.mark.parametrize("pad", [1, 4, 5, 8])
@pytest.mark.parametrize("Lr", [96, 160, 512])
def test_kernel_matches_plain(cuda, pad, Lr):
    rng = np.random.default_rng(pad * 1000 + Lr)
    args = [torch.from_numpy(a).to(cuda) for a in _case(rng, pad, 1000, Lr)]
    ker = extend.banded_extend_cuda(*args, pad, MATCH, MIS, GAP)
    plain = extend.banded_extend_plain(*args, pad, MATCH, MIS, GAP)
    torch.cuda.synchronize()
    for k, p, name in zip(ker, plain, ("score", "start", "end", "matches")):
        assert torch.equal(k, p), name


def test_wrapper_launches_kernel_on_cuda(cuda):
    rng = np.random.default_rng(0)
    args = [torch.from_numpy(a).to(cuda) for a in _case(rng, 4, 300, 160)]
    extend.reset_launch_counts()
    extend.banded_extend(*args, 4, MATCH, MIS, GAP)
    assert extend.LAUNCHES == {
        "banded_extend": 1, "banded_extend_plain": 0,
        "banded_extend_windows": 0, "banded_extend_windows_plain": 0,
        "seed_stage": 0, "seed_stage_plain": 0, **NO_SCATTER,
    }


def test_kernel_rejects_bad_inputs(cuda):
    rng = np.random.default_rng(0)
    text, w0, reads, lens = [torch.from_numpy(a).to(cuda)
                             for a in _case(rng, 4, 64, 96)]
    with pytest.raises(ValueError):
        extend.banded_extend_cuda(text, w0.long(), reads, lens, 4, 1, -1, -2)
    with pytest.raises(ValueError):
        extend.banded_extend_cuda(text.cpu(), w0, reads, lens, 4, 1, -1, -2)
    with pytest.raises(ValueError):
        extend.banded_extend_cuda(text, w0, reads, lens, 9, 1, -1, -2)


def _edge_case(rng, pad, N, Lr, T=4096):
    """Candidates at the edges of K1's design: N codes (and other codes >= 4,
    and the negative code -1, which the kernel sends to its clamped path)
    in the text and the reads, read_len 0, 1, 15, 16, 17, Lr - 1, Lr and
    past Lr (the edges of the 16-byte chunks), and windows that touch
    position 0 or the text's last byte or reach past them (the clamped
    path)."""
    n, N = N, max(N, 16)  # the edge rows come first; keep n of the rows
    text = rng.integers(0, 4, size=T).astype(np.int8)
    text[rng.random(T) < 0.02] = 4
    text[rng.random(T) < 0.005] = 9
    text[rng.random(T) < 0.002] = -1  # a base to the plain version's x < 4
    W = Lr + 2 * pad
    w0 = rng.integers(0, T - W, size=N).astype(np.int32)
    w0[:6] = (0, T - W, -7, T - W + 9, 1, T - W - 1)
    start = np.clip(w0 + pad + rng.integers(-4, 5, size=N), 0, T - Lr)
    reads = text[start[:, None] + np.arange(Lr)]
    noise = rng.random((N, Lr)) < 0.05
    reads = np.where(noise, rng.integers(0, 4, size=(N, Lr)), reads).astype(np.int8)
    reads[rng.random((N, Lr)) < 0.02] = 4
    reads[rng.random((N, Lr)) < 0.002] = -1
    lens = rng.integers(1, Lr + 1, size=N).astype(np.int32)
    edges = (0, 1, 15, 16, 17, Lr - 1, Lr, Lr + 5)
    lens[:len(edges)] = edges
    lens[6:6 + len(edges)] = edges
    reads[np.arange(Lr)[None, :] >= lens[:, None]] = 4
    return text, w0[:n], reads[:n], lens[:n]


def _hold_k1(cuda, case, pad):
    args = [torch.from_numpy(a).to(cuda) for a in case]
    ker = extend.banded_extend_cuda(*args, pad, MATCH, MIS, GAP)
    plain = extend.banded_extend_plain(*args, pad, MATCH, MIS, GAP)
    torch.cuda.synchronize()
    for k, p, name in zip(ker, plain, ("score", "start", "end", "matches")):
        assert torch.equal(k, p), name


@pytest.mark.parametrize("pad", range(1, 9))
@pytest.mark.parametrize("Lr", [32, 160])
def test_kernel_edges_match_plain(cuda, pad, Lr):
    """Every band width of the launch switch over read_len at the chunk
    edges, N codes in reads and text, and windows at the text's ends."""
    _hold_k1(cuda, _edge_case(np.random.default_rng(70 + pad + Lr), pad,
                              1000, Lr), pad)


@pytest.mark.parametrize("N", [1, 37, 4099, 70001])
def test_kernel_ragged_n_matches_plain(cuda, N):
    """N not a multiple of the block size (128)."""
    _hold_k1(cuda, _edge_case(np.random.default_rng(N), 4, N, 160), 4)


def test_kernel_rejects_unaligned_reads(cuda):
    """K1 loads read rows 16 bytes at a time: a reads view that starts off
    a 16-byte boundary, or rows of a width not a multiple of 16, raise."""
    text, w0, reads, lens = [torch.from_numpy(a).to(cuda) for a in
                             _edge_case(np.random.default_rng(2), 4, 64, 160)]
    buf = torch.empty(reads.numel() + 16, dtype=torch.int8, device=cuda)
    shifted = buf[1:1 + reads.numel()].view(reads.shape)
    shifted.copy_(reads)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    with pytest.raises(ValueError, match="16-byte"):
        extend.banded_extend_cuda(text, w0, shifted, lens, 4, 1, -1, -2)
    with pytest.raises(ValueError, match="multiple of 16"):
        extend.banded_extend_cuda(text, w0, reads[:, :150].contiguous(),
                                  lens, 4, 1, -1, -2)


def _windows_case(rng, pad, N, Lr):
    text, w0, reads, lens = _case(rng, pad, N, Lr, T=max(8192, 4 * Lr))
    W = Lr + 2 * pad
    windows = text[w0[:, None] + np.arange(W)]
    return windows, reads, lens


@pytest.mark.parametrize("pad", [1, 4, 5, 8])
@pytest.mark.parametrize("Lr", [96, 512])
def test_windows_kernel_matches_plain(cuda, pad, Lr):
    rng = np.random.default_rng(pad * 1000 + Lr + 7)
    args = [torch.from_numpy(a).to(cuda)
            for a in _windows_case(rng, pad, 1000, Lr)]
    ker = extend.banded_extend_windows_cuda(*args, pad, MATCH, MIS, GAP)
    plain = extend.banded_extend_windows_plain(*args, pad, MATCH, MIS, GAP)
    torch.cuda.synchronize()
    for k, p, name in zip(ker, plain, ("score", "start", "end", "matches")):
        assert torch.equal(k, p), name


def _k2_edge_case(rng, pad, N, Lr, W=None, T=4096):
    """K2 candidates at the edges of the fast DP, at window width W
    (default Lr + 2*pad - 1, the narrowest the wrapper takes): N codes
    (4 and 9) in windows and reads, a negative code (-1, which sends a row
    to the per-byte path) in every eighth row's window or read, read_len 0,
    1, 15, 16, 17, Lr - 1 and Lr in the first rows and in the buffer's last
    rows (whose 16-byte loads would leave the buffer)."""
    W = W or Lr + 2 * pad - 1
    T = max(T, 4 * W)
    text = rng.integers(0, 4, size=T).astype(np.int8)
    text[rng.random(T) < 0.02] = 4
    text[rng.random(T) < 0.005] = 9
    w0 = rng.integers(0, T - W, size=N)
    windows = text[w0[:, None] + np.arange(W)]
    start = np.clip(w0 + pad + rng.integers(-4, 5, size=N), 0, T - Lr)
    reads = text[start[:, None] + np.arange(Lr)]
    noise = rng.random((N, Lr)) < 0.05
    reads = np.where(noise, rng.integers(0, 4, size=(N, Lr)), reads).astype(np.int8)
    reads[rng.random((N, Lr)) < 0.02] = 4
    lens = rng.integers(1, Lr + 1, size=N).astype(np.int32)
    edges = (0, 1, 15, 16, 17, Lr - 1, Lr)
    lens[:len(edges)] = edges[:N]
    lens[-len(edges):] = edges[-N:]
    reads[np.arange(Lr)[None, :] >= lens[:, None]] = 4
    neg = np.flatnonzero(np.arange(N) % 8 == 3)
    half = rng.random(len(neg)) < 0.5
    windows[neg[half], rng.integers(0, W, size=int(half.sum()))] = -1
    reads[neg[~half], rng.integers(0, Lr, size=int((~half).sum()))] = -1
    return windows, reads, lens


def _hold_k2(cuda, windows, reads, lens, pad):
    """K2 against its plain version, bit for bit on all four outputs;
    tensors are moved to the card unless they are there."""
    args = [a if isinstance(a, torch.Tensor) else torch.from_numpy(a).to(cuda)
            for a in (windows, reads, lens)]
    ker = extend.banded_extend_windows_cuda(*args, pad, MATCH, MIS, GAP)
    plain = extend.banded_extend_windows_plain(*args, pad, MATCH, MIS, GAP)
    torch.cuda.synchronize()
    for k, p, name in zip(ker, plain, ("score", "start", "end", "matches")):
        assert torch.equal(k, p), name


def _off_boundary(a, cuda, offset: int):
    """A contiguous copy of ``a`` on the card whose data starts ``offset``
    bytes past a 16-byte boundary."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    buf = torch.empty(t.numel() + 16, dtype=t.dtype, device=cuda)
    view = buf[offset:offset + t.numel()].view(t.shape)
    view.copy_(t)
    assert view.is_contiguous() and view.data_ptr() % 16 == offset
    return view


@pytest.mark.parametrize("pad", range(1, 9))
@pytest.mark.parametrize("Lr", [32, 160, 512])
def test_windows_kernel_edges_match_plain(cuda, pad, Lr):
    """Every band width over read_len at the chunk edges, N and negative
    codes, the narrowest windows and the buffer's last rows."""
    _hold_k2(cuda, *_k2_edge_case(np.random.default_rng(90 + pad + Lr), pad,
                                  1000, Lr), pad)


@pytest.mark.parametrize("extra", [-1, 0, 5])
def test_windows_kernel_widths_match_plain(cuda, extra):
    """Windows of Lr + 2*pad + extra bytes: the narrowest, the rescue
    pass's and a wider one (rows at every offset in a 16-byte chunk)."""
    pad, Lr = 8, 512
    _hold_k2(cuda, *_k2_edge_case(np.random.default_rng(31 + extra), pad,
                                  2000, Lr, W=Lr + 2 * pad + extra), pad)


@pytest.mark.parametrize("offset", [1, 7])
def test_windows_kernel_unaligned_windows_match_plain(cuda, offset):
    """A windows view that starts off a 16-byte boundary (its first row
    takes the per-byte path, the others the fast DP)."""
    windows, reads, lens = _k2_edge_case(np.random.default_rng(offset), 4,
                                         600, 160)
    _hold_k2(cuda, _off_boundary(windows, cuda, offset), reads, lens, 4)


@pytest.mark.parametrize("n_last", [1, 2, 3, 40])
def test_windows_kernel_last_rows_match_plain(cuda, n_last):
    """The buffer's last rows, as a view that ends where the allocation
    ends: loads past the view's N * W bytes would leave it, so these rows
    take the per-byte path where their chunks would."""
    windows, reads, lens = _k2_edge_case(np.random.default_rng(n_last), 8,
                                         64, 512)
    lens[-n_last:] = 512
    w, r, rl = (torch.from_numpy(a).to(cuda) for a in (windows, reads, lens))
    _hold_k2(cuda, w[-n_last:], r[-n_last:], rl[-n_last:], 8)


@pytest.mark.parametrize("case", ["width 150", "width 500", "reads off 16"])
def test_windows_kernel_per_byte_launch_matches_plain(cuda, case):
    """Read rows the fast DP cannot load 16 bytes at a time (a width that
    is no multiple of 16, or a view off a 16-byte boundary): the launch
    runs the per-byte DP for every row, exact."""
    Lr = {"width 150": 150, "width 500": 500, "reads off 16": 160}[case]
    windows, reads, lens = _k2_edge_case(np.random.default_rng(Lr), 4, 700,
                                         Lr)
    if case == "reads off 16":
        reads = _off_boundary(reads, cuda, 3)
    _hold_k2(cuda, windows, reads, lens, 4)


@pytest.mark.parametrize("N", [1, 37, 4099, 70001])
def test_windows_kernel_ragged_n_matches_plain(cuda, N):
    """N not a multiple of the block size (128)."""
    _hold_k2(cuda, *_k2_edge_case(np.random.default_rng(N + 5), 4, N, 160),
             4)


def test_windows_wrapper_launches_kernel_on_cuda(cuda):
    rng = np.random.default_rng(1)
    args = [torch.from_numpy(a).to(cuda)
            for a in _windows_case(rng, 8, 300, 512)]
    extend.reset_launch_counts()
    extend.banded_extend_windows(*args, 8, MATCH, MIS, GAP)
    assert extend.LAUNCHES == {
        "banded_extend": 0, "banded_extend_plain": 0,
        "banded_extend_windows": 1, "banded_extend_windows_plain": 0,
        "seed_stage": 0, "seed_stage_plain": 0, **NO_SCATTER,
    }


def test_windows_kernel_rejects_bad_inputs(cuda):
    rng = np.random.default_rng(0)
    windows, reads, lens = [torch.from_numpy(a).to(cuda)
                            for a in _windows_case(rng, 4, 64, 96)]
    with pytest.raises(ValueError):  # W < Lr + 2*pad - 1
        extend.banded_extend_windows_cuda(windows[:, :100].contiguous(),
                                          reads, lens, 4, 1, -1, -2)
    with pytest.raises(ValueError):
        extend.banded_extend_windows_cuda(windows, reads, lens, 9, 1, -1, -2)
    with pytest.raises(ValueError):
        extend.banded_extend_windows_cuda(windows.int(), reads, lens, 4, 1,
                                          -1, -2)
    with pytest.raises(ValueError):
        extend.banded_extend_windows_cuda(windows, reads, lens.long(), 4, 1,
                                          -1, -2)


# ---------------------------------------------------------------------------
# K3, the seed stage (ops/seed.py, csrc/seed_stage.cu)
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def tiny_index(tmp_path_factory):
    return _host.build_align_index(tiny_db(tmp_path_factory.mktemp("tiny")))


def _seed_case(cuda, index, lookup, N, Lr, pad, monkeypatch):
    """(codes_fwd, read_len, run_table, seed_pos, bucket_lo, cfg_static) on
    the card: N reads of Lr - 2 bases simulated from the tiny DB at a code
    width of Lr (rows of length 0, 15 and all N first), unpacked as the
    query unpacks them, and the aligner's seed tables (CHD, or the bucketed
    bisection when ``lookup`` is "bisect")."""
    if lookup == "bisect":
        monkeypatch.setattr(aligner_mod, "_build_chd", lambda keys: None)
    cfg = _host.AlignConfig(extension_band=pad)
    al = aligner_from_reference(index, cfg, cuda)
    assert (al.lookup_steps >= 0) == (lookup == "bisect")
    codes, lens, _ = simulate_read_batch(index, max(N, 4), Lr - 2, 0.01,
                                         seed=N + Lr, indel_rate=0.01)
    codes = np.ascontiguousarray(codes[:N, :Lr])
    lens = lens[:N].astype(np.int32)
    lens[:3] = (0, 15, Lr - 2)[:N]
    codes[2:3] = 4
    c, n = (torch.from_numpy(a).to(cuda) for a in (codes, lens))
    return (unpack_reads(c, n), n, al.run_table, al.seed_pos, al.bucket_lo,
            al.static())


@pytest.mark.parametrize("lookup", ["chd", "bisect"])
@pytest.mark.parametrize("Lr,pad", [(152, 4), (512, 8)])
@pytest.mark.parametrize("N", [1, 37, 4099, 70001])
def test_seed_kernel_matches_plain(cuda, tiny_index, monkeypatch, lookup, Lr,
                                   pad, N):
    """K3 against its plain version, bit for bit on its three outputs, at
    ragged N (the block takes 4 reads), both lookups, the short and the
    long preset's band and widths."""
    args = _seed_case(cuda, tiny_index, lookup, N, Lr, pad, monkeypatch)
    ker = seed.seed_candidates_cuda(*args)
    plain = seed.seed_candidates_plain(*args)
    torch.cuda.synchronize()
    for k, p, name in zip(ker, plain, ("cand_diag", "cand_votes", "strand")):
        assert k.dtype == p.dtype and torch.equal(k, p), name
    if N > 3:
        assert (plain[1][3:, 0] > 0).float().mean() > 0.9


@pytest.fixture(scope="module")
def crafted_seed_cases():
    return chip_smoke.seed_cases()


@pytest.mark.parametrize("name", chip_smoke.SEED_CASES)
def test_seed_kernel_crafted_case_matches_plain(cuda, crafted_seed_cases,
                                                name):
    """K3 against its plain version, bit for bit, on each crafted case:
    ties, the strands' tie, a round with every count 0, 256 slots at top_k
    8, int32 differences of -2^31 and 2^31 - 1, empty, short and all-N
    rows, and a row of the widest width."""
    case = crafted_seed_cases[name]
    args = tuple(torch.from_numpy(a).to(cuda) for a in case[:5]) + case[5:]
    ker = seed.seed_candidates_cuda(*args)
    plain = seed.seed_candidates_plain(*args)
    torch.cuda.synchronize()
    for k, p, out in zip(ker, plain, ("cand_diag", "cand_votes", "strand")):
        assert k.dtype == p.dtype and torch.equal(k, p), out


def test_seed_wrapper_launches_kernel_on_cuda(cuda, tiny_index, monkeypatch):
    args = _seed_case(cuda, tiny_index, "chd", 300, 152, 4, monkeypatch)
    extend.reset_launch_counts()
    seed.seed_candidates(*args)
    assert extend.LAUNCHES == {
        "banded_extend": 0, "banded_extend_plain": 0,
        "banded_extend_windows": 0, "banded_extend_windows_plain": 0,
        "seed_stage": 1, "seed_stage_plain": 0, **NO_SCATTER,
    }


def test_seed_kernel_rejects_bad_inputs(cuda, tiny_index, monkeypatch):
    codes, lens, run_table, seed_pos, bucket_lo, cfg = _seed_case(
        cuda, tiny_index, "chd", 64, 152, 4, monkeypatch)
    with pytest.raises(ValueError):  # not contiguous
        seed.seed_candidates(codes[:, ::2], lens, run_table, seed_pos,
                             bucket_lo, cfg)
    with pytest.raises(ValueError):  # read_len not int32
        seed.seed_candidates(codes, lens.long(), run_table, seed_pos,
                             bucket_lo, cfg)
    with pytest.raises(ValueError):  # a CHD row of 2 + 3 columns, C = 4
        seed.seed_candidates(codes, lens, run_table[:, :5].contiguous(),
                             seed_pos, bucket_lo, cfg)
    with pytest.raises(ValueError):  # a table on the CPU
        seed.seed_candidates(codes, lens, run_table.cpu(), seed_pos,
                             bucket_lo, cfg)


def test_extend_rows_cpu_equal_cuda(cuda, tmp_path):
    db = tiny_db(tmp_path / "tiny")
    index = _host.build_align_index(db)
    rng = np.random.default_rng(5)
    B, chunk = 512, 512
    start = rng.integers(0, len(index.text) - 2048, size=B)
    codes = index.text[start[:, None] + np.arange(chunk)].astype(np.int8)
    lens = np.full(B, chunk, dtype=np.int64)
    lens[:2] = (0, 1)
    w0 = start - 8 + rng.integers(-3, 4, size=B)
    w0[2:4] = (-20, len(index.text))
    strand = np.zeros(B, dtype=np.int8)
    rows = []
    for dev in ("cpu", cuda):
        al = aligner_from_reference(
            index, _host.AlignConfig.for_read_type("long"), dev)
        rows.append(al.extend_packed(codes, lens, w0, strand).cpu())
    assert torch.equal(rows[0], rows[1])
    assert (rows[1][3] & 1).float().mean() > 0.9


def test_align_long_reads_cpu_equal_cuda(cuda, tmp_path):
    """The long-read path (seeded K1 at Lr 512, pad 8, and the rescue K2)
    gives the same alignment arrays on the CPU and on the card."""
    db = tiny_db(tmp_path / "tiny")
    index = _host.build_align_index(db)
    reads, _ = simulate_long_reads(index, 16, 4096, seed=9)
    got = []
    for dev in ("cpu", cuda):
        al = aligner_from_reference(
            index, _host.AlignConfig.for_read_type("long"), dev)
        extend.reset_launch_counts()
        got.append(align_long_reads(al, reads, chunk=512, batch_size=256,
                                    seed_stride=2, as_arrays=True))
    assert extend.LAUNCHES["banded_extend"] > 0
    assert extend.LAUNCHES["banded_extend_windows"] > 0
    assert got[0].read_ids == got[1].read_ids
    for name in ("ts", "te", "mapq", "read_len"):
        np.testing.assert_array_equal(getattr(got[0], name),
                                      getattr(got[1], name), err_msg=name)


def test_query_rows_cpu_equal_cuda(cuda, tmp_path):
    db = tiny_db(tmp_path / "tiny")
    index = _host.build_align_index(db)
    codes, lens, _ = simulate_read_batch(index, 2048, 150, 0.01, seed=3,
                                         indel_rate=0.01)
    rows = []
    for dev in ("cpu", cuda):
        al = aligner_from_reference(index, _host.AlignConfig(), dev)
        rows.append(al.query_packed(*al.upload(codes, lens)).cpu())
    assert torch.equal(rows[0], rows[1])


@pytest.mark.parametrize("width", [150, 100, 120, 250])
def test_align_codes_odd_width_cpu_equal_cuda(cuda, tmp_path, width):
    """Code matrices of a width that is no multiple of 16 (K1 loads read
    rows 16 bytes at a time; the aligner pads them, and the DP keeps the
    unpadded width's packed layout, which padding 120 and 250 would move):
    align_codes and the paired query on the card equal the CPU's."""
    db = tiny_db(tmp_path / "tiny")
    index = _host.build_align_index(db)
    codes, lens, _ = simulate_read_batch(index, 1024, width, 0.01, seed=3)
    codes = np.ascontiguousarray(codes[:, :width])
    lens[:3] = (0, 40, width - 1)
    c1, l1, c2, l2 = simulate_pairs(index, 512, seed=3, Lr=width - 2,
                                    L=width)
    got = []
    for dev in ("cpu", cuda):
        al = aligner_from_reference(index, _host.AlignConfig(), dev)
        extend.reset_launch_counts()
        got.append((al.align_codes(codes, lens),
                    al.align_paired_codes(c1, l1, c2, l2)))
        assert extend.LAUNCHES["banded_extend"] == (2 if dev == cuda else 0)
        assert extend.LAUNCHES["seed_stage"] == (2 if dev == cuda else 0)
    (single, (m1, m2)), (single_d, (m1_d, m2_d)) = got
    for a, b in ((single, single_d), (m1, m1_d), (m2, m2_d)):
        for name in ("text_start", "text_end", "score", "matches", "mapq",
                     "strand", "aligned"):
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name),
                                          err_msg=name)
    assert single_d.aligned.mean() > 0.9


def test_align_long_reads_odd_chunk_cpu_equal_cuda(cuda, tmp_path):
    """Long reads cut into chunks of 500 bases (no multiple of 16)."""
    db = tiny_db(tmp_path / "tiny")
    index = _host.build_align_index(db)
    reads, _ = simulate_long_reads(index, 16, 4096, seed=9)
    got = []
    for dev in ("cpu", cuda):
        al = aligner_from_reference(
            index, _host.AlignConfig.for_read_type("long"), dev)
        got.append(align_long_reads(al, reads, chunk=500, batch_size=256,
                                    seed_stride=2, as_arrays=True))
    assert got[0].read_ids == got[1].read_ids and len(got[1].read_ids) > 12
    for name in ("ts", "te", "mapq", "read_len"):
        np.testing.assert_array_equal(getattr(got[0], name),
                                      getattr(got[1], name), err_msg=name)


def test_paired_rows_cpu_equal_cuda(cuda, tmp_path):
    """The joint mate query: one K1 launch per paired batch on the card,
    packed [8, B] rows equal to the CPU's."""
    db = tiny_db(tmp_path / "tiny")
    index = _host.build_align_index(db)
    c1, l1, c2, l2 = simulate_pairs(index, 2048, seed=3)
    l2[:3] = (0, 40, 149)
    rows = []
    for dev in ("cpu", cuda):
        al = aligner_from_reference(index, _host.AlignConfig(), dev)
        extend.reset_launch_counts()
        rows.append(al.query_paired_packed(*al.upload(c1, l1),
                                           *al.upload(c2, l2)).cpu())
    assert extend.LAUNCHES["banded_extend"] == 1
    assert extend.LAUNCHES["banded_extend_plain"] == 0
    assert extend.LAUNCHES["seed_stage"] == 1
    assert extend.LAUNCHES["seed_stage_plain"] == 0
    assert torch.equal(rows[0], rows[1])
    assert (rows[1][3] & 1).float().mean() > 0.95


def test_device_tail_cpu_agrees_with_cuda(cuda, tmp_path):
    """feed_paired and the device tail on the CPU and on the card: the
    classification identical, the tables within the port's tail bars
    (_torch_helpers.assert_tables_agree, abundances within 2e-4)."""
    db = tiny_db(tmp_path / "tiny")
    index = _host.build_align_index(db)
    pairs = simulate_pairs(index, 4096, seed=4)
    cfg = _host.ProfilingConfig.for_read_type("short")
    cfg.tail = "device"
    outs = []
    for dev in ("cpu", cuda):
        al = aligner_from_reference(index, _host.AlignConfig(), dev)
        pipe = FusedPipeline(al, build_fused_tables(db, index, dev), 1024)
        pipe.feed_paired(*pairs)
        out = tmp_path / torch.device(dev).type
        assert profile_from_fused_result(pipe.finish(), pipe.tables, index, db,
                                         cfg, out)
        outs.append(out)
    assert ((outs[0] / "reads_classification.tsv").read_text()
            == (outs[1] / "reads_classification.tsv").read_text())
    assert_tables_agree(outs[0], outs[1], abundance_tol=2e-4)


@pytest.mark.parametrize("L_cap", [None, 3])
def test_windowed_feed_cpu_equal_cuda(cuda, tmp_path, L_cap):
    """The windowed scatter on the dup-graph community (codes, paired and
    interval feeds; at L_cap 3 a third of the reads take the host
    residual): na/ta/bc, the per-read columns and the overflow count on the
    card equal the CPU's, with K1 once per codes dispatch."""
    db = dup_db(tmp_path / "dup", n_species=2, strains=2, n_blocks=400)
    index = _host.build_align_index(db)
    codes, lens, _ = simulate_read_batch(index, 3000, 150, 0.01, seed=3,
                                         indel_rate=0.01)
    pairs = simulate_pairs(index, 1500, seed=4)
    intervals = random_intervals(index, 700, seed=5)
    res = []
    for dev in ("cpu", cuda):
        al = aligner_from_reference(index, _host.AlignConfig(), dev)
        pipe = FusedPipeline(al, build_fused_tables(db, index, dev), 1024,
                             L_cap)
        extend.reset_launch_counts()
        pipe.feed(codes, lens)
        pipe.feed_paired(*pairs)
        pipe.feed_intervals(*intervals)
        res.append(pipe.finish())
        assert not pipe.use_ranges
        assert extend.LAUNCHES["banded_extend"] == (
            pipe.n_batches if dev == cuda else 0)
        # K11 once per windowed dispatch on the card, the plain version on
        # the CPU
        key = "classify_scatter" if dev == cuda else "classify_scatter_plain"
        assert extend.LAUNCHES[key] == extend.LAUNCHES[
            "scatter_window_dispatch"] > 0
        assert extend.LAUNCHES["classify_scatter_ranges"] == 0
    (cpu, gpu) = res
    for a, b in ((cpu.na_d, gpu.na_d), (cpu.ta_d, gpu.ta_d),
                 (cpu.bc_d, gpu.bc_d)):
        assert torch.equal(a, b.cpu())
    for k in ("mapq", "aligned", "ridx", "read_len"):
        np.testing.assert_array_equal(cpu.reads[k], gpu.reads[k], err_msg=k)
    assert gpu.n_overflow == cpu.n_overflow
    assert (gpu.n_overflow > 0) == (L_cap is not None)


@pytest.mark.parametrize("width", [65, 1024, "hash"])
def test_node_abundances_device_cpu_equal_cuda(cuda, width):
    """The per-species device coverage on rows wider than 64 nodes (where
    the reference switches to its sort dedup) and on two unique trios whose hashes collide (the linear
    probe): na, ta and bc on the card equal the CPU's bit for bit."""
    rng = np.random.default_rng(3)
    if width == "hash":
        extra = [[5, 6, *COLLIDING_TRIOS[0], 9], [11, *COLLIDING_TRIOS[1], 13]]
        nodes_len, paths, reads, rs0 = coverage_case(
            rng, 16, n_nodes=5000, n_reads=200, extra_paths=extra)
        reads += [(f"c{i}", np.array(p) + rs0, 0, 40)
                  for i, p in enumerate(extra)]
    else:
        nodes_len, paths, reads, rs0 = coverage_case(rng, width)
    ti = _host.build_trio_index(nodes_len, paths)
    packed = pack_reads([ReadRecord(r, n, 0, a, b, "s")
                         for r, n, a, b in reads], rs0)
    cpu, gpu = (node_abundances_device(packed, nodes_len, ti, device=d)
                for d in ("cpu", cuda))
    for name, a, b in zip(("na", "ta", "bc"), cpu, gpu):
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert (gpu[1] > 0).sum() > 0


def test_align_file_cpu_equal_cuda(cuda, tmp_path):
    """FASTQ -> align_file on the CPU and on the card: the same GafRecords,
    K1 once per batch on the card."""
    db = tiny_db(tmp_path / "tiny")
    index = _host.build_align_index(db)
    codes, lens, _ = simulate_read_batch(index, 2500, 150, 0.01, seed=3)
    path = tmp_path / "r.fq"
    write_reads(path, [f"S{i}" for i in range(len(lens))],
                code_seqs(codes, lens), "fq")
    got = []
    for dev in ("cpu", cuda):
        al = aligner_from_reference(index, _host.AlignConfig(), dev)
        extend.reset_launch_counts()
        stage = {}
        got.append(al.align_file(path, batch_size=1024, chunk_bytes=200_000,
                                 stage_out=stage))
    assert extend.LAUNCHES["banded_extend"] == stage["n_batches"] >= 3
    assert extend.LAUNCHES["banded_extend_plain"] == 0
    assert got[0] == got[1] and len(got[1]) > 2400


@pytest.mark.parametrize("flow", [["-s", "--fastpath"], ["-s"],
                                  ["-s", "-p", "--fastpath"],
                                  ["-l", "--fastpath"]])
def test_cli_cpu_equal_cuda(cuda, tmp_path, monkeypatch, flow):
    """pantax-gpu with --device cpu and with --device cuda over tiny_db
    (HiGHS): the species, strain and classification files byte-identical;
    on the card K1 (and K2 on long reads) launched, the plain DPs never."""
    from pantax_tpu_torch import cli

    db = tiny_db(tmp_path / "tiny")
    index = _host.build_align_index(db)
    if "-l" in flow:
        reads, _ = simulate_long_reads(index, 16, 4096, seed=9)
        files = [(tmp_path / "r.fq", [r for r, _ in reads],
                  [s for _, s in reads])]
    elif "-p" in flow:
        c1, l1, c2, l2 = simulate_pairs(index, 1024, seed=4)
        files = [(tmp_path / f"r{m}.fq", [f"P{i}/{m}" for i in range(1024)],
                  code_seqs(c, n)) for m, c, n in ((1, c1, l1), (2, c2, l2))]
    else:
        codes, lens, _ = simulate_read_batch(index, 2500, 150, 0.01, seed=3)
        files = [(tmp_path / "r.fq", [f"S{i}" for i in range(len(lens))],
                  code_seqs(codes, lens - np.arange(len(lens)) % 7))]
    for path, ids, seqs in files:
        write_reads(path, ids, seqs, "fq")
    outs = []
    for dev in ("cpu", "cuda"):
        wd = tmp_path / dev
        wd.mkdir()
        monkeypatch.chdir(wd)
        extend.reset_launch_counts()
        assert cli.main(["-d", str(db.root), *flow, "-r",
                         *(str(p) for p, _, _ in files), "--device", dev,
                         "--solver", "highs", "--batch-size", "512", "-o",
                         "out", "-R", "cls.tsv"]) == 0
        outs.append(wd)
    assert extend.LAUNCHES["banded_extend"] >= 1
    assert ("-l" in flow) == (extend.LAUNCHES["banded_extend_windows"] >= 1)
    assert extend.LAUNCHES["banded_extend_plain"] == 0
    assert extend.LAUNCHES["banded_extend_windows_plain"] == 0
    for name in ("out_species_abundance.txt", "out_strains_abundance.txt",
                 "cls.tsv"):
        assert (outs[0] / name).read_bytes() == (outs[1] / name).read_bytes()


def _mesh_query_case(index, entry: str) -> tuple:
    """2048 rows of one aligner entry's arguments: single-end reads, FR
    pairs, or text windows for extend_packed."""
    if entry == "paired":
        return simulate_pairs(index, 2048, seed=4)
    codes, lens, _ = simulate_read_batch(index, 2048, 150, 0.01, seed=3)
    if entry != "extend":
        return codes, lens
    rng = np.random.default_rng(1)
    start = rng.integers(0, len(index.text) - 1024, size=2048)
    return (index.text[start[:, None] + np.arange(512)].astype(np.int8),
            np.full(2048, 512, np.int64),
            start - 8 + rng.integers(-3, 4, size=2048),
            (rng.random(2048) < 0.5).astype(np.int8))


def _mesh_query(al, entry: str, args):
    if entry == "single":
        return al.query_packed(*al.upload(*args))
    if entry == "paired":
        return al.query_paired_packed(*al.upload(*args[:2]),
                                      *al.upload(*args[2:]))
    return al.extend_packed(*args)


@pytest.mark.parametrize("entry", ["single", "paired", "extend"])
def test_query_rows_on_card_mesh_equal_no_mesh(cuda, tmp_path, entry):
    """The aligner on make_mesh([cuda:0, cuda:0]): each dispatch's two row
    blocks launch K1 (K2 for extend_packed) once each, and the rows equal
    those of the aligner without a mesh."""
    from pantax_tpu_torch.parallel import make_mesh

    index = _host.build_align_index(tiny_db(tmp_path / "tiny"))
    args = _mesh_query_case(index, entry)
    rows = []
    for mesh in (None, make_mesh([cuda, cuda])):
        al = aligner_from_reference(index, _host.AlignConfig(), cuda,
                                    mesh=mesh)
        extend.reset_launch_counts()
        rows.append(_mesh_query(al, entry, args).cpu())
    key = "banded_extend_windows" if entry == "extend" else "banded_extend"
    assert extend.LAUNCHES[key] == 2
    assert extend.LAUNCHES[key + "_plain"] == 0
    assert torch.equal(rows[0], rows[1])


@pytest.mark.parametrize("entry", ["single", "paired", "extend"])
def test_query_rows_on_card_and_cpu_mesh_equal_no_mesh(cuda, tmp_path,
                                                       entry):
    """The aligner on make_mesh([cuda:0, cpu]), a mesh of two distinct
    devices: it holds a copy of the index tables on the CPU, moves the
    second row block there and its rows back to the card.  The card's
    block launches K1 (K2 for extend_packed), the CPU's block the plain
    DP, once each; the rows on the card equal those without a mesh."""
    from pantax_tpu_torch.parallel import make_mesh

    index = _host.build_align_index(tiny_db(tmp_path / "tiny"))
    args = _mesh_query_case(index, entry)
    cpu = torch.device("cpu")
    want = _mesh_query(aligner_from_reference(index, _host.AlignConfig(),
                                              cuda), entry, args)
    al = aligner_from_reference(index, _host.AlignConfig(), cuda,
                                mesh=make_mesh([cuda, cpu]))
    assert list(al._replicas) == [cpu]
    assert all(t.device == cpu for t in al._replicas[cpu])
    extend.reset_launch_counts()
    got = _mesh_query(al, entry, args)
    key = "banded_extend_windows" if entry == "extend" else "banded_extend"
    assert extend.LAUNCHES[key] == 1
    assert extend.LAUNCHES[key + "_plain"] == 1
    assert got.device == cuda
    assert torch.equal(got, want)


def test_node_abundances_device_on_card_mesh_equal_no_mesh(cuda):
    from pantax_tpu_torch.parallel import make_mesh

    rng = np.random.default_rng(3)
    nodes_len, paths, reads, rs0 = coverage_case(rng, 65)
    ti = _host.build_trio_index(nodes_len, paths)
    packed = pack_reads([ReadRecord(r, n, 0, a, b, "s")
                         for r, n, a, b in reads], rs0)
    one, two = (node_abundances_device(packed, nodes_len, ti, device=cuda,
                                       mesh=mesh)
                for mesh in (None, make_mesh([cuda, cuda])))
    for name, a, b in zip(("na", "ta", "bc"), one, two):
        np.testing.assert_array_equal(a, b, err_msg=name)


def test_node_abundances_device_on_card_and_cpu_mesh_equal_no_mesh(cuda):
    """make_mesh([cuda:0, cpu]): the second row block scattered on the CPU,
    its raw accumulators summed onto the card's; the coverage equals the
    card's without a mesh and the CPU's."""
    from pantax_tpu_torch.parallel import make_mesh

    rng = np.random.default_rng(3)
    nodes_len, paths, reads, rs0 = coverage_case(rng, 65)
    ti = _host.build_trio_index(nodes_len, paths)
    packed = pack_reads([ReadRecord(r, n, 0, a, b, "s")
                         for r, n, a, b in reads], rs0)
    cpu = torch.device("cpu")
    got = node_abundances_device(packed, nodes_len, ti, device=cuda,
                                 mesh=make_mesh([cuda, cpu]))
    for want in (node_abundances_device(packed, nodes_len, ti, device=cuda),
                 node_abundances_device(packed, nodes_len, ti, device=cpu)):
        for name, a, b in zip(("na", "ta", "bc"), got, want):
            np.testing.assert_array_equal(a, b, err_msg=name)


def test_cross_process_sum_one_rank_on_card(cuda):
    """A one-process gloo group: cross_process_sum returns its inputs on
    the card, and gather_read_rows the process's own columns."""
    import socket

    import torch.distributed as dist

    from pantax_tpu_torch.parallel import distributed

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dev = distributed.init_distributed(f"127.0.0.1:{port}", 1, 0,
                                       device=cuda)
    try:
        assert dev == cuda
        acc = (torch.arange(10, device=cuda),
               torch.arange(5, dtype=torch.int32, device=cuda))
        got = distributed.cross_process_sum(acc)
        for a, b in zip(acc, got):
            assert b.device == cuda and torch.equal(a, b)
        reads = {k: np.arange(4) for k in distributed.COLUMNS}
        reads["ids"] = list("abcd")
        rows = distributed.gather_read_rows(reads)
        assert rows["ids"] == reads["ids"]
        np.testing.assert_array_equal(rows["mapq"], reads["mapq"])
    finally:
        dist.destroy_process_group()


def test_tail_segment_sums_repeat_on_card(cuda):
    """The device tail's float32 segment sums give the same bits on every
    call on the card (the sorted accumulation), and agree with the CPU's
    sequential sums within float32 rounding."""
    from pantax_tpu_torch.ops.profile_tail import _seg_sum

    rng = np.random.default_rng(0)
    vals = torch.from_numpy(rng.random(1 << 20, dtype=np.float32) * 40)
    seg = torch.from_numpy(rng.integers(0, 31, size=1 << 20))  # 30: the pad
    runs = [_seg_sum(vals.to(cuda), seg.to(cuda), 30).cpu() for _ in range(5)]
    for r in runs[1:]:
        assert torch.equal(r, runs[0])
    # n u: the worst relative error of a float32 sum of n positive terms
    n = len(vals) / 30
    torch.testing.assert_close(runs[0], _seg_sum(vals, seg, 30),
                               rtol=n * 2.0**-24, atol=0)


@pytest.mark.parametrize("runner,k1", [("run_e2e_benchmark", 8),
                                       ("accuracy_benchmark", 4)])
def test_runner_cpu_equal_cuda(cuda, tmp_path, monkeypatch, runner, k1):
    """run_e2e_benchmark (an untimed and a timed pass) and
    accuracy_benchmark over tiny_db on the CPU and on the card (HiGHS):
    the four tables byte-identical, every key that is not a time equal; on
    the card K1 launched once per batch, the plain DP never."""
    from pantax_tpu_torch import benchmarks
    from pantax_tpu_torch.config import ProfilingConfig

    orig = ProfilingConfig.for_read_type.__func__
    monkeypatch.setattr(ProfilingConfig, "for_read_type", classmethod(
        lambda c, rt, **kw: orig(c, rt, **{"solver": "highs", **kw})))
    db = tiny_db(tmp_path / "tiny")
    got = []
    for dev in ("cpu", cuda):
        extend.reset_launch_counts()
        got.append(getattr(benchmarks, runner)(
            db, n_reads=4096, batch=1024, out_dir=str(tmp_path / str(dev)),
            device=dev))
    assert extend.LAUNCHES["banded_extend"] == k1
    assert extend.LAUNCHES["banded_extend_plain"] == 0
    for key in ("total_reads", "aligned_frac", "strains_detected",
                "l1_error", "detected", "total", "pred", "truth"):
        assert got[0].get(key) == got[1].get(key), key
    for name in ("species_abundance.txt", "strain_abundance.txt",
                 "ori_strain_abundance.txt", "reads_classification.tsv"):
        assert ((tmp_path / "cpu" / name).read_bytes()
                == (tmp_path / str(cuda) / name).read_bytes()), name


# ---------------------------------------------------------------------------
# K6 and K11, the classify + scatter (ops/scatter.py, csrc/classify_scatter.cu)
# ---------------------------------------------------------------------------
def test_scatter_kernels_crafted_cases_match_plain(cuda, tmp_path):
    """K6 and K11 against their plain versions on every crafted case of
    chip_smoke.scatter_cases (tiny_db and the small dup community, tables
    as built and masked; K11 at chip_smoke.K11_CRAFTED's windows: 8 on
    tiny_db, 4, 12, 16, 32 and 64 on the community, every template width):
    ridx, overflow and the accumulators bit for bit, no add into a sink."""
    assert chip_smoke.crafted_scatter(str(tmp_path), cuda, None) == 0
    assert chip_smoke.crafted_scatter(str(tmp_path), cuda,
                                      chip_smoke.K11_CRAFTED) == 0


@pytest.mark.parametrize("which", ["tiny", "scale", "dup"])
def test_scatter_kernels_match_plain_on_a_batch(cuda, tmp_path, which):
    """One query batch of each DB through K6 and K11 (at the automatic node
    window, and at 3 segments) against the plain versions."""
    from pantax_tpu_torch.benchmarks import scale_db
    from pantax_tpu_torch.ops.fused import auto_node_window

    make = {"tiny": lambda p: tiny_db(p),
            "scale": lambda p: scale_db(p, n_species=2, genome_len=50_000),
            "dup": lambda p: dup_db(p, n_species=2, strains=2,
                                    n_blocks=400)}[which]
    index, tables, tstart, tnode = chip_smoke.crafted_setup(
        str(tmp_path / which), cuda, make)
    al = aligner_from_reference(index, _host.AlignConfig(), cuda)
    codes, lens, _ = simulate_read_batch(index, 4099, 150, 0.01, seed=3,
                                         indel_rate=0.01)
    cols = chip_smoke.query_cols(al, codes, lens)
    assert chip_smoke.hold_scatter(cols, tables, tstart, tnode, which) == 0
    for L_cap in (auto_node_window(index, 160), 3):
        assert chip_smoke.hold_scatter(cols, tables, tstart, tnode, which,
                                       L_cap) == 0


def test_scatter_wrappers_launch_kernels_on_cuda(cuda, tmp_path):
    """On CUDA tensors each dispatcher launches its kernel and counts it
    (an empty batch launches nothing and counts nothing)."""
    index, tables, tstart, tnode = chip_smoke.crafted_setup(
        str(tmp_path / "tiny"), cuda, tiny_db)
    cols = [torch.from_numpy(a).to(cuda)
            for a in chip_smoke.scatter_cases(index, 8)["span_3_up"]]
    from pantax_tpu_torch.ops import scatter

    extend.reset_launch_counts()
    acc = chip_smoke.zero_accs(tables, tstart.shape[0], cuda)
    scatter.classify_scatter_ranges(*cols, tables, tstart, tnode, acc)
    scatter.classify_scatter(*cols, tables, tstart, tnode, acc, 8)
    empty = [c[:0] for c in cols]
    ridx, ov = scatter.classify_scatter(*empty, tables, tstart, tnode, acc, 8)
    torch.cuda.synchronize()
    assert ridx.shape == ov.shape == (0,)
    assert extend.LAUNCHES == dict(NO_SCATTER, **{
        "banded_extend": 0, "banded_extend_plain": 0,
        "banded_extend_windows": 0, "banded_extend_windows_plain": 0,
        "seed_stage": 0, "seed_stage_plain": 0,
        "classify_scatter_ranges": 1, "classify_scatter": 1})


def test_scatter_kernels_reject_bad_inputs(cuda, tmp_path):
    from pantax_tpu_torch.ops import scatter

    index, tables, tstart, tnode = chip_smoke.crafted_setup(
        str(tmp_path / "tiny"), cuda, tiny_db)
    ts, te, al = [torch.from_numpy(a).to(cuda)
                  for a in chip_smoke.scatter_cases(index, 8)["span_2"]]
    acc = chip_smoke.zero_accs(tables, tstart.shape[0], cuda)
    with pytest.raises(ValueError):  # int64 positions
        scatter.classify_scatter_ranges(ts.long(), te, al, tables, tstart,
                                        tnode, acc)
    with pytest.raises(ValueError):  # a strided view
        scatter.classify_scatter(ts[::2], te[::2], al[::2], tables, tstart,
                                 tnode, acc, 8)
    with pytest.raises(ValueError):  # a node window past 64
        scatter.classify_scatter(ts, te, al, tables, tstart, tnode, acc, 65)
    with pytest.raises(ValueError):  # the accumulators on the CPU
        scatter.classify_scatter_ranges(ts, te, al, tables, tstart, tnode,
                                        tuple(a.cpu() for a in acc))
    with pytest.raises(ValueError):  # a diff array without its sentinel
        scatter.classify_scatter(ts, te, al, tables, tstart, tnode,
                                 (acc[0], acc[1][:-1], acc[2]), 8)


@pytest.mark.parametrize("variant", ["", ", masked", ", shifted", ", coarse"],
                         ids=["built", "masked", "shifted", "coarse"])
def test_k6_table_variants_match_plain_on_a_batch(cuda, tmp_path, variant):
    """K6 on one query batch of a small scale_db (4099 reads, B odd) and on
    reads in its fullest buckets, with each of chip_smoke.table_variants'
    tables (haplotype offsets cut into segments: the haplotype search;
    buckets 32x wider: the scan and the bisection), against its plain
    version."""
    from pantax_tpu_torch.benchmarks import scale_db

    index, tables, tstart, tnode = chip_smoke.crafted_setup(
        str(tmp_path / "scale"), cuda,
        lambda p: scale_db(p, n_species=2, genome_len=50_000))
    t = chip_smoke.table_variants(tables, tstart, index.text_len)[variant]
    al = aligner_from_reference(index, _host.AlignConfig(), cuda)
    codes, lens, _ = simulate_read_batch(index, 4099, 150, 0.01, seed=5)
    cols = chip_smoke.query_cols(al, codes, lens)
    assert chip_smoke.hold_scatter(cols, t, tstart, tnode, variant) == 0
    full = [torch.from_numpy(a).to(cuda)
            for a in chip_smoke.scatter_cases(index, 32)["full_bucket"]]
    assert chip_smoke.hold_scatter(full, t, tstart, tnode, variant) == 0


def test_k6_refuses_tables_without_its_records(cuda, tmp_path):
    """K6's wrapper raises before launching on tables whose records are
    missing, on the CPU, or of another shape; nothing is counted."""
    from types import SimpleNamespace
    from pantax_tpu_torch.ops import scatter

    index, tables, tstart, tnode = chip_smoke.crafted_setup(
        str(tmp_path / "tiny"), cuda, tiny_db)
    cols = [torch.from_numpy(a).to(cuda)
            for a in chip_smoke.scatter_cases(index, 8)["span_3_up"]]
    acc = chip_smoke.zero_accs(tables, tstart.shape[0], cuda)
    extend.reset_launch_counts()
    for rec in (None, tables.seg_rec.cpu(), tables.seg_rec[:-1],
                tables.seg_rec.long(), tables.seg_rec[:, :4].contiguous()):
        t = SimpleNamespace(**{k: getattr(tables, k)
                               for k in chip_smoke.SCATTER_FIELDS})
        t.seg_rec = rec
        with pytest.raises(ValueError):
            scatter.classify_scatter_ranges(*cols, t, tstart, tnode, acc)
    assert extend.LAUNCHES["classify_scatter_ranges"] == 0


# ---------------------------------------------------------------------------
# K8, the strain solve's batched ADMM chunk
# the float plan (binary not given: a non-0/1 A takes it)
# (S, n_pad, p_pad): the smoke's buckets, the smallest, more instances
# than clusters fit at once, wide rows (p_pad 36 on chip; 132 and 260
# streamed, with L in global memory) and a streamed bucket
K8_SHAPES = [(10, 65536, 4), (1, 4096, 4), (34, 65536, 4), (3, 8192, 36),
             (2, 4096, 132), (1, 4096, 260), (1, 1048576, 4)]


@pytest.mark.parametrize("seeded", [False, True], ids=["zero", "seeded"])
@pytest.mark.parametrize("shape", K8_SHAPES,
                         ids=[f"{s}x{n}x{p}" for s, n, p in K8_SHAPES])
def test_k8_matches_plain_after_one_step(cuda, shape, seeded):
    """K8 against the plain chunk after one step (chip_smoke.hold_k8:
    every state vector and res within K8_STEP_BAR, the inputs untouched),
    a path of each instance pinned, from the callers' aliased zero state
    and from a random one; L as the card's cholesky lays it out."""
    S, n, p = shape
    case = chip_smoke.admm_case(S + n + p, S, n, p, seeded)
    args = chip_smoke.admm_args(case, cuda)
    assert chip_smoke.hold_k8(args, f"at {shape}") <= chip_smoke.K8_STEP_BAR


@pytest.mark.parametrize("seeded", [False, True], ids=["zero", "seeded"])
@pytest.mark.parametrize("shape", K8_SHAPES,
                         ids=[f"{s}x{n}x{p}" for s, n, p in K8_SHAPES])
def test_k8_matches_plain_after_25_steps(cuda, shape, seeded):
    """K8 against the plain chunk after 25 steps (chip_smoke.hold_k8,
    K8_BARS[25]): what one step does not reach, the CTA sums' buffer
    parity, w and uw carried between steps, the over-relaxation of a
    non-zero w, on chip and streamed."""
    S, n, p = shape
    case = chip_smoke.admm_case(S + n + p, S, n, p, seeded)
    args = chip_smoke.admm_args(case, cuda)
    assert chip_smoke.hold_k8(args, f"at {shape}", 25) <= \
        chip_smoke.K8_BARS[25]


@pytest.mark.parametrize("steps", [1, 25])
@pytest.mark.parametrize("seeded", [False, True], ids=["zero", "seeded"])
def test_k8_at_p_pad_2048_matches_the_exact_steps(cuda, steps, seeded):
    """p_pad 2048 at 8192 rows, past what the CTA's shared memory took
    while it held the warps' sums of every column: streamed, L from global
    memory.  K8 within K8_BARS[steps] of the plain chunk run in float64 on
    the same inputs (chip_smoke.hold_k8, exact): the float32 plain chunk
    is itself 6.0e-5 off that after one step (NVIDIA H100), so it cannot
    referee at this width."""
    case = chip_smoke.admm_case(1 + 8192 + 2048, 1, 8192, 2048, seeded)
    args = chip_smoke.admm_args(case, cuda)
    assert chip_smoke.hold_k8(args, "at p_pad 2048", steps, exact=True) \
        <= chip_smoke.K8_BARS[steps]


@pytest.mark.parametrize("shape,iters", [((10, 65536, 4), 250),
                                         ((1, 4096, 260), 25),
                                         ((1, 1048576, 4), 25),
                                         ((1, 8192, 2048), 2)])
def test_k8_two_launches_are_identical(cuda, shape, iters):
    args = chip_smoke.admm_args(chip_smoke.admm_case(1, *shape, False), cuda)
    chip_smoke.k8_repeats(args, iters, f"at {shape}")


def _pao_instances(seed):
    """The CPU test's instances (tests/test_torch_fused.py, one pinned
    path) and larger ones: buckets (5, 4096, 4), (2, 8192, 4) and the
    singletons (4096, 8), (4096, 12), (4096, 32)."""
    rng = np.random.default_rng(seed)
    out = []
    for n, p in ((300, 2), (300, 3), (300, 5), (2000, 3), (3000, 4),
                 (6000, 3), (5000, 4), (1500, 9), (1200, 30)):
        A = (rng.random((n, p)) < 0.7).astype(np.float64)
        b = np.maximum(A @ rng.uniform(1, 8, size=p)
                       + rng.normal(0, 0.5, size=n), 0)
        out.append((A, b, 1.05 * b.max(), None))
    out.append((out[0][0], out[0][1], out[0][2], np.array([False, True])))
    return out


def test_k8_full_solves_match_highs_and_the_plain_run(cuda):
    """solve_pao_batch on the card (every chunk one K8 launch) reaches
    HiGHS's objective and the CPU run's (the plain chunk) within 1e-4
    relative, the pinned path at 0."""
    from pantax_tpu_torch.profile.pao import solve_pao_batch

    inst = _pao_instances(7)
    extend.reset_launch_counts()
    card = solve_pao_batch(inst, "admm", device=cuda)
    launches = dict(extend.LAUNCHES)
    assert launches["admm_chunk"] == launches["admm_chunk_dispatch"] > 0
    assert launches["admm_chunk_plain"] == 0
    plain = solve_pao_batch(inst, "admm", device="cpu")
    exact = solve_pao_batch(inst, "highs", device="cpu")
    for k, p, e in zip(card, plain, exact):
        assert k.objective <= e.objective * (1 + 1e-4) + 1e-6
        assert k.objective <= p.objective * (1 + 1e-4) + 1e-6
        assert p.objective <= k.objective * (1 + 1e-4) + 1e-6
    assert card[-1].x[1] == 0.0


# the bits plan (0/1 A): every bucket (clusters of 4 and 8 CTAs at p_pad
# 4; of 1, 2, 4 and 8 past it) at every width (p_pad 4 and 8; 12, 32 and
# 36 pad to 16, 32 and 64)
K8_BITS_SHAPES = [(2, n, p) for n in (4096, 8192, 16384, 32768, 65536)
                  for p in (4, 8, 12, 32, 36)]


@pytest.mark.parametrize("steps", [1, 25])
@pytest.mark.parametrize("seeded", [False, True], ids=["zero", "seeded"])
@pytest.mark.parametrize("shape", K8_BITS_SHAPES,
                         ids=[f"{s}x{n}x{p}" for s, n, p in K8_BITS_SHAPES])
def test_k8_bits_plan_matches_plain(cuda, shape, seeded, steps):
    """The bits plan against the plain chunk after 1 and 25 steps (every
    state vector and res within K8_BARS, the inputs untouched), from the
    callers' aliased zero state and a random one."""
    from pantax_tpu_torch.ops import admm

    S, n, p = shape
    assert admm.launch_plan(S, n, p, binary=True).bits
    args = chip_smoke.admm_args(chip_smoke.admm_case(S + n + p, S, n, p,
                                                     seeded), cuda)
    assert chip_smoke.hold_k8(args, f"at {shape}", steps, binary=True) <= \
        chip_smoke.K8_BARS[steps]


@pytest.mark.parametrize("steps", [1, 25])
@pytest.mark.parametrize("seeded", [False, True], ids=["zero", "seeded"])
def test_k8_bits_at_p_pad_64_matches_the_exact_steps(cuda, steps, seeded):
    """The bits plan's widest instantiation (64 paths at 65536 rows, 8
    CTAs) within K8_BARS[steps] of the plain chunk in float64."""
    args = chip_smoke.admm_args(chip_smoke.admm_case(
        1 + 65536 + 64, 1, 65536, 64, seeded), cuda)
    assert chip_smoke.hold_k8(args, "at p_pad 64", steps, exact=True,
                              binary=True) <= chip_smoke.K8_BARS[steps]


@pytest.mark.parametrize("shape", [(10, 65536, 4), (3, 4096, 4),
                                   (2, 16384, 12), (2, 32768, 32),
                                   (1, 65536, 64)])
def test_k8_bits_two_launches_are_identical(cuda, shape):
    args = chip_smoke.admm_args(chip_smoke.admm_case(1, *shape, False), cuda)
    chip_smoke.k8_repeats(args, 250, f"at {shape}", binary=True)


@pytest.mark.parametrize("steps", [1, 25])
@pytest.mark.parametrize("shape", [(2, 65536, 4), (2, 8192, 36)])
def test_k8_non_zero_one_a_takes_the_float_plan(cuda, shape, steps):
    """A with entries of 2.0 (a path that revisits a node) is not 0/1 as
    _admm_solve_stack tests it, so it takes the float plan, within
    K8_BARS of the plain chunk."""
    from pantax_tpu_torch.ops import admm
    from pantax_tpu_torch.profile import pao

    S, n, p = shape
    A, b, ub, state, _L = chip_smoke.admm_case(S + n, S, n, p, True)
    rows = np.random.default_rng(3).integers(0, n // 2, size=64)
    A[:, rows, 1] *= 2.0
    L = pao._admm_factor(torch.from_numpy(A)).contiguous().numpy()
    binary = pao._zero_one(A)
    assert not binary and not admm.launch_plan(S, n, p, binary).bits
    args = chip_smoke.admm_args((A, b, ub, state, L), cuda)
    assert chip_smoke.hold_k8(args, f"at {shape} with 2.0s", steps,
                              binary=binary) <= chip_smoke.K8_BARS[steps]


def test_k8_bits_plan_solves_match_highs(cuda):
    """solve_pao_batch on the card with the bits plan at every width
    (0/1 instances of 6-40 paths over 2,000-9,000 rows: widths 8, 16, 32
    and 64, buckets of one and two CTAs) reaches HiGHS's objective and
    the CPU run's within 1e-4 relative, as
    test_k8_full_solves_match_highs_and_the_plain_run holds the smoke's
    widths."""
    from pantax_tpu_torch.profile.pao import solve_pao_batch

    rng = np.random.default_rng(11)
    inst = []
    for n, p in ((2000, 6), (3000, 7), (9000, 12), (3000, 30), (4000, 40)):
        A = (rng.random((n, p)) < 0.6).astype(np.float64)
        b = np.maximum(A @ rng.uniform(1, 8, size=p)
                       + rng.normal(0, 0.5, size=n), 0)
        inst.append((A, b, 1.05 * b.max(), None))
    extend.reset_launch_counts()
    card = solve_pao_batch(inst, "admm", device=cuda)
    launches = dict(extend.LAUNCHES)
    assert launches["admm_chunk"] == launches["admm_chunk_dispatch"] > 0
    assert launches["admm_chunk_plain"] == 0
    plain = solve_pao_batch(inst, "admm", device="cpu")
    exact = solve_pao_batch(inst, "highs", device="cpu")
    for k, p, e in zip(card, plain, exact):
        assert k.objective <= e.objective * (1 + 1e-4) + 1e-6
        assert k.objective <= p.objective * (1 + 1e-4) + 1e-6
        assert p.objective <= k.objective * (1 + 1e-4) + 1e-6


def test_k8_rejects_bad_inputs(cuda):
    from pantax_tpu_torch.profile import pao

    A, b, ub, rho, state, L = chip_smoke.admm_args(
        chip_smoke.admm_case(2, 2, 4096, 4, False), cuda)
    bad = [
        (A, b.cpu(), ub, rho, state, L, 1),                  # CPU and CUDA
        (A.double(), b, ub, rho, state, L, 1),               # float64
        (A, b, ub, rho, (state[0], state[1].double(), *state[2:]), L, 1),
        (A.mT.contiguous().mT, b, ub, rho, state, L, 1),     # not contiguous
        (A, b[:, :2048].contiguous(), ub, rho, state, L, 1),  # shapes
        (A, b, ub[:1], rho, state, L, 1),
        (A, b, ub, rho, state, L[:, :2], 1),
        (A, b, ub, rho, state, L, 0),                        # no step
    ]
    for args in bad:
        with pytest.raises(ValueError):
            pao._admm_chunk_batch(*args)
    # a bucket no plan fits: 3 x 4096 rows
    A3, b3, ub3, _, st3, L3 = chip_smoke.admm_args(
        chip_smoke.admm_case(3, 1, 12288, 4, False), cuda)
    with pytest.raises(ValueError):
        pao._admm_chunk_batch(A3, b3, ub3, 1.0, st3, L3, 1)


# ---------------------------------------------------------------------------
# K9 and K10b, the device tail's strain stats and coordinate-median polish
# (S, n_pad, p_pad): the smoke's bucket, the smallest, p_pad 8 and 32, a
# 16-CTA-row bucket and one whose residuals sit in global memory (rows in
# registers up to here); rows in shared memory in one CTA and in a
# cluster, p_pad past 32, and the live bits in global memory too
K10B_SHAPES = [(10, 65536, 4), (1, 4096, 4), (3, 8192, 8), (2, 16384, 32),
               (4, 32768, 8), (1, 524288, 4), (1, 12288, 4), (2, 24576, 4),
               (1, 65536, 36), (1, 524288, 32)]
# the crafted edges of chip_smoke.polish_case, one instance each (edge 5
# overfills K10b's candidate buffer from 65536 rows)
K10B_CRAFTED = [(6, 4096, 4), (6, 8192, 8), (6, 65536, 4), (6, 4096, 32)]


def _polish_args(cuda, shape, crafted=False):
    return [torch.from_numpy(a).to(cuda)
            for a in chip_smoke.polish_case(sum(shape), *shape, crafted)]


@pytest.mark.parametrize("shape", K10B_SHAPES,
                         ids=[f"{s}x{n}x{p}" for s, n, p in K10B_SHAPES])
def test_k10b_matches_plain_bit_for_bit(cuda, shape):
    """K10b's x equals the plain polish's bit for bit (the sign of a zero
    aside), the inputs untouched (chip_smoke.hold_k10b)."""
    chip_smoke.hold_k10b(_polish_args(cuda, shape), f"at {shape}")


@pytest.mark.parametrize("shape", K10B_CRAFTED,
                         ids=[f"{s}x{n}x{p}" for s, n, p in K10B_CRAFTED])
def test_k10b_crafted_edges_match_plain(cuda, shape):
    """Ties at every median, zeros of both signs, a column with no live
    row, t* past both clips, a dead instance and a first digit's bin
    holding every live row, bit for bit."""
    chip_smoke.hold_k10b(_polish_args(cuda, shape, True),
                         f"on the crafted edges at {shape}")


@pytest.mark.parametrize("sweeps", [0, 1, 3, 8, 20])
def test_k10b_other_sweep_counts_match_plain(cuda, sweeps):
    chip_smoke.hold_k10b(_polish_args(cuda, (3, 8192, 4)), f"at {sweeps} "
                         f"sweeps", sweeps)


@pytest.mark.parametrize("sweeps", [0, 1, 3, 8, 20])
@pytest.mark.parametrize("shape", [(6, 4096, 4), (6, 65536, 4)])
def test_k10b_crafted_edges_at_each_sweep_count(cuda, shape, sweeps):
    """The crafted edges, the early stop among them, at 0-20 sweeps."""
    chip_smoke.hold_k10b(_polish_args(cuda, shape, True),
                         f"on the crafted edges at {shape}, {sweeps} sweeps",
                         sweeps)


def test_k10b_marks_an_a_other_than_zero_one(cuda):
    """An instance whose A holds a value other than 0 and 1 gets NaN x;
    the bucket's other instances are polished."""
    from pantax_tpu_torch.ops import profile_tail, tail_kernels

    A, b, x, ub = _polish_args(cuda, (3, 16384, 4))
    A[1, 100, 2] = 0.5
    got = tail_kernels.launch_k10b(A, b, x, ub)
    want = profile_tail.polish_batch_plain(A, b, x, ub)
    assert torch.isnan(got[1]).all()
    keep = [0, 2]
    assert torch.equal(got[keep] + 0.0, want[keep] + 0.0)


@pytest.mark.parametrize("shape", [(10, 65536, 4), (1, 524288, 4)])
def test_k10b_two_launches_are_identical(cuda, shape):
    from pantax_tpu_torch.ops import tail_kernels

    args = _polish_args(cuda, shape)
    chip_smoke.repeats_identical(lambda: tail_kernels.launch_k10b(*args),
                                 f"K10b at {shape}")


def test_k10b_rejects_bad_inputs(cuda):
    from pantax_tpu_torch.ops import profile_tail

    A, b, x, ub = _polish_args(cuda, (2, 4096, 4))
    bad = [
        (A, b.cpu(), x, ub),                      # CPU and CUDA
        (A.double(), b, x, ub),                   # float64
        (A, b, x.double(), ub),
        (A.mT.contiguous().mT, b, x, ub),         # not contiguous
        (A, b[:, :2048].contiguous(), x, ub),     # shapes
        (A, b, x[:1], ub),
        (A, b, x, ub[:, :2]),
        (A[:, :1000].contiguous(), b[:, :1000].contiguous(), x, ub),  # n_pad
    ]
    extend.reset_launch_counts()
    for args in bad:
        with pytest.raises(ValueError):
            profile_tail.polish_batch(*args)
    with pytest.raises(ValueError):
        profile_tail.polish_batch(A, b, x, ub, -1)
    assert extend.LAUNCHES["polish"] == extend.LAUNCHES["polish_plain"] == 0


def _stats_case(cuda, tmp_path):
    """tail_stats' arguments on a scale_db slice's paired coverage, fed
    on the card, as dispatch_tail_stats passes them."""
    from pantax_tpu_torch.benchmarks import scale_db
    from pantax_tpu_torch.ops.fused import _ensure_tail_tables

    db = scale_db(tmp_path / "scale", n_species=3, genome_len=50_000)
    index = _host.build_align_index(db)
    al = aligner_from_reference(index, _host.AlignConfig(), cuda)
    pipe = FusedPipeline(al, build_fused_tables(db, index, cuda), 2048)
    pipe.feed_paired(*simulate_pairs(index, 6000, seed=11))
    r = pipe.finish()
    return chip_smoke.k9_args(_ensure_tail_tables(pipe.tables), r.na_d,
                              r.ta_d, r.bc_d, 0.0)


def test_k9_matches_plain_on_fed_coverage(cuda, tmp_path):
    """K9 against the plain stats on paired coverage of a scale_db slice:
    counts, path_cov, sp_max and sp_valid exact, the float sums within
    K9_RTOL; two launches bit-identical (chip_smoke.hold_k9)."""
    args, kw = _stats_case(cuda, tmp_path)
    chip_smoke.hold_k9(args, kw, "on a scale_db slice's coverage")
    chip_smoke.hold_k9((*args[:7], 2.5), kw, "at min_depth 2.5")


@pytest.mark.parametrize("seed", [9, 10, 11])
def test_k9_matches_plain_on_crafted_tables(cuda, seed):
    """Trio owners interleaved within each species (pads among them), a
    hap without trios, one of zero trios, one of a single nonzero trio, a
    species without nodes (chip_smoke.k9_case)."""
    chip_smoke.hold_k9(*chip_smoke.k9_case(seed, cuda), f"crafted {seed}")


@pytest.mark.parametrize("edge", chip_smoke.K9_EDGES,
                         ids=[e[0] for e in chip_smoke.K9_EDGES])
def test_k9_matches_plain_on_its_edges(cuda, edge):
    """chip_smoke.K9_EDGES: a hap of more trios than its plan's registers
    hold (the rest gathered from L2 in each pass) beside a species of
    600,000 nodes, clusters of 2, G + S past the 132 SMs (a CTA an item),
    against the plain stats in float64 (chip_smoke.k9_want: the float32
    plain sums over 600,000 nodes are themselves 2e-5 off)."""
    what, *shape = edge
    chip_smoke.hold_k9(*chip_smoke.k9_case(21, cuda, *shape), what,
                       exact=True)


def _k9_unaligned(args, off: int, dev):
    """args with na moved ``off`` floats past a 16-byte boundary."""
    na = args[0]
    buf = torch.zeros(na.numel() + off, dtype=na.dtype, device=dev)
    buf[off:] = na
    return (buf[off:], *args[1:])


@pytest.mark.parametrize("off", [1, 2, 3])
def test_k9_matches_plain_on_an_unaligned_na(cuda, off):
    """na off a 16-byte boundary: each species' head and tail (1-3 nodes)
    read apart from its float4s."""
    args, kw = chip_smoke.k9_case(9, cuda)
    chip_smoke.hold_k9(_k9_unaligned(args, off, cuda), kw,
                       f"na {off} floats past 16 bytes")


def test_k9_gives_the_models_bits(cuda):
    """K9's seven outputs equal, bit for bit, the numpy model of its sums
    at the plan's cluster (tests/test_torch_tail_kernels.py's
    model_tail_stats): on k9_case's tables, on K9_EDGES and with na off a
    16-byte boundary."""
    from pantax_tpu_torch.ops import tail_kernels
    from test_torch_tail_kernels import model_tail_stats

    cases = [((), 0), ((), 1), ((), 3)] + [
        (tuple(e[1:]), 0) for e in chip_smoke.K9_EDGES]
    for shape, off in cases:
        args, kw = chip_smoke.k9_case(9, cuda, *shape)
        if off:
            args = _k9_unaligned(args, off, cuda)
        na, ta, bc, _trio_hap, path_node = args[:5]
        G, S, order = kw["G"], kw["S"], kw["order"]
        got = tail_kernels.launch_k9(na, ta, bc, path_node, order, args[7],
                                     G=G, S=S)
        C = tail_kernels.stats_plan(G, S, order[0].numel()).cluster
        want = model_tail_stats(
            na.cpu().numpy(), ta.cpu().numpy(), bc.cpu().numpy(),
            path_node.cpu().numpy(), [t.cpu().numpy() for t in order],
            args[7], G, S, C, na_offset=na.data_ptr() // 4 % 4)
        for name, g, w in zip(chip_smoke.K9_OUTPUTS, got, want):
            assert np.array_equal(g.cpu().numpy(), w), (shape, off, name)


def test_capped_device_tail_matches_host_tail(cuda, tmp_path, monkeypatch):
    """The sampling cap on the card (the CPU test
    test_device_tail_matches_host_tail[capped]): cfg.sample_nodes between
    two species' sp_valid from K9 sends the species over it to the device
    tail's host solve and the others to the device solve; the
    classification byte-identical to the host tail's, abundances within
    2e-4."""
    import filecmp

    from pantax_tpu_torch.benchmarks import scale_db
    from pantax_tpu_torch.ops.fused import _ensure_tail_tables
    from pantax_tpu_torch.ops.profile_tail import compute_tail_stats
    from pantax_tpu_torch.profile import engine

    db = scale_db(tmp_path / "scale", n_species=3, genome_len=50_000)
    index = _host.build_align_index(db)
    al = aligner_from_reference(index, _host.AlignConfig(), cuda)
    tables = build_fused_tables(db, index, cuda)
    pipe = FusedPipeline(al, tables, 2048)
    weights = np.tile([6.0, 2.0, 1.0], 3) * np.repeat([1.0, 1.5, 0.7], 3)
    pipe.feed_paired(*simulate_pairs(index, 6000, seed=11,
                                     hap_weights=weights))
    r = pipe.finish()
    extend.reset_launch_counts()
    valid = compute_tail_stats(_ensure_tail_tables(tables), r.na_d, r.ta_d,
                               r.bc_d, 0.0).sp_valid
    assert extend.LAUNCHES["tail_stats"] == 1
    cap = int(np.sort(valid)[1])
    assert (valid > cap).any() and (valid <= cap).any()
    prepare, host_solves = engine.prepare_two_stage, []

    def counted(*args, **kw):
        host_solves.append(args[1])  # the species' nodes
        return prepare(*args, **kw)

    outs = {}
    for tail in ("host", "device"):
        cfg = _host.ProfilingConfig.for_read_type("short")
        cfg.tail, cfg.sample_nodes = tail, cap
        extend.reset_launch_counts()
        outs[tail] = tmp_path / tail
        if tail == "device":
            monkeypatch.setattr(engine, "prepare_two_stage", counted)
        assert profile_from_fused_result(r, tables, index, db, cfg,
                                         outs[tail])
        la = extend.LAUNCHES
        if tail == "device":
            assert la["tail_stats"] == la["tail_stats_dispatch"] == 1
            assert la["polish"] == la["polish_dispatch"] > 0
            assert la["tail_stats_plain"] == la["polish_plain"] == 0
            assert host_solves and all(n > cap for n in host_solves)
    assert filecmp.cmp(outs["host"] / "reads_classification.tsv",
                       outs["device"] / "reads_classification.tsv",
                       shallow=False)
    assert_tables_agree(outs["host"], outs["device"], abundance_tol=2e-4)


def test_k9_rejects_bad_inputs(cuda):
    from pantax_tpu_torch.ops import tail_kernels

    args, kw = chip_smoke.k9_case(9, cuda)
    na, ta, bc, path_node = args[0], args[1], args[2], args[4]
    G, S, order = kw["G"], kw["S"], kw["order"]
    extend.reset_launch_counts()
    bad = [((na, ta.cpu(), bc, path_node), order),
           ((na.double(), ta, bc, path_node), order),
           ((na, ta, bc.long(), path_node), order),
           ((na, ta, bc[:-1], path_node), order),
           ((na, ta, bc, path_node), (order[0], order[1][:-1], *order[2:])),
           ((na, ta, bc, path_node), (order[0].long(), *order[1:])),
           ((na, ta, bc, path_node), (*order[:3], order[3][:-1]))]
    for a, o in bad:
        with pytest.raises(ValueError):
            tail_kernels.tail_stats_cuda(*a, o, args[7], G=G, S=S)
    assert extend.LAUNCHES["tail_stats"] == 0


def test_device_tail_launches_k9_and_k10b_once_per_dispatch(cuda, tmp_path):
    """The device tail on the card: dispatch_tail_stats launches K9 once,
    every polish launches K10b, the plain versions never; two calls write
    byte-identical tables."""
    db = tiny_db(tmp_path / "tiny")
    index = _host.build_align_index(db)
    cfg = _host.ProfilingConfig.for_read_type("short")
    cfg.tail = "device"
    al = aligner_from_reference(index, _host.AlignConfig(), cuda)
    pipe = FusedPipeline(al, build_fused_tables(db, index, cuda), 1024)
    pipe.feed_paired(*simulate_pairs(index, 4096, seed=4))
    result = pipe.finish()
    outs = []
    for rep in range(2):
        extend.reset_launch_counts()
        out = tmp_path / f"out{rep}"
        assert profile_from_fused_result(result, pipe.tables, index, db, cfg,
                                         out)
        la = extend.LAUNCHES
        assert la["tail_stats"] == la["tail_stats_dispatch"] == 1
        assert la["polish"] == la["polish_dispatch"] > 0
        assert la["tail_stats_plain"] == la["polish_plain"] == 0
        outs.append(out)
    for name in ("strain_abundance.txt", "ori_strain_abundance.txt"):
        assert ((outs[0] / name).read_bytes() == (outs[1] / name).read_bytes())


# ---------------------------------------------------------------------------
# K4 and K5 (csrc/query_io.cu): the query's prologue and epilogue
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def query_lib():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return query.build_query_kernels()


@pytest.mark.parametrize("width", [150, 151, 160])
def test_query_kernels_match_plain_on_a_batch(cuda, query_lib, tiny_index,
                                              width):
    """K4a, K4b and K5 on one query dispatch's own chain (K4a's rows feed
    K3, K4b's rows K1, K1's outputs K5) and K5p on a paired one, each
    bit for bit against its plain version, at code widths 150, 151 and
    160 (mate 2 cut to 150 columns in the pairs)."""
    al = aligner_from_reference(tiny_index, _host.AlignConfig(), cuda)
    codes, lens, _ = simulate_read_batch(tiny_index, 4099, 150, 0.01, seed=3)
    cw = np.full((4099, width), 4, np.int8)
    cw[:, :150] = codes[:, :150]
    lens[:3] = (0, 1, 149)
    errs = {k: [] for k in chip_smoke.QUERY_KERNELS}
    chip_smoke._query_case(query_lib, al, *al.upload(cw, lens),
                           f"width {width}", errs)
    c1, l1, c2, l2 = simulate_pairs(tiny_index, 2049, seed=4)
    chip_smoke._query_case(query_lib, al, *al.upload(c1, l1), "paired",
                           errs, *al.upload(np.ascontiguousarray(
                               c2[:, :150]), l2))
    assert max(max(v) for v in errs.values() if v) == 0


def test_query_extension_rows_match_plain(cuda, query_lib, tiny_index):
    """K4a and K4b as the extension takes them: 512-base chunks, K 1,
    int32 strands, window starts clipped at pad 0, against the plain
    versions."""
    al = aligner_from_reference(
        tiny_index, _host.AlignConfig.for_read_type("long"), cuda)
    codes, lens, _ = simulate_read_batch(tiny_index, 1000, 512, 0.01, seed=6)
    lens[:2] = (0, 300)
    rng = np.random.default_rng(2)
    c, n = al.upload(codes, lens)
    chip_smoke.hold_k4a(query_lib, (c, n), "chunks")
    fwd = query.launch_k4a(query_lib, c, n)[0]
    args = (fwd, n, al.put(rng.integers(0, 3, size=1000), np.int32),
            al.put(rng.integers(-100, len(tiny_index.text), size=1000),
                   np.int32), 0, len(tiny_index.text) - 2048, 512)
    chip_smoke.hold_k4b(query_lib, args, "extension rows")


@pytest.mark.parametrize("name", chip_smoke.K4B_CASES)
def test_k4b_crafted_rows_match_plain(cuda, query_lib, name):
    """K4b on k4b_cases (the CPU tests hold a model of its word-wise
    arithmetic to the plain version on the same rows): every read_len %
    16, read_len 0, the width and past it, every byte value, at code
    widths 150-512, as the query and as the extension takes them."""
    chip_smoke.hold_k4b(query_lib, chip_smoke.k4b_args(
        chip_smoke.k4b_cases()[name], cuda), name)


def test_segment_lookup_on_card_equals_cpu(cuda, tiny_index):
    """The Aligner's bucket table, built on the card, is the one built on
    the CPU: pos_lo[b] the starts at or before b << win_shift."""
    al = aligner_from_reference(tiny_index, _host.AlignConfig(), cuda)
    seg = al.segment_lookup
    cpu = query.segment_lookup(al.tstart.cpu(), tiny_index.text_len)
    assert seg.pos_lo.device.type == "cuda"
    assert (seg.win_shift, seg.steps) == (cpu.win_shift, cpu.steps)
    assert torch.equal(cpu.pos_lo, seg.pos_lo.cpu())
    bounds = np.arange(cpu.pos_lo.shape[0], dtype=np.int64) << seg.win_shift
    assert np.array_equal(seg.pos_lo.cpu().numpy(), np.searchsorted(
        tiny_index.tstart, bounds, side="right"))


@pytest.mark.parametrize("name", chip_smoke.PICK_CASES + chip_smoke.PAIR_CASES)
def test_pick_kernels_crafted_cases_match_plain(cuda, query_lib, name):
    """K5 and K5p on pick_cases (the CPU tests hold the plain versions to
    the reference on the same cases): 7 columns and packed rows."""
    case = chip_smoke.pick_cases()[name]
    assert chip_smoke.hold_k5(query_lib, chip_smoke.pick_args(case, cuda),
                              name) == 0


def test_query_entry_points_launch_kernels_on_cuda(cuda, tiny_index):
    """A single-end, a paired and an extension dispatch on the card: one
    K4a and one K4b launch each, one K5 or K5p a query, no plain run."""
    al = aligner_from_reference(tiny_index, _host.AlignConfig(), cuda)
    codes, lens, _ = simulate_read_batch(tiny_index, 256, 150, 0.01, seed=3)
    c1, l1, c2, l2 = simulate_pairs(tiny_index, 256, seed=4)
    extend.reset_launch_counts()
    al.query_packed(*al.upload(codes, lens))
    al.query(*al.upload(codes, lens))
    al.query_paired_packed(*al.upload(c1, l1), *al.upload(c2, l2))
    al.extend_packed(codes, lens, np.zeros(256, np.int64),
                     np.zeros(256, np.int8))
    torch.cuda.synchronize()
    got = {k: extend.LAUNCHES[k] for k in NO_SCATTER
           if k.startswith("query_")}
    assert got == {"query_prologue": 4, "query_prologue_plain": 0,
                   "query_rows": 4, "query_rows_plain": 0,
                   "query_pick": 2, "query_pick_plain": 0,
                   "query_pick_paired": 1, "query_pick_paired_plain": 0}
    chip_smoke.check_k4_k5(dict(extend.LAUNCHES), "entry points")


def test_query_kernels_reject_bad_inputs(cuda, query_lib):
    """The wrappers raise ValueError on a wrong dtype, a non-contiguous
    tensor, mixed devices, K past 8, K4b's codes or rows not a multiple of
    4 wide, and a bucket table of the segments on the CPU or not 2^k + 1
    bounds long."""
    c = torch.zeros((8, 32), dtype=torch.int8, device=cuda)
    n = torch.full((8,), 32, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        query.launch_k4a(query_lib, c.to(torch.int32), n)
    with pytest.raises(ValueError):
        query.launch_k4a(query_lib, c.t(), n)
    with pytest.raises(ValueError):
        query.launch_k4a(query_lib, c, n.cpu())
    with pytest.raises(ValueError):
        query.launch_k4b(query_lib, c, n,
                         torch.zeros((8, 9), dtype=torch.int8, device=cuda),
                         torch.zeros((8, 9), dtype=torch.int32, device=cuda),
                         4, 10, 32)
    with pytest.raises(ValueError, match="multiple of 4"):
        query.launch_k4b(query_lib, c[:, :30].contiguous(), n,
                         torch.zeros((8, 2), dtype=torch.int8, device=cuda),
                         torch.zeros((8, 2), dtype=torch.int32, device=cuda),
                         4, 10, 32)
    with pytest.raises(ValueError, match="multiple of 4"):
        query.launch_k4b(query_lib, c, n,
                         torch.zeros((8, 2), dtype=torch.int8, device=cuda),
                         torch.zeros((8, 2), dtype=torch.int32, device=cuda),
                         4, 10, 34)
    args = chip_smoke.pick_args(chip_smoke.pick_cases()["ties"], cuda)
    with pytest.raises(ValueError):
        query.launch_k5(query_lib, *args[:5], args[5].to(torch.int64),
                        *args[6:])
    seg = args[9]
    for bad in (seg.to("cpu"), seg._replace(pos_lo=seg.pos_lo[:-1])):
        with pytest.raises(ValueError):
            query.launch_k5(query_lib, *args[:9], bad, *args[10:])
