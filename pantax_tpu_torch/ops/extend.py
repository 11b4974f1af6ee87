"""Banded glocal DP extension: K1 (window fetch fused in) and K2 (windows
given).

Ports of the two Pallas kernels of pantax_tpu/ops/extend_pallas.py:
``banded_extend_pallas`` (:171), which computes exactly what the JAX main
path runs with XLA as aligner._extract_windows + aligner._banded_extend,
and ``banded_extend_pallas_dponly`` (:316), which is aligner._banded_extend
over windows already extracted.  Each has two versions here:

- the CUDA kernels, ``csrc/banded_extend.cu``, built with nvcc for sm_90a
  at first use into a git-ignored build directory and bound with ctypes.
  Both run one device DP: the fast DP (vector loads, N codes remapped once
  into a byte-table match, the step loop unrolled by 16) where its 16-byte
  loads are possible, the per-byte DP elsewhere.  K1 runs it over the
  index text at w0; K2 over the windows buffer [N, W] read as one text, row
  n at n * W.  K2's per-byte path takes every row where the read rows
  cannot be loaded 16 bytes at a time (a width that is no multiple of 16,
  a view off a 16-byte boundary), a row whose bytes share a 16-byte chunk
  with bytes outside the buffer (the first or last row of a buffer that
  starts or ends off a 16-byte boundary) and rows with a negative code; it
  is exact, at the first design's speed.  At the rescue pass's shape
  (16384 x 512, pad 8) K2 is bound by integer issue with one warp a
  scheduler, whose latency stays partly exposed (PERF.md section 6);
- ``banded_extend_windows_plain``, the plain torch DP (a Python loop over
  the read columns on [Wb, N] int32 tensors), and ``banded_extend_plain``,
  which gathers the windows from the text (``extract_windows``) and calls
  it.

``banded_extend`` and ``banded_extend_windows`` take the plain version only
for CPU tensors.  On a CUDA tensor they launch the kernel or raise; nothing
falls back.

K1's entries and the plain DPs take the DP's width ``lr`` apart from the
row width (``reads.shape[1]``, the default): a caller that pads its read
rows (K1 loads them 16 bytes at a time) passes its own width, and the
packed cell layout, ``packed_layout(lr)``, is that of the unpadded rows on
both devices.  The DP stops at read_len, which must not exceed ``lr``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

NEG = -(10**6)
_SH_MATCH = 5

# Launch counts, one per function; the kernel's count grows only where the
# kernel is launched, the plain count where the plain DP runs in its place.
LAUNCHES = {"banded_extend": 0, "banded_extend_plain": 0,
            "banded_extend_windows": 0, "banded_extend_windows_plain": 0}

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "banded_extend.cu"
_NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
_libs: dict[Path, ctypes.CDLL] = {}  # by source path


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def packed_layout(Lr: int) -> tuple[int, int]:
    """(sh_score, bias) for a DP over Lr read columns (Lr <= 8192); same
    layout as pantax_tpu.align.aligner.packed_layout."""
    if Lr > 8192:
        raise ValueError(f"read length {Lr} exceeds the packed-cell DP limit")
    m_bits = int(Lr + 1).bit_length()
    sh_score = _SH_MATCH + m_bits
    bias_bits = int(2 * Lr + 64).bit_length()
    if sh_score + bias_bits + 1 > 31:
        raise ValueError(f"packed DP cell overflow for Lr={Lr}")
    return sh_score, 1 << bias_bits


def _check_band(pad: int) -> None:
    if 2 * pad >= 1 << _SH_MATCH:
        # start_off spans [0, 2*pad]; wider bands overflow the 5-bit field
        raise ValueError(
            f"extension band {pad} too wide for the packed cell layout "
            f"(needs 2*band < {1 << _SH_MATCH})"
        )


def _unpack_cell(cell, b_best, read_len, sh_score: int, bias: int):
    score = (cell >> sh_score) - bias
    matches = (cell >> _SH_MATCH) & ((1 << (sh_score - _SH_MATCH)) - 1)
    start_off = cell & ((1 << _SH_MATCH) - 1)
    end_off = (read_len - 1) + b_best.to(torch.int32) + 1
    return score, start_off, end_off, matches


def extract_windows(text, w0, W: int):
    """window[i] = text[w0[i] : w0[i] + W], int8 [N, W]: a row gather over
    the int8 text (positions clamped into it; the aligner clips w0 so that
    real windows never need it)."""
    cols = torch.arange(W, device=text.device)
    idx = (w0.to(torch.int64)[:, None] + cols).clamp_(0, text.shape[0] - 1)
    return text[idx]


def _dp_width(reads, lr: int | None) -> int:
    """The DP's width: ``lr``, else the row width; at most the row width."""
    if lr is None:
        return reads.shape[1]
    if not 1 <= lr <= reads.shape[1]:
        raise ValueError(f"lr={lr} outside 1..{reads.shape[1]} (the row width)")
    return lr


def banded_extend_plain(text, w0, reads, read_len, pad: int, match: int,
                        mismatch: int, gap: int, lr: int | None = None):
    """Plain torch version of K1: (score, start_off, end_off, matches),
    int32 [N] each, window = text[w0 : w0 + lr + 2*pad] (positions clamped
    into the text)."""
    _check_band(pad)
    lr = _dp_width(reads, lr)
    return banded_extend_windows_plain(
        extract_windows(text, w0, lr + 2 * pad), reads, read_len, pad, match,
        mismatch, gap, lr)


def banded_extend_windows_plain(windows, reads, read_len, pad: int,
                                match: int, mismatch: int, gap: int,
                                lr: int | None = None):
    """Plain torch version of K2, aligner._banded_extend: the DP of read i
    (its first ``lr`` columns) against windows[i] (int8 [N, W],
    W >= lr + 2*pad - 1)."""
    _check_band(pad)
    Lr = _dp_width(reads, lr)
    sh_score, bias = packed_layout(Lr)
    Wb = 2 * pad
    dev = windows.device
    winT = windows.to(torch.int32).T.contiguous()      # [W, N]
    readT = reads[:, :Lr].to(torch.int32).T.contiguous()  # [Lr, N]
    rl = read_len.to(torch.int32)
    d_score = 1 << sh_score
    gap_p = gap * d_score
    mis_d = mismatch * d_score
    ok_gain = (match - mismatch) * d_score + (1 << _SH_MATCH)

    def sub_packed(i):
        row = winT[i:i + Wb]
        x = readT[i]
        ok = (row == x) & (x < 4) & (row < 4)
        return mis_d + ok.to(torch.int32) * ok_gain

    band = torch.arange(Wb, dtype=torch.int32, device=dev)[:, None]
    state = (bias << sh_score) + band + sub_packed(0)
    for i in range(1, Lr):
        v = state + sub_packed(i)
        v[:-1] = torch.maximum(v[:-1], state[1:] + gap_p)
        for b in range(1, Wb):
            v[b] = torch.maximum(v[b], v[b - 1] + gap_p)
        state = torch.where(i < rl, v, state)
    out = torch.where(rl >= 1, state, NEG)
    b_best = torch.argmax(out, dim=0)  # first band row reaching the max
    cell = torch.gather(out, 0, b_best[None])[0]
    return _unpack_cell(cell, b_best, rl, sh_score, bias)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin)")
    return path


def build_dir() -> Path:
    """Where compiled kernels go: $PANTAX_TORCH_BUILD, else ``build/`` beside
    the package (git-ignored)."""
    env = os.environ.get("PANTAX_TORCH_BUILD")
    return Path(env) if env else _SRC.parent.parent.parent / "build"


def build_kernels(src: Path | str | None = None) -> ctypes.CDLL:
    """Compile a kernel source (csrc/banded_extend.cu unless ``src`` names
    another with the same C entry points, such as an earlier commit's; once
    per source content) and load it.  The library's ``build_log`` holds
    nvcc's output (ptxas's register and spill report), kept beside the
    ``.so``."""
    src = Path(src).resolve() if src is not None else _SRC
    if src in _libs:
        return _libs[src]
    code = src.read_bytes()
    tag = hashlib.sha256(code + " ".join(_NVCC_FLAGS).encode()).hexdigest()[:16]
    out_dir = build_dir() / "kernels"
    out_dir.mkdir(parents=True, exist_ok=True)
    so = out_dir / f"banded_extend_{tag}.so"
    log = so.with_suffix(".log")
    if not so.exists():
        tmp = out_dir / f".banded_extend_{tag}.{os.getpid()}.so"
        proc = subprocess.run(
            [_nvcc(), *_NVCC_FLAGS, "-o", str(tmp), str(src)],
            capture_output=True, text=True,
        )
        if proc.returncode:
            raise RuntimeError(
                f"nvcc failed on {src}:\n{proc.stdout}{proc.stderr}")
        log.write_text(proc.stdout + proc.stderr)
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    lib.build_log = log.read_text() if log.exists() else ""
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.banded_extend_launch.restype = i32
    lib.banded_extend_launch.argtypes = [
        vp, i64, vp, vp, vp, i32, i32, i32, i32, i32, i32, i32, i32,
        vp, vp, vp, vp, vp,
    ]
    lib.banded_extend_windows_launch.restype = i32
    lib.banded_extend_windows_launch.argtypes = [
        vp, i32, vp, vp, i32, i32, i32, i32, i32, i32, i32, i32,
        vp, vp, vp, vp, vp,
    ]
    _libs[src] = lib
    return lib


def _check_cuda_args(pad: int, tensors) -> torch.device:
    """The checks both kernels' wrappers make: pad 1..8, and every tensor
    on one CUDA device (any other device raises) with its dtype, rank and
    contiguity."""
    _check_band(pad)
    if not 1 <= pad <= 8:
        raise ValueError(f"CUDA kernel takes pad 1..8 (band rows <= 16), got {pad}")
    dev = tensors[0][1].device
    for name, t, dtype, ndim in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{name} must be on {dev} (got {t.device})")
        if t.dtype != dtype or t.dim() != ndim:
            raise ValueError(f"{name} must be {dtype} with {ndim} dims")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return dev


def _launch(lib, fn_name: str, dev, N: int, *args):
    """Call ``fn_name`` of the kernel library ``lib`` with ``args``, four
    fresh int32 [N] outputs and the current stream (no synchronise); raise
    on the CUDA error it returns."""
    outs = [torch.empty(N, dtype=torch.int32, device=dev) for _ in range(4)]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(lib, fn_name)(*args, *(o.data_ptr() for o in outs),
                                   stream)
    if rc != 0:
        raise RuntimeError(f"{fn_name} failed: CUDA error {rc}")
    return tuple(outs)


def launch_k1(lib, text, w0, reads, read_len, pad: int, match: int,
              mismatch: int, gap: int, lr: int | None = None):
    """Check K1's arguments and launch ``lib``'s banded_extend_launch on
    the current stream (no synchronise, no count).  The read rows are
    loaded 16 bytes at a time: ``reads`` must start on a 16-byte boundary
    and its width be a multiple of 16; ``lr`` is the DP's width (the
    packed layout's)."""
    dev = _check_cuda_args(pad, (("text", text, torch.int8, 1),
                                 ("w0", w0, torch.int32, 1),
                                 ("reads", reads, torch.int8, 2),
                                 ("read_len", read_len, torch.int32, 1)))
    N, Lr = reads.shape
    if w0.shape[0] != N or read_len.shape[0] != N:
        raise ValueError("w0, reads and read_len disagree on N")
    if Lr < 1 or Lr % 16:
        raise ValueError(f"K1 takes reads of a width that is a positive "
                         f"multiple of 16 (got {Lr})")
    if reads.data_ptr() % 16:
        raise ValueError("reads must start on a 16-byte boundary")
    return _launch(lib, "banded_extend_launch", dev, N, text.data_ptr(),
                   text.numel(), w0.data_ptr(), reads.data_ptr(),
                   read_len.data_ptr(), N, Lr, pad, match, mismatch, gap,
                   *packed_layout(_dp_width(reads, lr)))


def launch_k2(lib, windows, reads, read_len, pad: int, match: int,
              mismatch: int, gap: int):
    """Check K2's arguments and launch ``lib``'s
    banded_extend_windows_launch on the current stream (no synchronise, no
    count).  Any read width and any 16-byte offset of the rows is taken."""
    dev = _check_cuda_args(pad, (("windows", windows, torch.int8, 2),
                                 ("reads", reads, torch.int8, 2),
                                 ("read_len", read_len, torch.int32, 1)))
    N, Lr = reads.shape
    W = windows.shape[1]
    if windows.shape[0] != N or read_len.shape[0] != N:
        raise ValueError("windows, reads and read_len disagree on N")
    if Lr < 1 or W < Lr + 2 * pad - 1:
        raise ValueError(f"windows of width {W} do not cover reads of "
                         f"{Lr} bases at pad {pad} (need >= {Lr + 2 * pad - 1})")
    return _launch(lib, "banded_extend_windows_launch", dev, N,
                   windows.data_ptr(), W, reads.data_ptr(),
                   read_len.data_ptr(), N, Lr, pad, match, mismatch, gap,
                   *packed_layout(Lr))


def banded_extend_cuda(text, w0, reads, read_len, pad: int, match: int,
                       mismatch: int, gap: int, lr: int | None = None):
    """Launch K1 on the current stream (no synchronise)."""
    outs = launch_k1(build_kernels(), text, w0, reads, read_len, pad, match,
                     mismatch, gap, lr)
    LAUNCHES["banded_extend"] += 1
    return outs


def banded_extend_windows_cuda(windows, reads, read_len, pad: int,
                               match: int, mismatch: int, gap: int):
    """Launch K2 on the current stream (no synchronise)."""
    outs = launch_k2(build_kernels(), windows, reads, read_len, pad, match,
                     mismatch, gap)
    LAUNCHES["banded_extend_windows"] += 1
    return outs


def banded_extend(text, w0, reads, read_len, pad: int, match: int,
                  mismatch: int, gap: int, lr: int | None = None):
    """(score, start_off, end_off, matches), int32 [N] each, for every
    candidate window text[w0[i] : w0[i] + lr + 2*pad] against reads[i]
    (read_len[i] bases); window coordinates, like aligner._banded_extend."""
    if text.device.type == "cpu":
        LAUNCHES["banded_extend_plain"] += 1
        return banded_extend_plain(text, w0, reads, read_len, pad, match,
                                   mismatch, gap, lr)
    return banded_extend_cuda(text, w0, reads, read_len, pad, match,
                              mismatch, gap, lr)


def banded_extend_windows(windows, reads, read_len, pad: int, match: int,
                          mismatch: int, gap: int):
    """aligner._banded_extend: (score, start_off, end_off, matches), int32
    [N] each, of reads[i] (read_len[i] bases) against windows[i]."""
    if windows.device.type == "cpu":
        LAUNCHES["banded_extend_windows_plain"] += 1
        return banded_extend_windows_plain(windows, reads, read_len, pad,
                                           match, mismatch, gap)
    return banded_extend_windows_cuda(windows, reads, read_len, pad, match,
                                      mismatch, gap)
