"""On-demand build + ctypes loading of the native C++ host helpers, the
port's copy of pantax_tpu/utils/native.py (the wrappers the port reaches).

Compiles the repository's shared ``native/pantax_native.cpp`` with g++ once
per source content into the port's git-ignored build directory
(``ops.extend.build_dir()/native``), never over the tracked library beside
the source.  Every entry point returns None when no compiler or library is
available, and its caller takes a NumPy path.
"""
from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

log = logging.getLogger(__name__)

_SRC = Path(__file__).resolve().parents[2] / "native" / "pantax_native.cpp"
_FLAGS = ("-O3", "-shared", "-fPIC")
_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_tried = False


def _build() -> Path:
    """The compiled library for the current source (built once, renamed
    into place so a concurrent process never loads a partial file)."""
    from ..ops.extend import build_dir

    src = _SRC.read_bytes()
    tag = hashlib.sha256(src + " ".join(_FLAGS).encode()).hexdigest()[:16]
    out_dir = build_dir() / "native"
    out_dir.mkdir(parents=True, exist_ok=True)
    so = out_dir / f"pantax_native_{tag}.so"
    if not so.exists():
        tmp = out_dir / f".pantax_native_{tag}.{os.getpid()}.so"
        subprocess.run(["g++", *_FLAGS, str(_SRC), "-o", str(tmp)],
                       check=True, capture_output=True)
        os.replace(tmp, so)
    return so


def load_native() -> ctypes.CDLL | None:
    """Build (if needed) and load the native library; None if unavailable."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not _SRC.exists():
            return None
        try:
            lib = ctypes.CDLL(str(_build()))
        except (OSError, subprocess.CalledProcessError) as e:
            log.warning("native library unavailable, using NumPy paths: %s", e)
            return None
        lib.fastx_parse.restype = ctypes.c_longlong
        lib.fastx_parse.argtypes = [
            ctypes.c_char_p, ctypes.c_longlong,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong,
        ]
        lib.unique_kmer_positions.restype = ctypes.c_longlong
        lib.unique_kmer_positions.argtypes = [
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
        ]
        lib.kmer_hash_sample.restype = ctypes.c_longlong
        lib.kmer_hash_sample.argtypes = [
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
        ]
        lib.chd_build.restype = ctypes.c_longlong
        lib.chd_build.argtypes = [
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p,
        ]
        _lib = lib
        return _lib


def fastx_parse_native(data: bytes):
    """Parse a decompressed FASTA/FASTQ buffer.

    Returns (codes int8 [total_bases], offsets int64 [n+1], ids list[str])
    or None when the native library is unavailable / the format is unexpected.
    """
    lib = load_native()
    if lib is None:
        return None
    n_max = max(data.count(b"\n") // 2 + 2, 4)
    codes = np.empty(len(data), dtype=np.int8)
    offsets = np.empty(n_max + 1, dtype=np.int64)
    id_spans = np.empty(2 * n_max, dtype=np.int64)
    n = lib.fastx_parse(
        data, len(data),
        codes.ctypes.data_as(ctypes.c_void_p),
        offsets.ctypes.data_as(ctypes.c_void_p),
        id_spans.ctypes.data_as(ctypes.c_void_p),
        n_max,
    )
    if n < 0:
        return None
    ids = [
        data[id_spans[2 * i] : id_spans[2 * i + 1]].decode()
        for i in range(n)
    ]
    return codes[: offsets[n]], offsets[: n + 1], ids


def kmer_hash_sample_native(codes: np.ndarray, k: int, density_bits: int):
    """Single-pass sampled canonical k-mer hashing.

    Returns (hashes uint32 [m], positions int64 [m]) or None if unavailable.
    """
    lib = load_native()
    if lib is None:
        return None
    codes = np.ascontiguousarray(codes, dtype=np.int8)
    n = len(codes)
    cap = max(n // max(1 << max(density_bits - 1, 0), 1) + 64, 64)
    while True:
        out_hash = np.empty(cap, dtype=np.uint32)
        out_pos = np.empty(cap, dtype=np.int64)
        m = lib.kmer_hash_sample(
            codes.ctypes.data_as(ctypes.c_void_p), n, k, density_bits,
            out_hash.ctypes.data_as(ctypes.c_void_p),
            out_pos.ctypes.data_as(ctypes.c_void_p), cap,
        )
        if m >= 0:
            return out_hash[:m].copy(), out_pos[:m].copy()
        cap = max(cap * 4, 1024)  # overflowed at -m entries; retry larger


def chd_build_native(keys: np.ndarray, mb: int, Tb: int):
    """Displacement-hash placement (align.aligner._build_chd's hot loop).

    Returns (slot int64 [n], disp int32 [2^mb]), None when the library is
    unavailable, or False when placement fails (caller falls back)."""
    lib = load_native()
    if lib is None:
        return None
    keys = np.ascontiguousarray(keys, dtype=np.uint32)
    n = len(keys)
    slot = np.empty(n, dtype=np.int64)
    disp = np.empty(1 << mb, dtype=np.int32)
    rc = lib.chd_build(
        keys.ctypes.data_as(ctypes.c_void_p), n, mb, Tb,
        slot.ctypes.data_as(ctypes.c_void_p),
        disp.ctypes.data_as(ctypes.c_void_p),
    )
    if rc < 0:
        return False
    return slot, disp


def unique_kmer_positions_native(codes: np.ndarray, k: int):
    """(sorted 2-bit-packed keys uint64, positions int64) of k-mers occurring
    exactly once (N-containing k-mers skipped); None if unavailable."""
    lib = load_native()
    if lib is None:
        return None
    codes = np.ascontiguousarray(codes, dtype=np.int8)
    n = len(codes)
    cap = max(n, 64)
    out_key = np.empty(cap, dtype=np.uint64)
    out_pos = np.empty(cap, dtype=np.int64)
    m = lib.unique_kmer_positions(
        codes.ctypes.data_as(ctypes.c_void_p), n, k,
        out_key.ctypes.data_as(ctypes.c_void_p),
        out_pos.ctypes.data_as(ctypes.c_void_p), cap,
    )
    if m < 0:
        return None
    return out_key[:m].copy(), out_pos[:m].copy()
