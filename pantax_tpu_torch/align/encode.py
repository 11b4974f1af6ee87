"""Base encoding and 32-bit rolling k-mer hashing, identical on host (NumPy)
and device (JAX int32 wraparound arithmetic).

Bases are coded A=0 C=1 G=2 T=3, anything else 4 (invalid).  The k-mer hash is
a degree-(k-1) polynomial over the codes mod 2^32; the canonical hash is
min(h(S), h(rc(S))), which is strand-symmetric because
h(rc(S)) = sum_j (3 - S_j) * B^j.  A final avalanche mix decorrelates the
polynomial structure; seeds are sampled where mix(canon) % density == 0
(FracMinHash-style open syncmer sampling — both the text index and the reads
apply the same rule, so no windowed minimum is needed on either side).
"""
from __future__ import annotations

import numpy as np

BASE_LUT = np.full(256, 4, dtype=np.int8)
for i, b in enumerate(b"ACGT"):
    BASE_LUT[b] = i
for i, b in enumerate(b"acgt"):
    BASE_LUT[b] = i

HASH_BASE = np.uint32(0x9E3779B1)  # odd => invertible mod 2^32


def encode_seq(seq: bytes | np.ndarray) -> np.ndarray:
    """ASCII bytes -> int8 codes 0..4."""
    arr = np.frombuffer(seq, dtype=np.uint8) if isinstance(seq, (bytes, bytearray)) else seq
    return BASE_LUT[arr]


def _mix32(h: np.ndarray) -> np.ndarray:
    """xorshift-multiply avalanche (murmur3 finalizer), uint32."""
    h = h.astype(np.uint32)
    h ^= h >> np.uint32(16)
    h *= np.uint32(0x85EBCA6B)
    h ^= h >> np.uint32(13)
    h *= np.uint32(0xC2B2AE35)
    h ^= h >> np.uint32(16)
    return h


def kmer_hashes(codes: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """(canonical mixed hash uint32, valid bool) per k-mer start position.

    codes: int8 [L]; output length L - k + 1 (empty if L < k).
    """
    L = len(codes)
    n = L - k + 1
    if n <= 0:
        return np.zeros(0, dtype=np.uint32), np.zeros(0, dtype=bool)
    c = codes.astype(np.uint32)
    pows = np.empty(k, dtype=np.uint32)
    pows[0] = 1
    with np.errstate(over="ignore"):  # mod-2^32 wraparound is the hash
        for j in range(1, k):
            pows[j] = pows[j - 1] * HASH_BASE
    hf = np.zeros(n, dtype=np.uint32)
    hr = np.zeros(n, dtype=np.uint32)
    invalid = np.zeros(n, dtype=bool)
    for i in range(k):
        ci = c[i : i + n]
        hf += ci * pows[k - 1 - i]
        hr += (np.uint32(3) - ci) * pows[i]
        invalid |= ci == 4
    canon = np.minimum(hf, hr)
    return _mix32(canon), ~invalid


def sample_positions(
    hashes: np.ndarray, valid: np.ndarray, density_bits: int
) -> np.ndarray:
    """Positions passing the open-sampling rule mix(h) % 2^density_bits == 0."""
    mask = valid & ((hashes & np.uint32((1 << density_bits) - 1)) == 0)
    return np.flatnonzero(mask)
