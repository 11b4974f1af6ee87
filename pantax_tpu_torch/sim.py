"""Reverse complement of ASCII reads, the port's copy of
pantax_tpu/sim.py's ``revcomp`` (the port simulates reads with
benchmarks.simulate_read_batch and simulate_long_reads instead of the rest
of that module)."""
from __future__ import annotations

_COMP = bytes.maketrans(b"ACGTN", b"TGCAN")


def revcomp(seq: bytes) -> bytes:
    return seq.translate(_COMP)[::-1]
