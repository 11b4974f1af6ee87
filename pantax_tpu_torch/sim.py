"""Reverse complement of ASCII reads, the port's copy of
pantax_tpu/sim.py's ``revcomp`` (the rest of that module simulates reads
against the GAF flow, ROADMAP M11)."""
from __future__ import annotations

_COMP = bytes.maketrans(b"ACGTN", b"TGCAN")


def revcomp(seq: bytes) -> bytes:
    return seq.translate(_COMP)[::-1]
