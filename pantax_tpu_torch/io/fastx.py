"""FASTA/FASTQ readers and writers (gzip-transparent), the port's copy of
pantax_tpu/io/fastx.py (the record reader and the FASTA writer).

Host-side I/O layer. Sequences are returned as Python ``bytes`` (uppercased);
2-bit/int8 encoding for the device happens in :mod:`pantax_tpu_torch.align.encode`.

Parity: the reference uses needletail for FASTA/FASTQ parsing
(PanTax's src/fastixe.rs:70-94 uppercases and renames records);
uppercasing is applied here at parse time.
"""
from __future__ import annotations

import gzip
import io
import os
from typing import Iterable, Iterator, Tuple

Record = Tuple[str, bytes]


def _open_text(path: str | os.PathLike) -> io.BufferedReader:
    path = os.fspath(path)
    f = open(path, "rb")
    magic = f.peek(2)[:2] if hasattr(f, "peek") else f.read(2)
    if magic == b"\x1f\x8b":
        f.close()
        return gzip.open(path, "rb")  # type: ignore[return-value]
    f.seek(0)
    return f


def iter_fastx(path: str | os.PathLike) -> Iterator[Record]:
    """Yield (name, seq) from a FASTA or FASTQ file, plain or gzipped.

    The record name is the first whitespace-delimited token after '>'/'@'.
    Sequences are uppercased bytes.
    """
    with _open_text(path) as f:
        first = f.read(1)
        if not first:
            return
        if first == b">":
            yield from _iter_fasta(f)
        elif first == b"@":
            yield from _iter_fastq(f)
        else:
            raise ValueError(f"{path}: not FASTA/FASTQ (starts with {first!r})")


def _iter_fasta(f) -> Iterator[Record]:
    # We already consumed the first '>'
    name = None
    chunks: list[bytes] = []
    for raw in f:
        line = raw.rstrip()
        if name is None:
            name = line.split()[0].decode() if line else ""
            continue
        if line.startswith(b">"):
            yield name, b"".join(chunks).upper()
            name = line[1:].split()[0].decode() if len(line) > 1 else ""
            chunks = []
        else:
            chunks.append(line)
    if name is not None:
        yield name, b"".join(chunks).upper()


def _iter_fastq(f) -> Iterator[Record]:
    # We already consumed the first '@'
    line = f.readline().rstrip()
    while True:
        name = line.split()[0].decode()
        seq = f.readline().rstrip()
        f.readline()  # '+'
        f.readline()  # quals
        yield name, seq.upper()
        header = f.readline()
        if not header:
            return
        line = header.rstrip()[1:]


def write_fasta(path: str | os.PathLike, records: Iterable[Record], width: int = 80) -> None:
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "wb") as f:
        for name, seq in records:
            f.write(b">" + name.encode() + b"\n")
            for i in range(0, len(seq), width):
                f.write(seq[i : i + width] + b"\n")
