"""FASTA/FASTQ readers and writers (gzip-transparent), the port's copy of
pantax_tpu/io/fastx.py: the record reader (``list(iter_fastx(path))`` is
the reference's read_fasta / read_fastq), the FASTA writer, the streamed
record-aligned chunk reader and the paired-mate block reader.  (The
byte-range shard reader and its record-boundary search belong to multi-GPU
input, ROADMAP M12.)

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

import numpy as np

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


def stream_fastx_buffers(
    path: str | os.PathLike, chunk_bytes: int = 64 << 20
) -> Iterator[bytes]:
    """Yield decompressed FASTA/FASTQ byte buffers, each ending on a record
    boundary, reading at most ~chunk_bytes at a time — bounded-memory input
    for multi-GB read files (the whole-file path caps near RAM size).

    FASTQ chunks cut after the last complete 4-line record; FASTA chunks cut
    before the last '\\n>' header."""
    with _open_text(path) as f:
        first = f.read(1)
        if not first:
            return
        fastq = first == b"@"
        buf = first
        while True:
            data = f.read(chunk_bytes)
            buf += data
            if not data:
                if buf.strip():
                    yield buf
                return
            if fastq:
                arr = np.frombuffer(buf, dtype=np.uint8)
                nl = np.flatnonzero(arr == 10)
                k = (len(nl) // 4) * 4
                cut = int(nl[k - 1]) + 1 if k else 0
            else:
                p = buf.rfind(b"\n>")
                cut = p + 1 if p >= 0 else 0
            if cut <= 0:
                continue  # record longer than the chunk: read more
            yield buf[:cut]
            buf = buf[cut:]


def stream_paired_parsed(
    path1: str | os.PathLike,
    path2: str | os.PathLike | None,
    parse,
    chunk_bytes: int = 64 << 20,
):
    """Yield parsed mate blocks ``(cf1, of1, ids1, cf2, of2, ids2)`` per
    streamed chunk, from two mate files (paired by order) or ONE interleaved
    file (``path2=None``) — the reference's ShortReadPaired /
    ShortReadPairedInter input modes (PanTax's src/types.rs:34-48,
    alignment.rs:14-119).  ``parse(path, buf) -> (codes_flat int8 [sum lens],
    offsets int64 [n+1], ids list[str])`` is the caller's record parser.

    Interleaved chunks may end on an odd record; the dangling mate is carried
    into the next chunk, so yielded blocks always hold complete pairs."""
    if path2 is not None:
        for buf1, buf2 in zip(stream_fastx_buffers(path1, chunk_bytes),
                              stream_fastx_buffers(path2, chunk_bytes)):
            cf1, of1, ids1 = parse(path1, buf1)
            cf2, of2, ids2 = parse(path2, buf2)
            if len(ids1) != len(ids2):
                raise ValueError(
                    "paired files desynchronized (unequal chunk read counts "
                    f"{len(ids1)} vs {len(ids2)}); mates must pair by order"
                )
            yield cf1, of1, ids1, cf2, of2, ids2
        return

    # interleaved: split even/odd records, carry a dangling mate
    left: tuple | None = None
    for buf in stream_fastx_buffers(path1, chunk_bytes):
        cf, of, ids = parse(path1, buf)
        if left is not None:
            lcf, lid = left
            cf = np.concatenate([lcf, cf])
            of = np.concatenate([of[:1], of[1:] + len(lcf)])
            of = np.insert(of, 1, len(lcf))
            ids = [lid] + ids
            left = None
        if len(ids) % 2:
            last = len(of) - 2
            left = (cf[of[last]:of[last + 1]].copy(), ids[-1])
            cf, of, ids = cf[: of[last]], of[: last + 1], ids[:-1]
        if not len(ids):
            continue
        l_all = np.diff(of)
        idx1 = np.arange(0, len(ids), 2)
        idx2 = idx1 + 1

        def split(idxs):
            lens = l_all[idxs]
            offsets = np.zeros(len(idxs) + 1, dtype=of.dtype)
            np.cumsum(lens, out=offsets[1:])
            flat = np.concatenate(
                [cf[of[i]: of[i] + l_all[i]] for i in idxs]
            ) if len(idxs) else cf[:0]
            return flat, offsets, [ids[i] for i in idxs]

        yield (*split(idx1), *split(idx2))
    if left is not None:
        raise ValueError(
            f"{path1}: odd read count in interleaved paired file"
        )
