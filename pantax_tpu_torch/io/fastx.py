"""FASTA/FASTQ readers and writers (gzip-transparent), the port's copy of
pantax_tpu/io/fastx.py: the record reader and read_fasta / read_fastq,
the FASTA writer, PanSN record names, the streamed
record-aligned chunk reader, the byte-range shard reader of multi-process
input (``shard_fastx_buffers``, ``iter_fastx_shard``) and the paired-mate
block reader.

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


def read_fasta(path: str | os.PathLike) -> list[Record]:
    return list(iter_fastx(path))


def read_fastq(path: str | os.PathLike) -> list[Record]:
    return list(iter_fastx(path))


def write_fasta(path: str | os.PathLike, records: Iterable[Record], width: int = 80) -> None:
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "wb") as f:
        for name, seq in records:
            f.write(b">" + name.encode() + b"\n")
            for i in range(0, len(seq), width):
                f.write(seq[i : i + width] + b"\n")


def pansn_name(genome_name: str, contig: str, haplotype: int = 0) -> str:
    """PanSN sample#haplotype#contig naming used when merging genomes
    (PanTax prefixes records with '<genome>#0#', src/fastixe.rs:70-94)."""
    return f"{genome_name}#{haplotype}#{contig}"


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


def _next_record_start(f, off: int, size: int, fastq: bool) -> int:
    """Smallest record-start byte offset >= ``off`` in an uncompressed
    FASTA/FASTQ file (``size`` if none).  A FASTQ header line is identified
    as a line starting with '@' whose line+2 starts with '+' — a quality
    line starting with '@' never qualifies because the line two after it is
    a sequence line (nucleotides, never '+')."""
    if off <= 0:
        return 0
    if off >= size:
        return size
    # align to the next line start at or after off
    f.seek(off - 1)
    if f.read(1) != b"\n":
        pos = off
        while True:
            blk = f.read(1 << 20)
            if not blk:
                return size
            nl = blk.find(b"\n")
            if nl >= 0:
                off = pos + nl + 1
                break
            pos += len(blk)
    if not fastq:
        f.seek(off)
        pos = off
        prev_tail = b""
        while True:
            blk = f.read(1 << 20)
            if not blk:
                return size
            if blk[0:1] == b">" and pos == off:
                return pos
            p = (prev_tail + blk).find(b"\n>")
            if p >= 0:
                return pos - len(prev_tail) + p + 1
            prev_tail = blk[-1:]
            pos += len(blk)
    # FASTQ: need line structure — read a growing window of whole lines
    window = b""
    f.seek(off)
    while True:
        blk = f.read(1 << 20)
        window += blk
        lines = window.split(b"\n")
        # drop the trailing partial line unless EOF ended the window
        n_full = len(lines) - (0 if not blk else 1)
        starts = []
        pos = off
        for ln in lines[: max(n_full, 0)]:
            starts.append(pos)
            pos += len(ln) + 1
        for j in range(len(starts)):
            if lines[j][:1] == b"@" and j + 2 < len(starts) and lines[j + 2][:1] == b"+":
                return starts[j]
        if not blk:
            return size
        if len(window) > (1 << 28):
            raise ValueError("no FASTQ record boundary within 256MB window")


def shard_fastx_buffers(
    path: str | os.PathLike,
    process_id: int,
    num_processes: int,
    chunk_bytes: int = 64 << 20,
) -> Iterator[bytes]:
    """Record-aligned byte-range shard of ONE FASTA/FASTQ file for
    multi-process input.  All processes pass the same path; process i
    yields exactly the records whose start offset falls in
    [i·size/P, (i+1)·size/P), so P processes collectively stream every
    record exactly once with no coordination and no pre-splitting.  Buffers
    have the
    same record-aligned contract as :func:`stream_fastx_buffers`.

    Gzipped inputs are not seekable: every process then decompresses the
    whole stream but keeps only its round-robin share of record-aligned
    chunks (~4MB granularity), which still bounds memory and partitions the
    records exactly.
    """
    if not (0 <= process_id < num_processes):
        raise ValueError(f"process_id {process_id} not in [0, {num_processes})")
    path = os.fspath(path)
    with open(path, "rb") as probe:
        magic = probe.read(2)
    if magic == b"\x1f\x8b":
        gran = min(chunk_bytes, 4 << 20)
        for i, buf in enumerate(stream_fastx_buffers(path, gran)):
            if i % num_processes == process_id:
                yield buf
        return

    size = os.path.getsize(path)
    with open(path, "rb") as f:
        first = f.read(1)
        if not first:
            return
        if first not in (b">", b"@"):
            raise ValueError(f"{path}: not FASTA/FASTQ (starts with {first!r})")
        fastq = first == b"@"
        lo = size * process_id // num_processes
        hi = size * (process_id + 1) // num_processes
        start = _next_record_start(f, lo, size, fastq)
        end = _next_record_start(f, hi, size, fastq) if hi < size else size
        if start >= end:
            return
        f.seek(start)
        remaining = end - start
        buf = b""
        while remaining > 0:
            data = f.read(min(chunk_bytes, remaining))
            if not data:
                break
            remaining -= len(data)
            buf += data
            if remaining <= 0:
                break
            if fastq:
                nl = np.flatnonzero(np.frombuffer(buf, dtype=np.uint8) == 10)
                k = (len(nl) // 4) * 4
                cut = int(nl[k - 1]) + 1 if k else 0
            else:
                p = buf.rfind(b"\n>")
                cut = p + 1 if p >= 0 else 0
            if cut <= 0:
                continue
            yield buf[:cut]
            buf = buf[cut:]
        if buf.strip():
            yield buf


def iter_fastx_shard(
    path: str | os.PathLike, process_id: int, num_processes: int
) -> Iterator[Record]:
    """Record iterator over this process's shard of one shared file
    (see :func:`shard_fastx_buffers`)."""
    for buf in shard_fastx_buffers(path, process_id, num_processes):
        f = io.BytesIO(buf)
        first = f.read(1)
        if first == b">":
            yield from _iter_fasta(f)
        elif first == b"@":
            yield from _iter_fastq(f)


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
