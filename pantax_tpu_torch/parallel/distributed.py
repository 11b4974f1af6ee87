"""Multi-process runs of the port: the counterpart of
pantax_tpu/parallel/distributed.py, on ``torch.distributed``.

Every process calls :func:`init_distributed` with the same coordinator
address and process count, takes its share of the reads (the byte-range
shard of one shared file, ``local_read_shard``; the CLI also round-robins
paired chunks and long-read groups), scatters them into its own coverage
accumulators, and merges them with :func:`cross_process_sum` before the
finalize.  Coverage addends are integers, so the merged coverage is
bit-identical to one process's over all the reads.

The group runs gloo over host tensors: the merge runs once per run (three
accumulators, the largest ``TB_pad + 1`` int32), and gloo lets two ranks
share one card, which NCCL does not.  Every collective here runs on every
rank in the same order whatever the rank owns, so a rank that owns no
reads completes with the others (the reference's gather skips its read-id
collectives on such a rank, which deadlocks the fleet).
"""
from __future__ import annotations

import datetime

import numpy as np
import torch
import torch.distributed as dist

from ..io.fastx import iter_fastx_shard
from ..ops.coverage_device import (
    build_padded_tables, finalize_species, species_accumulators,
)

# seconds each process waits for the group to form and for each collective
# (a rank still aligning when another reaches the merge holds it there)
TIMEOUT_S = 1800

# the per-read columns gather_read_rows carries, and the dtypes they come in
COLUMNS = ("mapq", "aligned", "ridx", "read_len", "ts", "te")
_DTYPES = tuple(np.dtype(t) for t in ("bool", "int8", "int16", "int32",
                                      "int64"))


def parse_spec(spec: str) -> tuple[str, int, int]:
    """``HOST:PORT,N,I`` -> (coordinator "HOST:PORT", N, I); raises
    ValueError on anything else."""
    parts = spec.rsplit(",", 2)
    host, _, port = parts[0].rpartition(":")
    if (len(parts) != 3 or not host or not port.isdigit()
            or not (parts[1].isdigit() and parts[2].isdigit())
            or int(parts[2]) >= int(parts[1])):
        raise ValueError(f"--distributed {spec!r}: expected HOST:PORT,N,I "
                         "with 0 <= I < N")
    return parts[0], int(parts[1]), int(parts[2])


def init_distributed(coordinator: str, num_processes: int, process_id: int,
                     *, device) -> torch.device:
    """Join the gloo group at tcp://``coordinator`` (process 0 hosts it) as
    ``process_id`` of ``num_processes``, waiting at most TIMEOUT_S; raises
    when the group does not form.  Returns this process's device: on CUDA
    card ``process_id % device_count`` (made the current device), else
    ``device``."""
    dist.init_process_group(
        "gloo", init_method=f"tcp://{coordinator}",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=TIMEOUT_S))
    d = torch.device(device)
    if d.type == "cuda":
        d = torch.device("cuda", process_id % torch.cuda.device_count())
        torch.cuda.set_device(d)
    return d


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def local_read_shard(path):
    """This process's records of ONE shared FASTA/FASTQ file: the records
    whose start falls in its byte range (shard_fastx_buffers), so the
    processes together read each record once."""
    return iter_fastx_shard(path, process_index(), process_count())


def cross_process_sum(arrs) -> tuple:
    """The element-wise sum of each tensor of ``arrs`` over all processes,
    on every process and on the tensor's device: an all_reduce of a host
    copy.  Integer sums, so it is exact in any order."""
    out = []
    for a in arrs:
        host = a.detach().to("cpu", copy=True).contiguous()
        dist.all_reduce(host, op=dist.ReduceOp.SUM)
        out.append(host.to(a.device))
    return tuple(out)


def _all_gather(t: torch.Tensor) -> np.ndarray:
    """[P, *t.shape]: every process's ``t`` (equal shapes) in process
    order."""
    parts = [torch.empty_like(t) for _ in range(process_count())]
    dist.all_gather(parts, t)
    return torch.stack(parts).numpy()


def gather_read_rows(reads: dict) -> dict:
    """Every process's per-read columns (FusedPipeline.finish()'s reads:
    COLUMNS and ``ids``) concatenated in process order, on every process.
    Process order is file order only where each process reads one
    contiguous byte range: the byte-range shard of one uncompressed file.
    There the rows equal one process's over the whole file; elsewhere they
    are those rows permuted (a gzip file's chunks are dealt round-robin,
    several files give a0 b0 a1 b1, as do round-robin paired chunks and
    long-read groups).  Three collectives on every
    rank whatever it owns: a header (row count, whether it has ids, the
    id bytes, each column's dtype), the columns as int64, the ids as one
    newline-joined byte buffer."""
    n = len(reads["mapq"])
    ids = reads.get("ids")
    blob = "\n".join(ids).encode() if ids else b""
    cols = [np.asarray(reads[k]) for k in COLUMNS]
    head = _all_gather(torch.tensor(
        [n, ids is not None, len(blob)] + [_DTYPES.index(c.dtype)
                                           for c in cols],
        dtype=torch.int64))
    counts, has_ids, blens = head[:, 0], head[:, 1], head[:, 2]
    owners = np.flatnonzero(counts > 0)

    local = torch.zeros((len(COLUMNS), max(int(counts.max()), 1)),
                        dtype=torch.int64)
    for j, c in enumerate(cols):
        local[j, :n] = torch.from_numpy(c.astype(np.int64))
    g = _all_gather(local)
    out = {}
    for j, k in enumerate(COLUMNS):
        dtype = (np.result_type(*(_DTYPES[c] for c in head[owners, 3 + j]))
                 if len(owners) else np.dtype(np.int64))
        out[k] = np.concatenate(
            [g[i, j, :counts[i]] for i in range(len(counts))]).astype(dtype)

    buf = torch.zeros(max(int(blens.max()), 1), dtype=torch.uint8)
    buf[:len(blob)] = torch.from_numpy(np.frombuffer(blob, np.uint8).copy())
    gb = _all_gather(buf)
    if len(owners) and has_ids[owners].all():
        out["ids"] = [s for i in owners for s in
                      gb[i, :blens[i]].tobytes().decode().split("\n")]
    elif has_ids[owners].any():
        raise ValueError("some processes' reads have ids and others' not")
    else:
        out["ids"] = None
    return out


def distributed_node_abundances(packed_local, nodes_len, trio_index, *,
                                device):
    """One species' (node_abundance, trio_abundance, node_base_cov) over
    every process's PackedReads: this process's scatter into its raw
    accumulators (species_accumulators), their cross_process_sum, then the
    finalize.  Every process returns the merged host arrays, bit-identical
    to node_abundances_device over all the rows."""
    t = build_padded_tables(nodes_len, trio_index.trio_len,
                            trio_index.trio_nodes)
    acc = species_accumulators(packed_local, t, device)
    return finalize_species(cross_process_sum(acc), t, device)
