"""The port's byte-range shard reader (pantax_tpu_torch/io/fastx.py:
shard_fastx_buffers, iter_fastx_shard, _next_record_start) against the
JAX package's: the buffers of every process byte-equal to the
reference's for the same (path, process, P, chunk_bytes) on FASTQ, FASTA
(multi-line records) and gzip input at P = 1, 2, 3 and 5, and the
processes' records together the whole file's, in order."""
import numpy as np
import pytest

from pantax_tpu.io import fastx as ref_fastx
from pantax_tpu_torch.io import fastx

from _torch_helpers import write_reads

CHUNK = 3000  # bytes: several buffers per process


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The same 600 reads (40-300 bases, some quality lines starting with
    '@') as FASTQ, as FASTA of 60-column lines, and as gzipped FASTQ."""
    root = tmp_path_factory.mktemp("shard")
    rng = np.random.default_rng(11)
    seqs = [bytes(rng.choice(list(b"ACGT"), size=int(n)))
            for n in rng.integers(40, 300, size=600)]
    ids = [f"r{i}" for i in range(len(seqs))]
    paths = {}
    for name, fmt in (("reads.fq", "fq"), ("reads.fa", "fa"),
                      ("reads.fq.gz", "fq")):
        write_reads(root / name, ids, seqs, fmt)
        paths[name] = root / name
    # a quality line that starts with '@' must not read as a header
    fq = paths["reads.fq"]
    lines = fq.read_bytes().split(b"\n")
    for j in range(3, len(lines) - 1, 40):
        lines[j] = b"@" + lines[j][1:]
    fq.write_bytes(b"\n".join(lines))
    return paths, ids


@pytest.mark.parametrize("P", [1, 2, 3, 5])
@pytest.mark.parametrize("name", ["reads.fq", "reads.fa", "reads.fq.gz"])
def test_shard_buffers_equal_reference(files, name, P):
    paths, ids = files
    path = paths[name]
    got_ids = []
    for i in range(P):
        ours = list(fastx.shard_fastx_buffers(path, i, P, chunk_bytes=CHUNK))
        theirs = list(ref_fastx.shard_fastx_buffers(path, i, P,
                                                    chunk_bytes=CHUNK))
        assert ours == theirs, (i, P)
        assert list(fastx.iter_fastx_shard(path, i, P)) == list(
            ref_fastx.iter_fastx_shard(path, i, P))
        got_ids += [rid for rid, _ in fastx.iter_fastx_shard(path, i, P)]
    assert got_ids == ids
    assert [r for i in range(P) for r in fastx.iter_fastx_shard(path, i, P)
            ] == list(fastx.iter_fastx(path))


@pytest.mark.parametrize("name", ["reads.fq", "reads.fa"])
def test_next_record_start_equal_reference(files, name):
    path = files[0][name]
    size = path.stat().st_size
    fastq = name.endswith(".fq")
    offsets = [0, 1, 2, 57, size // 3, size // 2, size - 5, size]
    with open(path, "rb") as f:
        ours = [fastx._next_record_start(f, o, size, fastq) for o in offsets]
    with open(path, "rb") as f:
        theirs = [ref_fastx._next_record_start(f, o, size, fastq)
                  for o in offsets]
    assert ours == theirs


def test_shard_rejects_bad_process_id(files):
    with pytest.raises(ValueError):
        list(fastx.shard_fastx_buffers(files[0]["reads.fq"], 2, 2))


def test_local_read_shard_outside_a_group_is_the_whole_file(files):
    from pantax_tpu_torch.parallel.distributed import local_read_shard

    path = files[0]["reads.fa"]
    assert list(local_read_shard(path)) == list(fastx.iter_fastx(path))
