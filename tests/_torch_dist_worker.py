"""Worker process of tests/test_torch_distributed.py: one rank of a
torch.distributed gloo group on the CPU, running the port only.

    python tests/_torch_dist_worker.py cov <rank> <n> <port> <out.npz>
    python tests/_torch_dist_worker.py cli <rank> <n> <port> <run_dir>
        <chunk_bytes> <group_bases> <pantax-gpu args...>

``cov`` runs distributed_node_abundances on its block of the rows of
make_inputs() (the generator of tests/_dist_worker.py over the port's
PackedReads) and saves the merged arrays; ``cli`` runs pantax-gpu
--distributed 127.0.0.1:<port>,<n>,<rank> --device cpu in <run_dir> with
the module constants CHUNK_BYTES and GROUP_BASES (and MIN_GROUP_BASES)
set as given, and exits with its code.
"""
import os
import sys

import numpy as np

# a hang fails the test (the parent also kills the process at its timeout)
GLOO_TIMEOUT_S = 120


def make_inputs(seed: int = 0, R: int = 200, N: int = 61, L: int = 7):
    """tests/_dist_worker.make_inputs, over the port's PackedReads."""
    from pantax_tpu_torch._host import PackedReads

    rng = np.random.default_rng(seed)
    nodes_len = rng.integers(5, 60, size=N)
    nod = np.full((R, L), -1, np.int64)
    lens = rng.integers(1, L + 1, R)
    for i in range(R):
        s = rng.integers(0, N - 1)
        nod[i, : lens[i]] = np.arange(s, s + lens[i]) % N
    packed = PackedReads(
        nodes=nod,
        lengths=lens.astype(np.int64),
        read_start=rng.integers(0, 5, R).astype(np.int64),
        read_end=rng.integers(40, 200, R).astype(np.int64),
    )
    paths = {
        "h1": np.arange(0, N - 10, dtype=np.int64),
        "h2": np.concatenate([np.arange(0, 20), np.arange(30, N)]).astype(np.int64),
    }
    return packed, nodes_len, paths


def coverage(rank: int, n: int, port: str, out: str) -> None:
    from pantax_tpu_torch._host import PackedReads, build_trio_index
    from pantax_tpu_torch.parallel.distributed import (
        distributed_node_abundances, init_distributed,
    )

    init_distributed(f"127.0.0.1:{port}", n, rank, device="cpu")
    packed, nodes_len, paths = make_inputs()
    ti = build_trio_index(nodes_len, paths)
    # unequal blocks of two ranks: rank 0 takes the first 60 rows
    sl = slice(0, 60) if rank == 0 else slice(60, None)
    local = PackedReads(nodes=packed.nodes[sl], lengths=packed.lengths[sl],
                        read_start=packed.read_start[sl],
                        read_end=packed.read_end[sl])
    na, ta, bc = distributed_node_abundances(local, nodes_len, ti,
                                             device="cpu")
    np.savez(f"{out}.p{rank}", na=na, ta=ta, bc=bc)


def cli(rank: int, n: int, port: str, run_dir: str, chunk_bytes: str,
        group_bases: str, argv: list) -> int:
    from pantax_tpu_torch import cli as port_cli
    from pantax_tpu_torch.parallel import distributed

    distributed.TIMEOUT_S = GLOO_TIMEOUT_S
    port_cli.CHUNK_BYTES = int(chunk_bytes)
    port_cli.GROUP_BASES = port_cli.MIN_GROUP_BASES = int(group_bases)
    os.makedirs(run_dir, exist_ok=True)
    os.chdir(run_dir)
    return port_cli.main([*argv, "--device", "cpu", "--distributed",
                          f"127.0.0.1:{port},{n},{rank}"])


def main() -> int:
    import torch

    torch.set_num_threads(1)
    mode, rank, n, port = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), \
        sys.argv[4]
    if mode == "cov":
        from pantax_tpu_torch.parallel import distributed

        distributed.TIMEOUT_S = GLOO_TIMEOUT_S
        coverage(rank, n, port, sys.argv[5])
        return 0
    return cli(rank, n, port, *sys.argv[5:8], sys.argv[8:])


if __name__ == "__main__":
    sys.exit(main())
