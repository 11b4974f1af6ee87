"""The benchmark of pantax_tpu_torch: whole samples profiled through the
``pantax-gpu`` command line, from FASTQ files to the species and strain
tables, on one card.

    python -m pantax_bench.run --workload ecoli9.short --seed 1 \\
        --seconds 51 --trace 0

``BENCHMARK.json`` at the repository root names the cells; each cell's
configuration, traffic mix, limits and per-layer metrics are files of
their own under this package (``configs/``, ``traffic/``, ``workloads/``,
``metrics/``), found by name.  Nothing here imports JAX or the JAX
package, and ``reference/`` imports nothing of the port.
"""
