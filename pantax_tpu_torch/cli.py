"""pantax-gpu command-line interface, the port's counterpart of
pantax_tpu/cli.py.

    pantax-gpu -f genomes_info.txt -s -r reads.fq --species --strain
    python -m pantax_tpu_torch.cli --device cpu -s --fastpath -r reads.fq

The flags, defaults and exit codes are the reference CLI's (database
construction -f/--create, alignment indexing --index, read profiling -s/-l,
-r, --species/--strain, and the tuning knobs), plus ``--device``: every
flow runs on ``cuda`` (the default; no GPU is an error, never a CPU run)
or, where asked, on ``cpu`` through the kernels' plain versions.  Stage
skipping is file-existence driven (PanTax's main.rs:195-230): rerunning
resumes where outputs are missing unless --force.

More than one device: ``--mesh N`` shards every read batch over N local
cards (on --device cpu, N CPU replicas), and ``--distributed HOST:PORT,N,I``
runs this process as process I of N of one run (a torch.distributed gloo
group; each process drives card I % the local card count).  On the
--fastpath flows each process takes its share of the reads (the byte-range
shard of each single-end file, the round-robin chunks of paired input, the
round-robin read groups of long reads), the coverage accumulators are
summed across processes before the finalize and the per-read columns
gathered in process order; process 0 writes the outputs.  Integer coverage
sums make every such run's coverage, and so its species and strain
tables, bit-identical to one device's.  reads_classification.tsv lists
the reads in one process's order only for one uncompressed single-end
file; otherwise its rows are a one-process run's, permuted.
"""
from __future__ import annotations

import argparse
import dataclasses
import logging
import os
import shutil
import sys
import time
from pathlib import Path

log = logging.getLogger("pantax_tpu_torch")

# the read files' stream granularity (record-aligned buffers of about this
# many bytes), also the round-robin unit of paired input under
# --distributed; a module constant, so tests can cut files into many chunks
CHUNK_BYTES = 64 << 20
# the long-read flow's read groups (total bases; align/long_read.py's
# DEFAULT_GROUP_BASES); under --distributed they are the round-robin unit,
# GROUP_BASES / N but no smaller than MIN_GROUP_BASES
GROUP_BASES = 1 << 30
MIN_GROUP_BASES = 64 << 20


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="pantax-gpu",
        description="GPU pangenome-graph strain-level metagenomic profiler",
    )
    from . import __version__

    p.add_argument("--version", action="version",
                   version=f"pantax-gpu {__version__}")
    g = p.add_argument_group("general")
    g.add_argument("-f", "--genomesInformation", dest="genomes_info",
                   help="genomes_info.txt (5 tab columns with header)")
    g.add_argument("-d", "--db", default="pantax_db", help="database directory")
    g.add_argument("-s", "--short-read", action="store_true", dest="short_read")
    g.add_argument("-l", "--long-read", action="store_true", dest="long_read")
    g.add_argument("-p", "--paired", action="store_true",
                   help="paired short reads: two files (R1 R2) or one "
                        "interleaved file; mates are aligned jointly with a "
                        "fragment model (consistency bonus + weak-mate rescue)")
    g.add_argument("-r", "--reads", nargs="+", default=[], help="FASTQ/FASTA file(s)")
    g.add_argument("--species", action="store_true")
    g.add_argument("--strain", action="store_true")
    g.add_argument("-t", "--threads", type=int, default=8)
    g.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the alignment and profiling run: the GPU "
                        "(default; fails without one) or the CPU, through "
                        "the kernels' plain versions")

    c = p.add_argument_group("database construction")
    c.add_argument("--create", action="store_true", help="build database and exit")
    c.add_argument("--index", action="store_true", help="build alignment index and exit")
    c.add_argument("--warm-kernels", action="store_true",
                   help="with --index: also build the CUDA kernels and run "
                        "one batch of the query, the fused step and the "
                        "device profile tail (the long-read chunk query and "
                        "extension with -l), so their first uses are paid")
    c.add_argument("--base-dir", default=None,
                   help="directory genome paths resolve against (default: cwd)")
    c.add_argument("--fast", action="store_true", dest="fast_query",
                   help="screen genomes against the read sample by containment "
                        "ANI before building the database")
    c.add_argument("-A", "--ani", type=float, default=99.0,
                   help="--fast mode: min coverage-adjusted ANI to keep a genome")
    c.add_argument("--qt", action="store_true", dest="query_and_filter",
                   help="only run the --fast genome screen and exit "
                        "(writes the filtered genomes_info)")
    c.add_argument("--syldb", default=None,
                   help="genome sketch cache directory (built on first use)")
    c.add_argument("--export-gfa", default=None, metavar="PATH",
                   help="write the combined pangenome GFA (global node ids) "
                        "and exit (reference_pangenome.gfa interop)")
    c.add_argument("--gfa-dir", default=None,
                   help="directory of externally built <taxid>.gfa species "
                        "graphs (e.g. pggb) to import instead of constructing")

    a = p.add_argument_group("alignment")
    a.add_argument("--long-read-type", default="hifi",
                   choices=["hifi", "ontr10", "ontr9", "clr"],
                   help="sets chunking and DP band width (GraphAligner's "
                        "--precise-clipping analog, alignment.rs:144-165)")
    a.add_argument("--batch-size", type=int, default=None,
                   help="reads per device dispatch (default: 65536 short, "
                        "16384 long)")
    a.add_argument("--mesh", default="auto", metavar="auto|off|N",
                   help="shard read batches over N local cards (on --device "
                        "cpu, N CPU replicas); 'auto' meshes every local "
                        "card when more than one is visible (not under "
                        "--distributed), 'off' and 1 run on one device")
    a.add_argument("--distributed", default=None, metavar="HOST:PORT,N,I",
                   help="run as process I of N (coordinator address "
                        "HOST:PORT, served by process 0; torch.distributed "
                        "over gloo); --fastpath flows only, process 0 "
                        "writes the outputs (the classification rows in "
                        "one process's order only for one uncompressed "
                        "single-end file)")
    a.add_argument("--coverage", default="auto",
                   choices=["auto", "host", "device"],
                   help="strain coverage engine (device = torch on --device)")
    a.add_argument("--tail", default="auto",
                   choices=["auto", "host", "device"],
                   help="fused profile tail: keep na/ta/bc on device "
                        "(device) or download and filter on host (host)")
    a.add_argument("--fastpath", action="store_true",
                   help="array-native profiling without writing the GAF "
                        "artifact (short reads resume from "
                        "alignment_arrays.npz)")

    q = p.add_argument_group("profiling")
    q.add_argument("-a", dest="min_species_abundance", type=float, default=1e-4)
    q.add_argument("--fr", dest="unique_trio_nodes_fraction", type=float, default=None,
                   help="min covered fraction of a strain's unique trio nodes "
                        "(default 0.3 short / 0.5 long)")
    q.add_argument("--fc", dest="unique_trio_nodes_count", type=float, default=0.46)
    q.add_argument("--sr", dest="single_cov_ratio", type=float, default=0.85)
    q.add_argument("--sd", dest="single_cov_diff", type=float, default=0.2)
    q.add_argument("--min_cov", type=float, default=0.0)
    q.add_argument("--min_depth", type=float, default=0.0)
    q.add_argument("--shift", default=None, choices=[None, "true", "false"])
    q.add_argument("--no_filter", action="store_true",
                   help="disable the species mapq credibility filter")
    q.add_argument("--sample", dest="sample_nodes", type=int, default=500000)
    q.add_argument("--sample_test", action="store_true")
    q.add_argument("--ds", dest="designated_species", default=None,
                   help="comma-separated species taxids to profile")
    q.add_argument("--smode", type=int, default=2)
    q.add_argument("--solver", default="admm", choices=["admm", "highs"])

    o = p.add_argument_group("output")
    o.add_argument("-T", "--tmp-dir", default="pantax_db_tmp")
    o.add_argument("-o", "--output", dest="pantax_output", default=None,
                   help="output file prefix")
    o.add_argument("-R", "--report", dest="pantax_report", default=None,
                   help="reads classification output file")
    o.add_argument("-n", "--next", action="store_true", dest="next_for_strain",
                   help="keep tmp dir for a later --strain run")
    o.add_argument("--force", action="store_true")
    o.add_argument("--debug", action="store_true")
    o.add_argument("-v", "--verbose", action="store_true")
    o.add_argument("--log-dir", default=None, help="also write a log file here")
    o.add_argument("--log_m", default=None, help="log file name discriminant")
    o.add_argument("--trace-dir", default=None,
                   help="write a torch.profiler trace of the alignment stage")
    return p


def main(argv: list[str] | None = None) -> int:
    try:
        return _main(argv)
    except FileNotFoundError as e:
        print(f"pantax-gpu: file not found: {e}", file=sys.stderr)
        return 1
    except ValueError as e:
        print(f"pantax-gpu: {e}", file=sys.stderr)
        return 1


def _main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    if args.batch_size is None:
        # the reference's defaults: the long-read [B, chunk] DP at 16384
        # rows, short reads at the wide batch that amortizes the seed stage
        args.batch_size = 16384 if args.long_read else 65536
    from .utils.logging import setup_logging

    setup_logging(args.log_dir, args.log_m, args.verbose)
    t0 = time.time()

    if args.distributed and args.reads and not args.fastpath:
        # the reference's own refusal: the per-species GAF flow has no
        # process sharding (every process would redo the whole alignment
        # and race on the same output files)
        log.error("--distributed requires --fastpath (the per-species "
                  "GAF flow is single-process; rerun with --fastpath "
                  "or drop --distributed)")
        return 2
    try:
        return _run(args, t0)
    finally:
        if args.distributed:
            import torch.distributed as dist

            if dist.is_initialized():
                dist.destroy_process_group()


def _run(args, t0: float) -> int:
    """_main after the argument checks: the device, the process group and
    the mesh, then the flows."""
    import torch

    from .utils.logging import device_trace, stage_timer

    if args.device == "cuda":
        from .device import require_cuda

        try:
            dev = require_cuda()
        except RuntimeError as e:
            log.error("%s; pass --device cpu to run on the CPU", e)
            return 1
    else:
        dev = torch.device("cpu")
    if args.distributed:
        from .parallel.distributed import init_distributed, parse_spec

        coord, n_proc, proc_id = parse_spec(args.distributed)
        dev = init_distributed(coord, n_proc, proc_id, device=dev)
        log.info("distributed runtime: process %d of %d", proc_id, n_proc)
    log.info("device: %s", torch.cuda.get_device_name(dev)
             if dev.type == "cuda" else "cpu")
    from .parallel import auto_mesh

    # under --distributed each process drives its own card, so "auto"
    # builds no mesh there
    mesh = auto_mesh("off" if args.distributed and args.mesh == "auto"
                     else args.mesh, dev)
    if mesh is not None:
        log.info("device mesh: %s; read batches sharded over it",
                 ", ".join(map(str, mesh)))

    from .db.construct import DatabasePaths, build_database, load_database

    db_path = Path(args.db)
    if args.genomes_info:
        genomes_info = args.genomes_info
        if args.fast_query and args.reads:
            # --fast: pre-screen genomes against the read sample
            # (construct.rs:22-63 semantics via containment sketches)
            from .db.sketch import fast_query_filter, sketch_genomes
            from .io.metadata import read_genomes_info, write_genomes_info

            infos = read_genomes_info(genomes_info)
            base = args.base_dir or os.getcwd()
            sketches = sketch_genomes(
                infos, base, cache_dir=args.syldb or str(db_path) + "_sketches"
            )
            kept_ids = set(
                fast_query_filter(args.reads, sketches, min_ani=args.ani)
            )
            kept = [gi for gi in infos if gi.genome_id in kept_ids]
            log.info("--fast: kept %d/%d genomes at ANI >= %.1f",
                     len(kept), len(infos), args.ani)
            if not kept:
                log.error("--fast removed every genome; lower --ani")
                return 1
            db_path = Path(str(db_path) + "_fast")
            db_path.mkdir(parents=True, exist_ok=True)
            genomes_info = db_path / "genomes_info_fast_input.txt"
            write_genomes_info(genomes_info, kept)
            if args.query_and_filter:
                # --qt: screen only, no build (main.rs:208-210,
                # construct.rs:22-63 fast_query_and_filter)
                log.info("--qt: filtered genomes_info at %s", genomes_info)
                return 0
        db = build_database(
            genomes_info, db_path, threads=args.threads,
            force=args.force and not DatabasePaths(db_path).is_complete(),
            base_dir=args.base_dir, gfa_dir=args.gfa_dir,
        )
    else:
        db = load_database(db_path)
    if args.export_gfa:
        db.export_gfa(args.export_gfa)
        log.info("combined GFA written to %s", args.export_gfa)
        return 0
    if args.create:
        log.info("database ready at %s (%.1fs)", db.root, time.time() - t0)
        return 0

    from .align.index import build_align_index

    index = build_align_index(db)
    log.info("alignment index: %d seeds over %d bases", index.num_seeds, index.text_len)
    if args.index:
        if args.warm_kernels:
            _warm_kernels(args, db, index, dev, mesh)
        return 0

    if not args.reads:
        log.error("no reads given (-r) and not --create/--index")
        return 2
    if not (args.short_read or args.long_read):
        log.error("specify read type: -s (short) or -l (long)")
        return 2
    if not (args.species or args.strain):
        args.species = args.strain = True

    tmp = Path(args.tmp_dir)
    tmp.mkdir(parents=True, exist_ok=True)
    gaf_file = tmp / "gfa_mapped.gaf"

    if args.fastpath and args.short_read:
        return _run_fastpath(args, db, index, tmp, t0, dev, mesh)
    if args.fastpath and args.long_read:
        return _run_fastpath_long(args, db, index, tmp, t0, dev, mesh)

    from .io.gaf import filter_best_long_read_alignments, read_gaf, write_gaf

    if gaf_file.exists() and not args.force:
        log.info("- Alignment exists (%s), skipping...", gaf_file)
        gaf = read_gaf(gaf_file)
    else:
        aligner = _aligner(index, "long" if args.long_read else "short", dev,
                           mesh)
        with stage_timer("alignment"), device_trace(args.trace_dir):
            if args.short_read:
                gaf = []
                if args.paired and len(args.reads) == 2:
                    gaf = aligner.align_paired_files(
                        args.reads[0], args.reads[1], batch_size=args.batch_size
                    )
                elif args.paired and len(args.reads) == 1:
                    gaf = aligner.align_paired_files(
                        args.reads[0], None, batch_size=args.batch_size
                    )
                else:
                    for rf in args.reads:
                        gaf.extend(aligner.align_file(rf, batch_size=args.batch_size))
            else:
                from .align.long_read import (
                    LONG_READ_PRESETS, LONG_READ_SEED_STRIDE,
                    align_long_reads, iter_read_groups,
                )

                # streamed in bounded read groups (GraphAligner streams from
                # disk, alignment.rs:144-165); per-group alignment is exact
                # because chunk merging is per read
                chunk = LONG_READ_PRESETS[args.long_read_type]
                gaf = []
                for group in iter_read_groups(args.reads):
                    gaf.extend(align_long_reads(
                        aligner, group, chunk=chunk,
                        batch_size=args.batch_size,
                        seed_stride=LONG_READ_SEED_STRIDE[args.long_read_type],
                    ))
                gaf = filter_best_long_read_alignments(gaf)
        write_gaf(gaf_file, gaf)
        log.info("- Aligned %d reads", len(gaf))

    from .pipeline import profile_from_gaf

    read_type = "short" if args.short_read else "long"
    cfg = _profiling_config(args, db, tmp, read_type,
                            species=args.species, strain=args.strain)
    with stage_timer("profiling"):
        profile_from_gaf(gaf, db, cfg, tmp, force=args.force, device=dev,
                         mesh=mesh)

    return _emit_outputs(args, tmp, args.species, args.strain, t0)


def _aligner(index, read_type: str, dev, mesh):
    from .config import AlignConfig
    from .convert import aligner_from_reference
    from .utils.logging import stage_timer

    with stage_timer("aligner (seed lookup, index tables on the device)"):
        return aligner_from_reference(
            index, AlignConfig.for_read_type(read_type), dev, mesh)


def _warm_kernels(args, db, index, dev, mesh) -> None:
    """--index --warm-kernels: build K1-K3, K6 and K11 (on a card), then
    run one batch of each device path the profiling flows take, so a later
    run pays no first use: the query over all-N reads of zero and of full
    length, and on the short path the fused step and the device profile
    tail over a uniform coverage; on the long path the chunk query and
    the seed-free extension at the preset chunk."""
    import numpy as np
    import torch

    from .utils.logging import stage_timer

    if dev.type == "cuda":
        from .ops.extend import build_kernels
        from .ops.scatter import build_scatter_kernels
        from .ops.seed import build_seed_kernel

        with stage_timer("kernel build (K1, K2, K3, K6, K11)"):
            build_kernels()
            build_seed_kernel()
            build_scatter_kernels()
    aligner = _aligner(index, "long" if args.long_read else "short", dev, mesh)
    B = args.batch_size
    if args.long_read:
        from .align.long_read import LONG_READ_PRESETS

        chunk = LONG_READ_PRESETS[args.long_read_type]
        with stage_timer(f"kernel warmup (long-read {chunk}bp)"):
            zc = np.full((B, chunk), 4, dtype=np.int8)
            for lens in (np.zeros(B, np.int64), np.full(B, chunk, np.int64)):
                aligner.align_codes(zc, lens)
                aligner.extend_packed(zc, lens, np.zeros(B, np.int64),
                                      np.zeros(B, np.int8)).cpu()
        return
    from .config import ProfilingConfig
    from .ops.fused import (
        FusedPipeline, FusedResult, _device_tail_solve, _ensure_tail_tables,
        build_fused_tables,
    )
    from .ops.profile_tail import dispatch_tail_stats

    with stage_timer("kernel warmup (query + fused step)"):
        zc = np.full((B, 160), 4, dtype=np.int8)
        tables = build_fused_tables(db, index, dev, aligner.segment_lookup)
        pipe = FusedPipeline(aligner, tables, B)
        for lens in (np.zeros(B, np.int64), np.full(B, 160, np.int64)):
            aligner.align_codes(zc, lens)
            pipe.feed(zc, lens)
        pipe.finish()
    with stage_timer("kernel warmup (device profile tail)"):
        # a uniform coverage passes every strain through the first filter,
        # so every species' solve runs
        cfg = ProfilingConfig.for_read_type("short")
        fake = FusedResult(
            torch.ones(tables.N_pad, dtype=torch.float32, device=dev),
            torch.ones(tables.U_pad, dtype=torch.float32, device=dev),
            torch.ones(tables.N_pad, dtype=torch.int32, device=dev),
            {"aligned": np.ones(1, bool)}, 0,
        )
        stats = dispatch_tail_stats(_ensure_tail_tables(tables), fake.na_d,
                                    fake.ta_d, fake.bc_d, cfg.min_depth)
        _device_tail_solve(tables, cfg, list(tables.species), fake, stats)


def _profiling_config(args, db, tmp: Path, read_type: str, *,
                      species: bool, strain: bool):
    """Shared ProfilingConfig construction for the GAF and fastpath flows.

    Resolves the data-dependent defaults exactly once so both paths agree:
    fr = 0.3 short / 0.5 long when unset (explicit --fr 0.0 is honored), and
    the reference's shift quirk — shift on iff the range file is empty —
    unless --shift overrides (main.rs:107-124 parity).
    """
    from .config import ProfilingConfig

    fr = args.unique_trio_nodes_fraction
    if fr is None:
        fr = 0.3 if read_type == "short" else 0.5
    if args.shift is not None:
        shift = args.shift == "true"
    else:
        with open(db.range_file) as f:
            shift = not any(True for _ in f)
    return ProfilingConfig(
        db=db.root,
        wd=tmp,
        min_species_abundance=args.min_species_abundance,
        unique_trio_nodes_fraction=fr,
        unique_trio_nodes_mean_count_f=args.unique_trio_nodes_count,
        single_cov_ratio=args.single_cov_ratio,
        single_cov_diff=args.single_cov_diff,
        min_cov=args.min_cov,
        min_depth=args.min_depth,
        species=species,
        strain=strain,
        filtered=not args.no_filter,
        sample_nodes=args.sample_nodes,
        sample_test=args.sample_test,
        designated_species=(
            [s.strip() for s in args.designated_species.split(",") if s.strip()]
            if args.designated_species else None
        ),
        mode=args.smode,
        solver=args.solver,
        coverage=args.coverage,
        tail=args.tail,
        shift=shift,
        read_type=read_type,
    )


def _codes_matrix(codes_flat, offsets, pad):
    """(codes int8 [n, pad] padded with 4, lens int64 [n]) of the parser's
    concatenated codes and record offsets."""
    import numpy as np

    from .align.aligner import _code_matrix

    lens = np.diff(offsets).astype(np.int64)
    return _code_matrix(codes_flat[: int(lens.sum())], lens, pad), lens


def _run_fastpath_long(args, db, index, tmp: Path, t0: float, dev,
                       mesh) -> int:
    """Array-native long-read flow: chunked alignment -> merged per-read
    intervals -> fused interval profiling (the same accumulators and tails
    as short reads; FusedPipeline.feed_intervals).  The best-alignment
    filter's thresholds (gaf_filter.rs:44-97) are applied inside
    align_long_reads.  Each bounded read group is aligned and fed in
    turn, so host memory never holds the whole input (GraphAligner's
    streaming role, alignment.rs:144-165).  Under --distributed the read
    groups go round-robin over the processes (a byte-range shard would
    cut multi-line FASTA records), at GROUP_BASES / N bases a group but
    no fewer than MIN_GROUP_BASES; a process may own no group."""
    from .align.long_read import (
        LONG_READ_PRESETS, LONG_READ_SEED_STRIDE, align_long_reads,
        iter_read_groups,
    )
    from .ops.fused import (
        FusedPipeline, build_fused_tables, profile_from_fused_result,
    )
    from .parallel.distributed import process_count, process_index
    from .utils.logging import stage_timer

    n_proc, rank = process_count(), process_index()
    group_bases = (GROUP_BASES if n_proc == 1
                   else max(GROUP_BASES // n_proc, MIN_GROUP_BASES))
    aligner = _aligner(index, "long", dev, mesh)
    with stage_timer("fused tables"):
        tables = build_fused_tables(db, index, dev, aligner.segment_lookup)
    pipe = FusedPipeline(aligner, tables, batch=args.batch_size)
    with stage_timer("long-read alignment+coverage (fastpath)"):
        for gi, group in enumerate(iter_read_groups(args.reads,
                                                    group_bases)):
            if gi % n_proc != rank:
                continue
            merged = align_long_reads(
                aligner, group, chunk=LONG_READ_PRESETS[args.long_read_type],
                batch_size=args.batch_size,
                seed_stride=LONG_READ_SEED_STRIDE[args.long_read_type],
                as_arrays=True,
            )
            pipe.feed_intervals(
                merged.ts, merged.te, merged.mapq, merged.read_len,
                ids=merged.read_ids,
            )

    cfg = _profiling_config(args, db, tmp, "long",
                            species=True,
                            strain=args.strain or not args.species)
    with stage_timer("profiling (fused intervals)"):
        result = _finish(pipe)
        if result is None:
            return 0
        log.info("- Aligned %d reads", len(result.reads["mapq"]))
        profile_from_fused_result(result, tables, index, db, cfg, tmp)

    return _emit_outputs(args, tmp, True, cfg.strain, t0)


def _run_fastpath(args, db, index, tmp: Path, t0: float, dev, mesh) -> int:
    """Array-native short-read flow: parse -> align -> profile, no GAF text.
    Input streams in record-aligned buffers (bounded memory); the alignment
    arrays are checkpointed to <tmp>/alignment_arrays.npz for resume."""
    import numpy as np

    from .fastpath import AlignmentArrays, profile_from_alignments
    from .utils.logging import stage_timer
    from .utils.native import load_native

    arrays_file = tmp / "alignment_arrays.npz"
    if arrays_file.exists() and not args.force:
        log.info("- Alignment exists (%s), skipping...", arrays_file)
        with np.load(arrays_file) as z:
            merged = AlignmentArrays(
                read_ids=[str(s) for s in z["read_ids"]],
                ts=z["ts"], te=z["te"], mapq=z["mapq"], read_len=z["read_len"],
            )
    else:
        if load_native() is None:
            log.error("--fastpath requires the native parser; rerun without it")
            return 1
        # fused flow: align+classify+coverage per batch (ops/fused.py;
        # paired mode uses the joint fragment-model step); the resume
        # artifact and all outputs are those of the per-species flow
        return _run_fastpath_fused(args, db, index,
                                   _aligner(index, "short", dev, mesh),
                                   tmp, t0, arrays_file)
    log.info("- Aligned %d reads", len(merged.read_ids))

    cfg = _profiling_config(args, db, tmp, "short",
                            species=True,
                            strain=args.strain or not args.species)
    with stage_timer("profiling"):
        profile_from_alignments(merged, index, db, cfg, tmp, device=dev,
                                mesh=mesh)

    return _emit_outputs(args, tmp, True, cfg.strain, t0)


def _run_fastpath_fused(args, db, index, aligner, tmp: Path, t0: float,
                        arrays_file: Path) -> int:
    """Streaming fused flow: parse buffers -> fused align+coverage steps ->
    per-species-slice profiling.  Writes the same alignment_arrays.npz
    resume artifact as the per-species flow.

    Under --distributed each process feeds its byte-range shard of each
    single-end file (io/fastx.shard_fastx_buffers), or every N-th chunk of
    paired input (a byte range of two mate files, or of one interleaved
    file, would split pairs), and no resume artifact is written: the
    processes' shards do not make one."""
    import numpy as np

    from .align.aligner import _parse_chunk, _round_up
    from .io.fastx import (
        shard_fastx_buffers, stream_fastx_buffers, stream_paired_parsed,
    )
    from .ops.fused import (
        FusedPipeline, build_fused_tables, profile_from_fused_result,
    )
    from .parallel.distributed import process_count, process_index
    from .utils.logging import stage_timer

    n_proc, rank = process_count(), process_index()

    def buffers(rf):
        if n_proc > 1:
            return shard_fastx_buffers(rf, rank, n_proc, CHUNK_BYTES)
        return stream_fastx_buffers(rf, CHUNK_BYTES)

    with stage_timer("fused tables"):
        tables = build_fused_tables(db, index, aligner.device,
                                    aligner.segment_lookup)
    pipe = FusedPipeline(aligner, tables, batch=args.batch_size)

    with stage_timer("alignment+coverage (fused)"):
        if args.paired and len(args.reads) in (1, 2):
            # r2=None is the reference's interleaved ShortReadPairedInter
            # mode (types.rs:34-48): mates are adjacent records,
            # de-interleaved by the shared streamer and fed through the
            # same joint fragment-model step as two-file mode; the pad is
            # the wider mate's, and --batch-size counts pairs
            r2 = args.reads[1] if len(args.reads) == 2 else None
            for ci, block in enumerate(stream_paired_parsed(
                    args.reads[0], r2, _parse_chunk, CHUNK_BYTES)):
                if ci % n_proc != rank:
                    continue
                cf1, of1, ids1, cf2, of2, ids2 = block
                if len(ids1) == 0:
                    continue
                pad = _round_up(int(max(np.diff(of1).max(),
                                        np.diff(of2).max())))
                c1, l1 = _codes_matrix(cf1, of1, pad)
                c2, l2 = _codes_matrix(cf2, of2, pad)
                pipe.feed_paired(c1, l1, c2, l2, ids1=ids1, ids2=ids2)
        else:
            for rf in args.reads:
                for buf in buffers(rf):
                    codes_flat, offsets, ids = _parse_chunk(rf, buf)
                    if len(ids) == 0:
                        continue
                    pad = _round_up(int(np.diff(offsets).max()))
                    codes, lens = _codes_matrix(codes_flat, offsets, pad)
                    pipe.feed(codes, lens, ids=ids)
        result = _finish(pipe)
        if result is None:
            return 0

    reads = result.reads
    keep_rows = np.flatnonzero(reads["aligned"])
    ids = reads["ids"]
    if n_proc == 1:
        read_ids = (np.asarray(ids, dtype=np.str_)[keep_rows]
                    if ids is not None
                    else np.char.add("R", keep_rows.astype(np.str_)))
        np.savez(
            arrays_file,
            read_ids=np.asarray(read_ids, dtype=np.str_),
            ts=reads["ts"][keep_rows].astype(np.int64),
            te=reads["te"][keep_rows].astype(np.int64),
            mapq=reads["mapq"][keep_rows].astype(np.int64),
            read_len=reads["read_len"][keep_rows].astype(np.int64),
        )
    log.info("- Aligned %d reads", len(keep_rows))

    cfg = _profiling_config(args, db, tmp, "short",
                            species=True,
                            strain=args.strain or not args.species)
    with stage_timer("profiling"):
        profile_from_fused_result(result, tables, index, db, cfg, tmp)

    return _emit_outputs(args, tmp, True, cfg.strain, t0)


def _finish(pipe):
    """pipe.finish(); under --distributed with the coverage accumulators
    summed across the processes and every process's per-read columns
    gathered in process order: the merged result on process 0, None (after
    a log line) on the others, which write nothing."""
    from .parallel.distributed import (
        cross_process_sum, gather_read_rows, process_count, process_index,
    )
    from .utils.logging import stage_timer

    if process_count() == 1:
        return pipe.finish()
    with stage_timer("cross-process merge (accumulators, read columns)"):
        result = pipe.finish(process_reduce=cross_process_sum)
        reads = gather_read_rows(result.reads)
    if process_index() != 0:
        log.info("- process %d: %d reads in its share, merged; process 0 "
                 "writes the outputs", process_index(),
                 len(result.reads["mapq"]))
        return None
    return dataclasses.replace(result, reads=reads)


def _emit_outputs(args, tmp, species: bool, strain: bool, t0: float) -> int:
    """Move result tables out of the tmp dir (handle_res parity,
    main.rs:60-100) and clean up."""
    prefix = f"{args.pantax_output}_" if args.pantax_output else ""
    if species:
        _copy(tmp / "species_abundance.txt",
              Path(f"{prefix}species_abundance.txt"))
    if strain:
        _copy(tmp / "strain_abundance.txt",
              Path(f"{prefix}strains_abundance.txt" if prefix
                   else "strain_abundance.txt"))
    if args.pantax_report:
        _copy(tmp / "reads_classification.tsv", Path(args.pantax_report))
    if not args.next_for_strain and not args.debug:
        shutil.rmtree(tmp, ignore_errors=True)
    log.info("- Done in %.1fs", time.time() - t0)
    return 0


def _copy(src: Path, dst: Path) -> None:
    if src.exists() and src.resolve() != dst.resolve():
        shutil.copy(src, dst)


if __name__ == "__main__":
    sys.exit(main())
