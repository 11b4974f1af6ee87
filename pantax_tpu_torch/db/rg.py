"""pantax-gpu-rg: reference-genome database curation driver.

The equivalent of scripts/pantax-rg (PanTax's scripts/pantax-rg:184-254):
from a provided genomes_info.txt (or a directory of FASTAs plus a metadata
table), compute genome stats, deduplicate each species' genomes (graph or
hierarchical clustering over containment ANI), disambiguate strain taxids,
and emit the curated genomes_info.txt consumed by database construction.

The port's copy of pantax_tpu/db/rg.py.
"""
from __future__ import annotations

import argparse
import logging
import sys
from pathlib import Path

from ..io.metadata import (
    GenomeInfo, group_by_species, read_genomes_info, write_genomes_info,
)
from .preprocess import (
    assign_strain_taxids, cluster_species_genomes, genome_stats,
    hierarchical_cluster,
)
from .sketch import sketch_file

log = logging.getLogger("pantax_tpu_torch.rg")


def curate(
    infos: list[GenomeInfo],
    base_dir: str,
    mode: str = "graph",
    max_n: int = 10,
    top_m: int = 100,
    cutoff: float = 0.1,
) -> tuple[list[GenomeInfo], dict[str, list[str]]]:
    """Returns (curated infos, rep path -> clustered member paths)."""
    by_species = group_by_species(infos)
    kept: list[GenomeInfo] = []
    clusters: dict[str, list[str]] = {}
    for taxid, genomes in by_species.items():
        if len(genomes) == 1:
            kept.extend(genomes)
            continue
        paths = [g.resolved_path(base_dir) for g in genomes]
        by_path = {p: g for p, g in zip(paths, genomes)}
        stats = {p: genome_stats(p) for p in paths}
        sketches = {p: sketch_file(p) for p in paths}
        if mode == "hcls":
            selected, rep_to_cluster = hierarchical_cluster(
                paths, cutoff=cutoff, sketches=sketches
            )
        else:
            selected, rep_to_cluster = cluster_species_genomes(
                paths, stats, top_m=top_m, max_n=max_n, sketches=sketches
            )
        log.info("species %s: %d genomes -> %d after dedup", taxid,
                 len(genomes), len(selected))
        kept.extend(by_path[p] for p in paths if p in selected)
        clusters.update(rep_to_cluster)
    return assign_strain_taxids(kept), clusters


NCBI_SUMMARY_URL = (
    "https://ftp.ncbi.nlm.nih.gov/genomes/refseq/bacteria/assembly_summary.txt"
)


def download_assembly_summary(dest: Path) -> Path:
    """Fetch the NCBI RefSeq bacteria assembly_summary to ``dest`` (the
    reference driver wgets it when missing, pantax-rg:218-219).  Raises a
    helpful error when the host has no network access."""
    import urllib.error
    import urllib.request

    dest.parent.mkdir(parents=True, exist_ok=True)
    try:
        urllib.request.urlretrieve(NCBI_SUMMARY_URL, dest)  # noqa: S310
    except (urllib.error.URLError, OSError) as e:
        raise SystemExit(
            f"--download-summary failed ({e}): this host cannot reach NCBI. "
            f"Download {NCBI_SUMMARY_URL} elsewhere and pass it with "
            "--summary."
        ) from e
    log.info("downloaded assembly summary to %s", dest)
    return dest


def remove_plasmids(
    infos: list[GenomeInfo], base_dir: str, out_dir: Path,
    min_scaffold_mb: float = 1.0,
) -> list[GenomeInfo]:
    """Write plasmid/short-scaffold-filtered copies of each genome FASTA to
    ``out_dir`` and return infos pointing at them (the reference's --remove
    extraction stage, pantax-rg:86,130-150 ->
    scripts/genomes_process.py:193-231).  Genomes whose every scaffold falls
    below the cutoff are dropped with a warning (the reference logs the same
    condition)."""
    from ..io.fastx import iter_fastx, write_fasta
    from .preprocess import filter_plasmids

    out_dir.mkdir(parents=True, exist_ok=True)
    kept_infos: list[GenomeInfo] = []
    for gi in infos:
        src = gi.resolved_path(base_dir)
        kept = filter_plasmids(list(iter_fastx(src)),
                               min_scaffold_mb=min_scaffold_mb)
        if not kept:
            log.warning(
                "%s: every scaffold below %.1fMbp after plasmid removal; "
                "genome dropped", gi.genome_id, min_scaffold_mb,
            )
            continue
        dst = out_dir / Path(src).name
        write_fasta(dst, kept)
        kept_infos.append(GenomeInfo(
            gi.genome_id, gi.strain_taxid, gi.species_taxid,
            gi.organism_name, str(dst),
        ))
    log.info("plasmid removal: %d/%d genomes kept under %s",
             len(kept_infos), len(infos), out_dir)
    return kept_infos


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        prog="pantax-gpu-rg",
        description="curate a reference-genome set into genomes_info.txt",
    )
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("-c", "--custom",
                     help="input genomes_info.txt (5 tab columns with header)")
    src.add_argument("-r", "--genomes-dir",
                     help="directory of local genome FASTAs; taxonomy is "
                          "resolved from --summary (NCBI assembly_summary) "
                          "or --gtdb (GTDB metadata) — the pantax-rg "
                          "RefSeq/GTDB modes (pantax-rg:184-254)")
    p.add_argument("--summary", default=None,
                   help="NCBI assembly_summary.txt (strain/species taxids, "
                        "organism name, ftp-path-derived file names)")
    p.add_argument("--gtdb", default=None,
                   help="GTDB metadata TSV (gtdb_taxonomy species names; "
                        "strain taxids are synthesized from 5000001)")
    p.add_argument("--assembly-level", default="complete",
                   help="'complete' (default) or 'all' or an exact NCBI "
                        "assembly_level value")
    p.add_argument("--ds", "--species-clusters", dest="species_clusters",
                   default=None,
                   help="comma-separated species filter (NCBI species "
                        "taxids, or GTDB species names)")
    p.add_argument("-o", "--out", default="genomes_info.txt")
    p.add_argument("--cluster", choices=["graph", "hcls", "none"], default="graph")
    p.add_argument("--base-dir", default=None)
    p.add_argument("-n", "--max-n", type=int, default=10,
                   help="max genomes per species pangenome")
    p.add_argument("-m", "--top-m", type=int, default=100,
                   help="pre-rank cap per species by N50")
    p.add_argument("--cutoff", type=float, default=0.1,
                   help="hcls distance cutoff (100 - ANI)")
    p.add_argument("--cluster-out", default=None,
                   help="write rep -> cluster members table here")
    p.add_argument("--remove", action="store_true",
                   help="remove plasmids / short scaffolds: write filtered "
                        "genome copies and point the curated genomes_info at "
                        "them (pantax-rg --remove)")
    p.add_argument("-rl", "--remove-scaffold-len", type=float, default=1.0,
                   metavar="MBP",
                   help="--remove scaffold length cutoff in Mbp (default 1)")
    p.add_argument("--filtered-dir", default=None,
                   help="--remove output directory "
                        "(default <out>_filtered_genomes)")
    p.add_argument("--download-summary", action="store_true",
                   help="download the NCBI RefSeq bacteria assembly_summary "
                        "for -r mode (errors helpfully offline; "
                        "pantax-rg:218-219)")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO, stream=sys.stderr,
                        format="%(asctime)s [%(levelname)s] %(message)s")

    if args.download_summary and not args.summary:
        dest = Path(args.genomes_dir or ".") / "assembly_summary_bacteria.txt"
        args.summary = str(download_assembly_summary(dest))
    if args.custom:
        infos = read_genomes_info(args.custom)
    else:
        from .preprocess import resolve_genomes_gtdb, resolve_genomes_ncbi

        species = (
            [s.strip() for s in args.species_clusters.split(",") if s.strip()]
            if args.species_clusters else None
        )
        if args.gtdb:
            infos = resolve_genomes_gtdb(
                args.gtdb, args.genomes_dir,
                assembly_level=args.assembly_level, species_filter=species,
            )
        elif args.summary:
            infos = resolve_genomes_ncbi(
                args.summary, args.genomes_dir,
                assembly_level=args.assembly_level, species_filter=species,
            )
        else:
            p.error("-r/--genomes-dir requires --summary or --gtdb")
        log.info("resolved %d genomes from %s", len(infos), args.genomes_dir)
    base_dir = args.base_dir or str(Path.cwd())
    if args.remove:
        filtered_dir = Path(args.filtered_dir or
                            str(Path(args.out).with_suffix(""))
                            + "_filtered_genomes")
        infos = remove_plasmids(infos, base_dir, filtered_dir,
                                min_scaffold_mb=args.remove_scaffold_len)
        # filtered copies carry absolute paths; clustering reads them as-is
        base_dir = str(Path.cwd())
    if args.cluster == "none":
        curated, clusters = assign_strain_taxids(infos), {}
    else:
        curated, clusters = curate(infos, base_dir, mode=args.cluster,
                                   max_n=args.max_n, top_m=args.top_m,
                                   cutoff=args.cutoff)
    write_genomes_info(args.out, curated)
    if args.cluster_out:
        with open(args.cluster_out, "w") as f:
            for rep, members in clusters.items():
                f.write(f"{rep}\t{','.join(members)}\n")
    log.info("wrote %d genomes to %s", len(curated), args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
