"""Database construction: per-species graphs, species_range, genome stats.

Parity with the reference's construct stage
(PanTax's src/construct.rs:21-231):
  - genomes grouped by species_taxid; species with >= 2 genomes get a
    pangenome graph (here: anchor-partition constructor replacing pggb),
    single-genome species get an eq-1 chain graph;
  - species_range.txt: global node-id ranges, multi-genome species first
    (sort_range.rs:8-41);
  - species_genomes_stats.txt: species mean genome length (stat.rs:88-142);
  - genomes_info.txt copied into the DB.

Graphs are stored as one .npz per species under species_graph_info/
(replacing .bin/.bin.lz4/.bin.zst of zip.rs).
"""
from __future__ import annotations

import logging
import os
import shutil
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from ..graph.build_eq1 import CHUNK_SIZE, build_chain_graph
from ..graph.core import (
    GRAPH_DIR,
    SpeciesGraph,
    graph_path,
    save_species_range,
    sort_range,
)
from ..graph.pangenome import DEFAULT_PAN_CHUNK, build_pangenome_graph
from ..io.fastx import iter_fastx
from ..io.metadata import GenomeInfo, group_by_species, read_genomes_info

log = logging.getLogger(__name__)


@dataclass
class DatabasePaths:
    root: Path

    @property
    def range_file(self) -> Path:
        return self.root / "species_range.txt"

    @property
    def stats_file(self) -> Path:
        return self.root / "species_genomes_stats.txt"

    @property
    def genomes_info_file(self) -> Path:
        return self.root / "genomes_info.txt"

    @property
    def graph_dir(self) -> Path:
        return self.root / GRAPH_DIR

    def load_graph(self, taxid: str) -> SpeciesGraph:
        return SpeciesGraph.load(graph_path(self.root, taxid))

    def is_complete(self) -> bool:
        return self.range_file.exists() and self.stats_file.exists()

    def export_gfa(self, out_path) -> None:
        """Write the combined pangenome GFA with global node ids — the
        interop artifact matching the reference DB's reference_pangenome.gfa
        (construct.rs:156-208, vg combine semantics: species concatenated in
        range order with offset node ids)."""
        from ..graph.core import load_species_range

        with open(out_path, "wb") as f:
            f.write(b"H\tVN:Z:1.1\n")
            for r in load_species_range(self.range_file):
                g = self.load_graph(r.species)
                base = r.start  # global 1-based id of local node 0
                for i in range(g.num_nodes):
                    f.write(b"S\t%d\t%s\n" % (base + i, g.node_seq(i)))
                edges = set()
                for hi in range(g.num_paths):
                    p = g.path(hi)
                    s = g.path_strand(hi)
                    for a, sa, b, sb in zip(p[:-1], s[:-1], p[1:], s[1:]):
                        edges.add((int(a), int(sa), int(b), int(sb)))
                ori = (b"+", b"-")
                for a, sa, b, sb in sorted(edges):
                    f.write(b"L\t%d\t%s\t%d\t%s\t0M\n"
                            % (base + a, ori[sa], base + b, ori[sb]))
                step = (b">", b"<")
                for hi, name in enumerate(g.path_names):
                    p = g.path(hi)
                    s = g.path_strand(hi)
                    walk = b"".join(
                        step[int(si)] + b"%d" % (base + n) for n, si in zip(p, s)
                    )
                    span = int(g.nodes_len[p].sum())
                    f.write(
                        b"W\t%s\t0\tmerged\t0\t%d\t%s\n"
                        % (name.encode(), span, walk)
                    )


def _genome_seq(gi: GenomeInfo, base_dir: str) -> bytes:
    """Concatenated contig sequence of a genome (chromosome merge parity,
    zip.rs:154-158)."""
    return b"".join(seq for _, seq in iter_fastx(gi.resolved_path(base_dir)))


def _import_gfa_graph(gfa_file: str) -> SpeciesGraph:
    """Import an externally built (e.g. pggb/vg) species GFA as the graph
    (construct.rs keeps pggb output authoritative; here GFA import is the
    interop path so existing reference databases remain usable)."""
    from ..io.gfa import read_gfa

    parsed = read_gfa(gfa_file, keep_seq=True)
    return SpeciesGraph.from_paths(
        parsed.nodes_len, parsed.paths, parsed.node_seqs,
        strands=parsed.path_strands or None,
    )


def _build_species_graph(
    taxid: str,
    genomes: list[GenomeInfo],
    base_dir: str,
    chunk_size: int,
    pan_chunk_size: int,
    gfa_dir: str | None = None,
) -> SpeciesGraph:
    if gfa_dir is not None:
        gfa_file = os.path.join(gfa_dir, f"{taxid}.gfa")
        if os.path.exists(gfa_file):
            return _import_gfa_graph(gfa_file)
    if len(genomes) == 1:
        return build_chain_graph(
            genomes[0].resolved_path(base_dir),
            chunk_size=chunk_size,
            hap_id=genomes[0].hap_id,
        )
    seqs = {gi.hap_id: _genome_seq(gi, base_dir) for gi in genomes}
    return build_pangenome_graph(seqs, chunk_size=pan_chunk_size)


def build_database(
    genomes_info_path: str | os.PathLike,
    db_dir: str | os.PathLike,
    chunk_size: int = CHUNK_SIZE,
    pan_chunk_size: int = DEFAULT_PAN_CHUNK,
    threads: int = 8,
    force: bool = False,
    base_dir: str | os.PathLike | None = None,
    gfa_dir: str | os.PathLike | None = None,
) -> DatabasePaths:
    """Relative genome paths in genomes_info resolve against ``base_dir``
    (default: the current working directory — reference parity, where paths
    like ``../genomes/...`` are relative to where pantax runs,
    PanTax's test/pantax.sh).  When ``gfa_dir`` holds a
    ``<taxid>.gfa`` (e.g. built by pggb), it is imported instead of running
    the anchor-partition constructor."""
    db = DatabasePaths(Path(db_dir))
    if db.is_complete() and not force:
        log.info("database %s exists, skipping construction", db.root)
        return db
    db.root.mkdir(parents=True, exist_ok=True)
    db.graph_dir.mkdir(exist_ok=True)

    infos = read_genomes_info(genomes_info_path)
    base_dir = os.fspath(base_dir) if base_dir is not None else os.getcwd()
    by_species = group_by_species(infos)
    multi = [t for t, g in by_species.items() if len(g) >= 2]
    single = [t for t, g in by_species.items() if len(g) == 1]

    # crash-resumable construction: completed species are recorded and skipped
    # on rerun (finished_pangenome.txt parity, task_scheduling.rs:238-254);
    # a failing species aborts only itself, the others continue
    # (task_scheduling.rs:631-668)
    import threading

    from ..utils.logging import ProgressMonitor

    finished_file = db.root / "finished_species.txt"
    finished: set[str] = set()
    if finished_file.exists() and not force:
        finished = set(finished_file.read_text().split())

    local_ranges: dict[str, tuple[int, int, int]] = {}
    failures: dict[str, str] = {}
    progress = ProgressMonitor(len(by_species), "pangenome build")
    lock = threading.Lock()

    def build_one(taxid: str) -> None:
        gp = graph_path(db.root, taxid)
        try:
            if taxid in finished and os.path.exists(gp):
                graph = SpeciesGraph.load(gp)
            else:
                graph = _build_species_graph(
                    taxid, by_species[taxid], base_dir, chunk_size,
                    pan_chunk_size,
                    os.fspath(gfa_dir) if gfa_dir is not None else None,
                )
                graph.save(gp)
            lo, hi = graph.local_range()
            with lock:
                local_ranges[taxid] = (lo, hi, int(graph.is_pan))
                with open(finished_file, "a") as f:
                    f.write(taxid + "\n")
            log.debug("species %s: %d nodes, %d paths", taxid,
                      graph.num_nodes, graph.num_paths)
            progress.update(ok=True)
        except Exception as e:  # keep building the other species
            log.error("species %s failed: %s", taxid, e)
            with lock:
                failures[taxid] = str(e)
            progress.update(ok=False)

    with ThreadPoolExecutor(max_workers=threads) as pool:
        list(pool.map(build_one, multi + single))

    if failures:
        log.warning("%d/%d species failed to build: %s", len(failures),
                    len(by_species), sorted(failures))
        if len(failures) == len(by_species):
            raise RuntimeError("all species failed to build")
        multi = [t for t in multi if t not in failures]
        single = [t for t in single if t not in failures]

    ranges = sort_range(local_ranges, multi, single)
    save_species_range(db.range_file, ranges)

    # species mean genome length (stat.rs:88-142)
    with open(db.stats_file, "w") as f:
        for taxid in multi + single:
            lens = [
                sum(len(s) for _, s in iter_fastx(gi.resolved_path(base_dir)))
                for gi in by_species[taxid]
            ]
            f.write(f"{taxid}\t{np.mean(lens):.1f}\n")

    if Path(genomes_info_path).resolve() != db.genomes_info_file.resolve():
        shutil.copy(genomes_info_path, db.genomes_info_file)
    return db


def load_database(db_dir: str | os.PathLike) -> DatabasePaths:
    db = DatabasePaths(Path(db_dir))
    if not db.is_complete():
        raise FileNotFoundError(f"{db_dir} is not a complete database")
    return db
