"""genomes_info.txt metadata: 5 tab-separated columns with a header row:
genome_ID, strain_taxid, species_taxid, organism_name, id (path to FASTA).

Parity: PanTax's src/types.rs:18-31 and
PanTax's src/main.rs:173-193.
"""
from __future__ import annotations

import os
from dataclasses import dataclass

HEADER = "genome_ID\tstrain_taxid\tspecies_taxid\torganism_name\tid"


@dataclass
class GenomeInfo:
    genome_id: str
    strain_taxid: str
    species_taxid: str
    organism_name: str
    path: str

    def resolved_path(self, base_dir: str | os.PathLike) -> str:
        if os.path.isabs(self.path):
            return self.path
        return os.path.normpath(os.path.join(os.fspath(base_dir), self.path))

    @property
    def file_stem(self) -> str:
        """File name without the last extension (Path::file_stem parity)."""
        name = os.path.basename(self.path)
        if name.endswith(".gz"):
            name = name[: -len(".gz")]
        stem, _, _ = name.rpartition(".")
        return stem or name

    @property
    def hap_id(self) -> str:
        """First two '_'-separated tokens of the file stem — the haplotype id
        used to join strain metrics back to metadata
        (PanTax's src/profile.rs:3105-3146)."""
        stem = self.file_stem
        parts = stem.split("_")
        if len(parts) >= 2:
            return "_".join(parts[:2])
        return stem


def read_genomes_info(path: str | os.PathLike) -> list[GenomeInfo]:
    infos: list[GenomeInfo] = []
    with open(path) as f:
        header = f.readline()
        if not header.startswith("genome_ID"):
            raise ValueError(f"{path}: expected genomes_info header, got {header!r}")
        for line in f:
            line = line.rstrip("\n")
            if not line:
                continue
            cols = line.split("\t")
            if len(cols) != 5:
                raise ValueError(f"{path}: expected 5 columns, got {len(cols)}: {line!r}")
            infos.append(GenomeInfo(*cols))
    return infos


def write_genomes_info(path: str | os.PathLike, infos: list[GenomeInfo]) -> None:
    with open(path, "w") as f:
        f.write(HEADER + "\n")
        for gi in infos:
            f.write(
                f"{gi.genome_id}\t{gi.strain_taxid}\t{gi.species_taxid}\t"
                f"{gi.organism_name}\t{gi.path}\n"
            )


def group_by_species(infos: list[GenomeInfo]) -> dict[str, list[GenomeInfo]]:
    """Group genomes by species_taxid preserving first-seen species order.

    Parity: PanTax's src/construct.rs:233-291.
    """
    groups: dict[str, list[GenomeInfo]] = {}
    for gi in infos:
        groups.setdefault(gi.species_taxid, []).append(gi)
    return groups
