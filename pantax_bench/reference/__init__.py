"""The plain reference that decides a run's ``correct``.

NumPy only: it imports neither JAX, nor the JAX package, nor anything of
the port, and takes nothing the port made.  From the genomes the harness
generated and the FASTQ files it wrote, it places every read on a species
(k-mer votes over the genomes), aligns a seeded sample of the placed
reads to each strain of their species (banded edit distance), and works
out each species' coverage and each strain's share of it.
"""
from .profile import Profile, reference_profile

__all__ = ["Profile", "reference_profile"]
