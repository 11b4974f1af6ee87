"""Fixtures of the benchmark's CPU tests: a tiny benchmark tree whose
database is built once a session."""
from __future__ import annotations

import pytest

from .tiny import write_tree


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    return write_tree(tmp_path_factory.mktemp("bench_tree"))


@pytest.fixture
def cuda_card():
    """Skips unless a CUDA card is present (decided here, never at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
