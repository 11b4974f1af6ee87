"""A run with the timed path broken underneath comes out not correct:
once for each fault a cell can have.  (No cell spans chips, so there is
no exchange between chips to leave out.)"""
from __future__ import annotations

import json

import numpy as np
import pytest

from pantax_bench import run


def _state_unchanged(monkeypatch):
    """The fused step returns the coverage state unchanged."""
    from pantax_tpu_torch.ops import fused

    def feed(self, codes, lens, ids=None):
        self.n_batches = getattr(self, "n_batches", 0)

    monkeypatch.setattr(fused.FusedPipeline, "feed", feed)
    monkeypatch.setattr(fused.FusedPipeline, "feed_paired",
                        lambda self, *a, **k: None)


def _half_batch(monkeypatch):
    """Each batch's second half left out."""
    from pantax_tpu_torch.ops import fused

    orig = fused.FusedPipeline.feed

    def feed(self, codes, lens, ids=None):
        h = len(lens) // 2
        return orig(self, codes[:h], lens[:h],
                    ids=None if ids is None else ids[:h])

    monkeypatch.setattr(fused.FusedPipeline, "feed", feed)


def _answer_altered(monkeypatch):
    """Each read's species index moved to the next species where the
    fused pipeline produces it."""
    from pantax_tpu_torch.ops import fused

    orig = fused.FusedPipeline.finish

    def finish(self, *a, **k):
        res = orig(self, *a, **k)
        r = res.reads["ridx"]
        n = len(self.tables.ranges)
        res.reads["ridx"] = np.where(r >= 0, (r + 1) % n, r)
        return res

    monkeypatch.setattr(fused.FusedPipeline, "finish", finish)


def _minor_strains_swapped(monkeypatch):
    """Each species' two minor strains (weights 1 and 3 of 1:3:9) given
    each other's coverage where the strain table is produced."""
    from pantax_tpu_torch.profile import report

    orig = report.abundance_est

    def est(cfg, metrics, genomes_info, out_dir):
        by_species = {}
        for m in metrics:
            by_species.setdefault(m.otu, []).append(m)
        for ms in by_species.values():
            a, b = sorted(ms, key=lambda m: m.hap_id)[:2]
            a.second_sol, b.second_sol = b.second_sol, a.second_sol
        return orig(cfg, metrics, genomes_info, out_dir)

    monkeypatch.setattr(report, "abundance_est", est)


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch,
                                   _answer_altered, _minor_strains_swapped])
def test_fault_is_not_correct(tiny_root, capsys, monkeypatch, fault):
    fault(monkeypatch)
    rc = run.main(["--workload", "tinyscale.short", "--seed", "41",
                   "--seconds", "1", "--trace", "0"], root=tiny_root,
                  chip=False)
    out = capsys.readouterr().out.strip().splitlines()
    if rc == 0:
        assert json.loads(out[-1])["correct"] is False
    else:
        assert not out or not out[-1].startswith("{")
