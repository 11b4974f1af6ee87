"""Single-device compile check of the port: the counterpart of the
reference's ``__graft_entry__.entry`` (its sibling dryrun_multichip is in
dryrun.py).

    fn, args = entry()                 # on the card
    fn, args = entry("cpu", root)      # on the CPU, tiny_db under root
    ts, te, score, matches, mapq, strand, aligned = fn(*args)

``fn`` is the aligner's query step (2-bit reads to k-mer seeds, the CHD
seed lookup, the diagonal vote, the window fetch and banded DP, K1 on the
card, and the query epilogue, its projection through the bucket table of
the segment starts that the aligner built); ``args`` are the index tables
of tiny_db and 256 reads of 128 bases sampled within its haplotypes, on
the device.
"""
from __future__ import annotations

import numpy as np

from .. import _host
from ..align.aligner import query_batch
from ..benchmarks import tiny_db
from ..convert import aligner_from_reference
from ..device import card_unless


def _reads_from_index(index, B: int, Lr: int, seed: int = 0):
    """B reads of Lr bases, each inside one haplotype (a start in the last
    Lr bases before a separator would give a read spanning two genomes)."""
    rng = np.random.default_rng(seed)
    hap = rng.integers(0, len(index.hap_names), size=B)
    lo = index.hap_offsets[hap]
    hi = index.hap_offsets[hap + 1] - 1 - Lr  # -1: separator byte
    starts = lo + (rng.random(B) * (hi - lo)).astype(np.int64)
    codes = np.stack([index.text[s:s + Lr] for s in starts]).astype(np.int8)
    return codes, np.full(B, Lr, dtype=np.int32)


def entry(device=None, root=None):
    """(fn, args) of the query step on tiny_db (built under ``root``, by
    default in the temp dir) with B = 256 and Lr = 128, on ``device``: the
    card unless the caller names another (device.card_unless: raises
    without one)."""
    dev = card_unless(device)
    index = _host.build_align_index(tiny_db(root))
    aligner = aligner_from_reference(index, _host.AlignConfig(), dev)
    codes, lens = _reads_from_index(index, 256, 128)
    seg, static = aligner.segment_lookup, aligner.static()

    def fn(text, run_table, seed_pos, bucket_lo, tstart, tnode, codes,
           read_len):
        return query_batch(text, run_table, seed_pos, bucket_lo, tstart,
                           tnode, seg, codes, read_len, static)

    args = (aligner.text, aligner.run_table, aligner.seed_pos,
            aligner.bucket_lo, aligner.tstart, aligner.tnode,
            *aligner.upload(codes, lens))
    return fn, args
