"""Carry state from the reference into the port.

This system has no weights: its parameters are its device tables.  The
align index (host numpy, shared with the reference) gives the Aligner's
tables; a reference FusedTables' device arrays give the port's fused
tables, so both packages run on identical tables in the parity tests.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .align.aligner import Aligner, build_seed_lookup
from .ops.fused import FusedSpecies, FusedTables
from .ops.profile_tail import ORDER_FIELDS, TailTables, owner_tables


def aligner_from_reference(index, cfg, device, mesh=None) -> Aligner:
    """The port's Aligner over the reference's AlignIndex (its queries
    sharded over ``mesh`` when one is given)."""
    lookup = build_seed_lookup(index.seed_keys, index.seed_pos,
                               cfg.hits_per_seed)
    return Aligner(index, lookup, cfg, device=device, mesh=mesh)


def fused_tables_from_reference(jax_tables, device, index=None) -> FusedTables:
    """A reference FusedTables (pantax_tpu.ops.fused) -> the port's, with its
    device arrays copied through numpy; given the AlignIndex, with K6's
    records (the card's range scatter needs them)."""
    t = jax_tables

    def host(a, dtype):
        return np.asarray(a).astype(dtype, copy=False)

    species = [
        FusedSpecies(range_=s.range_, ridx=s.ridx, off=s.off,
                     num_nodes=s.num_nodes, trio_lo=s.trio_lo,
                     trio_hi=s.trio_hi, paths=s.paths, nodes_len=s.nodes_len,
                     trio_index=s.trio_index)
        for s in t.species
    ]
    return FusedTables(
        species=species, ranges=list(t.ranges),
        hap_offsets=host(t.hap_offsets_d, np.int32),
        hap_range=host(t.hap_range_d, np.int32),
        pos_lo=host(t.pos_lo_d, np.int32),
        nodes_len=host(t.nodes_len_d, np.int32),
        base_offset=host(t.base_offset_d, np.int32),
        trio_len=host(t.trio_len_d, np.int32),
        trio_seg=host(t.trio_seg_d, np.int32),
        has_dups=bool(t.has_dups), hap_dup=np.asarray(t.hap_dup, dtype=bool),
        win_shift=int(t.win_shift),
        pos_steps=int(t.pos_steps), N_pad=int(t.N_pad), TB_pad=int(t.TB_pad),
        U_pad=int(t.U_pad), device=device,
        tstart=None if index is None else index.tstart,
        tnode=None if index is None else index.tnode,
    )


def tail_tables_from_reference(jax_tt, device) -> TailTables:
    """A reference TailTables (pantax_tpu.ops.profile_tail) -> the port's:
    its device arrays as int32 tensors on ``device``, its host metadata
    as it is, and K9's slices (ORDER_FIELDS) derived from them."""
    dev = {"trio_hap": "trio_hap_d", "path_node": "path_node_d",
           "path_hap": "path_hap_d", "node_species": "node_species_d"}
    kw = {}
    for f in dataclasses.fields(TailTables):
        if f.name in dev:
            a = np.asarray(getattr(jax_tt, dev[f.name]), dtype=np.int32)
            kw[f.name] = torch.from_numpy(a.copy()).to(device)
        elif f.name not in ORDER_FIELDS:
            kw[f.name] = getattr(jax_tt, f.name)
    # K9's slices, which the reference's tables lack
    kw.update(owner_tables(np.asarray(jax_tt.trio_hap_d), jax_tt.hap_node_off,
                           jax_tt.sp_off, jax_tt.sp_nvert, jax_tt.G, device))
    return TailTables(**kw)
