"""Checkpoint / resume: serialize model state + topology.

The reference has no checkpointing (SURVEY §5 — its only serialization is
newick export); long-running device jobs need one. A checkpoint bundles:

  * the partition's model state (frequencies, substitution rates, category
    rates/weights, pinv, pattern weights, asc weights) — small host arrays;
  * the tree topology + branch lengths as newick text (the reference's own
    interchange format);
  * optionally the CLV/scaler device arrays for exact mid-computation
    resume (they are otherwise recomputable from tips in one traversal).

Format: a single .npz (atomic rename on save). Orbax is unnecessary for
state this small, and .npz keeps checkpoints portable across devices.
"""
from __future__ import annotations

import os
import tempfile
from typing import Optional, Tuple

import numpy as np

from .partition import Partition
from .trees import export_newick, parse_newick
from .trees.utree import UTree

FORMAT_VERSION = 1


def save(path: str, partition: Partition, tree: Optional[UTree] = None,
         include_clvs: bool = False, **extra) -> None:
    """Write an atomic checkpoint. `extra` entries (e.g. optimizer step,
    best logL) are stored verbatim under 'x_<key>'."""
    p = partition
    payload = dict(
        version=np.int64(FORMAT_VERSION),
        shape=np.array([p.tips, p.clv_buffers, p.states, p.sites,
                        p.rate_matrices, p.prob_matrices, p.rate_cats,
                        p.scale_buffers], dtype=np.int64),
        dtype=np.bytes_(str(p.dtype)),
        frequencies=p.frequencies,
        subst_params=p.subst_params,
        rates=p.rates,
        rate_weights=p.rate_weights,
        prop_invar=p.prop_invar,
        pattern_weights=p.pattern_weights,
        invariant=p.invariant,
        tip_states=p.tip_states,
        tips_set=p._tips_set,
        asc_bias=np.int64(p.asc_bias.value),
        site_repeats=np.bool_(p.repeats is not None),
        rate_scalers=np.bool_(p.rate_scalers),
        sites_padded=np.int64(p.sites_padded),
    )
    # tips set via set_tip_clv hold raw probabilities that tip_states
    # cannot reconstruct — persist those as [sites, states] (the exact
    # set_tip_clv input; rate-replicated on load)
    clv_tips = np.flatnonzero(getattr(p, "_tips_clv_set",
                                      np.zeros(p.tips, dtype=bool)))
    if clv_tips.size:
        payload["tip_clv_indices"] = clv_tips.astype(np.int64)
        payload["tip_clv_probs"] = np.stack(
            [p.get_clv(int(t))[:, 0, :] for t in clv_tips])
    if tree is not None:
        payload["newick"] = np.bytes_(export_newick(tree.vroot))
        # row -> taxon label, so load() can re-bind the parsed tree's
        # tips to their partition rows: parse_newick assigns tip CLV
        # indices in PARSE order, which need not match the row order the
        # tips were set in (e.g. a stepwise-addition tree). Only written
        # when every tip carries a unique non-empty label — duplicates
        # would collapse in the label->row map and bind two tips to one
        # row; such trees keep the parse-order binding.
        labels = [""] * p.tips
        for tip in tree.tips():
            labels[tip.clv_index] = tip.label or ""
        if all(labels) and len(set(labels)) == p.tips:
            payload["tip_labels"] = np.array(labels, dtype=np.bytes_)
    if include_clvs and p.repeats is None:
        # repeats partitions: pooled buffers are schedule-dependent and
        # recomputable from tips in one traversal — not checkpointed
        payload["clv"] = np.asarray(p.clv)
        payload["scale_buffer"] = np.asarray(p.scale_buffer)
    for k, v in extra.items():
        payload[f"x_{k}"] = np.asarray(v)

    d = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as fh:
            np.savez_compressed(fh, **payload)
        os.replace(tmp, path)
    except BaseException:
        os.unlink(tmp)
        raise


def load(path: str, dtype=None) -> Tuple[Partition, Optional[UTree],
                                         dict]:
    """Rebuild (partition, tree, extras) from a checkpoint. `dtype`
    overrides the stored dtype — e.g. reload an fp32 GPU analysis as
    fp64 on CPU for a final certified cross-check (the stored CLVs, if
    any, are dropped on a dtype change: recomputable from tips)."""
    import jax.numpy as jnp

    from . import constants as C

    z = np.load(path)
    if int(z["version"]) != FORMAT_VERSION:
        raise ValueError(f"unsupported checkpoint version {z['version']}")
    (tips, clv_buffers, states, sites, rate_matrices, prob_matrices,
     rate_cats, scale_buffers) = [int(v) for v in z["shape"]]
    stored_dtype = jnp.dtype(z["dtype"].item().decode())
    dtype_changed = dtype is not None and dtype != stored_dtype
    part = Partition(tips, clv_buffers, states, sites, rate_matrices,
                     prob_matrices, rate_cats, scale_buffers,
                     dtype=dtype if dtype is not None else stored_dtype,
                     asc_bias=C.AscBias(int(z["asc_bias"])),
                     site_repeats=bool(z["site_repeats"]),
                     rate_scalers=bool(z["rate_scalers"])
                     if "rate_scalers" in z else False,
                     sites_alignment=int(z["sites_padded"])
                     if "sites_padded" in z else 1)
    part.frequencies[:] = z["frequencies"]
    part.subst_params[:] = z["subst_params"]
    part.rates = z["rates"].copy()
    part.rate_weights = z["rate_weights"].copy()
    part.prop_invar[:] = z["prop_invar"]
    part.pattern_weights[:] = z["pattern_weights"]
    part.invariant[:] = z["invariant"]

    # restore tip CLVs (and repeats tables) from the stored state codes
    tip_states = z["tip_states"]
    for t in np.flatnonzero(z["tips_set"]):
        part._set_tip_masks(int(t), tip_states[t, :sites])
    if "tip_clv_indices" in z:
        idx = z["tip_clv_indices"].astype(np.int64)
        for t, probs in zip(idx, z["tip_clv_probs"]):
            part.set_tip_clv(int(t), probs)

    if "clv" in z and not dtype_changed:
        part.clv = jnp.asarray(z["clv"], part.dtype)
        part.scale_buffer = jnp.asarray(z["scale_buffer"])

    tree = None
    if "newick" in z:
        tree = parse_newick(z["newick"].item().decode(), unroot=True)
        if "tip_labels" in z:
            # re-bind tips to their partition rows by label (see save;
            # only written for unique complete label sets)
            row_of = {lab.decode(): i
                      for i, lab in enumerate(z["tip_labels"])}
            if len(row_of) == len(z["tip_labels"]):
                for tip in tree.tips():
                    row = row_of.get(tip.label or "")
                    if row is not None:
                        tip.clv_index = tip.node_index = row

    extras = {k[2:]: z[k] for k in z.files if k.startswith("x_")}
    return part, tree, extras
