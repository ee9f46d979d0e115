"""Conditional likelihood vector (CLV) updates — Felsenstein pruning.

Design notes
------------
CLVs are stored as [node, rate, state, site]: the site axis is the minor
(contiguous) axis, so the per-site Felsenstein product vectorizes fully,
while the state contraction is a small batched matmul:

    parent[r, i, s] = (sum_j Pl[r,i,j] * left[r,j,s])
                    * (sum_j Pr[r,i,j] * right[r,j,s])

The reference iterates an operation list serially and dispatches tt/ti/ii
SIMD kernels (reference: /root/reference/src/partials.c:237-291,
/root/reference/src/core_partials.c:629-790). Here tips are bit-decoded CLVs
(the reference's "plain" mode) so every operation is the ii case, executed as
one `lax.scan` over the operation arrays — topology is data, not code, so one
compiled program serves every topology of a given size. Independent
operations of the same tree level can also be batched (see
`update_partials_levels`), turning the scan into depth-many batched launches.

Numerical scaling semantics are preserved exactly
(core_partials.c:707-789): per-site mode multiplies the whole site block by
2**256 when all states*rates entries fall below 2**-256 and increments an
integer scaler; per-rate mode (PLL_ATTRIB_RATE_SCALERS) checks each rate
category independently. Parent scalers start as the sum of child scalers
(pll.c:1183 fill_parent_scaler).
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp


class Operations(NamedTuple):
    """Structure-of-arrays operation list (pll.h:314-324 pll_operation_t)."""
    parent_clv: jnp.ndarray      # [n] int32
    parent_scaler: jnp.ndarray   # [n] int32 (-1 = none)
    child1_clv: jnp.ndarray
    child1_matrix: jnp.ndarray
    child1_scaler: jnp.ndarray
    child2_clv: jnp.ndarray
    child2_matrix: jnp.ndarray
    child2_scaler: jnp.ndarray


def _read_scaler(scaler: jnp.ndarray, idx: jnp.ndarray) -> jnp.ndarray:
    """Child scaler row(s), or zeros when idx is SCALE_BUFFER_NONE (-1).

    idx may be a scalar (scan variant) or a [W] vector (level variant)."""
    row = jnp.take(scaler, jnp.maximum(idx, 0), axis=0)
    ok = (idx >= 0).reshape(jnp.shape(idx) + (1,) * (row.ndim - jnp.ndim(idx)))
    return jnp.where(ok, row, jnp.zeros_like(row))


def _one_partial(pl, left, pr, right, preferred):
    terma = jnp.einsum('rij,rjs->ris', pl, left,
                       preferred_element_type=preferred,
                       precision=jax.lax.Precision.HIGHEST)
    termb = jnp.einsum('rij,rjs->ris', pr, right,
                       preferred_element_type=preferred,
                       precision=jax.lax.Precision.HIGHEST)
    return terma * termb


@partial(jax.jit, static_argnames=('rate_scalers',))
def update_partials(clv: jnp.ndarray,        # [N, R, s, S]
                    scaler: jnp.ndarray,     # [K+1, S] or [K+1, R, S] int32
                    pmatrix: jnp.ndarray,    # [E, R, s, s]
                    ops: Operations,
                    scale_threshold: float,
                    scale_factor: float,
                    rate_scalers: bool = False):
    """Execute the operation list; returns updated (clv, scaler).

    `scaler` must carry one trailing scratch row (index K) that absorbs
    writes for operations with parent_scaler_index == -1.
    """
    dtype = clv.dtype
    trash = scaler.shape[0] - 2       # last row is the guaranteed-zero row
    thresh = jnp.asarray(scale_threshold, dtype)
    factor = jnp.asarray(scale_factor, dtype)

    def body(carry, op):
        clv, scaler = carry
        (parent, psc, c1, m1, s1, c2, m2, s2) = op

        left = jnp.take(clv, c1, axis=0)
        right = jnp.take(clv, c2, axis=0)
        pl = jnp.take(pmatrix, m1, axis=0)
        pr = jnp.take(pmatrix, m2, axis=0)
        x = _one_partial(pl, left, pr, right, dtype)

        has_scaler = psc >= 0
        child_sc = _read_scaler(scaler, s1) + _read_scaler(scaler, s2)
        if rate_scalers:
            # all states of one rate category below threshold -> scale it
            mask = jnp.all(x < thresh, axis=1)            # [R, S]
            scaled = jnp.where(mask[:, None, :], x * factor, x)
        else:
            # all states x rates of the site below threshold -> scale site
            mask = jnp.all(x < thresh, axis=(0, 1))       # [S]
            scaled = jnp.where(mask[None, None, :], x * factor, x)
        new_sc = child_sc + mask.astype(scaler.dtype)

        x = jnp.where(has_scaler, scaled, x)
        write_row = jnp.where(has_scaler, psc, trash)
        clv = clv.at[parent].set(x)
        scaler = scaler.at[write_row].set(new_sc)
        return (clv, scaler), None

    op_stack = jnp.stack([ops.parent_clv, ops.parent_scaler,
                          ops.child1_clv, ops.child1_matrix, ops.child1_scaler,
                          ops.child2_clv, ops.child2_matrix, ops.child2_scaler],
                         axis=1)
    (clv, scaler), _ = jax.lax.scan(body, (clv, scaler), op_stack)
    return clv, scaler


@partial(jax.jit, static_argnames=('rate_scalers', 'profiles'))
def update_partials_repeats_pool(clv_flat: jnp.ndarray,   # [R, s, T]
                                 sc_flat: jnp.ndarray,    # [T2] / [R, T2]
                                 pmatrix: jnp.ndarray,    # [E, R, s, s]
                                 buckets,  # tuple of (fields, gl, gr)
                                 scale_threshold: float,
                                 scale_factor: float,
                                 rate_scalers: bool = False,
                                 profiles=None):
    """All capacity buckets over the POOLED class-column storage in one
    compiled program (see repeats.FlatLayout): node n's class columns
    live at clv_flat[:, :, off[n]:off[n]+cap[n]]. Each bucket of width W
    computes only W columns per op; child columns are read as a W-wide
    window at the child's offset and permuted by the gather maps — cost
    scales with CLASS counts, not with the alignment width."""
    if profiles is None:
        profiles = ((False, False),) * len(buckets)
    for (fields, gl, gr), (il, ir) in zip(buckets, profiles):
        clv_flat, sc_flat = _repeats_pool_bucket(
            clv_flat, sc_flat, pmatrix, fields, gl, gr,
            scale_threshold, scale_factor, rate_scalers=rate_scalers,
            ident_l=il, ident_r=ir)
    return clv_flat, sc_flat


@partial(jax.jit, static_argnames=('rate_scalers', 'ident_l', 'ident_r'))
def _repeats_pool_bucket(clv_flat, sc_flat, pmatrix,
                         fields,           # [n, 8] int32
                         gather_left,      # [n, W] int32 (child-local)
                         gather_right,     # [n, W] int32
                         scale_threshold: float,
                         scale_factor: float,
                         rate_scalers: bool = False,
                         ident_l: bool = False,
                         ident_r: bool = False):
    dtype = clv_flat.dtype
    R, s = clv_flat.shape[0], clv_flat.shape[1]
    W = gather_left.shape[1]
    thresh = jnp.asarray(scale_threshold, dtype)
    factor = jnp.asarray(scale_factor, dtype)

    def permute(win, idx):
        """win [R, s, W] child window, idx [W] child-local class ids."""
        return jnp.take(win, idx, axis=2)

    def permute_sc(win, idx):
        """win [W] (or [R, W]) scaler window."""
        return jnp.take(win, idx, axis=-1)

    def sc_window(buf, off):
        if buf.ndim == 1:
            return jax.lax.dynamic_slice(buf, (off,), (W,))
        return jax.lax.dynamic_slice(
            buf, (jnp.zeros((), off.dtype), off), (buf.shape[0], W))

    def body(carry, xs):
        clv_flat, sc_flat = carry
        f, gl, gr = xs
        zero = jnp.zeros((), f.dtype)
        p_off, psc_off, c1_off, m1, s1_off, c2_off, m2, s2_off = \
            [f[i] for i in range(8)]
        lwin = jax.lax.dynamic_slice(clv_flat, (zero, zero, c1_off),
                                     (R, s, W))
        rwin = jax.lax.dynamic_slice(clv_flat, (zero, zero, c2_off),
                                     (R, s, W))
        pl = jnp.take(pmatrix, m1, axis=0)
        pr = jnp.take(pmatrix, m2, axis=0)
        # bclv ordering (core_partials.c:906-977 partial-left precompute):
        # the matvec runs on the child's CLASS columns (<= W of them) and
        # only the result is permuted to parent classes — matvec work
        # scales with the child's class count, not the parent's. Identity
        # maps (repeats disabled on both ends; trace-time flags) skip the
        # permute entirely: at full width the W x W one-hot would
        # dominate the step.
        def child_term(pm, win, idx, is_ident):
            t = jnp.einsum('rij,rjc->ric', pm, win,
                           preferred_element_type=dtype,
                           precision=jax.lax.Precision.HIGHEST)
            return t if is_ident else permute(t, idx)

        terma = child_term(pl, lwin, gl, ident_l)
        termb = child_term(pr, rwin, gr, ident_r)
        x = terma * termb                                     # [R, s, W]

        def child_sc(off, idx, is_ident):
            win = sc_window(sc_flat, off)
            return win if is_ident else permute_sc(win, idx)

        sc1 = child_sc(s1_off, gl, ident_l)
        sc2 = child_sc(s2_off, gr, ident_r)
        child_sc = sc1 + sc2
        if rate_scalers:
            mask = jnp.all(x < thresh, axis=1)                # [R, W]
            scaled = jnp.where(mask[:, None, :], x * factor, x)
        else:
            mask = jnp.all(x < thresh, axis=(0, 1))           # [W]
            scaled = jnp.where(mask[None, None, :], x * factor, x)
        new_sc = child_sc + mask.astype(sc_flat.dtype)

        clv_flat = jax.lax.dynamic_update_slice(clv_flat, scaled,
                                                (zero, zero, p_off))
        if sc_flat.ndim == 1:
            sc_flat = jax.lax.dynamic_update_slice(sc_flat, new_sc,
                                                   (psc_off,))
        else:
            sc_flat = jax.lax.dynamic_update_slice(sc_flat, new_sc,
                                                   (zero, psc_off))
        return (clv_flat, sc_flat), None

    (clv_flat, sc_flat), _ = jax.lax.scan(
        body, (clv_flat, sc_flat), (fields, gather_left, gather_right))
    return clv_flat, sc_flat


@jax.jit
def gather_flat_view(clv_flat: jnp.ndarray,     # [R, s, T]
                     sc_flat: jnp.ndarray,      # [T2] or [R, T2]
                     clv_cols: jnp.ndarray,     # [S] absolute columns
                     sc_cols: jnp.ndarray):     # [S] absolute columns
    """Per-site expansion from the pooled storage for the likelihood /
    sumtable kernels (core_likelihood.c:211-349 repeats indexing)."""
    return (jnp.take(clv_flat, clv_cols, axis=2),
            jnp.take(sc_flat, sc_cols, axis=-1))


@partial(jax.jit, static_argnames=('rate_scalers',))
def update_partials_levels(clv: jnp.ndarray,
                           scaler: jnp.ndarray,
                           pmatrix: jnp.ndarray,
                           ops: Operations,          # padded to [L, W] each
                           valid: jnp.ndarray,       # [L, W] bool
                           scale_threshold: float,
                           scale_factor: float,
                           rate_scalers: bool = False):
    """Level-scheduled variant: ops grouped into L levels of width W.

    All operations inside one level are independent (different parents whose
    children are already computed), so each level runs as one batched einsum
    over [W, R, s, S] — this is the launch-width knob that keeps the device busy
    on balanced trees (depth O(log n) levels instead of O(n) scan steps).
    Padded slots (valid == False) write to scratch rows.
    """
    dtype = clv.dtype
    n_nodes = clv.shape[0] - 1          # last row is scratch
    trash_sc = scaler.shape[0] - 2      # last row is the guaranteed-zero row
    thresh = jnp.asarray(scale_threshold, dtype)
    factor = jnp.asarray(scale_factor, dtype)

    def level(carry, xs):
        clv, scaler = carry
        (parent, psc, c1, m1, s1, c2, m2, s2, ok) = xs

        left = jnp.take(clv, c1, axis=0)               # [W, R, s, S]
        right = jnp.take(clv, c2, axis=0)
        pl = jnp.take(pmatrix, m1, axis=0)             # [W, R, s, s]
        pr = jnp.take(pmatrix, m2, axis=0)
        terma = jnp.einsum('wrij,wrjs->wris', pl, left,
                           preferred_element_type=dtype,
                       precision=jax.lax.Precision.HIGHEST)
        termb = jnp.einsum('wrij,wrjs->wris', pr, right,
                           preferred_element_type=dtype,
                       precision=jax.lax.Precision.HIGHEST)
        x = terma * termb

        has_scaler = (psc >= 0) & ok
        child_sc = _read_scaler(scaler, s1) + _read_scaler(scaler, s2)
        if rate_scalers:
            mask = jnp.all(x < thresh, axis=2)          # [W, R, S]
            scaled = jnp.where(mask[:, :, None, :], x * factor, x)
        else:
            mask = jnp.all(x < thresh, axis=(1, 2))     # [W, S]
            scaled = jnp.where(mask[:, None, None, :], x * factor, x)
        new_sc = child_sc + mask.astype(scaler.dtype)

        hs = has_scaler.reshape((-1,) + (1,) * (x.ndim - 1))
        x = jnp.where(hs, scaled, x)
        clv = clv.at[jnp.where(ok, parent, n_nodes)].set(x)
        scaler = scaler.at[jnp.where(has_scaler, psc, trash_sc)].set(new_sc)
        return (clv, scaler), None

    xs = (ops.parent_clv, ops.parent_scaler,
          ops.child1_clv, ops.child1_matrix, ops.child1_scaler,
          ops.child2_clv, ops.child2_matrix, ops.child2_scaler, valid)
    (clv, scaler), _ = jax.lax.scan(level, (clv, scaler), xs)
    return clv, scaler
