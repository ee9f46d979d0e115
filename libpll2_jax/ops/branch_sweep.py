"""Device-resident all-branches Newton smoothing.

The reference's clients optimize branch lengths by walking the tree and,
per edge, calling pll_update_sumtable + a few Newton iterations of
pll_compute_likelihood_derivatives, updating CLVs as the walk reorients
(reference: /root/reference/examples/newton/newton.c:31-100 applied
tree-wide; /root/reference/src/derivatives.c:239,333). Host-looping that
costs one device dispatch (and host sync) per edge
(optimize.py:newton_optimize_branches). This module compiles the ENTIRE
multi-pass smoothing into one program:

  pass = full postorder refresh (down CLVs with current lengths)
         + a pre-order edge walk; per step ONE CLV update — either the
           "up" CLV of the next edge (combining the parent side's up CLV
           with the sibling's down CLV) or, on subtree exit, the
           refreshed "down" CLV of the exited node (the reference's
           newview-on-return) — then one sumtable, `iterations` Newton
           updates and an in-place P-matrix refresh for the new length
           (exit steps run a harmless dummy optimization into scratch);
  sweep = `passes` such passes chained in a fori_loop -> ONE dispatch.

Directional ("up") CLVs live in auxiliary rows appended to the partition's
CLV/scaler buffers; a host-side stack allocator bounds them at O(depth)
rows (an aux row dies when the walk leaves its subtree).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .. import constants as C
from . import derivatives as ops_derivatives
from . import pmatrix as ops_pmatrix

AUX = 1 << 20      # schedule-builder sentinel offset for aux rows


def build_smoothing_schedule(tree, n_nodes: int, scale_buffers: int,
                             n_matrices: int):
    """Pre-order edge walk with one CLV op per step.

    Returns (steps [n_steps, 13] int32, n_aux). Columns:
      0  up/refresh-CLV write row   1  its scaler write row
      2  c1 clv row   3 c1 matrix   4 c1 scaler row
      5  c2 clv row   6 c2 matrix   7 c2 scaler row
      8  edge child clv row    9  edge child scaler row
      10 edge parent-side clv row  11 parent-side scaler row
      12 edge pmatrix index (== n_matrices for dummy/exit steps: those
         optimize a scratch branch slot, results discarded)
    Row indices address the COMBINED buffers: clv rows [0, n_nodes] are the
    partition's (incl. scratch at n_nodes), aux rows start at n_nodes+1;
    scaler rows [0, scale_buffers) are the partition's, aux rows at
    scale_buffers+k, then the trash and guaranteed-zero rows last."""
    steps = []
    free_aux: list = []
    n_aux = 0

    def new_aux():
        nonlocal n_aux
        if free_aux:
            return free_aux.pop()
        k = n_aux
        n_aux += 1
        return k

    def sc(idx):
        return idx if idx >= 0 else -1           # -1 -> zero row (patched)

    DUMMY_EDGE = [0, -1, 0, -1, n_matrices]      # tip CLVs, zero scalers

    def recurse(u, parent_mat, pside_clv, pside_sc):
        """u: the half-edge of the current node pointing to the parent
        side; the edge above u is already optimized."""
        if u.is_tip():
            return
        h1, h2 = u.next, u.next.next
        for hc, hsib in ((h1, h2), (h2, h1)):
            aux = new_aux()
            steps.append([
                AUX + aux, AUX + aux,
                pside_clv, parent_mat, sc(pside_sc),
                hsib.back.clv_index, hsib.pmatrix_index,
                sc(hsib.back.scaler_index),
                hc.back.clv_index, sc(hc.back.scaler_index),
                AUX + aux, AUX + aux,
                hc.pmatrix_index,
            ])
            recurse(hc.back, hc.pmatrix_index, AUX + aux, AUX + aux)
            free_aux.append(aux)
        # exit refresh: recompute u's down CLV from its (now fresh)
        # children so later siblings/ancestors read updated values
        steps.append([
            u.clv_index, sc(u.scaler_index),
            h1.back.clv_index, h1.pmatrix_index, sc(h1.back.scaler_index),
            h2.back.clv_index, h2.pmatrix_index, sc(h2.back.scaler_index),
            *DUMMY_EDGE,
        ])

    r = tree.vroot
    # root edge first: both sides are standard down CLVs; the step's CLV
    # op refreshes r's own CLV (a no-op repeat of the postorder, harmless)
    steps.append([
        r.clv_index, sc(r.scaler_index),
        r.next.back.clv_index, r.next.pmatrix_index,
        sc(r.next.back.scaler_index),
        r.next.next.back.clv_index, r.next.next.pmatrix_index,
        sc(r.next.next.back.scaler_index),
        r.clv_index, sc(r.scaler_index),
        r.back.clv_index, sc(r.back.scaler_index),
        r.pmatrix_index,
    ])
    recurse(r.back, r.pmatrix_index, r.clv_index, r.scaler_index)
    recurse(r, r.pmatrix_index, r.back.clv_index, r.back.scaler_index)

    arr = np.asarray(steps, dtype=np.int64)
    zero_sc = scale_buffers + n_aux + 1

    def fix_clv(v):
        return n_nodes + 1 + (v - AUX) if v >= AUX else v

    def fix_sc(v):
        if v >= AUX:
            return scale_buffers + (v - AUX)
        if v == -1:
            return zero_sc
        return v

    out = np.zeros_like(arr, dtype=np.int32)
    for col in (0, 2, 5, 8, 10):
        out[:, col] = [fix_clv(v) for v in arr[:, col]]
    for col in (1, 4, 7, 9, 11):
        out[:, col] = [fix_sc(v) for v in arr[:, col]]
    for col in (3, 6, 12):
        out[:, col] = arr[:, col]
    return out, n_aux


@partial(jax.jit, static_argnames=('passes', 'iterations', 'n_aux',
                                   'scale_threshold', 'scale_factor',
                                   'asc_type', 'n_real'))
def newton_sweep(clv, scaler, pmatrix, branches,
                 eigenvals, inv_eigenvecs, eigenvecs, prop_invar,
                 rates, rate_weights, freqs, params_idx_rates,
                 ops,                     # packed postorder Operations
                 steps,                   # [n_steps, 13] int32
                 pattern_weights, invariant,
                 scale_threshold: float, scale_factor: float,
                 passes: int = 2, iterations: int = 8, n_aux: int = 0,
                 asc_type: int = 0, n_real: int = -1):
    """Multi-pass all-edges Newton smoothing in ONE dispatch.

    Returns (branches, pmatrix, clv, scaler) with every edge optimized
    `passes` times; clv/scaler are the partition-shaped buffers (aux rows
    stripped), refreshed with the final lengths."""
    from .partials import update_partials

    dtype = clv.dtype
    K = scaler.shape[0] - 2
    n_nodes = clv.shape[0] - 1

    # combined buffers: [partition rows | aux rows]; scaler keeps its
    # trash/zero rows LAST so update_partials' shape-derived rows hold
    aux_clv = jnp.zeros((n_aux,) + clv.shape[1:], dtype)
    aux_sc = jnp.zeros((n_aux,) + scaler.shape[1:], scaler.dtype)
    clv_c = jnp.concatenate([clv, aux_clv], axis=0)
    sc_c = jnp.concatenate([scaler[:K], aux_sc, scaler[K:]], axis=0)
    thresh = jnp.asarray(scale_threshold, dtype)
    factor = jnp.asarray(scale_factor, dtype)
    # scratch branch slot absorbs the dummy optimizations of exit steps
    branches_p = jnp.concatenate([branches, jnp.zeros(1, branches.dtype)])
    pmatrix_p = jnp.concatenate(
        [pmatrix, jnp.zeros((1,) + pmatrix.shape[1:], pmatrix.dtype)])

    def one_pass(_, carry):
        clv_c, sc_c, branches_p, pmatrix_p = carry
        with jax.named_scope("sweep.postorder"):
            clv_c, sc_c = update_partials(clv_c, sc_c, pmatrix_p, ops,
                                          scale_threshold, scale_factor)

        def step(carry, st):
            clv_c, sc_c, branches_p, pmatrix_p = carry
            (up_clv, up_sc, c1, m1, s1, c2, m2, s2,
             e_c, e_csc, e_p, e_psc, mat) = [st[i] for i in range(13)]
            with jax.named_scope("sweep.upclv"):
                left = jnp.take(clv_c, c1, axis=0)
                right = jnp.take(clv_c, c2, axis=0)
                pl = jnp.take(pmatrix_p, m1, axis=0)
                pr = jnp.take(pmatrix_p, m2, axis=0)
                x = (jnp.einsum('rij,rjs->ris', pl, left,
                                preferred_element_type=dtype,
                       precision=jax.lax.Precision.HIGHEST)
                     * jnp.einsum('rij,rjs->ris', pr, right,
                                  preferred_element_type=dtype,
                       precision=jax.lax.Precision.HIGHEST))
                mask = jnp.all(x < thresh, axis=(0, 1))
                x = jnp.where(mask[None, None, :], x * factor, x)
                new_sc = (jnp.take(sc_c, s1, axis=0)
                          + jnp.take(sc_c, s2, axis=0)
                          + mask.astype(sc_c.dtype))
                clv_c = clv_c.at[up_clv].set(x)
                sc_c = sc_c.at[up_sc].set(new_sc)
            with jax.named_scope("sweep.sumtable"):
                sumtable = ops_derivatives.update_sumtable(
                    jnp.take(clv_c, e_p, axis=0),
                    jnp.take(clv_c, e_c, axis=0),
                    jnp.take(sc_c, e_psc, axis=0),
                    jnp.take(sc_c, e_csc, axis=0),
                    inv_eigenvecs, eigenvecs, freqs, params_idx_rates,
                    scale_threshold, rate_scalers=False,
                    has_pscaler=True, has_cscaler=True)
            asc_scalers = None
            if asc_type in (1, 2):
                asc_scalers = (jnp.take(sc_c, e_psc, axis=0)
                               + jnp.take(sc_c, e_csc, axis=0))

            def newton_it(_, b):
                d1, d2 = ops_derivatives.likelihood_derivatives(
                    sumtable, eigenvals, prop_invar, freqs, rates,
                    rate_weights, params_idx_rates, pattern_weights,
                    invariant, b, asc_scalers=asc_scalers,
                    scale_threshold=scale_threshold, asc_type=asc_type,
                    n_real=n_real)
                return ops_derivatives.newton_step(
                    b, d1, d2, C.OPT_MIN_BRANCH_LEN, C.OPT_MAX_BRANCH_LEN)

            with jax.named_scope("sweep.newton"):
                blen = jax.lax.fori_loop(0, iterations, newton_it,
                                         jnp.take(branches_p, mat))
            branches_p = branches_p.at[mat].set(blen)
            with jax.named_scope("sweep.pmatrix"):
                pm = ops_pmatrix.update_prob_matrices(
                    eigenvals, inv_eigenvecs, eigenvecs, prop_invar,
                    rates, params_idx_rates, blen[None])[0]
            pmatrix_p = pmatrix_p.at[mat].set(pm)
            return (clv_c, sc_c, branches_p, pmatrix_p), None

        (clv_c, sc_c, branches_p, pmatrix_p), _ = jax.lax.scan(
            step, (clv_c, sc_c, branches_p, pmatrix_p), steps)
        return clv_c, sc_c, branches_p, pmatrix_p

    clv_c, sc_c, branches_p, pmatrix_p = jax.lax.fori_loop(
        0, passes, one_pass, (clv_c, sc_c, branches_p, pmatrix_p))
    # final refresh with the optimized lengths so returned CLVs/scalers
    # are consistent with `branches`
    clv_c, sc_c = update_partials(clv_c, sc_c, pmatrix_p, ops,
                                  scale_threshold, scale_factor)
    clv_out = clv_c[:n_nodes + 1]
    sc_out = jnp.concatenate([sc_c[:K], sc_c[K + n_aux:]], axis=0)
    return branches_p[:-1], pmatrix_p[:-1], clv_out, sc_out
