"""Fused full-tree evaluation: one compiled program per problem size.

The reference evaluates a tree by four separate library calls
(reference: /root/reference/src/models.c:412, partials.c:237,
likelihood.c:586, derivatives.c:239,333). On an accelerator, each host
round-trip and each separately-launched kernel costs more than the math for
small state counts, so the engine fuses the whole traversal into ONE jitted
function:

    branches -> P-matrices -> CLV scan -> edge logL (-> d1/d2 -> Newton step)

Topology is data, not code: the operation list, root indices and the
params->matrix ordering enter as traced integer arrays, so one compiled
program serves every topology of a given (tips, sites, states, rates) size —
the SPR search loop never re-compiles (see SURVEY §7 "Host-device churn").

All functions are shape-polymorphic over a sharded site axis; under a
`jax.sharding.Mesh` the final site reductions lower to `psum` over ICI
(see parallel/sharding.py).
"""
from __future__ import annotations

from functools import partial
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from . import constants as C
from .ops import derivatives as ops_derivatives
from .ops import likelihood as ops_likelihood
from .ops import partials as ops_partials
from .ops import pallas_fused as ops_fused
from .ops import pmatrix as ops_pmatrix
from .partition import Operation, Partition, pack_operations
from .trees import create_operations, traverse


def _scatter_root_rows(clv, scaler, root_idx, rows):
    """Write the fused kernel's root-edge rows back into the partition
    buffers (API contract for downstream sumtable/derivative consumers).
    EXPENSIVE inside a loop: XLA materializes a copy of the whole clv
    buffer per dynamic-update — loop paths scatter once, after the loop."""
    p_clv, p_sc_i, c_clv, c_sc_i, _ = root_idx
    clv_p, clv_c, sc_p, sc_c = rows
    clv = clv.at[p_clv].set(clv_p.astype(clv.dtype))
    clv = clv.at[c_clv].set(clv_c.astype(clv.dtype))
    trash = scaler.shape[0] - 2
    scaler = scaler.at[jnp.where(p_sc_i >= 0, p_sc_i, trash)].set(sc_p)
    scaler = scaler.at[jnp.where(c_sc_i >= 0, c_sc_i, trash)].set(sc_c)
    return clv, scaler


def _zero_root_rows(clv, sites, rate_scalers: bool = False):
    """fori_loop carry initializer matching the fused kernel's root-row
    outputs (f32 CLVs + int32 scalers, whatever the partition dtype)."""
    r, s = clv.shape[1], clv.shape[2]
    sc_shape = (r, sites) if rate_scalers else (sites,)
    return (jnp.zeros((r, s, sites), jnp.float32),
            jnp.zeros((r, s, sites), jnp.float32),
            jnp.zeros(sc_shape, jnp.int32),
            jnp.zeros(sc_shape, jnp.int32))


def _scatter_if_ran(k, clv, scaler, root_idx, rows):
    """Post-loop scatter, guarded: with a traced trip count of 0 the carry
    still holds the all-zero initializer — writing it would corrupt the
    partition's root rows."""
    return jax.lax.cond(
        k > 0,
        lambda: _scatter_root_rows(clv, scaler, root_idx, rows),
        lambda: (clv, scaler))


@partial(jax.jit, static_argnames=('rate_scalers', 'levels',
                                   'pallas_interpret', 'scale_threshold',
                                   'scale_factor', 'asc_type', 'n_real',
                                   'fused_slots', 'fused_mesh',
                                   'fused_scatter'))
def _fused_loglikelihood(clv, scaler, eigenvals, inv_eigenvecs, eigenvecs,
                         prop_invar, rates, rate_weights, freqs,
                         params_idx_rates, branches,
                         op_arrays, root_idx, pattern_weights, invariant,
                         scale_threshold, scale_factor,
                         rate_scalers: bool = False,
                         valid=None, levels: bool = False,
                         pallas_interpret: bool = False,
                         asc_type: int = 0, n_real: int = -1,
                         fused_slots: int = 0, edge_params=None,
                         fused_mesh=None, fused_scatter: bool = True):
    """branches[e] is ordered by pmatrix index e. `edge_params` (an
    optional [E, R] int table) switches P-matrix computation to the
    per-branch heterotachy variant — every edge may use its own rate
    matrix (reference: examples/heterotachy) while the CLV and
    likelihood stages are unchanged. With `levels`, op_arrays
    are [L, W] level-grouped and each level runs as one batched launch.
    With `fused_slots` > 0, op_arrays is (table, tip_codes[, tip_clvs])
    for the single-pass whole-traversal kernel (ops/pallas_fused.py):
    inner CLVs stay in the kernel's slot file — only the root edge's
    rows are scattered back into `clv`/`scaler`."""
    with jax.named_scope("pll.pmatrix"):
        if edge_params is not None:
            pmatrix = ops_pmatrix.update_prob_matrices_per_edge(
                eigenvals, inv_eigenvecs, eigenvecs, prop_invar, rates,
                edge_params, branches)
        else:
            pmatrix = ops_pmatrix.update_prob_matrices(
                eigenvals, inv_eigenvecs, eigenvecs, prop_invar, rates,
                params_idx_rates, branches)
    if fused_slots > 0:
        table, tip_codes, tip_clvs = (op_arrays if len(op_arrays) == 3
                                      else op_arrays + (None,))
        p_clv, p_sc_i, c_clv, c_sc_i, mat = root_idx

        def _traverse(codes, pm, tbl, *ctips):
            # under a mesh this body runs PER SHARD (shard_map); the
            # kernel pads the local column block to its site tile itself,
            # so shards need only equal widths
            return ops_fused.fused_traversal(
                codes, pm, tbl,
                rates=clv.shape[1], states=clv.shape[2],
                n_slots=fused_slots, threshold=scale_threshold,
                factor=scale_factor, interpret=pallas_interpret,
                rate_scalers=rate_scalers,
                tip_clvs=ctips[0] if ctips else None)

        with jax.named_scope("pll.fused_traversal"):
            if fused_mesh is not None:
                # per-shard traversal: the kernel is elementwise over the
                # site axis, so each device runs it on its local columns;
                # the psum happens later in the edge logL reduction
                from jax import shard_map
                from jax.sharding import PartitionSpec as P

                sites_ax = P(None, "sites")
                sc_ax = P(None, "sites") if rate_scalers else P("sites")
                extra_in = (P(None, None, "sites"),) \
                    if tip_clvs is not None else ()
                extra_arg = (tip_clvs,) if tip_clvs is not None else ()
                clv_p, clv_c, sc_p, sc_c = shard_map(
                    _traverse, mesh=fused_mesh,
                    in_specs=(sites_ax, P(), P()) + extra_in,
                    out_specs=(P(None, None, "sites"),
                               P(None, None, "sites"),
                               sc_ax, sc_ax),
                    check_vma=False,
                )(tip_codes, pmatrix, table, *extra_arg)
            else:
                clv_p, clv_c, sc_p, sc_c = _traverse(
                    tip_codes, pmatrix, table,
                    *((tip_clvs,) if tip_clvs is not None else ()))
        # the tip operands may be pre-padded to the kernel's site tile;
        # everything downstream (pattern weights, partition buffers) uses
        # the partition's width — drop the pad columns here
        w = clv.shape[3]
        if clv_p.shape[-1] != w:
            clv_p, clv_c = clv_p[..., :w], clv_c[..., :w]
            sc_p, sc_c = sc_p[..., :w], sc_c[..., :w]
        with jax.named_scope("pll.edge_logl"):
            total, per = ops_likelihood.edge_loglikelihood(
                clv_p, clv_c, sc_p, sc_c, jnp.take(pmatrix, mat, axis=0),
                freqs, prop_invar, rate_weights, params_idx_rates,
                pattern_weights, invariant, scale_threshold,
                rate_scalers=rate_scalers, has_pscaler=True,
                has_cscaler=True, asc_type=asc_type, n_real=n_real)
        if not fused_scatter:
            # loop/batched callers take the raw root rows; the big clv
            # buffer is untouched (no per-iteration whole-buffer copy)
            return total, per, (clv_p, clv_c, sc_p, sc_c), scaler, pmatrix
        # keep the API contract for downstream consumers (sumtable,
        # derivatives): the root edge's rows are refreshed; inner rows
        # stay stale by design (they never left the kernel)
        clv, scaler = _scatter_root_rows(clv, scaler, root_idx,
                                         (clv_p, clv_c, sc_p, sc_c))
        return total, per, clv, scaler, pmatrix
    with jax.named_scope("pll.partials"):
        if levels:
            clv, scaler = ops_partials.update_partials_levels(
                clv, scaler, pmatrix, op_arrays, valid, scale_threshold,
                scale_factor, rate_scalers=rate_scalers)
        else:
            clv, scaler = ops_partials.update_partials(
                clv, scaler, pmatrix, op_arrays, scale_threshold,
                scale_factor, rate_scalers=rate_scalers)
    with jax.named_scope("pll.edge_logl"):
        p_clv, p_sc, c_clv, c_sc, mat = root_idx
        total, per = ops_likelihood.edge_loglikelihood(
            jnp.take(clv, p_clv, axis=0), jnp.take(clv, c_clv, axis=0),
            jnp.take(scaler, p_sc, axis=0), jnp.take(scaler, c_sc, axis=0),
            jnp.take(pmatrix, mat, axis=0),
            freqs, prop_invar, rate_weights, params_idx_rates,
            pattern_weights, invariant, scale_threshold,
            rate_scalers=rate_scalers, has_pscaler=True, has_cscaler=True,
            asc_type=asc_type, n_real=n_real)
    return total, per, clv, scaler, pmatrix


@partial(jax.jit, static_argnames=('rate_scalers', 'levels',
                                   'pallas_interpret', 'scale_threshold',
                                   'scale_factor', 'asc_type', 'n_real',
                                   'fused_slots', 'fused_mesh',
                                   'fused_scatter'))
def _fused_newton_step(clv, scaler, eigenvals, inv_eigenvecs, eigenvecs,
                       prop_invar, rates, rate_weights, freqs,
                       params_idx_rates, branches,
                       op_arrays, root_idx, pattern_weights, invariant,
                       scale_threshold, scale_factor,
                       rate_scalers: bool = False,
                       valid=None, levels: bool = False,
                       pallas_interpret: bool = False,
                       asc_type: int = 0, n_real: int = -1,
                       fused_slots: int = 0, edge_params=None,
                       fused_mesh=None, fused_scatter: bool = True):
    """One full 'training' step: evaluate the tree, then Newton-update the
    root branch length from d1/d2 (the reference's examples/newton loop body,
    reference: /root/reference/examples/newton/newton.c:66-96, fused).

    With fused_scatter=False (loop bodies), the fused path returns the raw
    root rows in place of (clv, scaler) so no whole-buffer copy occurs."""
    p_clv, p_sc, c_clv, c_sc, mat = root_idx
    if fused_slots > 0:
        total, _, rows, _, pmatrix = _fused_loglikelihood(
            clv, scaler, eigenvals, inv_eigenvecs, eigenvecs, prop_invar,
            rates, rate_weights, freqs, params_idx_rates, branches,
            op_arrays, root_idx, pattern_weights, invariant,
            scale_threshold, scale_factor, rate_scalers=rate_scalers,
            valid=valid, levels=levels, pallas_interpret=pallas_interpret,
            asc_type=asc_type, n_real=n_real, fused_slots=fused_slots,
            edge_params=edge_params, fused_mesh=fused_mesh,
            fused_scatter=False)
        clv_p, clv_c, sc_p, sc_c = rows
    else:
        total, _, clv, scaler, pmatrix = _fused_loglikelihood(
            clv, scaler, eigenvals, inv_eigenvecs, eigenvecs, prop_invar,
            rates, rate_weights, freqs, params_idx_rates, branches,
            op_arrays, root_idx, pattern_weights, invariant,
            scale_threshold, scale_factor, rate_scalers=rate_scalers,
            valid=valid, levels=levels, pallas_interpret=pallas_interpret,
            asc_type=asc_type, n_real=n_real, edge_params=edge_params,
            fused_mesh=fused_mesh)
        clv_p = jnp.take(clv, p_clv, axis=0)
        clv_c = jnp.take(clv, c_clv, axis=0)
        sc_p = jnp.take(scaler, p_sc, axis=0)
        sc_c = jnp.take(scaler, c_sc, axis=0)
    sumtable = ops_derivatives.update_sumtable(
        clv_p, clv_c, sc_p, sc_c,
        inv_eigenvecs, eigenvecs, freqs, params_idx_rates, scale_threshold,
        rate_scalers=rate_scalers, has_pscaler=True, has_cscaler=True)
    blen = jnp.take(branches, mat)
    # Lewis/Felsenstein asc corrections need the synthetic columns'
    # absolute scalers (per-site mode only; asc excludes rate scalers)
    asc_scalers = None
    if asc_type in (1, 2):
        asc_scalers = sc_p + sc_c
    d1, d2 = ops_derivatives.likelihood_derivatives(
        sumtable, eigenvals, prop_invar, freqs, rates, rate_weights,
        params_idx_rates, pattern_weights, invariant, blen,
        asc_scalers=asc_scalers, scale_threshold=scale_threshold,
        asc_type=asc_type, n_real=n_real)
    new_len = ops_derivatives.newton_step(blen, d1, d2,
                                          C.OPT_MIN_BRANCH_LEN,
                                          C.OPT_MAX_BRANCH_LEN)
    branches = branches.at[mat].set(new_len)
    if fused_slots > 0:
        if not fused_scatter:
            return total, d1, d2, branches, (clv_p, clv_c, sc_p, sc_c), \
                scaler
        clv, scaler = _scatter_root_rows(clv, scaler, root_idx,
                                         (clv_p, clv_c, sc_p, sc_c))
    return total, d1, d2, branches, clv, scaler


@partial(jax.jit, static_argnames=('rate_scalers', 'levels',
                                   'pallas_interpret', 'scale_threshold',
                                   'scale_factor', 'asc_type', 'n_real',
                                   'fused_slots', 'fused_mesh',
                                   'fused_scatter'))
def _fused_loglikelihood_loop(k, clv, scaler, eigenvals, inv_eigenvecs,
                              eigenvecs, prop_invar, rates, rate_weights,
                              freqs, params_idx_rates, branches, op_arrays,
                              root_idx, pattern_weights, invariant,
                              scale_threshold, scale_factor,
                              rate_scalers: bool = False,
                              valid=None, levels: bool = False,
                              pallas_interpret: bool = False,
                              asc_type: int = 0, n_real: int = -1,
                              fused_slots: int = 0, edge_params=None,
                              fused_mesh=None, fused_scatter: bool = True):
    """k chained full-traversal evaluations in ONE dispatch (the CLV state
    threads through the loop, so XLA cannot hoist the work). Benchmarking
    helper: amortizes host->device dispatch latency.

    The fused path carries only the root-edge rows through the loop and
    scatters them into the big clv buffer ONCE at the end — the
    per-iteration scatter made XLA copy the whole (tens-of-MB) buffer
    every trip, costing ~2.3x the traversal kernel itself."""
    if fused_slots > 0:
        table, codes = op_arrays[0], op_arrays[1]
        rest = op_arrays[2:]
        rows0 = _zero_root_rows(clv, clv.shape[3], rate_scalers)

        def body(_, carry):
            acc, rows_prev = carry
            # thread the carry into the (otherwise loop-invariant) kernel
            # inputs so XLA cannot hoist the traversal out of the loop
            dep = jnp.isnan(acc).astype(jnp.int32)       # always 0, traced
            total, _, rows, _, _ = _fused_loglikelihood(
                clv, scaler, eigenvals, inv_eigenvecs, eigenvecs,
                prop_invar, rates, rate_weights, freqs, params_idx_rates,
                branches, (table + dep, codes) + rest, root_idx,
                pattern_weights,
                invariant, scale_threshold, scale_factor,
                rate_scalers=rate_scalers, valid=valid, levels=levels,
                pallas_interpret=pallas_interpret,
                asc_type=asc_type, n_real=n_real, fused_slots=fused_slots,
                edge_params=edge_params, fused_mesh=fused_mesh,
                fused_scatter=False)
            return acc + total, rows
        acc, rows = jax.lax.fori_loop(
            0, k, body, (jnp.zeros((), clv.dtype), rows0))
        if fused_scatter:
            clv, scaler = _scatter_if_ran(k, clv, scaler, root_idx, rows)
        return acc, clv, scaler

    def body(_, carry):
        clv, scaler, acc = carry
        total, _, clv, scaler, _ = _fused_loglikelihood(
            clv, scaler, eigenvals, inv_eigenvecs, eigenvecs, prop_invar,
            rates, rate_weights, freqs, params_idx_rates, branches,
            op_arrays, root_idx, pattern_weights, invariant,
            scale_threshold, scale_factor, rate_scalers=rate_scalers,
            valid=valid, levels=levels, pallas_interpret=pallas_interpret,
            asc_type=asc_type, n_real=n_real, edge_params=edge_params,
            fused_mesh=fused_mesh)
        return clv, scaler, acc + total
    clv, scaler, acc = jax.lax.fori_loop(
        0, k, body, (clv, scaler, jnp.zeros((), clv.dtype)))
    return acc, clv, scaler


@partial(jax.jit, static_argnames=('rate_scalers', 'levels',
                                   'pallas_interpret', 'scale_threshold',
                                   'scale_factor', 'asc_type', 'n_real',
                                   'fused_slots', 'fused_mesh',
                                   'fused_scatter'))
def _fused_newton_loop(k, clv, scaler, eigenvals, inv_eigenvecs, eigenvecs,
                       prop_invar, rates, rate_weights, freqs,
                       params_idx_rates, branches, op_arrays, root_idx,
                       pattern_weights, invariant,
                       scale_threshold, scale_factor,
                       rate_scalers: bool = False,
                       valid=None, levels: bool = False,
                       pallas_interpret: bool = False,
                       asc_type: int = 0, n_real: int = -1,
                       fused_slots: int = 0, edge_params=None,
                       fused_mesh=None, fused_scatter: bool = True):
    """k chained Newton iterations on the root branch in ONE dispatch
    (the reference's examples/newton loop, device-resident). The fused
    path carries root rows only; one scatter after the loop."""
    zero = jnp.zeros((), clv.dtype)
    if fused_slots > 0:
        rows0 = _zero_root_rows(clv, clv.shape[3], rate_scalers)

        def body(_, carry):
            rows_prev, branches, total, d1, d2 = carry
            total, d1, d2, branches, rows, _ = _fused_newton_step(
                clv, scaler, eigenvals, inv_eigenvecs, eigenvecs,
                prop_invar, rates, rate_weights, freqs, params_idx_rates,
                branches, op_arrays, root_idx, pattern_weights, invariant,
                scale_threshold, scale_factor, rate_scalers=rate_scalers,
                valid=valid, levels=levels, pallas_interpret=pallas_interpret,
                asc_type=asc_type, n_real=n_real, fused_slots=fused_slots,
                edge_params=edge_params, fused_mesh=fused_mesh,
                fused_scatter=False)
            return rows, branches, total, d1, d2

        rows, branches, total, d1, d2 = jax.lax.fori_loop(
            0, k, body, (rows0, branches, zero, zero, zero))
        if fused_scatter:
            clv, scaler = _scatter_if_ran(k, clv, scaler, root_idx, rows)
        return total, d1, d2, branches, clv, scaler

    def body(_, carry):
        clv, scaler, branches, total, d1, d2 = carry
        total, d1, d2, branches, clv, scaler = _fused_newton_step(
            clv, scaler, eigenvals, inv_eigenvecs, eigenvecs, prop_invar,
            rates, rate_weights, freqs, params_idx_rates, branches,
            op_arrays, root_idx, pattern_weights, invariant,
            scale_threshold, scale_factor, rate_scalers=rate_scalers,
            valid=valid, levels=levels, pallas_interpret=pallas_interpret,
            asc_type=asc_type, n_real=n_real, edge_params=edge_params,
            fused_mesh=fused_mesh)
        return clv, scaler, branches, total, d1, d2

    clv, scaler, branches, total, d1, d2 = jax.lax.fori_loop(
        0, k, body, (clv, scaler, branches, zero, zero, zero))
    return total, d1, d2, branches, clv, scaler


def pack_repeats_canonical(partition, operations, root_indices,
                           pad_counts=None):
    """Build the pooled-storage schedule for one topology: installs the
    flat layout on `partition` and returns numpy
    (packed [(f, gl, gr)] per width, root_cols 4-tuple, mat, layout).

    Bucket shapes are canonicalized — every lane width from 128 up to the
    padded class domain is present and op counts are padded to powers of
    two (dummy ops recompute into the scratch tail) — so topology moves
    (and, for the sharded engine, different shards) hit a bounded set of
    compiled programs. `pad_counts` ({width: n}) forces a minimum op count
    per width, used to align per-shard tables to one common shape."""
    from .repeats import schedule_buckets_flat
    p = partition
    width = p.sites + p.asc_extra           # class domain incl. asc columns
    layout, buckets = schedule_buckets_flat(
        p.repeats, operations, width, p.scale_buffers)
    p._install_flat(layout)
    # the partition's own step-by-step schedule cache is now stale
    p._repeat_key = None
    p._repeat_schedule = None

    s_pad = -(-width // 128) * 128
    widths = []
    w = 128
    while w < s_pad:
        widths.append(w)
        w *= 2
    widths.append(s_pad)
    by_w = {wd: [] for wd in widths}
    # engine mode merges identity-profile runs back together and
    # always permutes: stable compiled shapes across topology moves
    # matter more than the permute saving inside search loops
    for wd, f, gl, gr, _, _ in buckets:
        by_w[wd].append((f, gl, gr))
    tail_off = layout.total - s_pad
    packed = []
    for wd in widths:
        rows = by_w[wd]
        n_real = sum(f.shape[0] for f, _, _ in rows)
        n = 1
        while n < max(n_real, 1, (pad_counts or {}).get(wd, 1)):
            n *= 2
        f = np.zeros((n, 8), dtype=np.int32)
        gl = np.zeros((n, wd), dtype=np.int32)
        gr = np.zeros((n, wd), dtype=np.int32)
        # dummy rows: recompute into the scratch tail / trash region
        f[:] = [tail_off, layout.sc_trash, 0, 0, layout.sc_zero,
                0, 0, layout.sc_zero]
        k = 0
        for fr, glr, grr in rows:
            f[k:k + fr.shape[0]] = fr
            gl[k:k + glr.shape[0]] = glr
            gr[k:k + grr.shape[0]] = grr
            k += fr.shape[0]
        packed.append((f, gl, gr))

    def cols(node, sc_idx):
        sid = p.repeats.site_id[node].astype(np.int64)
        c = (layout.off[node] + sid).astype(np.int32)
        has = sc_idx >= 0 and layout.sc_caps[sc_idx] > 0
        base = layout.sc_off[sc_idx] if has else layout.sc_zero
        return c, (base + sid).astype(np.int32)

    p_clv, p_sc, c_clv, c_sc, mat = root_indices
    pc, psc = cols(p_clv, p_sc)
    cc, csc = cols(c_clv, c_sc)
    return packed, (pc, psc, cc, csc), mat, layout


@partial(jax.jit, static_argnames=('rate_scalers', 'scale_threshold',
                                   'scale_factor', 'asc_type', 'n_real'))
def _repeats_loglikelihood(clv_flat, sc_flat, eigenvals, inv_eigenvecs,
                           eigenvecs, prop_invar, rates, rate_weights,
                           freqs, params_idx_rates, branches,
                           buckets, root_cols, mat,
                           pattern_weights, invariant,
                           scale_threshold, scale_factor,
                           rate_scalers: bool = False,
                           asc_type: int = 0, n_real: int = -1,
                           edge_params=None):
    """Fused full-tree evaluation over POOLED site-repeats storage: one
    dispatch runs pmatrices -> all capacity buckets -> root-edge logL.
    root_cols = (p_cols, p_sc_cols, c_cols, c_sc_cols) absolute per-site
    column indices into the pools (host-computed from the layout +
    site_id maps). `edge_params` selects per-branch heterotachy exactly
    as in _fused_loglikelihood (class schedules are model-independent,
    so repeats compose freely with per-edge rate matrices)."""
    with jax.named_scope("pll.pmatrix"):
        if edge_params is not None:
            pmatrix = ops_pmatrix.update_prob_matrices_per_edge(
                eigenvals, inv_eigenvecs, eigenvecs, prop_invar, rates,
                edge_params, branches)
        else:
            pmatrix = ops_pmatrix.update_prob_matrices(
                eigenvals, inv_eigenvecs, eigenvecs, prop_invar, rates,
                params_idx_rates, branches)
    with jax.named_scope("pll.partials.repeats"):
        clv_flat, sc_flat = ops_partials.update_partials_repeats_pool(
            clv_flat, sc_flat, pmatrix, buckets,
            scale_threshold, scale_factor, rate_scalers=rate_scalers)
    p_cols, p_sc_cols, c_cols, c_sc_cols = root_cols
    with jax.named_scope("pll.edge_logl"):
        total, per = ops_likelihood.edge_loglikelihood(
            jnp.take(clv_flat, p_cols, axis=2),
            jnp.take(clv_flat, c_cols, axis=2),
            jnp.take(sc_flat, p_sc_cols, axis=-1),
            jnp.take(sc_flat, c_sc_cols, axis=-1),
            jnp.take(pmatrix, mat, axis=0),
            freqs, prop_invar, rate_weights, params_idx_rates,
            pattern_weights, invariant, scale_threshold,
            rate_scalers=rate_scalers, has_pscaler=True, has_cscaler=True,
            asc_type=asc_type, n_real=n_real)
    return total, per, clv_flat, sc_flat, pmatrix


@partial(jax.jit, static_argnames=('rate_scalers', 'scale_threshold',
                                   'scale_factor', 'asc_type', 'n_real'))
def _repeats_loglikelihood_loop(k, clv_flat, sc_flat, eigenvals,
                                inv_eigenvecs, eigenvecs, prop_invar,
                                rates, rate_weights, freqs,
                                params_idx_rates, branches,
                                buckets, root_cols, mat,
                                pattern_weights, invariant,
                                scale_threshold, scale_factor,
                                rate_scalers: bool = False,
                                asc_type: int = 0, n_real: int = -1,
                                edge_params=None):
    """k chained repeats evaluations in one dispatch (bench helper; the
    pooled buffers thread through the carry so the work cannot hoist)."""
    def body(_, carry):
        clv_flat, sc_flat, acc = carry
        total, _, clv_flat, sc_flat, _ = _repeats_loglikelihood(
            clv_flat, sc_flat, eigenvals, inv_eigenvecs, eigenvecs,
            prop_invar, rates, rate_weights, freqs, params_idx_rates,
            branches, buckets, root_cols, mat, pattern_weights, invariant,
            scale_threshold, scale_factor, rate_scalers=rate_scalers,
            asc_type=asc_type, n_real=n_real, edge_params=edge_params)
        return clv_flat, sc_flat, acc + total
    clv_flat, sc_flat, acc = jax.lax.fori_loop(
        0, k, body, (clv_flat, sc_flat, jnp.zeros((), clv_flat.dtype)))
    return acc, clv_flat, sc_flat


@partial(jax.jit, static_argnames=('rate_scalers', 'scale_threshold',
                                   'scale_factor', 'asc_type', 'n_real'))
def _repeats_newton_loop(k, clv_flat, sc_flat, eigenvals, inv_eigenvecs,
                         eigenvecs, prop_invar, rates, rate_weights,
                         freqs, params_idx_rates, branches,
                         buckets, root_cols, mat,
                         pattern_weights, invariant,
                         scale_threshold, scale_factor,
                         rate_scalers: bool = False,
                         asc_type: int = 0, n_real: int = -1,
                         edge_params=None):
    """k chained Newton iterations on the root branch over pooled
    repeats storage, one dispatch."""
    p_cols, p_sc_cols, c_cols, c_sc_cols = root_cols

    def body(_, carry):
        clv_flat, sc_flat, branches, total, d1, d2 = carry
        total, _, clv_flat, sc_flat, pmatrix = _repeats_loglikelihood(
            clv_flat, sc_flat, eigenvals, inv_eigenvecs, eigenvecs,
            prop_invar, rates, rate_weights, freqs, params_idx_rates,
            branches, buckets, root_cols, mat, pattern_weights, invariant,
            scale_threshold, scale_factor, rate_scalers=rate_scalers,
            asc_type=asc_type, n_real=n_real, edge_params=edge_params)
        sumtable = ops_derivatives.update_sumtable(
            jnp.take(clv_flat, p_cols, axis=2),
            jnp.take(clv_flat, c_cols, axis=2),
            jnp.take(sc_flat, p_sc_cols, axis=-1),
            jnp.take(sc_flat, c_sc_cols, axis=-1),
            inv_eigenvecs, eigenvecs, freqs, params_idx_rates,
            scale_threshold, rate_scalers=rate_scalers,
            has_pscaler=True, has_cscaler=True)
        blen = jnp.take(branches, mat)
        # Lewis/Felsenstein derivative corrections need the synthetic
        # columns' ABSOLUTE scalers; the pooled class scalers are
        # absolute, so the per-site slices sum directly
        asc_scalers = None
        if asc_type in (1, 2):
            asc_scalers = (jnp.take(sc_flat, p_sc_cols, axis=-1)
                           + jnp.take(sc_flat, c_sc_cols, axis=-1))
        d1, d2 = ops_derivatives.likelihood_derivatives(
            sumtable, eigenvals, prop_invar, freqs, rates, rate_weights,
            params_idx_rates, pattern_weights, invariant, blen,
            asc_scalers=asc_scalers,
            scale_threshold=scale_threshold,
            asc_type=asc_type, n_real=n_real)
        new_len = ops_derivatives.newton_step(blen, d1, d2,
                                              C.OPT_MIN_BRANCH_LEN,
                                              C.OPT_MAX_BRANCH_LEN)
        branches = branches.at[mat].set(new_len)
        return clv_flat, sc_flat, branches, total, d1, d2

    zero = jnp.zeros((), clv_flat.dtype)
    clv_flat, sc_flat, branches, total, d1, d2 = jax.lax.fori_loop(
        0, k, body, (clv_flat, sc_flat, branches, zero, zero, zero))
    return total, d1, d2, branches, clv_flat, sc_flat


@partial(jax.jit, static_argnames=('rate_scalers', 'scale_threshold',
                                   'scale_factor', 'asc_type', 'n_real',
                                   'fused_slots', 'pallas_interpret'))
def _fused_multi_topology(clv, scaler, eigenvals, inv_eigenvecs, eigenvecs,
                          prop_invar, rates, rate_weights, freqs,
                          params_idx_rates, branches_k, ops_k, root_idx_k,
                          pattern_weights, invariant,
                          scale_threshold, scale_factor,
                          rate_scalers: bool = False,
                          asc_type: int = 0, n_real: int = -1,
                          fused_slots: int = 0,
                          pallas_interpret: bool = False,
                          edge_params=None):
    """logL of K candidate topologies in ONE dispatch.

    branches_k [K, E], ops_k: Operations with [K, n] arrays (scan path) or
    (tables [K, n_ops+1, 8], tip_codes) for the single-pass traversal
    kernel, root_idx_k [K, 5]. Each candidate runs a full traversal from
    the same initial CLVs (the op count is topology-invariant, so every
    candidate reuses the same compiled body); only the scalar logL is
    kept, so memory stays at one CLV buffer. This is the batched replacement
    for the reference consumers' move -> rescore -> rollback loop: tens of
    SPR/NNI candidates amortize one dispatch.

    With `edge_params` (heterotachy), every candidate's pmatrices use the
    per-edge table AND its likelihood mixing uses ITS OWN root edge's
    model (edge_params[root_mat]) — what set_topology + loglikelihood
    would compute after applying that move.
    """
    def _pidx(root_idx):
        if edge_params is None:
            return params_idx_rates
        return edge_params[root_idx[4]]          # [R] candidate-root model

    if fused_slots > 0:
        tables_k, tip_codes = ops_k[0], ops_k[1]
        rest = ops_k[2:]

        def eval_one(branches, table, root_idx):
            total, _, _, _, _ = _fused_loglikelihood(
                clv, scaler, eigenvals, inv_eigenvecs, eigenvecs,
                prop_invar, rates, rate_weights, freqs, _pidx(root_idx),
                branches, (table, tip_codes) + rest, root_idx,
                pattern_weights,
                invariant, scale_threshold, scale_factor,
                rate_scalers=rate_scalers, asc_type=asc_type,
                n_real=n_real, fused_slots=fused_slots,
                pallas_interpret=pallas_interpret,
                edge_params=edge_params, fused_scatter=False)
            return total

        # vmap the candidate axis: Pallas grows the kernel grid by one
        # dimension, so a whole chunk of candidates runs as ONE kernel
        # launch (a lax.scan paid ~1 ms of per-iteration launch overhead
        # per candidate). Chunked to bound the [chunk, R*s, S]
        # intermediates; the padded count is a power of two, so chunks
        # divide evenly.
        chunk = min(tables_k.shape[0], 128)

        def body(carry, xs):
            return carry, jax.vmap(eval_one)(*xs)

        _, totals = jax.lax.scan(
            body, None,
            jax.tree.map(lambda a: a.reshape((-1, chunk) + a.shape[1:]),
                         (branches_k, tables_k, root_idx_k)))
        return totals.reshape(-1)

    def body(carry, xs):
        branches, ops, root_idx = xs
        total, _, _, _, _ = _fused_loglikelihood(
            clv, scaler, eigenvals, inv_eigenvecs, eigenvecs, prop_invar,
            rates, rate_weights, freqs, _pidx(root_idx), branches,
            ops, root_idx, pattern_weights, invariant,
            scale_threshold, scale_factor, rate_scalers=rate_scalers,
            asc_type=asc_type, n_real=n_real, edge_params=edge_params)
        return carry, total

    _, totals = jax.lax.scan(body, None, (branches_k, ops_k, root_idx_k))
    return totals



_PALLAS_MODES = ("auto", True, False, "interpret", "pool")


def _ctip_rows(partition):
    """tip clv_index -> row in the raw tip-CLV value matrix (or -1 for
    state-code tips); None when no set_tip_clv tip exists. Single source
    of the ascending-index ordering contract shared with
    ops_fused.tip_clv_matrix."""
    if not bool(np.any(partition._tips_clv_set)):
        return None
    rows = np.full(partition.tips, -1, np.int32)
    idxs = np.flatnonzero(partition._tips_clv_set)
    rows[idxs] = np.arange(len(idxs), dtype=np.int32)
    return rows


class TreeEngine:
    """Compiled full-tree evaluator bound to one Partition + topology size.

    Host-side it compiles the traversal once into operation arrays; after
    a topology move only the arrays change, not the program.
    """

    def __init__(self, partition: Partition, tree=None,
                 operations: Optional[Sequence[Operation]] = None,
                 branches: Optional[Sequence[float]] = None,
                 pmatrix_indices: Optional[Sequence[int]] = None,
                 root=None, params_index: int = 0,
                 level_schedule: bool = True,
                 pallas="auto", edge_params=None):
        """pallas selects the CLV execution path:
          'auto'  — the whole-traversal kernel (ops/pallas_fused) when the
                    engine runs on a GPU and the problem is eligible
                    (fp32, all tips set, equal shards under a mesh); the
                    XLA levels/scan path otherwise;
          True    — the kernel, compiled; PllError when the engine's
                    platform is not a GPU;
          'interpret' — the kernel in Pallas interpret mode (any backend);
          'pool'  — for site-repeats partitions: the POOLED XLA compute
                    path instead of the dense fused kernel over the
                    compressed storage;
          False   — pure XLA (scan or level schedule).
        An ineligible problem (fp64, unset tips, an unpackable schedule)
        takes the XLA path; `execution_path` names the path taken."""
        if pallas not in _PALLAS_MODES:
            raise C.PllError(
                C.ERROR_PARAM_INVALID,
                f"pallas must be one of {sorted(map(str, _PALLAS_MODES))}, "
                f"got {pallas!r} (the per-level and pooled-repeats kernels "
                f"were removed: use 'auto', 'interpret' or 'pool')")
        self.partition = partition
        p = partition
        self.repeats_mode = p.repeats is not None
        if tree is not None:
            trav = traverse(tree.vroot)
            operations, branches, pmatrix_indices = create_operations(trav)
            root = tree.vroot
        # when the partition lives on a mesh, pin every small operand to the
        # same mesh (replicated) so one SPMD program sees consistent devices
        mesh = getattr(p, "mesh", None)
        if mesh is not None:
            from jax.sharding import PartitionSpec as P

            from .parallel.sharding import owned_shards, put_global
            self._rep = lambda x: put_global(x, mesh, P())
            self._site = lambda x: put_global(x, mesh, P("sites"))
            # the PROCESS-LOCAL padded width split over the shards this
            # process feeds
            mesh_n = owned_shards(mesh)
            platform = mesh.devices.flat[0].platform
        else:
            self._rep = self._site = jnp.asarray
            mesh_n = 1
            platform = jax.default_backend()
        # the kernel pads its site axis to its tile and slices the root
        # rows back, so any site count is eligible; only the sharded path
        # needs the partition itself to split evenly
        fused_core_ok = (p.dtype == jnp.float32
                         and (mesh is None or p.sites_padded % mesh_n == 0))
        eligible = fused_core_ok and p.repeats is None
        if pallas is True and platform != "gpu":
            raise C.PllError(
                C.ERROR_PARAM_INVALID,
                f"pallas=True compiles the fused kernel for a GPU; this "
                f"engine runs on {platform!r} (use pallas='interpret' to "
                f"run the kernel in interpret mode, or pallas='auto')")
        kernel_ok = pallas in (True, "interpret") or (
            pallas == "auto" and platform == "gpu")
        self.pallas_interpret = pallas == "interpret"
        # every tip must be set — from state codes (bitmask decode in the
        # kernel) or raw probabilities (set_tip_clv -> f32 rows streamed
        # in); the reference treats the latter as ordinary CLVs in every
        # kernel (reference: pll.c:959-1024)
        tips_codes_ok = bool(np.all(p._tips_set | p._tips_clv_set))
        # dense-math fused kernel over POOLED-storage partitions: repeats
        # partitions keep the compressed buffers (the memory win) but
        # EVALUATE through the dense kernel, which never materializes
        # inner CLVs. pallas='pool' forces the pooled XLA compute path.
        self.repeats_dense_fused = (
            self.repeats_mode and kernel_ok and fused_core_ok
            and mesh is None and tips_codes_ok)
        if self.repeats_dense_fused:
            self.repeats_mode = False
            self._clv_stub = jnp.zeros(
                (1, p.rate_cats, p.states, p.sites_padded), jnp.float32)
            self._sc_stub = jnp.zeros((3, p.sites_padded), jnp.int32)
        self._fused_wanted = ((kernel_ok and eligible and tips_codes_ok)
                              or self.repeats_dense_fused)
        self.fused_mesh = mesh
        self.levels = level_schedule
        self.params_index = params_index
        R = p.rate_cats
        # per-branch heterotachy: edge_params[e] is the rate-matrix index
        # used by pmatrix slot e (all rate categories); the root edge's
        # model drives the frequency/eigen mixing in the likelihood and
        # derivative stages, exactly as a reference client rooting the
        # evaluation on that branch would
        if edge_params is not None:
            ep = np.asarray(edge_params, dtype=np.int32)
            if ep.shape != (p.prob_matrices,):
                raise C.PllError(
                    C.ERROR_PARAM_INVALID,
                    f"edge_params must have shape ({p.prob_matrices},)")
            self.edge_params = self._rep(jnp.asarray(
                np.repeat(ep[:, None], R, axis=1)))
            self._edge_params_host = ep
            p._ensure_eigen(np.unique(ep))
        else:
            self.edge_params = None
            self._edge_params_host = None
        self.params_idx_rates = self._rep(
            jnp.asarray([params_index] * R, np.int32))
        self._tip_codes_version = None
        self._packed_ctips = frozenset()
        self._pack_topology(operations, branches, pmatrix_indices, root)
        p._ensure_eigen([params_index])

    @property
    def use_pallas(self) -> bool:
        """True when the fused Pallas kernel evaluates this engine."""
        return self.use_fused

    @property
    def ops(self):
        """Execution-plan operands. On the fused path the tip operands
        (bitmask codes + raw tip-CLV rows) are re-read through the
        version-checked cache so tip setters after engine construction
        take effect; the packed op table itself is topology state."""
        if self.use_fused:
            return self._ops + self._tip_codes()
        return self._ops

    @property
    def execution_path(self) -> str:
        """Which compute path this engine actually selected — eligibility
        checks (fp32, per-site scalers, tips from state codes, mesh
        alignment) downgrade SILENTLY, so inspect this when performance
        looks wrong. One of: repeats-dense-fused, fused, pool, levels,
        scan."""
        if self.repeats_dense_fused:
            return "repeats-dense-fused"
        if self.use_fused:
            return "fused"
        if self.repeats_mode:
            return "pool"
        return "levels" if self.levels else "scan"

    @property
    def asc_type(self) -> int:
        return self.partition.asc_bias.value

    @property
    def n_real(self) -> int:
        return self.partition.sites if self.partition.asc_extra else -1

    def _model_args(self):
        """Device-resident model operands, cached until a Partition setter
        bumps _model_version (avoids re-uploading unchanged model state on
        every call in search loops)."""
        p = self.partition
        version = p._model_version
        if getattr(self, "_model_cache_version", None) != version:
            # model setters invalidate the eigendecomposition; recompute
            # before uploading (the step-by-step path does this inside
            # update_prob_matrices)
            p._ensure_eigen([self.params_index])
            if self._edge_params_host is not None:
                p._ensure_eigen(np.unique(self._edge_params_host))
            d = p.dtype
            self._model_cache = tuple(
                self._rep(jnp.asarray(a, d)) for a in (
                    p.eigenvals, p.inv_eigenvecs, p.eigenvecs, p.prop_invar,
                    p.rates, p.rate_weights, p.frequencies)
            ) + (self.params_idx_rates,)
            self._site_cache = (self._site(jnp.asarray(p.pattern_weights)),
                                self._site(jnp.asarray(p.invariant)))
            self._model_cache_version = version
        return self._model_cache

    def _site_args(self):
        self._model_args()
        return self._site_cache

    def _tip_codes(self):
        """Device tip operands for the fused kernel — (bitmask codes,
        raw tip-CLV rows or None) — cached until a tip setter bumps the
        partition's tip version. Under a mesh both are sharded on their
        SITE axis."""
        p = self.partition
        v = getattr(p, "_tip_version", 0)
        if self._tip_codes_version != v:
            ctip_set = frozenset(np.flatnonzero(p._tips_clv_set).tolist())
            if ctip_set != self._packed_ctips:
                raise C.PllError(
                    C.ERROR_PARAM_INVALID,
                    "the set of raw-probability tips (set_tip_clv) "
                    "changed after this fused-kernel engine packed its "
                    "schedule; rebuild the TreeEngine (or call "
                    "set_topology) so the op table re-encodes which "
                    "tips stream CLV rows")
            mesh = getattr(p, "mesh", None)
            if mesh is None:
                grain = ops_fused.kernel_grain(p.states)
                pad_to = -(-p.sites_padded // grain) * grain
            else:
                pad_to = 0     # sharded axis must keep the partition width
            codes = jnp.asarray(ops_fused.tip_code_matrix(p, pad_to=pad_to))
            ctips = ops_fused.tip_clv_matrix(p, pad_to=pad_to)
            ctips = None if ctips is None else jnp.asarray(ctips)
            if mesh is not None:
                from jax.sharding import PartitionSpec as P

                from .parallel.sharding import put_global
                codes = put_global(codes, mesh, P(None, "sites"))
                if ctips is not None:
                    ctips = put_global(ctips, mesh, P(None, None, "sites"))
            self._tip_codes_cache = (codes, ctips)
            self._tip_codes_version = v
        return self._tip_codes_cache

    def _pack_repeats(self, operations, root_indices):
        """Build the pooled-storage schedule for one topology: installs
        the flat layout on the partition and returns (buckets, root_cols,
        mat) as device arrays (see pack_repeats_canonical)."""
        packed, root_cols, mat, _ = pack_repeats_canonical(
            self.partition, operations, root_indices)
        return (tuple((self._rep(jnp.asarray(f)), self._rep(jnp.asarray(g)),
                       self._rep(jnp.asarray(h))) for f, g, h in packed),
                tuple(self._rep(jnp.asarray(a)) for a in root_cols),
                self._rep(jnp.asarray(mat, np.int32)))

    def _pack_topology(self, operations, branches, pmatrix_indices,
                       root) -> None:
        """(Re)build op tables, pmatrix-ordered branches and root indices
        for the configured execution mode."""
        p = self.partition
        self.use_fused = False
        self.fused_slots = 0
        if self.repeats_mode:
            ri = (root.clv_index, root.scaler_index,
                  root.back.clv_index, root.back.scaler_index,
                  root.pmatrix_index)
            self._repeats_pack_args = (operations, ri)
            self._ops, self._root_cols, self._root_mat = \
                self._pack_repeats(operations, ri)
            self.valid = None
            blen = np.zeros(p.prob_matrices)
            blen[np.asarray(pmatrix_indices)] = np.asarray(branches)
            self.branches = self._rep(jnp.asarray(blen, p.dtype))
            self.root_idx = self._rep(jnp.asarray(list(ri),
                                                  dtype=np.int32))
            if self._edge_params_host is not None:
                # the root edge's model drives freqs/eigen mixing
                rm = int(self._edge_params_host[ri[4]])
                self.params_idx_rates = self._rep(jnp.asarray(
                    [rm] * p.rate_cats, np.int32))
                p._model_version += 1     # refresh cached operands
            return
        if self._fused_wanted:
            ctip_rows = _ctip_rows(p)
            table, n_slots = ops_fused.pack_fused_schedule(
                operations, p.tips,
                (root.clv_index, root.back.clv_index),
                clv_tip_rows=ctip_rows)
            if table is not None:
                self.use_fused = True
                self.fused_slots = n_slots
                self.valid = None
                self._packed_ctips = frozenset(
                    np.flatnonzero(p._tips_clv_set).tolist())
                self._tip_codes_version = None    # re-derive tip operands
                # tip operands are NOT baked into self.ops: the `ops`
                # property re-reads them through the version-checked
                # cache, so tip setters after engine construction take
                # effect (placement loops, EPA queries)
                ops = (jnp.asarray(table),)
            elif self.repeats_dense_fused:
                # a schedule the kernel cannot run (partial traversal /
                # missing scalers): a pooled partition has no dense
                # buffers to fall back on — use the pooled compute path
                self.repeats_dense_fused = False
                self.repeats_mode = True
                self._pack_topology(operations, branches, pmatrix_indices,
                                    root)
                return
        if not self.use_fused:
            if self.levels:
                from .partition import pack_level_operations
                ops, valid = pack_level_operations(operations, p.tips,
                                                   scratch_clv=p.nodes)
                self.valid = self._rep(valid)
            else:
                ops = pack_operations(operations, scratch_clv=p.nodes)
                self.valid = None
        self._ops = jax.tree.map(self._rep, ops)
        # branch lengths stored in pmatrix-index order
        blen = np.zeros(p.prob_matrices)
        blen[np.asarray(pmatrix_indices)] = np.asarray(branches)
        self.branches = self._rep(jnp.asarray(blen, p.dtype))
        self.root_idx = self._rep(jnp.asarray(
            [root.clv_index, root.scaler_index,
             root.back.clv_index, root.back.scaler_index,
             root.pmatrix_index], dtype=np.int32))
        if self._edge_params_host is not None:
            # the root edge's model drives freqs/eigen mixing downstream
            rm = int(self._edge_params_host[root.pmatrix_index])
            self.params_idx_rates = self._rep(jnp.asarray(
                [rm] * self.partition.rate_cats, np.int32))
            self.partition._model_version += 1   # refresh cached operands

    def set_topology(self, tree) -> None:
        """Rebind to a new topology of the same size without rebuilding the
        engine (search loops): refreshes op tables, branches and root
        indices only."""
        trav = traverse(tree.vroot)
        operations, branches, pmatrix_indices = create_operations(trav)
        self._pack_topology(operations, branches, pmatrix_indices,
                            tree.vroot)

    def _dense_bufs(self):
        """(clv, scaler) operands for the dense eval programs. A pooled
        (repeats_dense_fused) partition has no dense buffers — a 1-row
        stub provides the shapes; the fused kernel never reads it and the
        scatter-back is skipped (fused_scatter=False)."""
        if self.repeats_dense_fused:
            return self._clv_stub, self._sc_stub
        p = self.partition
        return p.clv, p.scale_buffer

    def loglikelihood(self, branches=None) -> float:
        """Full-traversal logL. `branches`, if given, must be in
        PMATRIX-INDEX order (the engine's storage order) — traversal-ordered
        lists from create_operations must be permuted through their
        pmatrix_indices first, as the constructor does."""
        total, _ = self._loglikelihood_dev(branches)
        return float(total)

    def loglikelihood_persite(self, branches=None):
        """(total logL, per-site WEIGHTED logL [sites_padded]) — the
        reference's persite_lnl output (likelihood.c:122 persite arg);
        synthetic asc columns and lane padding carry 0."""
        total, per = self._loglikelihood_dev(branches)
        return float(total), self._persite_host(per)

    def _loglikelihood_dev(self, branches=None):
        """Full evaluation with NO host sync: returns (total, per-site)
        as device values; the partition's CLV/scaler/pmatrix buffers
        update as device futures. Callers overlap host work (schedule
        builds, ranking) with the device evaluation — a blocking
        round-trip would otherwise serialize every consumer behind the
        per-site transfer."""
        p = self.partition
        if branches is not None:
            self.branches = self._rep(jnp.asarray(branches, p.dtype))
        if self.repeats_mode:
            total, per, clv_flat, sc_flat, pmatrix = _repeats_loglikelihood(
                p.clv_flat, p.sc_flat, *self._model_args(),
                self.branches, self.ops, self._root_cols, self._root_mat,
                *self._site_args(), p.scale_threshold, p.scale_factor,
                rate_scalers=p.rate_scalers,
                asc_type=self.asc_type, n_real=self.n_real,
                edge_params=self.edge_params)
            p.clv_flat, p.sc_flat, p.pmatrix = clv_flat, sc_flat, pmatrix
            return total, per
        clv0, sc0 = self._dense_bufs()
        total, per, clv, scaler, pmatrix = _fused_loglikelihood(
            clv0, sc0, *self._model_args(),
            self.branches, self.ops, self.root_idx, *self._site_args(),
            p.scale_threshold, p.scale_factor, rate_scalers=p.rate_scalers,
            valid=self.valid, levels=self.levels,
            pallas_interpret=self.pallas_interpret,
            asc_type=self.asc_type, n_real=self.n_real,
            fused_slots=self.fused_slots, edge_params=self.edge_params,
            fused_mesh=self.fused_mesh if self.use_fused else None,
            fused_scatter=not self.repeats_dense_fused)
        p.pmatrix = pmatrix
        if not self.repeats_dense_fused:
            p.clv, p.scale_buffer = clv, scaler
        return total, per

    def _persite_host(self, per):
        """Per-site vector as numpy. Under a multi-process mesh only this
        process's column block is addressable — return that block (its
        global offset is process_index * block, matching the reference's
        per-rank persite_lnl slices)."""
        mesh = getattr(self.partition, "mesh", None)
        if mesh is not None:
            from .parallel.sharding import is_multiprocess
            if is_multiprocess(mesh):
                shards = sorted(per.addressable_shards,
                                key=lambda s: s.index[0].start or 0)
                return np.concatenate([np.asarray(s.data) for s in shards])
        return np.asarray(per)

    def site_rate_posteriors(self):
        """Empirical-Bayes per-site rate-category posteriors and
        posterior-mean site rates across the root edge (the consumers'
        per-site rate output). Returns (posteriors [R+1, sites_padded],
        site_rates [sites_padded]) as numpy arrays — the last category is
        the +I invariant class (all-zero when pinv = 0); synthetic
        asc/pad columns carry whatever the math gives and should be
        ignored."""
        p = self.partition
        margs = self._model_args()
        (eigenvals, inv_eigenvecs, eigenvecs, prop_invar, rates,
         rate_weights, freqs, pidx) = margs
        if self.repeats_mode:
            self.loglikelihood()
            pc, psc, cc, csc = self._root_cols
            clv_p = jnp.take(p.clv_flat, pc, axis=2)
            clv_c = jnp.take(p.clv_flat, cc, axis=2)
            sc_p = jnp.take(p.sc_flat, psc, axis=-1)
            sc_c = jnp.take(p.sc_flat, csc, axis=-1)
            pm_root = jnp.take(p.pmatrix, self._root_mat, axis=0)
        elif self.repeats_dense_fused:
            # pooled storage has no dense rows: one no-scatter eval
            # returns the root rows directly
            _, _, rows, _, pmatrix = _fused_loglikelihood(
                *self._dense_bufs(), *margs, self.branches, self.ops,
                self.root_idx, *self._site_args(), p.scale_threshold,
                p.scale_factor, rate_scalers=p.rate_scalers,
                pallas_interpret=self.pallas_interpret,
                asc_type=self.asc_type, n_real=self.n_real,
                fused_slots=self.fused_slots,
                edge_params=self.edge_params, fused_scatter=False)
            clv_p, clv_c, sc_p, sc_c = rows
            pm_root = jnp.take(pmatrix, self.root_idx[4], axis=0)
        else:
            self.loglikelihood()       # refresh the root rows
            ri = self.root_idx
            clv_p = jnp.take(p.clv, ri[0], axis=0)
            clv_c = jnp.take(p.clv, ri[2], axis=0)
            # scaler index -1 (a tip) wraps to the last row, which the
            # partition guarantees to be all-zero (SCALE_BUFFER_NONE)
            sc_p = jnp.take(p.scale_buffer, ri[1], axis=0)
            sc_c = jnp.take(p.scale_buffer, ri[3], axis=0)
            pm_root = jnp.take(p.pmatrix, ri[4], axis=0)
        post, site_rate = ops_likelihood.rate_posteriors(
            clv_p, clv_c, sc_p, sc_c, pm_root, freqs, prop_invar,
            rates, rate_weights, pidx, self._site_args()[1],
            scale_threshold=p.scale_threshold,
            rate_scalers=p.rate_scalers)
        return np.asarray(post), np.asarray(site_rate)

    def apply_branches_to_tree(self, tree) -> None:
        """Write the engine's (possibly optimized) branch lengths back onto
        the tree's half-edges, keyed by pmatrix index."""
        blen = np.asarray(self.branches, dtype=np.float64)
        seen = set()
        for node in tree.nodes():
            halves = [node] if node.is_tip() else list(node.ring())
            for h in halves:
                if h.back is not None and id(h) not in seen:
                    seen.add(id(h))
                    seen.add(id(h.back))
                    h.length = h.back.length = float(blen[h.pmatrix_index])

    def _evaluate_topologies_pooled(self, candidates) -> np.ndarray:
        """Candidate scoring over pooled storage: class schedules are
        topology-dependent data of varying shapes, so candidates score
        one dispatch each, then the engine's own schedule is restored."""
        p = self.partition
        out = np.zeros(len(candidates))
        for i, (operations, branches, pmatrix_indices, root) in \
                enumerate(candidates):
            ri = list(root) if isinstance(root, (tuple, list)) else [
                root.clv_index, root.scaler_index,
                root.back.clv_index, root.back.scaler_index,
                root.pmatrix_index]
            buckets, root_cols, mat = self._pack_repeats(
                operations, tuple(ri))
            blen = np.zeros(p.prob_matrices)
            blen[np.asarray(pmatrix_indices)] = np.asarray(branches)
            margs = list(self._model_args())
            if self._edge_params_host is not None:
                # heterotachy: THIS candidate's root edge's model
                # drives the freqs/eigen mixing, exactly as
                # set_topology + loglikelihood would compute
                rm = int(self._edge_params_host[ri[4]])
                margs[7] = self._rep(jnp.asarray(
                    [rm] * p.rate_cats, np.int32))
            total, _, _, _, _ = _repeats_loglikelihood(
                p.clv_flat, p.sc_flat, *margs,
                jnp.asarray(blen, p.dtype), buckets, root_cols, mat,
                *self._site_args(), p.scale_threshold, p.scale_factor,
                rate_scalers=p.rate_scalers,
                asc_type=self.asc_type, n_real=self.n_real,
                edge_params=self.edge_params)
            out[i] = float(total)
        if getattr(self, "_repeats_pack_args", None) is not None:
            self._ops, self._root_cols, self._root_mat = \
                self._pack_repeats(*self._repeats_pack_args)
        return out

    def evaluate_topologies(self, candidates) -> np.ndarray:
        """logL for each (operations, branches, pmatrix_indices, root)
        candidate tuple, all in one dispatch (see _fused_multi_topology).
        Candidate count is padded to a power of two so varying counts hit
        a bounded set of compiled shapes."""
        p = self.partition
        k = len(candidates)
        if k == 0:
            return np.zeros(0)
        if self.repeats_mode:
            return self._evaluate_topologies_pooled(candidates)
        w = 1
        while w < k:
            w *= 2
        packed, blens, roots = [], [], []
        fused_tables = [] if self.use_fused else None
        fused_slots = 0
        ctip_rows = _ctip_rows(p) if self._packed_ctips else None
        for ci in range(w):
            operations, branches, pmatrix_indices, root = \
                candidates[min(ci, k - 1)]
            # root may be a live UNode or a pre-snapshotted 5-tuple of
            # indices — candidates built from trial moves MUST snapshot
            # before rolling the move back (the node's pointers change)
            if isinstance(root, (tuple, list)):
                ri = list(root)
            else:
                ri = [root.clv_index, root.scaler_index,
                      root.back.clv_index, root.back.scaler_index,
                      root.pmatrix_index]
            roots.append(ri)
            if fused_tables is not None:
                table, n_slots = ops_fused.pack_fused_schedule(
                    operations, p.tips, (ri[0], ri[2]),
                    clv_tip_rows=ctip_rows)
                if table is None:
                    fused_tables = None    # fall back to the scan path
                else:
                    fused_tables.append(table)
                    fused_slots = max(fused_slots, n_slots)
            b = np.zeros(p.prob_matrices)
            b[np.asarray(pmatrix_indices)] = np.asarray(branches)
            blens.append(b)
        if fused_tables is not None:
            fused_slots = self._stable_slots(fused_slots)
            ops_k = ((jnp.asarray(np.stack(fused_tables)),)
                     + self._tip_codes())
        elif self.repeats_dense_fused:
            # the scan fallback needs dense buffers a pooled partition
            # does not have: score each candidate through the pooled
            # engine path instead (one dispatch each)
            return self._evaluate_topologies_pooled(candidates)
        else:
            for ci in range(w):
                operations = candidates[min(ci, k - 1)][0]
                packed.append(pack_operations(operations,
                                              scratch_clv=p.nodes))
            ops_k = jax.tree.map(lambda *xs: jnp.stack(xs), *packed)
            fused_slots = 0
        totals = _fused_multi_topology(
            *self._dense_bufs(), *self._model_args(),
            jnp.asarray(np.stack(blens), p.dtype), ops_k,
            jnp.asarray(np.asarray(roots, dtype=np.int32)),
            *self._site_args(), p.scale_threshold, p.scale_factor,
            rate_scalers=p.rate_scalers,
            asc_type=self.asc_type, n_real=self.n_real,
            fused_slots=fused_slots,
            pallas_interpret=self.pallas_interpret,
            edge_params=self.edge_params)
        return np.asarray(totals)[:k]

    def _stable_slots(self, n_slots: int) -> int:
        """Slot count for candidate-batch programs. fused_slots is a
        STATIC argument — every new value costs a full recompile of the
        multi-topology program (~10-15 s at 1000 taxa), and the max live
        slot count drifts by 1-2 as accepted moves reshape the tree. So:
        round up to a grain of 8 and keep the running maximum — the
        count is monotone across a search, giving at most one or two
        compiles per search instead of one per round."""
        grain = -(-max(int(n_slots), self.fused_slots) // 8) * 8
        self._cand_slots = max(getattr(self, "_cand_slots", 0), grain)
        return self._cand_slots

    def pack_candidate(self, vroot):
        """(table, blens, root_info, n_slots) for the CURRENT topology
        rooted at `vroot`, via the one-pass tree walk (no Operation
        objects) — the search loop's per-candidate fast path. Fused path
        only; returns None when the topology cannot be packed."""
        if not self.use_fused:
            return None
        p = self.partition
        ctips = _ctip_rows(p) if self._packed_ctips else None
        table, blens, ri, n_slots = ops_fused.fused_candidate_from_tree(
            vroot, p.tips, p.prob_matrices, clv_tip_rows=ctips)
        if table is None:
            return None
        return table, blens, ri, n_slots

    def evaluate_packed(self, packed) -> np.ndarray:
        """logL for pre-packed fused candidates [(table, blens,
        root_info, n_slots)] from pack_candidate — identical semantics
        to evaluate_topologies without the Operation-object pipeline
        (~1.7x less host work per candidate at 1000 taxa)."""
        p = self.partition
        k = len(packed)
        if k == 0:
            return np.zeros(0)
        w = 1
        while w < k:
            w *= 2
        tables = [packed[min(ci, k - 1)][0] for ci in range(w)]
        blens = [packed[min(ci, k - 1)][1] for ci in range(w)]
        roots = [list(packed[min(ci, k - 1)][2]) for ci in range(w)]
        fused_slots = self._stable_slots(max(pc[3] for pc in packed))
        ops_k = ((jnp.asarray(np.stack(tables)),) + self._tip_codes())
        totals = _fused_multi_topology(
            *self._dense_bufs(), *self._model_args(),
            jnp.asarray(np.stack(blens), p.dtype), ops_k,
            jnp.asarray(np.asarray(roots, dtype=np.int32)),
            *self._site_args(), p.scale_threshold, p.scale_factor,
            rate_scalers=p.rate_scalers,
            asc_type=self.asc_type, n_real=self.n_real,
            fused_slots=fused_slots,
            pallas_interpret=self.pallas_interpret,
            edge_params=self.edge_params)
        return np.asarray(totals)[:k]

    def evaluate_packed_arrays(self, tables, blens, roots,
                               n_slots: int) -> np.ndarray:
        """logL for pre-stacked fused candidate arrays — tables
        [K, n_ops+1, 8], blens [K, E], roots [K, 5] (the native SPR
        candidate builder's output, native/pllnative.cpp
        pll_nat_spr_candidates). Same semantics as evaluate_packed
        without the per-candidate Python list walk."""
        p = self.partition
        k = tables.shape[0]
        if k == 0:
            return np.zeros(0)
        w = 1
        while w < k:
            w *= 2
        if w != k:
            # pad with copies of the last candidate (bounded shape set)
            reps = [tables[-1:], blens[-1:], roots[-1:]]
            tables = np.concatenate(
                [tables, np.repeat(reps[0], w - k, axis=0)])
            blens = np.concatenate(
                [blens, np.repeat(reps[1], w - k, axis=0)])
            roots = np.concatenate(
                [roots, np.repeat(reps[2], w - k, axis=0)])
        fused_slots = self._stable_slots(int(n_slots))
        ops_k = ((jnp.asarray(tables),) + self._tip_codes())
        totals = _fused_multi_topology(
            *self._dense_bufs(), *self._model_args(),
            jnp.asarray(blens, p.dtype), ops_k,
            jnp.asarray(roots, np.int32),
            *self._site_args(), p.scale_threshold, p.scale_factor,
            rate_scalers=p.rate_scalers,
            asc_type=self.asc_type, n_real=self.n_real,
            fused_slots=fused_slots,
            pallas_interpret=self.pallas_interpret,
            edge_params=self.edge_params)
        return np.asarray(totals)[:k]

    def newton_loop(self, k: int):
        """k chained Newton iterations on the root branch in one dispatch;
        returns (last logL, d1, d2). Trip count is traced (one compile)."""
        p = self.partition
        if self.repeats_mode:
            total, d1, d2, branches, clv_flat, sc_flat = \
                _repeats_newton_loop(
                    jnp.asarray(k), p.clv_flat, p.sc_flat,
                    *self._model_args(), self.branches, self.ops,
                    self._root_cols, self._root_mat, *self._site_args(),
                    p.scale_threshold, p.scale_factor,
                    rate_scalers=p.rate_scalers,
                    asc_type=self.asc_type, n_real=self.n_real,
                    edge_params=self.edge_params)
            self.branches = branches
            p.clv_flat, p.sc_flat = clv_flat, sc_flat
            return float(total), float(d1), float(d2)
        total, d1, d2, branches, clv, scaler = _fused_newton_loop(
            jnp.asarray(k), *self._dense_bufs(), *self._model_args(),
            self.branches, self.ops, self.root_idx, *self._site_args(),
            p.scale_threshold, p.scale_factor, rate_scalers=p.rate_scalers,
            valid=self.valid, levels=self.levels,
            pallas_interpret=self.pallas_interpret,
            asc_type=self.asc_type, n_real=self.n_real,
            fused_slots=self.fused_slots, edge_params=self.edge_params,
            fused_mesh=self.fused_mesh if self.use_fused else None,
            fused_scatter=not self.repeats_dense_fused)
        self.branches = branches
        if not self.repeats_dense_fused:
            p.clv, p.scale_buffer = clv, scaler
        return float(total), float(d1), float(d2)

    def loglikelihood_loop(self, k: int) -> float:
        """Sum of k chained full-traversal logL evaluations, one dispatch.
        The trip count is traced: one compilation serves every k."""
        p = self.partition
        if self.repeats_mode:
            acc, clv_flat, sc_flat = _repeats_loglikelihood_loop(
                jnp.asarray(k), p.clv_flat, p.sc_flat,
                *self._model_args(), self.branches, self.ops,
                self._root_cols, self._root_mat, *self._site_args(),
                p.scale_threshold, p.scale_factor,
                rate_scalers=p.rate_scalers,
                asc_type=self.asc_type, n_real=self.n_real,
                edge_params=self.edge_params)
            p.clv_flat, p.sc_flat = clv_flat, sc_flat
            return float(acc)
        acc, _, _ = _fused_loglikelihood_loop(
            jnp.asarray(k), *self._dense_bufs(), *self._model_args(),
            self.branches, self.ops, self.root_idx, *self._site_args(),
            p.scale_threshold, p.scale_factor, rate_scalers=p.rate_scalers,
            valid=self.valid, levels=self.levels,
            pallas_interpret=self.pallas_interpret,
            asc_type=self.asc_type, n_real=self.n_real,
            fused_slots=self.fused_slots, edge_params=self.edge_params,
            fused_mesh=self.fused_mesh if self.use_fused else None,
            fused_scatter=not self.repeats_dense_fused)
        return float(acc)

    def newton_step(self):
        """Evaluate + one Newton update of the root branch; returns
        (logL, d1, d2)."""
        p = self.partition
        if self.repeats_mode:
            return self.newton_loop(1)
        total, d1, d2, branches, clv, scaler = _fused_newton_step(
            *self._dense_bufs(), *self._model_args(),
            self.branches, self.ops, self.root_idx, *self._site_args(),
            p.scale_threshold, p.scale_factor, rate_scalers=p.rate_scalers,
            valid=self.valid, levels=self.levels,
            pallas_interpret=self.pallas_interpret,
            asc_type=self.asc_type, n_real=self.n_real,
            fused_slots=self.fused_slots, edge_params=self.edge_params,
            fused_mesh=self.fused_mesh if self.use_fused else None,
            fused_scatter=not self.repeats_dense_fused)
        self.branches = branches
        if not self.repeats_dense_fused:
            p.clv, p.scale_buffer = clv, scaler
        return float(total), float(d1), float(d2)
