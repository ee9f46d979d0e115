"""Branch-length derivatives of the log-likelihood (Newton engine).

Two-phase split identical to the reference (reference:
/root/reference/src/core_derivatives.c:25-471 sumtable, :643-929 derivatives):

Phase 1 (once per edge, branch-length independent): rotate both CLVs into the
eigenbasis and form

    sum[r, j, s] = (sum_k clvp[r,k,s] * f[r,k] * inv_evecs[r,k,j])
                 * (sum_k evecs[r,j,k] * clvc[r,k,s])

Phase 2 (per candidate branch length, O(states) per site): with
x_rj = lambda_rj * rate_r / (1 - pinv_r),

    L  (s) = sum_r w_r sum_j sum[r,j,s] * exp(x_rj t)        (* (1-pinv) + inv)
    L' (s) = sum_r w_r sum_j sum[r,j,s] * x_rj exp(x_rj t)   (* (1-pinv))
    L''(s) = sum_r w_r sum_j sum[r,j,s] * x_rj^2 exp(x_rj t) (* (1-pinv))
    d1 = sum_s w_s * (-L'/L);   d2 = sum_s w_s * ((L'/L)^2 - L''/L)

Numerical-scaling note: per-site scalers cancel in the L'/L and L''/L ratios
so they are never materialized here; per-rate scalers are folded into the
sumtable as capped relative factors (core_derivatives.c:399-460), exactly as
the reference does.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..constants import (AB_FELSENSTEIN, AB_LEWIS, AB_NONE,
                         AB_STAMATAKIS, SCALE_RATE_MAXDIFF)


@partial(jax.jit, static_argnames=('rate_scalers', 'has_pscaler', 'has_cscaler'))
def update_sumtable(clv_parent: jnp.ndarray,   # [R, s, S]
                    clv_child: jnp.ndarray,    # [R, s, S]
                    pscaler: jnp.ndarray,      # per-rate mode: [R, S]
                    cscaler: jnp.ndarray,
                    inv_evecs: jnp.ndarray,    # [M, s, s]
                    evecs: jnp.ndarray,        # [M, s, s]
                    freqs: jnp.ndarray,        # [M, s]
                    params_idx: jnp.ndarray,   # [R]
                    scale_threshold: float,
                    rate_scalers: bool = False,
                    has_pscaler: bool = False,
                    has_cscaler: bool = False) -> jnp.ndarray:
    """Returns the sumtable [R, s, S]."""
    dtype = clv_parent.dtype
    a = inv_evecs[params_idx].astype(dtype)    # [R, s, s]
    b = evecs[params_idx].astype(dtype)
    f = freqs[params_idx].astype(dtype)        # [R, s]

    lefterm = jnp.einsum('rks,rkj->rjs', clv_parent * f[:, :, None], a,
                         preferred_element_type=dtype,
                       precision=jax.lax.Precision.HIGHEST)
    righterm = jnp.einsum('rjk,rks->rjs', b, clv_child,
                          preferred_element_type=dtype,
                       precision=jax.lax.Precision.HIGHEST)
    sumtable = lefterm * righterm

    if rate_scalers:
        sc = jnp.zeros_like(pscaler)
        if has_pscaler:
            sc = sc + pscaler
        if has_cscaler:
            sc = sc + cscaler
        rel = jnp.minimum(sc - jnp.min(sc, axis=0)[None, :],
                          SCALE_RATE_MAXDIFF)
        # gather-free threshold**rel: exact powers of two, no table
        from .likelihood import cap_pow
        sumtable = sumtable * cap_pow(scale_threshold, rel,
                                      dtype)[:, None, :]
    return sumtable


@partial(jax.jit, static_argnames=('asc_type', 'n_real'))
def likelihood_derivatives(sumtable: jnp.ndarray,      # [R, s, S]
                           eigenvals: jnp.ndarray,     # [M, s]
                           prop_invar: jnp.ndarray,    # [M]
                           freqs: jnp.ndarray,         # [M, s]
                           rates: jnp.ndarray,         # [R]
                           rate_weights: jnp.ndarray,  # [R]
                           params_idx: jnp.ndarray,    # [R]
                           pattern_weights: jnp.ndarray,  # [S]
                           invariant: jnp.ndarray,     # [S]
                           branch_length: jnp.ndarray,  # scalar
                           asc_scalers: jnp.ndarray | None = None,  # [S]
                           scale_threshold: float = 0.0,
                           asc_type: int = AB_NONE,
                           n_real: int = -1):
    """Returns (d1, d2): first/second derivative of -logL w.r.t. the length.

    Ascertainment bias (core_derivatives.c:852-924): Stamatakis needs no
    special handling here — the synthetic columns carry ordinary pattern
    weights and enter the main sums (scalers cancel in the L'/L ratios).
    Lewis/Felsenstein exclude them from the main sums and add derivative
    corrections of the log-of-sum terms; absolute likelihoods of the
    synthetic columns need their per-site scalers (`asc_scalers` = summed
    parent+child scaler rows) un-done explicitly."""
    dtype = sumtable.dtype
    lam = eigenvals[params_idx].astype(dtype)           # [R, s]
    pinv = prop_invar[params_idx].astype(dtype)         # [R]
    f = freqs[params_idx].astype(dtype)                 # [R, s]
    w = rate_weights.astype(dtype)                      # [R]

    x = lam * (rates.astype(dtype) / (1.0 - pinv))[:, None]   # [R, s]
    e = jnp.exp(x * branch_length.astype(dtype))
    # cat_lk[d, r, s]; d in {L, L', L''}
    diagp = jnp.stack([e, x * e, x * x * e])                  # [3, R, s]
    cat = jnp.einsum('rjs,drj->drs', sumtable, diagp,
                     preferred_element_type=dtype,
                       precision=jax.lax.Precision.HIGHEST)

    # invariant-site mixing per rate (core_derivatives.c:676-686)
    inv_ok = invariant >= 0
    inv_state = jnp.maximum(invariant, 0)
    inv_freq = jnp.take(f, inv_state, axis=1)                       # [R, S]
    inv_lk = jnp.where(inv_ok[None, :] & (pinv[:, None] > 0),
                       inv_freq * pinv[:, None], 0.0)
    one_m_pinv = jnp.where(pinv > 0, 1.0 - pinv, 1.0)[None, :, None]
    cat = cat * one_m_pinv
    cat = cat.at[0].add(inv_lk)

    site = jnp.einsum('drs,r->ds', cat, w, preferred_element_type=dtype,
                       precision=jax.lax.Precision.HIGHEST)
    valid = pattern_weights > 0
    lk0 = jnp.where(valid & (site[0] != 0), site[0], 1.0)
    deriv1 = -site[1] / lk0
    deriv2 = deriv1 * deriv1 - site[2] / lk0
    pw = jnp.where(valid, pattern_weights.astype(dtype), 0.0)
    if asc_type == AB_STAMATAKIS or (asc_type == AB_NONE and n_real < 0):
        return jnp.sum(pw * deriv1), jnp.sum(pw * deriv2)

    # mask the synthetic columns out of the main sums
    states = sumtable.shape[1]
    main = (jnp.arange(site.shape[1]) < n_real).astype(dtype)
    d1 = jnp.sum(pw * main * deriv1)
    d2 = jnp.sum(pw * main * deriv2)
    if asc_type == AB_NONE:
        return d1, d2

    # Lewis / Felsenstein corrections (core_derivatives.c:852-924)
    sc = jax.lax.dynamic_slice(asc_scalers, (n_real,), (states,))
    scaling = jnp.asarray(scale_threshold, dtype) ** sc.astype(dtype)
    asc_lk = jnp.sum(
        jax.lax.dynamic_slice(site, (0, n_real), (3, states))
        * scaling[None, :], axis=1)                      # [3]
    if asc_type == AB_LEWIS:
        sum_w = jnp.sum(pw * main)
        d1 = d1 + sum_w * (asc_lk[1] / (asc_lk[0] - 1.0))
        d2 = d2 + sum_w * (((asc_lk[0] - 1.0) * asc_lk[2]
                            - asc_lk[1] * asc_lk[1])
                           / ((asc_lk[0] - 1.0) * (asc_lk[0] - 1.0)))
    else:
        pw_all = pattern_weights.astype(dtype)
        sum_w_inv = jnp.sum(jax.lax.dynamic_slice(pw_all, (n_real,),
                                                  (states,)))
        d1 = d1 - sum_w_inv * (asc_lk[1] / asc_lk[0])
        d2 = d2 - sum_w_inv * ((asc_lk[2] * asc_lk[0]
                                - asc_lk[1] * asc_lk[1])
                               / (asc_lk[0] * asc_lk[0]))
    return d1, d2


def newton_step(length, d1, d2, xmin, xmax):
    """One guarded Newton-Raphson update on a branch length."""
    step = jnp.where(d2 != 0.0, d1 / d2, 0.0)
    new = length - step
    # fall back to bisection-style damping when Newton leaves the bracket
    new = jnp.where((new < xmin) | (new > xmax) | (d2 <= 0.0),
                    jnp.where(d1 > 0, length / 2.0,
                              jnp.minimum(length * 2.0, xmax)),
                    new)
    return jnp.clip(new, xmin, xmax)
