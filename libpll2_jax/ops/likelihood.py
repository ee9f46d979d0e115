"""Root- and edge-based log-likelihood evaluation.

Matches the reference semantics (reference:
/root/reference/src/core_likelihood.c:25-209 root, :1192-1497 edge ii;
per-rate scaler handling as in /root/reference/src/core_likelihood_avx.c:
320-523):

  site_lk = sum_r w_r * [ L_r(site) * (1 - pinv_r) + pinv_r * f_r(inv_state) ]
  logL    = sum_sites weight_s * log(site_lk)  (+ scaler * log(2**-256))

with the exact reference treatment of numerical scaling:
  * per-site scalers are undone in log space: + scalings * log(threshold);
  * per-rate scalers (PLL_ATTRIB_RATE_SCALERS) are reduced to a common
    per-site minimum plus capped (PLL_SCALE_RATE_MAXDIFF=4) relative factors
    multiplied into each rate term;
  * when an invariant-site term is present, the variable part is un-scaled by
    a capped linear factor instead ("undoing the scaling for the non-variant
    likelihood term only", core_likelihood.c:1470-1485).

Layout: CLVs are [rate, state, site] with sites on the minor axis; the
state contraction is a small batched matmul, everything else is lane-wise.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..constants import (AB_FELSENSTEIN, AB_LEWIS, AB_NONE,
                         AB_STAMATAKIS, SCALE_RATE_MAXDIFF)


def cap_pow(threshold, rel, dtype):
    """threshold ** min(rel, MAXDIFF) as SCALE_RATE_MAXDIFF select+multiply
    steps: elementwise, fusible into the surrounding kernel, and exact
    (powers of two multiply exactly)."""
    thr = jnp.asarray(threshold, dtype)
    f = jnp.ones(rel.shape, dtype)
    for k in range(1, SCALE_RATE_MAXDIFF + 1):
        f = jnp.where(rel >= k, f * thr, f)
    return f


def _site_scalings(scaler, rate_scalers: bool, threshold, dtype):
    """Split scalers into a per-site count and capped per-rate factors.

    scaler: [S] (per-site mode) or [R, S] (per-rate mode), already the sum of
    all contributing buffers. Returns (site_sc [S], rate_factor [R, S] or None).
    """
    if not rate_scalers:
        return scaler, None
    site_sc = jnp.min(scaler, axis=0)                      # [S]
    rel = jnp.minimum(scaler - site_sc[None, :], SCALE_RATE_MAXDIFF)
    return site_sc, cap_pow(threshold, rel, dtype)         # threshold**rel


def _finalize_site_lk(terma, terminv, site_sc, threshold, dtype):
    """Reference scaling/invariant interaction (core_likelihood.c:1463-1486)."""
    log_thresh = jnp.log(jnp.asarray(threshold, dtype))
    capped = jnp.minimum(site_sc, SCALE_RATE_MAXDIFF).astype(dtype)
    cap_factor = jnp.asarray(threshold, dtype) ** capped

    has_sc = site_sc > 0
    has_inv = terminv > 0.0
    # choose the argument of the log per the three reference branches
    log_arg = jnp.where(has_sc,
                        jnp.where(has_inv, terma * cap_factor + terminv, terma),
                        terma + terminv)
    # honest log: a zero site likelihood (total underflow the scalers
    # could not catch, e.g. per-site mode at extreme Gamma shapes on deep
    # trees) is -inf, exactly as the reference reports it. Padded/zero-
    # weight columns are neutralized downstream in _apply_asc.
    site_lk = jnp.log(jnp.maximum(log_arg, 0.0))
    site_lk = site_lk + jnp.where(has_sc & ~has_inv,
                                  site_sc.astype(dtype) * log_thresh, 0.0)
    return site_lk


def _apply_asc(site_lk, terma, site_sc, pattern_weights,
               asc_type: int, n_real: int, states: int, threshold, dtype):
    """Ascertainment-bias corrections (likelihood.c:24-117).

    The partition stores `states` synthetic all-state-k columns after the
    real sites; their pre-log likelihood `terma` and per-site scalers feed
    the correction. Stamatakis treats them as ordinary weighted sites (no
    masking needed); Lewis/Felsenstein exclude them from the main sum and
    apply a log-of-sum correction. Requires pinv == 0 (enforced upstream).
    Returns (total, weighted_per_site)."""
    pw = pattern_weights.astype(dtype)
    # site_lk may be -inf (zero site likelihood); 0 * -inf would be nan,
    # so zero-weight (padded) columns must be masked, not multiplied out
    if asc_type == AB_STAMATAKIS or (asc_type == AB_NONE and n_real < 0):
        # Stamatakis treats the synthetic columns as ordinary weighted sites;
        # n_real < 0 marks "no synthetic columns allocated"
        weighted = jnp.where(pw > 0, site_lk * pw, 0.0)
        if asc_type == AB_STAMATAKIS and n_real >= 0:
            # the reference adds the scaler-undo term UNWEIGHTED on the
            # synthetic columns (likelihood.c:95-101: site_lk = w*log(term)
            # + sc*log(thresh), not w*(log(term) + sc*log(thresh)))
            idxs = jnp.arange(site_lk.shape[0])
            asc_cols = (idxs >= n_real) & (idxs < n_real + states)
            sc_term = site_sc.astype(dtype) * jnp.log(
                jnp.asarray(threshold, dtype))
            weighted = jnp.where(asc_cols,
                                 (site_lk - sc_term) * pw + sc_term,
                                 weighted)
        return jnp.sum(weighted), weighted
    # mask the synthetic columns out of the main sum (their weights may be
    # set even when the correction is currently switched off)
    main = (jnp.arange(site_lk.shape[0]) < n_real).astype(dtype)
    weighted = jnp.where(pw * main > 0, site_lk * pw * main, 0.0)
    if asc_type == AB_NONE:
        return jnp.sum(weighted), weighted
    term_asc = jax.lax.dynamic_slice(terma, (n_real,), (states,))
    sc_asc = jax.lax.dynamic_slice(site_sc, (n_real,), (states,))
    base = jnp.sum(term_asc * jnp.asarray(threshold, dtype)
                   ** sc_asc.astype(dtype))
    if asc_type == AB_LEWIS:
        sum_w = jnp.sum(pw * main)
        corr = -sum_w * jnp.log(1.0 - base)
    else:
        sum_w_inv = jnp.sum(jax.lax.dynamic_slice(pw, (n_real,), (states,)))
        corr = sum_w_inv * jnp.log(base)
    return jnp.sum(weighted) + corr, weighted


def _mix_rates(terma_r, rate_factor, freqs_r, pinv_r, rate_weights,
               invariant, dtype):
    """Rate-weighted mixing with proportion-of-invariant-sites handling.

    terma_r: [R, S] per-rate site likelihoods; returns (terma [S], terminv [S]).
    """
    if rate_factor is not None:
        terma_r = terma_r * rate_factor

    w = rate_weights[:, None].astype(dtype)                 # [R, 1]
    pinv = pinv_r[:, None].astype(dtype)                    # [R, 1]
    terma = jnp.sum(w * terma_r * (1.0 - pinv), axis=0)     # [S]

    inv_ok = invariant >= 0                                 # [S]
    inv_state = jnp.maximum(invariant, 0)
    inv_freq = jnp.take(freqs_r.astype(dtype), inv_state, axis=1)  # [R, S]
    terminv = jnp.sum(jnp.where(inv_ok[None, :] & (pinv > 0),
                                w * inv_freq * pinv, 0.0), axis=0)
    return terma, terminv


@partial(jax.jit, static_argnames=('rate_scalers', 'has_scaler',
                                   'asc_type', 'n_real'))
def root_loglikelihood(clv: jnp.ndarray,            # [R, s, S]
                       scaler: jnp.ndarray,         # [S] or [R, S] int32
                       freqs: jnp.ndarray,          # [M, s]
                       prop_invar: jnp.ndarray,     # [M]
                       rate_weights: jnp.ndarray,   # [R]
                       params_idx: jnp.ndarray,     # [R] int
                       pattern_weights: jnp.ndarray,  # [S]
                       invariant: jnp.ndarray,      # [S] int (-1 = variable)
                       scale_threshold: float,
                       rate_scalers: bool = False,
                       has_scaler: bool = True,
                       asc_type: int = AB_NONE,
                       n_real: int = -1):
    """Returns (total logL, per-site weighted logL [S])."""
    dtype = clv.dtype
    f = freqs[params_idx].astype(dtype)              # [R, s]
    pinv = prop_invar[params_idx]

    term_r = jnp.einsum('ris,ri->rs', clv, f, preferred_element_type=dtype,
                       precision=jax.lax.Precision.HIGHEST)

    if has_scaler:
        site_sc, rate_factor = _site_scalings(scaler, rate_scalers,
                                               scale_threshold, dtype)
    else:
        site_sc = jnp.zeros(clv.shape[-1], dtype=jnp.int32)
        rate_factor = None

    terma, terminv = _mix_rates(term_r, rate_factor, f[:, :],
                                pinv, rate_weights, invariant, dtype)
    site_lk = _finalize_site_lk(terma, terminv, site_sc, scale_threshold, dtype)
    return _apply_asc(site_lk, terma, site_sc, pattern_weights,
                      asc_type, n_real, clv.shape[1], scale_threshold, dtype)


@partial(jax.jit, static_argnames=('rate_scalers', 'has_pscaler',
                                   'has_cscaler', 'asc_type', 'n_real'))
def edge_loglikelihood(clv_parent: jnp.ndarray,     # [R, s, S]
                       clv_child: jnp.ndarray,      # [R, s, S]
                       pscaler: jnp.ndarray,
                       cscaler: jnp.ndarray,
                       pmatrix: jnp.ndarray,        # [R, s, s]
                       freqs: jnp.ndarray,          # [M, s]
                       prop_invar: jnp.ndarray,     # [M]
                       rate_weights: jnp.ndarray,   # [R]
                       params_idx: jnp.ndarray,     # [R]
                       pattern_weights: jnp.ndarray,
                       invariant: jnp.ndarray,
                       scale_threshold: float,
                       rate_scalers: bool = False,
                       has_pscaler: bool = True,
                       has_cscaler: bool = True,
                       asc_type: int = AB_NONE,
                       n_real: int = -1):
    """Likelihood across the edge (parent, child) with transition matrix
    `pmatrix` on it; returns (total logL, per-site weighted logL)."""
    dtype = clv_parent.dtype
    f = freqs[params_idx].astype(dtype)
    pinv = prop_invar[params_idx]

    termb = jnp.einsum('rjk,rks->rjs', pmatrix, clv_child,
                       preferred_element_type=dtype,
                       precision=jax.lax.Precision.HIGHEST)
    terma_r = jnp.einsum('rjs,rj->rs', clv_parent * termb, f,
                         preferred_element_type=dtype,
                       precision=jax.lax.Precision.HIGHEST)

    sc = None
    if has_pscaler:
        sc = pscaler
    if has_cscaler:
        sc = cscaler if sc is None else sc + cscaler
    if sc is None:
        site_sc = jnp.zeros(clv_parent.shape[-1], dtype=jnp.int32)
        rate_factor = None
    else:
        site_sc, rate_factor = _site_scalings(sc, rate_scalers,
                                               scale_threshold, dtype)

    terma, terminv = _mix_rates(terma_r, rate_factor, f, pinv,
                                rate_weights, invariant, dtype)
    site_lk = _finalize_site_lk(terma, terminv, site_sc, scale_threshold, dtype)
    return _apply_asc(site_lk, terma, site_sc, pattern_weights,
                      asc_type, n_real, clv_parent.shape[1],
                      scale_threshold, dtype)


@partial(jax.jit, static_argnames=('rate_scalers', 'has_nscaler',
                                   'has_oscaler'))
def node_ancestral(clv_node: jnp.ndarray,           # [R, s, S]
                   clv_other: jnp.ndarray,          # [R, s, S]
                   nscaler: jnp.ndarray,
                   oscaler: jnp.ndarray,
                   pmatrix: jnp.ndarray,            # [R, s, s]
                   freqs: jnp.ndarray,              # [M, s]
                   rate_weights: jnp.ndarray,       # [R]
                   params_idx: jnp.ndarray,         # [R] int
                   scale_threshold: float,
                   rate_scalers: bool = False,
                   has_nscaler: bool = True,
                   has_oscaler: bool = True) -> jnp.ndarray:
    """Marginal ancestral state probabilities at a node, viewed across the
    edge to `other` (reference: /root/reference/src/likelihood.c:639-757,
    pll_compute_node_ancestral_extbuf).

    anc[site, i] ∝ sum_r w_r * freq[i] * clv_node[r,i,site]
                                       * (P_r @ clv_other[r,:,site])[i]
    normalized over states per site.  Per-site scalers multiply a whole
    site uniformly and cancel in the normalization (so outputs match the
    reference exactly); in per-rate scaler mode the relative scaler
    differences between rates are undone with the capped factors used by
    the likelihood path — a deliberate divergence: the reference sums the
    stored (scaled) CLV products without undoing per-rate factors
    (likelihood.c:735-744), which distorts the rate mixture.

    Returns anc [S, s] (rows sum to 1).
    """
    dtype = clv_node.dtype
    f = freqs[params_idx].astype(dtype)              # [R, s]
    combined = clv_node * jnp.einsum(
        'rjk,rks->rjs', pmatrix, clv_other,
        preferred_element_type=dtype, precision=jax.lax.Precision.HIGHEST)

    if rate_scalers:
        sc = None
        if has_nscaler:
            sc = nscaler
        if has_oscaler:
            sc = oscaler if sc is None else sc + oscaler
        if sc is not None:
            _, rate_factor = _site_scalings(sc, True, scale_threshold,
                                            dtype)       # [R, S]
            combined = combined * rate_factor[:, None, :]

    anc = jnp.einsum('r,rjs,rj->sj', rate_weights.astype(dtype), combined,
                     f, preferred_element_type=dtype,
                     precision=jax.lax.Precision.HIGHEST)   # [S, s]
    return anc / jnp.sum(anc, axis=1, keepdims=True)


@partial(jax.jit, static_argnames=('rate_scalers', 'scale_threshold'))
def rate_posteriors(clv_parent, clv_child, pscaler, cscaler,
                    pmatrix,                 # [R, s, s] root edge
                    freqs, prop_invar, rates, rate_weights, params_idx,
                    invariant,               # [S] int (-1 = variable)
                    scale_threshold: float = 2.0 ** -256,
                    rate_scalers: bool = False):
    """Empirical-Bayes per-site rate-category posteriors across the root
    edge, over the R Gamma categories PLUS the +I invariant category:

        post[r, s]  = w_r (1-pinv) L_r(s) / Z(s)     r < R
        post[R, s]  = pinv f(inv_state_s) / Z(s)     (0 when pinv = 0
                                                      or site varies)

    computed in log space so per-site scaling counts mix exactly with
    the unscaled invariant term. Returns (post [R+1, S], site_rate [S])
    where site_rate is the posterior mean (the invariant category is
    rate 0) — the consumers' per-site rate output."""
    dtype = clv_parent.dtype
    f = freqs[params_idx].astype(dtype)                     # [R, s]
    pinv = prop_invar[params_idx].astype(dtype)             # [R]

    termb = jnp.einsum('rjk,rks->rjs', pmatrix, clv_child,
                       preferred_element_type=dtype,
                       precision=jax.lax.Precision.HIGHEST)
    term_r = jnp.einsum('rjs,rj->rs', clv_parent * termb, f,
                        preferred_element_type=dtype,
                        precision=jax.lax.Precision.HIGHEST)  # [R, S]

    sc = pscaler + cscaler
    log_t = jnp.log(jnp.asarray(scale_threshold, dtype))
    if rate_scalers:
        site_sc = jnp.min(sc, axis=0)
        rel = jnp.minimum(sc - site_sc[None, :], SCALE_RATE_MAXDIFF)
        log_scale = (site_sc[None, :] + rel).astype(dtype) * log_t
    else:
        log_scale = sc[None, :].astype(dtype) * log_t       # [1, S]

    w = rate_weights[:, None].astype(dtype) * (1.0 - pinv)[:, None]
    log_var = (jnp.log(jnp.maximum(w, jnp.finfo(dtype).tiny))
               + jnp.log(jnp.maximum(term_r, 0.0)) + log_scale)  # [R, S]

    # invariant category: pinv * f(inv_state) at constant-capable sites
    inv_ok = invariant >= 0
    inv_state = jnp.maximum(invariant, 0)
    inv_freq = jnp.sum(jnp.take(f * pinv[:, None] *
                                rate_weights[:, None].astype(dtype),
                                inv_state, axis=1), axis=0)  # [S]
    log_inv = jnp.where(inv_ok & (inv_freq > 0),
                        jnp.log(jnp.maximum(inv_freq,
                                            jnp.finfo(dtype).tiny)),
                        -jnp.inf)

    logs = jnp.concatenate([log_var, log_inv[None, :]], axis=0)
    peak = jnp.max(logs, axis=0, keepdims=True)
    peak = jnp.where(jnp.isfinite(peak), peak, 0.0)
    expd = jnp.exp(logs - peak)
    post = expd / jnp.maximum(jnp.sum(expd, axis=0, keepdims=True),
                              jnp.finfo(dtype).tiny)
    cat_rates = jnp.concatenate([rates.astype(dtype),
                                 jnp.zeros((1,), dtype)])
    site_rate = jnp.sum(post * cat_rates[:, None], axis=0)
    return post, site_rate
