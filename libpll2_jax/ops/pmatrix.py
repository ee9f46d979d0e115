"""Batched transition-probability matrices P(t) = exp(Qt).

Computes every requested (edge x rate-category) matrix in one fused batch of
einsums — the batched replacement for the reference's per-edge loop
(reference: /root/reference/src/core_pmatrix.c:24-244).

Numerical semantics preserved:
  * P = I + inv_evecs @ diag(expm1(lambda * rate * t / (1 - pinv))) @ evecs.
    The expm1 + identity trick keeps P well-conditioned as Qt -> 0
    (core_pmatrix.c:189-223).
  * pinv is only applied when > MISC_EPSILON (core_pmatrix.c:196).
  * branch length <= 0 yields the identity matrix (core_pmatrix.c:227-231).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..constants import MISC_EPSILON


def update_prob_matrices(eigenvals: jnp.ndarray,    # [M, s]
                         inv_evecs: jnp.ndarray,    # [M, s, s]
                         evecs: jnp.ndarray,        # [M, s, s]
                         prop_invar: jnp.ndarray,   # [M]
                         rates: jnp.ndarray,        # [R]
                         params_idx: jnp.ndarray,   # [R] int
                         branch_lengths: jnp.ndarray,  # [E]
                         ) -> jnp.ndarray:
    """Return P as [E, R, states, states]."""
    dtype = evecs.dtype
    states = evecs.shape[-1]

    lam = eigenvals[params_idx]        # [R, s]
    a = inv_evecs[params_idx]          # [R, s, s]
    b = evecs[params_idx]              # [R, s, s]
    pinv = prop_invar[params_idx]      # [R]
    pinv = jnp.where(pinv > MISC_EPSILON, pinv, 0.0)

    t = branch_lengths.astype(dtype)   # [E]
    # exponent[e, r, m]
    expo = (lam * (rates / (1.0 - pinv))[:, None])[None, :, :] * t[:, None, None]
    expd = jnp.expm1(expo)

    # P[e,r,j,k] = I + sum_m a[r,j,m] * expd[e,r,m] * b[r,m,k]
    left = a[None, :, :, :] * expd[:, :, None, :]          # [E,R,j,m]
    pmat = jnp.einsum('erjm,rmk->erjk', left, b,
                      preferred_element_type=dtype,
                       precision=jax.lax.Precision.HIGHEST)
    pmat = pmat + jnp.eye(states, dtype=dtype)

    ident = jnp.broadcast_to(jnp.eye(states, dtype=dtype), pmat.shape)
    zero_len = (t <= 0.0)[:, None, None, None]
    return jnp.where(zero_len, ident, pmat)


def update_prob_matrices_per_edge(eigenvals: jnp.ndarray,   # [M, s]
                                  inv_evecs: jnp.ndarray,   # [M, s, s]
                                  evecs: jnp.ndarray,       # [M, s, s]
                                  prop_invar: jnp.ndarray,  # [M]
                                  rates: jnp.ndarray,       # [R]
                                  params_idx: jnp.ndarray,  # [E, R] int
                                  branch_lengths: jnp.ndarray,  # [E]
                                  ) -> jnp.ndarray:
    """Per-branch heterotachy variant: every edge may use a different
    rate matrix (reference: examples/heterotachy — achieved there by
    calling pll_update_prob_matrices once per branch class). params_idx
    is a full [edges, rate_cats] table; returns P [E, R, s, s]."""
    dtype = evecs.dtype
    states = evecs.shape[-1]

    lam = eigenvals[params_idx]        # [E, R, s]
    a = inv_evecs[params_idx]          # [E, R, s, s]
    b = evecs[params_idx]              # [E, R, s, s]
    pinv = prop_invar[params_idx]      # [E, R]
    pinv = jnp.where(pinv > MISC_EPSILON, pinv, 0.0)

    t = branch_lengths.astype(dtype)   # [E]
    expo = lam * (rates[None, :] / (1.0 - pinv))[:, :, None] \
        * t[:, None, None]
    expd = jnp.expm1(expo)             # [E, R, s]

    left = a * expd[:, :, None, :]                         # [E,R,j,m]
    pmat = jnp.einsum('erjm,ermk->erjk', left, b,
                      preferred_element_type=dtype,
                       precision=jax.lax.Precision.HIGHEST)
    pmat = pmat + jnp.eye(states, dtype=dtype)

    ident = jnp.broadcast_to(jnp.eye(states, dtype=dtype), pmat.shape)
    zero_len = (t <= 0.0)[:, None, None, None]
    return jnp.where(zero_len, ident, pmat)
