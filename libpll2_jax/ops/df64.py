"""Double-single ("df64") arithmetic and the certified final-evaluation
log-likelihood on a device without fast fp64.

The code was written for hardware without fp64; the production paths run fp32 with an
on-chip certificate of ~1e-6-class logL agreement against the CPU fp64
oracle (bench_validate.py). The reference's entire golden matrix, by
contrast, is fp64 (/root/reference/test/runtest.py:45-57). This module
closes that gap for FINAL evaluations: every number is carried as an
unevaluated fp32 pair (hi, lo) with |lo| <= ulp(hi)/2 — ~49 effective
mantissa bits — using the classic error-free transformations (Dekker
1971, Knuth TAOCP 4.2.2; the same technique as CUDA's double-single
and the "df64" literature):

  * two_sum / two_prod build exact fp32 sum/product error terms from
    IEEE adds and multiplies (the VPU's fp32 ops are IEEE-exact);
  * the Dekker product split uses the 2^12+1 magic constant (fp32 has a
    24-bit mantissa -> 12/12 split, products exact);
  * P-matrices come from the HOST in real fp64, split exactly into
    (f32(p), f32(p - f32(p))) pairs — the device never re-derives them;
  * per-site logs use a df64 log (frexp-style decomposition + atanh
    series evaluated in df64), because fp32 log's ~1-ulp-of-result
    error (~1e-6 absolute at |log| ~ 13) would dominate the budget.

Cost: ~20 fp32 VPU flops per df64 flop, on the XLA levels-path
structure — two orders of magnitude off the fused fp32 kernel, which
is exactly the intended division of labor: search on the fp32 fast
paths, certify the FINAL model/topology once in df64 (the module-level
`loglikelihood_df64(partition, tree)`, exported at the package root).
Gate case `dna_df64` holds it to TOL_LOGL <= 1e-8 against the CPU fp64
oracle on the scaling-stressed caterpillar.

All helpers take/return (hi, lo) tuples of equal-shape fp32 arrays.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

_SPLITTER = 4097.0               # 2^12 + 1 (fp32 Dekker split)


def two_sum(a, b):
    """Exact a + b = s + err for fp32 a, b (6 flops, Knuth)."""
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def quick_two_sum(a, b):
    """Exact a + b = s + err assuming |a| >= |b| (3 flops)."""
    s = a + b
    return s, b - (s - a)


def _split(a):
    c = jnp.float32(_SPLITTER) * a
    hi = c - (c - a)
    return hi, a - hi


def two_prod(a, b):
    """Exact a * b = p + err for fp32 a, b (Dekker)."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    err = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, err


def add(x, y):
    """df64 + df64 (the standard double-single sum)."""
    s, e = two_sum(x[0], y[0])
    e = e + x[1] + y[1]
    return quick_two_sum(s, e)


def mul(x, y):
    """df64 * df64."""
    p, e = two_prod(x[0], y[0])
    e = e + x[0] * y[1] + x[1] * y[0]
    return quick_two_sum(p, e)


def mul_pow2(x, f):
    """df64 * exact power of two (both halves scale exactly)."""
    return x[0] * f, x[1] * f


def div(x, y):
    """df64 / df64: one reciprocal refinement (Newton on the quotient)."""
    q0 = x[0] / y[0]
    # r = x - y*q0 in df64
    p = mul(y, (q0, jnp.zeros_like(q0)))
    r = add(x, (-p[0], -p[1]))
    q1 = r[0] / y[0]
    return quick_two_sum(q0, q1)


def const(v, like=None, dtype=jnp.float32):
    """Split a python/np float64 scalar into an exact df64 constant."""
    hi = np.float32(v)
    lo = np.float32(np.float64(v) - np.float64(hi))
    if like is not None:
        return (jnp.full_like(like, hi), jnp.full_like(like, lo))
    return (jnp.asarray(hi, dtype), jnp.asarray(lo, dtype))


def split_f64(a):
    """Exactly split a host fp64 array into fp32 (hi, lo) numpy pair."""
    a = np.asarray(a, np.float64)
    hi = a.astype(np.float32)
    lo = (a - hi.astype(np.float64)).astype(np.float32)
    return hi, lo


_LN2 = 0.6931471805599453094172321
# atanh series coefficients 1/(2k+1), enough terms that z^(2K+1) with
# |z| <= (sqrt(2)-1)/(sqrt(2)+1) = 0.1716 is below 2^-50
_ATANH_COEFS = (1.0 / 13, 1.0 / 11, 1.0 / 9, 1.0 / 7, 1.0 / 5,
                1.0 / 3, 1.0)


def log(x):
    """df64 natural log of a POSITIVE df64 array.

    x = 2^e * m with m in [sqrt(1/2), sqrt(2)):
        log x = e * ln2 + 2 * atanh((m - 1)/(m + 1))
    the series runs in df64; e and the scaling of m are exact (the
    exponent comes from the IEEE exponent FIELD — a rounded log2 could
    misplace m at the binade boundary and blow the series range)."""
    hi = jnp.maximum(x[0], jnp.finfo(jnp.float32).tiny)
    bits = jax.lax.bitcast_convert_type(hi, jnp.int32)
    e = (bits >> 23) - 127                       # floor(log2) for normals
    # mantissa in [1, 2); move to [sqrt(1/2), sqrt(2)) when m >= sqrt(2)
    m0 = jax.lax.bitcast_convert_type(
        (bits & jnp.int32(0x007fffff)) | jnp.int32(127 << 23),
        jnp.float32)
    e = jnp.where(m0 >= jnp.float32(1.4142135), e + 1, e)
    e = jnp.clip(e, -126, 127)
    biased = (e + 127) << 23
    pow2e = jax.lax.bitcast_convert_type(biased, jnp.float32)   # 2^e
    inv = 1.0 / pow2e                                           # exact
    m = mul_pow2(x, inv)
    one = const(1.0, like=hi)
    num = add(m, (-one[0], -one[1]))
    den = add(m, one)
    z = div(num, den)
    z2 = mul(z, z)
    acc = const(_ATANH_COEFS[0], like=hi)
    for c in _ATANH_COEFS[1:]:
        acc = add(mul(acc, z2), const(c, like=hi))
    at = mul(acc, z)                 # atanh(z)
    ln_m = mul_pow2(at, jnp.float32(2.0))
    ln2 = const(_LN2, like=hi)
    e_term = mul(ln2, (e.astype(jnp.float32), jnp.zeros_like(hi)))
    return add(e_term, ln_m)


def matvec(ph, pl, xh, xl):
    """df64 batched matvec: P [R, s, s] pairs @ x [R, s, S] pairs ->
    [R, s, S] pairs, contracting over the middle state axis with a
    Python loop over k (s iterations of exact-product + compensated
    accumulation — ~20 VPU flops per term)."""
    s = ph.shape[-1]
    acc = (jnp.zeros_like(xh), jnp.zeros_like(xl))
    for k in range(s):
        p_k = (ph[:, :, k][:, :, None], pl[:, :, k][:, :, None])
        x_k = (xh[:, k][:, None, :], xl[:, k][:, None, :])
        acc = add(acc, mul(p_k, x_k))
    return acc


# --------------------------------------------------------------------------
# certified final evaluation (full-tree edge logL in df64)
# --------------------------------------------------------------------------

@partial(jax.jit, static_argnames=('scale_threshold', 'scale_factor',
                                   'rate_cats', 'n_rows', 'n_sc'))
def _df64_edge_logl(tip_rows,            # [T, s, S] f32 (exact values)
                    op_stack,            # [n_ops, 8] int32 (scan layout)
                    pm_h, pm_l,          # [E, R, s, s] f32 pairs
                    root_idx,            # [5] int32
                    f_h, f_l,            # [R, s] frequency pairs
                    w_h, w_l,            # [R] rate-weight pairs
                    pattern_weights,     # [S] int
                    log_thr_h, log_thr_l,       # df64 log(threshold)
                    scale_threshold: float, scale_factor: float,
                    rate_cats: int, n_rows: int, n_sc: int):
    """Whole-tree edge log-likelihood in df64. Per-site scalers, no
    asc/+I (enforced by the caller). Returns a [128] df64 lane-partial
    pair; the host adds the 256 floats in fp64 (exact at this size)."""
    T, s, S = tip_rows.shape
    R = rate_cats
    f32 = jnp.float32
    thresh = jnp.asarray(scale_threshold, f32)
    factor = jnp.asarray(scale_factor, f32)

    clv_h = jnp.zeros((n_rows + 1, R, s, S), f32)
    clv_h = clv_h.at[:T].set(jnp.broadcast_to(tip_rows[:, None],
                                              (T, R, s, S)))
    clv_l = jnp.zeros_like(clv_h)
    scaler = jnp.zeros((n_sc + 2, S), jnp.int32)
    trash = n_sc

    def body(carry, op):
        clv_h, clv_l, scaler = carry
        parent, psc, c1, m1, s1, c2, m2, s2 = op
        la = matvec(jnp.take(pm_h, m1, axis=0),
                    jnp.take(pm_l, m1, axis=0),
                    jnp.take(clv_h, c1, axis=0),
                    jnp.take(clv_l, c1, axis=0))
        rb = matvec(jnp.take(pm_h, m2, axis=0),
                    jnp.take(pm_l, m2, axis=0),
                    jnp.take(clv_h, c2, axis=0),
                    jnp.take(clv_l, c2, axis=0))
        xh, xl = mul(la, rb)
        child_sc = (jnp.where(s1 >= 0,
                              jnp.take(scaler, jnp.maximum(s1, 0), axis=0),
                              0)
                    + jnp.where(s2 >= 0,
                                jnp.take(scaler, jnp.maximum(s2, 0),
                                         axis=0), 0))
        # scale ONLY when the op owns a scaler row: a SCALE_BUFFER_NONE
        # parent has nowhere to record the count, and an unrecorded
        # 2^16 factor would inflate the certified logL (same guard as
        # the production path, ops/partials.py update_partials)
        has_sc = psc >= 0
        mask = jnp.all(xh < thresh, axis=(0, 1)) & has_sc  # [S]
        fac = jnp.where(mask, factor, f32(1.0))[None, None, :]
        xh, xl = xh * fac, xl * fac                        # exact pow2
        new_sc = child_sc + mask.astype(jnp.int32)
        clv_h = clv_h.at[parent].set(xh)
        clv_l = clv_l.at[parent].set(xl)
        scaler = scaler.at[jnp.where(has_sc, psc, trash)].set(new_sc)
        return (clv_h, clv_l, scaler), None

    (clv_h, clv_l, scaler), _ = jax.lax.scan(
        body, (clv_h, clv_l, scaler), op_stack)

    p_clv, p_sc, c_clv, c_sc, e_mat = [root_idx[i] for i in range(5)]
    par = (jnp.take(clv_h, p_clv, axis=0), jnp.take(clv_l, p_clv, axis=0))
    termb = matvec(jnp.take(pm_h, e_mat, axis=0),
                   jnp.take(pm_l, e_mat, axis=0),
                   jnp.take(clv_h, c_clv, axis=0),
                   jnp.take(clv_l, c_clv, axis=0))
    prod = mul(par, termb)                                  # [R, s, S]
    # terma_r[r, S] = sum_j prod[r, j, S] * f[r, j]
    acc = (jnp.zeros((R, S), f32), jnp.zeros((R, S), f32))
    for j in range(s):
        fj = (f_h[:, j][:, None], f_l[:, j][:, None])
        acc = add(acc, mul((prod[0][:, j], prod[1][:, j]), fj))
    # mix rates: terma[S] = sum_r w_r * terma_r
    site = (jnp.zeros((S,), f32), jnp.zeros((S,), f32))
    for r in range(R):
        wr = (w_h[r], w_l[r])
        site = add(site, mul((acc[0][r], acc[1][r]), wr))
    site_lk = log(site)
    sc_sum = (jnp.where(p_sc >= 0,
                        jnp.take(scaler, jnp.maximum(p_sc, 0), axis=0), 0)
              + jnp.where(c_sc >= 0,
                          jnp.take(scaler, jnp.maximum(c_sc, 0), axis=0),
                          0)).astype(f32)                   # exact < 2^24
    undo = mul((log_thr_h, log_thr_l), (sc_sum, jnp.zeros_like(sc_sum)))
    site_lk = add(site_lk, undo)
    pw = pattern_weights.astype(f32)                        # exact < 2^24
    weighted = mul(site_lk, (pw, jnp.zeros_like(pw)))
    ok = pw > 0
    weighted = (jnp.where(ok, weighted[0], 0.0),
                jnp.where(ok, weighted[1], 0.0))
    # lane-partial reduction: [S] -> [128] df64 sums (host finishes in
    # fp64 — 256 floats, exact at this magnitude)
    Sp = -(-S // 128) * 128
    wh = jnp.pad(weighted[0], (0, Sp - S)).reshape(-1, 128)
    wl = jnp.pad(weighted[1], (0, Sp - S)).reshape(-1, 128)

    def red(carry, xs):
        return add(carry, xs), None

    out, _ = jax.lax.scan(red, (jnp.zeros(128, f32), jnp.zeros(128, f32)),
                          (wh, wl))
    return out


def _pmatrix_host64(eigenvals, inv_evecs, evecs, prop_invar, rates,
                    params_index, branch_lengths):
    """Reference-semantics P(t) in host numpy fp64 (mirror of
    ops/pmatrix.update_prob_matrices; reference core_pmatrix.c:189-231),
    split exactly into fp32 (hi, lo) pairs."""
    lam = np.asarray(eigenvals[params_index], np.float64)       # [s]
    a = np.asarray(inv_evecs[params_index], np.float64)         # [s, s]
    b = np.asarray(evecs[params_index], np.float64)
    pinv = float(prop_invar[params_index])
    from ..constants import MISC_EPSILON
    if pinv <= MISC_EPSILON:
        pinv = 0.0
    t = np.asarray(branch_lengths, np.float64)                  # [E]
    rates = np.asarray(rates, np.float64)                       # [R]
    expo = (lam[None, :] * (rates / (1.0 - pinv))[:, None]
            )[None, :, :] * t[:, None, None]                    # [E, R, s]
    expd = np.expm1(expo)
    left = a[None, None] * expd[:, :, None, :]
    pm = np.einsum('erjm,mk->erjk', left, b)
    pm = pm + np.eye(lam.shape[0])
    ident = np.broadcast_to(np.eye(lam.shape[0]), pm.shape)
    pm = np.where((t <= 0.0)[:, None, None, None], ident, pm)
    return split_f64(pm)


def loglikelihood_df64(partition, tree, params_index: int = 0) -> float:
    """Certified final evaluation: full-tree edge logL of `tree` on a
    DENSE partition, computed on the default device in df64 (~49-bit
    mantissa end to end: host-fp64 P-matrices exactly split, df64 CLV
    pruning, df64 per-site logs, fp64 host finish). Gate budget:
    TOL_LOGL <= 1e-8 vs the CPU fp64 oracle (`dna_df64` case).

    Scope (raise otherwise): no site repeats (dense rows), no asc bias,
    pinv == 0, per-site scalers, homogeneous model. The production fp32
    paths handle every configuration; this is the certification mode
    for FINAL results (reference bar: the all-fp64 golden matrix,
    /root/reference/test/runtest.py:45-57)."""
    from .. import constants as C
    from ..partition import pack_operations
    from ..trees import create_operations, traverse

    p = partition
    if (p.repeats is not None or p.asc_bias != C.AscBias.NONE
            or p.rate_scalers
            or float(np.max(np.asarray(p.prop_invar))) > 0.0):
        raise C.PllError(
            C.ERROR_PARAM_INVALID,
            "loglikelihood_df64 covers dense partitions with per-site "
            "scalers, no asc bias and pinv == 0 (the certification "
            "scope); use the fp32 paths for other configurations")
    operations, branches, pidx = create_operations(traverse(tree.vroot))
    # every inner op must own a scaler row: the certified path scales
    # aggressively (2^-16 window) and a SCALE_BUFFER_NONE parent drops
    # its children's accumulated counts on the floor (the reference's
    # fill_parent_scaler chain has the same structural loss —
    # pll.c:1183 — but its 2^-256 window rarely exercises it; here the
    # silent loss would be ~16*ln2 per dropped count, so refuse)
    vr_sc = tree.vroot.scaler_index
    if any(op.parent_scaler_index is None or op.parent_scaler_index < 0
           for op in operations) or vr_sc is None or vr_sc < 0:
        raise C.PllError(
            C.ERROR_PARAM_INVALID,
            "loglikelihood_df64 needs a scaler row on every inner node "
            "(the certified path's aggressive scaling cannot thread "
            "counts through SCALE_BUFFER_NONE parents)")
    ops = pack_operations(operations)
    op_stack = np.stack([np.asarray(x) for x in ops], axis=1)
    root = tree.vroot
    root_idx = np.asarray([root.clv_index, root.scaler_index,
                           root.back.clv_index, root.back.scaler_index,
                           root.pmatrix_index], np.int32)
    blen = np.zeros(p.prob_matrices)
    blen[np.asarray(pidx)] = np.asarray(branches)
    p._ensure_eigen([params_index])
    pm_h, pm_l = _pmatrix_host64(p.eigenvals, p.inv_eigenvecs,
                                 p.eigenvecs, p.prop_invar, p.rates,
                                 params_index, blen)
    f_h, f_l = split_f64(p.frequencies[params_index][None, :].repeat(
        p.rate_cats, axis=0))
    w_h, w_l = split_f64(p.rate_weights)
    # aggressive scaling window: the LO half of a df64 value sits
    # ~2^-25 below the hi; with the fp32 path's 2^-32 window, deep-site
    # intermediates reach 2^-64 and their lo halves (2^-89) are FTZ-
    # flushed, silently degrading those sites to fp32. A 2^-16 window
    # keeps every intermediate's lo normal (>= ~2^-57) at the cost of
    # more (exact power-of-two) scalings.
    threshold, factor = 2.0 ** -16, 2.0 ** 16
    lt_h, lt_l = (np.float32(np.log(np.float64(threshold))), None)
    lt_l = np.float32(np.log(np.float64(threshold)) - np.float64(lt_h))
    tips = p.dense_tip_rows().astype(jnp.float32)
    out = _df64_edge_logl(
        tips, jnp.asarray(op_stack), jnp.asarray(pm_h), jnp.asarray(pm_l),
        jnp.asarray(root_idx), jnp.asarray(f_h), jnp.asarray(f_l),
        jnp.asarray(w_h), jnp.asarray(w_l),
        jnp.asarray(np.asarray(p.pattern_weights)),
        jnp.asarray(lt_h), jnp.asarray(lt_l),
        scale_threshold=threshold, scale_factor=factor,
        rate_cats=p.rate_cats, n_rows=p.nodes, n_sc=p.scale_buffers)
    return float(np.sum(np.asarray(out[0], np.float64))
                 + np.sum(np.asarray(out[1], np.float64)))
