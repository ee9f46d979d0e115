"""Gradient-based model optimization — differentiable all the way through.

The reference is a pure evaluation library; its clients bolt Newton/Brent
loops on top, one parameter at a time (examples/newton, RAxML-NG's
optimizers). On an accelerator the natural design is different: the
entire fused likelihood — eigendecomposition (jnp.linalg.eigh), P-matrices,
the pruning recursion, scaling, rate mixing — is differentiable JAX code, so
ALL branch lengths and model parameters can be optimized simultaneously with
`jax.grad` + a first-order optimizer, in a handful of compiled steps.

Parameterization (unconstrained):
  * branch lengths: log-space (positivity);
  * substitution rates: log-space with the last rate pinned to 1;
  * frequencies: softmax logits.

The per-edge Newton engine (ops/derivatives.py) remains available for
reference-style single-branch optimization.

Caveat: `jnp.linalg.eigh`'s gradient is undefined at repeated eigenvalues —
exactly-symmetric models (JC69: all rates equal) sit on that degeneracy.
Start substitution-rate optimization from a slightly perturbed point, or
optimize branches first.
"""
from __future__ import annotations

from typing import Dict, Iterable

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from . import constants as C
from .engine import TreeEngine, _fused_loglikelihood
from .ops import eigen as ops_eigen


def _build_params(engine: TreeEngine,
                  optimize: Iterable[str],
                  subst_template=None) -> Dict[str, jnp.ndarray]:
    p = engine.partition
    d = p.dtype
    params: Dict[str, jnp.ndarray] = {}
    if "branches" in optimize:
        blen = jnp.maximum(engine.branches, C.OPT_MIN_BRANCH_LEN)
        params["log_branches"] = jnp.log(blen).astype(d)
    if "subst" in optimize:
        if subst_template is not None:
            tmpl = np.asarray(subst_template, np.int32)
            n_free = int(tmpl.max())
            # every class 0..n_free must be non-empty: class 0 is the
            # pinned reference rate the others are expressed against, and
            # an empty class's warm start would be the mean of an empty
            # slice (silent NaN optimization)
            missing = [c for c in range(n_free + 1)
                       if not np.any(tmpl == c)]
            if missing:
                raise C.PllError(
                    C.ERROR_PARAM_INVALID,
                    f"subst_template must use every class id 0..{n_free} "
                    f"at least once (class 0 is the pinned reference "
                    f"rate); missing: {missing}")
            if n_free > 0:
                # warm-start each class from the partition's CURRENT
                # rates (a second optimization round must not restart
                # from scratch); fall back to a small spread when the
                # rates sit at the all-equal point — eigh's gradient is
                # degenerate exactly there
                cur = np.maximum(np.asarray(p.subst_params, np.float64),
                                 1e-9)
                base = np.array([cur[:, tmpl == 0].mean(axis=1)]).T
                init = np.stack(
                    [np.log(cur[:, tmpl == c].mean(axis=1) / base[:, 0])
                     for c in range(1, n_free + 1)], axis=1)
                flat = np.abs(init) < 1e-3
                init[flat] = np.tile(np.linspace(0.08, 0.25, n_free),
                                     (p.rate_matrices, 1))[flat]
                params["log_subst"] = jnp.asarray(init, d)
        else:
            rates = np.maximum(p.subst_params, 1e-6)
            rates = rates / rates[:, -1:]
            params["log_subst"] = jnp.asarray(np.log(rates[:, :-1]), d)
    if "freqs" in optimize:
        params["freq_logits"] = jnp.asarray(np.log(
            np.maximum(p.frequencies, 1e-10)), d)
    return params


def _make_subst_expander(p, subst_template, dtype):
    """Returns expand(params)->[M, slots] full exchangeability rates from
    the free log-rates, honoring an optional class template (class 0
    pinned to 1). Shared by the differentiable and fused-FD paths."""
    base_subst = jnp.asarray(p.subst_params, dtype)
    tmpl = (None if subst_template is None
            else jnp.asarray(np.asarray(subst_template, np.int32)))

    def expand(params):
        if "log_subst" not in params:
            if tmpl is not None:
                # all classes pinned (e.g. JC/F81): every rate is 1
                return jnp.ones_like(base_subst)
            return base_subst
        if tmpl is not None:
            # class 0 pinned to 1; classes 1..n are free log-rates
            full = jnp.concatenate(
                [jnp.ones((p.rate_matrices, 1), dtype),
                 jnp.exp(params["log_subst"])], axis=1)
            return full[:, tmpl]
        return jnp.concatenate(
            [jnp.exp(params["log_subst"]),
             jnp.ones_like(params["log_subst"][:, :1])], axis=1)

    return expand


def make_loglikelihood_fn(engine: TreeEngine,
                          optimize: Iterable[str] = ("branches",),
                          subst_template=None):
    """Returns (fn, params0): fn(params) -> logL, differentiable.

    `subst_template` (int array over the upper-triangle rate slots) ties
    exchangeability rates into classes for NESTED substitution models:
    class 0 is pinned to rate 1, classes 1..n map to free log-rates —
    e.g. DNA HKY is [0, 1, 0, 0, 1, 0] (one free transition/transversion
    ratio), GTR is [1, 2, 3, 4, 5, 0]. Only the XLA execution paths are
    differentiable; the engine may use Pallas for plain evaluation, but
    optimization always runs levels/scan.
    """
    p = engine.partition
    d = p.dtype
    optimize = tuple(optimize)
    if subst_template is not None:
        subst_template = np.asarray(subst_template, np.int32)
        if subst_template.shape != (p.subst_params.shape[1],):
            raise C.PllError(C.ERROR_PARAM_INVALID,
                             "subst_template must cover every rate slot")
    if engine.use_pallas or engine.repeats_dense_fused:
        # rebuild XLA-path op tables for the differentiable program
        raise ValueError("build the TreeEngine with pallas=False for "
                         "gradient optimization (or use maximize_fused / "
                         "maximize_loglikelihood, which run model-parameter "
                         "optimization on the fused kernels directly)")
    if p.clv is None:
        raise C.PllError(
            C.ERROR_PARAM_INVALID,
            "gradient optimization runs over dense CLV buffers; pooled "
            "site-repeats partitions are not differentiable — build the "
            "partition without site_repeats (the fused engine keeps the "
            "speed either way)")
    base_eigen = (jnp.asarray(p.eigenvals, d),
                  jnp.asarray(p.inv_eigenvecs, d),
                  jnp.asarray(p.eigenvecs, d))
    base_freqs = jnp.asarray(p.frequencies, d)
    model_tail = (jnp.asarray(p.prop_invar, d), jnp.asarray(p.rates, d),
                  jnp.asarray(p.rate_weights, d))
    site_args = engine._site_args()
    clv0, sc0 = p.clv, p.scale_buffer

    expand_subst = _make_subst_expander(p, subst_template, d)
    params0 = _build_params(engine, optimize, subst_template)
    model_varies = "log_subst" in params0 or "freq_logits" in params0
    if subst_template is not None and not model_varies:
        # e.g. JC with fixed frequencies: the tied model is a constant —
        # decompose once instead of per optimizer step inside the scan
        tmpl_eigen = ops_eigen.update_eigen_jax(expand_subst({}),
                                                base_freqs)

    def fn(params: Dict[str, jnp.ndarray]):
        freqs = (jax.nn.softmax(params["freq_logits"], axis=-1)
                 if "freq_logits" in params else base_freqs)
        if model_varies:
            subst = expand_subst(params)
            ev, evecs, inv_evecs = ops_eigen.update_eigen_jax(subst, freqs)
        elif subst_template is not None:
            ev, evecs, inv_evecs = tmpl_eigen
        else:
            ev, inv_evecs, evecs = base_eigen
        branches = (jnp.exp(params["log_branches"])
                    if "log_branches" in params else engine.branches)
        total, _, _, _, _ = _fused_loglikelihood(
            clv0, sc0, ev, inv_evecs, evecs, *model_tail, freqs,
            engine.params_idx_rates, branches, engine.ops, engine.root_idx,
            *site_args, p.scale_threshold, p.scale_factor,
            rate_scalers=p.rate_scalers, valid=engine.valid,
            levels=engine.levels, asc_type=engine.asc_type,
            n_real=engine.n_real)
        return total

    return fn, params0


def maximize_loglikelihood(engine: TreeEngine,
                           optimize: Iterable[str] = ("branches",),
                           steps: int = 200,
                           learning_rate: float = 0.02,
                           tol: float = 1e-6,
                           patience: int = 25,
                           chunk: int = 25,
                           subst_template=None):
    """Adam ascent on logL over the selected parameter groups.

    Runs `chunk` Adam steps per device dispatch (a `lax.scan` over the
    update — a host-driven per-step loop pays one dispatch and one host
    sync per step; the early-stop check runs between chunks).
    Stops only after `patience` consecutive steps without a
    tol-improvement of the best logL (Adam is non-monotone, so a single
    flat step must not terminate). Returns (final logL, params, history);
    the best-seen parameters are applied back to the engine/partition.

    On a Pallas-path engine (fused / dense-fused repeats)
    model-parameter groups route to `maximize_fused` automatically —
    the fused kernels are not differentiable, so the gradient there is a
    batched central difference, still one dispatch per `chunk` steps.
    Branch lengths on Pallas engines belong to the Newton machinery
    (`newton_smooth_all` / `TreeEngine.newton_loop`) instead.
    """
    if engine.use_pallas or engine.repeats_dense_fused:
        if "branches" in tuple(optimize):
            raise C.PllError(
                C.ERROR_PARAM_INVALID,
                "branch lengths on a Pallas-path engine are optimized by "
                "the fused Newton machinery (newton_smooth_all / "
                "TreeEngine.newton_loop); maximize() on this engine "
                "covers the model groups ('subst', 'freqs') only")
        return maximize_fused(engine, optimize, steps=steps,
                              learning_rate=learning_rate, tol=tol,
                              patience=patience, chunk=chunk,
                              subst_template=subst_template)
    fn, params = make_loglikelihood_fn(engine, optimize,
                                       subst_template=subst_template)
    final, best_params, history = adam_ascent(
        fn, params, steps=steps, learning_rate=learning_rate, tol=tol,
        patience=patience, chunk=chunk)
    _apply(engine, best_params, subst_template=subst_template)
    return final, best_params, history


def make_fused_loglikelihood_fn(engine: TreeEngine,
                                optimize: Iterable[str] = ("subst",
                                                           "freqs"),
                                subst_template=None,
                                fd_chunk: int = 16):
    """Batched model-trial evaluator on the engine's OWN execution path.

    Returns (fn_batch, x0, unravel): `fn_batch(X)` maps a [K, n] matrix of
    flat unconstrained parameter vectors (the `ravel_pytree` order of the
    params pytree, recoverable via `unravel(x)`) to [K] log-likelihoods.
    Every trial re-eigendecomposes its model on device
    (ops/eigen.update_eigen_jax) and runs the SAME compiled program the
    engine's `loglikelihood()` uses — fused Pallas kernel, pooled repeats,
    dense-fused repeats, levels, whatever `execution_path` says — vmapped
    over trials in chunks of `fd_chunk`, so K trials cost ONE dispatch.

    The Pallas kernels are not differentiable; this is the evaluation
    half of `maximize_fused`'s central-difference loop. Branch lengths
    are out of scope (the fused Newton machinery owns them).
    """
    from jax.flatten_util import ravel_pytree

    p = engine.partition
    optimize = tuple(optimize)
    if "branches" in optimize:
        raise C.PllError(
            C.ERROR_PARAM_INVALID,
            "fused FD optimization covers model groups ('subst', "
            "'freqs'); branch lengths use newton_smooth_all / "
            "TreeEngine.newton_loop")
    if not any(g in optimize for g in ("subst", "freqs")):
        raise C.PllError(C.ERROR_PARAM_INVALID,
                         "nothing to optimize: pass 'subst' and/or 'freqs'")
    if subst_template is not None:
        subst_template = np.asarray(subst_template, np.int32)
        if subst_template.shape != (p.subst_params.shape[1],):
            raise C.PllError(C.ERROR_PARAM_INVALID,
                             "subst_template must cover every rate slot")
    d = p.dtype
    expand_subst = _make_subst_expander(p, subst_template, d)
    params0 = _build_params(engine, optimize, subst_template)
    if not params0:
        raise C.PllError(
            C.ERROR_PARAM_INVALID,
            "the requested groups leave no free parameter (every "
            "subst_template class is pinned and freqs are fixed)")
    x0, unravel = ravel_pytree(params0)
    base_freqs = jnp.asarray(p.frequencies, d)

    margs = engine._model_args()
    (_, _, _, prop_invar, rates, rate_weights, _, pidx) = margs
    pw, invariant = engine._site_args()

    if engine.repeats_mode:
        ops, root_cols, root_mat = (engine.ops, engine._root_cols,
                                    engine._root_mat)
        clv_flat, sc_flat = p.clv_flat, p.sc_flat

        def eval_one(ev, ivecs, evecs, freqs):
            total, _, _, _, _ = _repeats_loglikelihood(
                clv_flat, sc_flat, ev, ivecs, evecs, prop_invar, rates,
                rate_weights, freqs, pidx, engine.branches, ops,
                root_cols, root_mat, pw, invariant,
                p.scale_threshold, p.scale_factor,
                rate_scalers=p.rate_scalers, asc_type=engine.asc_type,
                n_real=engine.n_real, edge_params=engine.edge_params)
            return total
    else:
        clv0, sc0 = engine._dense_bufs()
        ops = engine.ops

        def eval_one(ev, ivecs, evecs, freqs):
            total, _, _, _, _ = _fused_loglikelihood(
                clv0, sc0, ev, ivecs, evecs, prop_invar, rates,
                rate_weights, freqs, pidx, engine.branches, ops,
                engine.root_idx, pw, invariant,
                p.scale_threshold, p.scale_factor,
                rate_scalers=p.rate_scalers, valid=engine.valid,
                levels=engine.levels,
                pallas_interpret=engine.pallas_interpret,
                asc_type=engine.asc_type, n_real=engine.n_real,
                fused_slots=engine.fused_slots,
                edge_params=engine.edge_params,
                fused_mesh=engine.fused_mesh if engine.use_fused else None,
                fused_scatter=False)
            return total

    def eval_x(x):
        params = unravel(x)
        freqs = (jax.nn.softmax(params["freq_logits"], axis=-1)
                 if "freq_logits" in params else base_freqs)
        subst = expand_subst(params)
        ev, evecs, ivecs = ops_eigen.update_eigen_jax(subst, freqs)
        return eval_one(ev, ivecs, evecs, freqs)

    meshed = engine.fused_mesh is not None and engine.use_fused

    def fn_batch(X):
        if meshed:
            # shard_map under vmap is fragile; trials run as a scan of
            # single SPMD evaluations (still one dispatch)
            return jax.lax.map(eval_x, X)
        K = X.shape[0]
        c = max(1, min(K, fd_chunk))
        kp = -(-K // c) * c
        if kp != K:
            # pad with copies of row 0 (same compiled chunk shape)
            X = jnp.concatenate(
                [X, jnp.broadcast_to(X[:1], (kp - K,) + X.shape[1:])])
        out = jax.lax.map(jax.vmap(eval_x), X.reshape(-1, c, X.shape[1]))
        return out.reshape(-1)[:K]

    return fn_batch, x0, unravel


def maximize_fused(engine: TreeEngine,
                   optimize: Iterable[str] = ("subst", "freqs"),
                   steps: int = 150, learning_rate: float = 0.05,
                   tol: float = 1e-4, patience: int = 25,
                   chunk: int = 10, fd_step: float = 0.02,
                   fd_chunk: int = 16, subst_template=None):
    """Model-parameter (subst rates / frequencies) ascent that never
    leaves the engine's fast execution path.

    The reference's clients keep every parameter trial on their fastest
    kernels (a Brent/BFGS driver around
    /root/reference/src/models.c:412 + likelihood.c:586 per trial); the
    device analog is a central-difference Adam: per step, the 2n+1 trial
    models (n = free parameters) evaluate as ONE batched fused program —
    eigendecomposition included — and `chunk` steps run per device
    dispatch. Cost per step is (2n+1) fused evals of compute inside a
    single dispatch, so wall-clock per step is ~1 dispatch (vs the
    25-50x slower XLA levels path the differentiable route needs).

    Works on every execution path (fused, dense-fused repeats, pooled,
    levels) and is the automatic route for `maximize_loglikelihood` on
    Pallas engines. fp32 evaluation noise bounds the achievable
    precision (~1e-2 logL); for tighter convergence build an fp64
    pallas=False engine and use the differentiable path. Returns
    (best logL, best params pytree, history); best params are applied
    back to the partition.
    """
    import optax

    fnb, x0, unravel = make_fused_loglikelihood_fn(
        engine, optimize, subst_template=subst_template, fd_chunk=fd_chunk)
    n = int(x0.size)
    eye = jnp.eye(n, dtype=x0.dtype) * jnp.asarray(fd_step, x0.dtype)
    opt = optax.adam(learning_rate)
    state = opt.init(x0)
    chunk = max(1, min(chunk, steps, patience))

    @partial(jax.jit, static_argnames=("k",))
    def run_chunk(x, state, k):
        def body(carry, _):
            x, state = carry
            X = jnp.concatenate([x[None], x[None] + eye, x[None] - eye])
            f = fnb(X)
            g = (f[1:n + 1] - f[n + 1:]) / (2.0 * fd_step)
            updates, state = opt.update(-g, state)        # ascent
            x2 = optax.apply_updates(x, updates)
            # f[0] is logL AT the pre-update x; x2 is post-update
            return (x2, state), (f[0], x2)
        (x, state), (lks, xs) = jax.lax.scan(body, (x, state), None,
                                             length=k)
        return x, state, lks, xs

    history = []
    best = -np.inf
    best_x = x0
    x = x0
    stale = 0
    done = 0
    while done < steps and stale < patience:
        entry = x
        k = min(chunk, steps - done)
        x, state, lks, xs = run_chunk(x, state, k)
        lks = np.asarray(lks, dtype=np.float64)
        history.extend(lks.tolist())
        done += k
        for i, lk in enumerate(lks):
            if lk > best + tol:
                best = float(lk)
                best_x = entry if i == 0 else xs[i - 1]
                stale = 0
            else:
                stale += 1

    # the loop's last x was never evaluated; score both candidates on the
    # compiled (2n+1)-row shape
    X_final = jnp.concatenate(
        [best_x[None], jnp.broadcast_to(x[None], (2 * n, n))])
    f_final = np.asarray(fnb(X_final), dtype=np.float64)
    if f_final[1] > f_final[0]:
        best_x, final = x, float(f_final[1])
    else:
        final = float(f_final[0])
    best_params = unravel(best_x)
    _apply(engine, best_params, subst_template=subst_template)
    return final, best_params, history


def adam_ascent(fn, params, steps: int = 200, learning_rate: float = 0.02,
                tol: float = 1e-6, patience: int = 25, chunk: int = 25):
    """Chunked-scan Adam ascent on a differentiable scalar fn(params);
    returns (best logL, best params, per-step history). The engine-aware
    wrapper is maximize_loglikelihood; PartitionedEngine.maximize reuses
    this loop over a joint multi-partition objective."""
    import optax

    loss = jax.jit(lambda q: -fn(q))
    grad = jax.value_and_grad(lambda q: -fn(q))
    opt = optax.adam(learning_rate)
    state = opt.init(params)
    chunk = max(1, min(chunk, steps, patience))

    @partial(jax.jit, static_argnames=("n",))
    def run_chunk(params, state, n):
        def body(carry, _):
            params, state = carry
            value, g = grad(params)
            updates, state = opt.update(g, state)
            params = optax.apply_updates(params, updates)
            # lks[i] is logL AT the pre-update params; params_hist[i] is
            # the params AFTER update i (tiny pytrees — stacking them
            # keeps exact best-params tracking across the chunk)
            return (params, state), (-value, params)
        (params, state), (lks, hist) = jax.lax.scan(
            body, (params, state), None, length=n)
        return params, state, lks, hist

    history = []
    best = -np.inf
    best_params = params
    stale = 0
    done = 0
    while done < steps and stale < patience:
        entry = params
        n = min(chunk, steps - done)
        params, state, lks, hist = run_chunk(params, state, n)
        lks = np.asarray(lks, dtype=np.float64)
        history.extend(lks.tolist())
        done += n
        for i, lk in enumerate(lks):
            if lk > best + tol:
                best = float(lk)
                # params that PRODUCED lks[i]: entry for i=0, else the
                # result of update i-1
                best_params = entry if i == 0 else jax.tree.map(
                    lambda a: a[i - 1], hist)
                stale = 0
            else:
                stale += 1

    # the final params were never evaluated inside the scan: consider them
    final_candidates = [best_params, params]
    finals = [float(-loss(q)) for q in final_candidates]
    best_params = final_candidates[int(np.argmax(finals))]
    final = max(finals)
    return final, best_params, history


def newton_smooth_all(engine: TreeEngine, tree, passes: int = 2,
                      iterations: int = 8) -> float:
    """All-branches Newton smoothing in ONE device dispatch.

    The device-resident analog of `newton_optimize_branches` (the
    reference's tree-wide smoothing loop, examples/newton applied per
    edge): per pass, a postorder refresh then a pre-order walk that
    optimizes every edge with `iterations` Newton updates, reorienting
    CLVs via auxiliary "up" rows (ops/branch_sweep.py). The tree's branch
    lengths and the engine's stored branches are updated in place; returns
    the final log-likelihood."""
    import jax

    from .ops import branch_sweep
    from .partition import pack_operations
    from .trees import create_operations as _create_ops
    from .trees.utree import traverse as _traverse

    p = engine.partition
    if p.clv is None:
        raise C.PllError(
            C.ERROR_PARAM_INVALID,
            "newton_smooth_all needs dense CLV buffers (directional "
            "'up' rows); pooled site-repeats partitions are not "
            "supported — use newton_optimize_branches or a dense "
            "partition")
    trav = _traverse(tree.vroot)
    operations, branches, pmatrix_indices = _create_ops(trav)
    steps, n_aux = branch_sweep.build_smoothing_schedule(
        tree, p.nodes, p.scale_buffers, p.prob_matrices)
    ops = pack_operations(operations, scratch_clv=p.nodes)
    blen = np.zeros(p.prob_matrices)
    blen[np.asarray(pmatrix_indices)] = np.asarray(branches)
    (ev, inv_evecs, evecs, prop_invar, rates, rate_weights, freqs,
     params_idx_rates) = engine._model_args()
    pw, invariant = engine._site_args()
    new_branches, pmatrix, clv, scaler = branch_sweep.newton_sweep(
        p.clv, p.scale_buffer, p.pmatrix,
        jnp.asarray(blen, p.dtype),
        ev, inv_evecs, evecs, prop_invar, rates, rate_weights, freqs,
        params_idx_rates, ops, jnp.asarray(steps), pw, invariant,
        p.scale_threshold, p.scale_factor,
        passes=passes, iterations=iterations, n_aux=n_aux,
        asc_type=engine.asc_type, n_real=engine.n_real)
    p.clv, p.scale_buffer, p.pmatrix = clv, scaler, pmatrix
    engine.branches = new_branches
    engine.apply_branches_to_tree(tree)
    return engine.loglikelihood()


def newton_optimize_branches(partition, tree, params_indices,
                             passes: int = 2, iterations: int = 8,
                             tol: float = 1e-6) -> float:
    """Classic per-edge Newton branch-length optimization — the loop the
    reference's consumers build from pll_update_sumtable /
    pll_compute_likelihood_derivatives (examples/newton, RAxML-NG's
    smoothings). For each edge: full traversal rooted at the edge, one
    sumtable (branch-independent), then a few Newton iterations on that
    length. O(edges * traversal) per pass — quadratic in tree size, with
    quadratic per-edge convergence; `maximize_loglikelihood` is the
    scalable first-order alternative. Returns the final logL.
    """
    from .ops.derivatives import newton_step as _guarded
    from .trees.utree import traverse as _traverse
    from .trees import create_operations as _create_ops

    def edges():
        seen = set()
        for node in tree.nodes():
            halves = [node] if node.is_tip() else list(node.ring())
            for h in halves:
                if h.back is not None and id(h) not in seen \
                        and id(h.back) not in seen:
                    seen.add(id(h))
                    yield h if not h.is_tip() else h.back

    logl = None
    for _ in range(passes):
        for h in edges():
            trav = _traverse(h)
            ops, branches, pmat_idx = _create_ops(trav)
            partition.update_prob_matrices(params_indices, pmat_idx,
                                           branches)
            partition.update_partials(ops)
            st = partition.update_sumtable(
                h.clv_index, h.back.clv_index,
                h.scaler_index, h.back.scaler_index, params_indices)
            blen = h.length
            for _ in range(iterations):
                d1, d2 = partition.compute_likelihood_derivatives(
                    st, params_indices, blen,
                    parent_scaler_index=h.scaler_index,
                    child_scaler_index=h.back.scaler_index)
                new = float(_guarded(jnp.asarray(blen), jnp.asarray(d1),
                                     jnp.asarray(d2),
                                     C.OPT_MIN_BRANCH_LEN,
                                     C.OPT_MAX_BRANCH_LEN))
                if abs(new - blen) < tol:
                    blen = new
                    break
                blen = new
            h.length = h.back.length = blen
            partition.update_prob_matrices(params_indices,
                                           [h.pmatrix_index], [blen])
            logl = partition.compute_edge_loglikelihood(
                h.clv_index, h.scaler_index, h.back.clv_index,
                h.back.scaler_index, h.pmatrix_index, params_indices)
    return logl


def _apply(engine: TreeEngine, params: Dict[str, jnp.ndarray],
           subst_template=None) -> None:
    p = engine.partition
    if "log_branches" in params:
        engine.branches = jnp.exp(params["log_branches"]).astype(p.dtype)
    if "log_subst" in params:
        free = np.exp(np.asarray(params["log_subst"], np.float64))
        if subst_template is not None:
            full = np.concatenate(
                [np.ones((p.rate_matrices, 1)), free], axis=1)
            subst = full[:, np.asarray(subst_template, np.int32)]
        else:
            subst = np.concatenate(
                [free, np.ones((p.rate_matrices, 1))], axis=1)
        for m in range(p.rate_matrices):
            p.set_subst_params(m, subst[m])
    if "freq_logits" in params:
        logits = np.asarray(params["freq_logits"], np.float64)
        f = np.exp(logits - logits.max(axis=1, keepdims=True))
        f = f / f.sum(axis=1, keepdims=True)
        for m in range(p.rate_matrices):
            p.set_frequencies(m, f[m])
    if "log_subst" in params or "freq_logits" in params:
        for m in range(p.rate_matrices):
            p.update_eigen(m)


def _brent_minimize(f, lo, hi, tol=1e-4, max_iter=60):
    """Scalar bounded minimization (Brent). Self-contained so the library
    carries no scipy dependency on its hot paths."""
    gold = 0.3819660112501051
    a, b = lo, hi
    x = w = v = a + gold * (b - a)
    fx = fw = fv = f(x)
    d = e = 0.0
    for _ in range(max_iter):
        m = 0.5 * (a + b)
        tol1 = tol * abs(x) + 1e-10
        if abs(x - m) <= 2 * tol1 - 0.5 * (b - a):
            break
        use_golden = True
        if abs(e) > tol1:
            r = (x - w) * (fx - fv)
            q = (x - v) * (fx - fw)
            p = (x - v) * q - (x - w) * r
            q = 2 * (q - r)
            if q > 0:
                p = -p
            q = abs(q)
            if (abs(p) < abs(0.5 * q * e) and p > q * (a - x)
                    and p < q * (b - x)):
                e, d = d, p / q          # parabolic step
                u = x + d
                if u - a < 2 * tol1 or b - u < 2 * tol1:
                    d = tol1 if x < m else -tol1
                use_golden = False
        if use_golden:
            e = (b if x < m else a) - x
            d = gold * e
        u = x + (d if abs(d) >= tol1 else (tol1 if d > 0 else -tol1))
        fu = f(u)
        if fu <= fx:
            if u < x:
                b = x
            else:
                a = x
            v, w, x = w, x, u
            fv, fw, fx = fw, fx, fu
        else:
            if u < x:
                a = u
            else:
                b = u
            if fu <= fw or w == x:
                v, w = w, u
                fv, fw = fw, fu
            elif fu <= fv or v == x or v == w:
                v, fv = u, fu
    return x, fx


def optimize_gamma_shape(engine: TreeEngine, lo: float = 0.02,
                         hi: float = 100.0, tol: float = 1e-4,
                         mode: int = C.GAMMA_RATES_MEAN):
    """Brent optimization of the Gamma shape alpha (the consumers'
    PLL-style one-dimensional Brent over category rates; the AS91
    discretization is host code, so alpha is not reachable by jax.grad).
    Each trial is ONE device eval at re-discretized rates. Applies the
    best alpha's rates to the partition; returns (best alpha, logL)."""
    from .ops.gamma import compute_gamma_cats as _cats
    p = engine.partition
    R = p.rate_cats
    if R < 2:
        raise C.PllError(C.ERROR_PARAM_INVALID,
                         "gamma shape needs >= 2 rate categories")

    def neg(alpha):
        p.set_category_rates(_cats(float(alpha), R, mode))
        return -engine.loglikelihood()

    # log-scale search: alpha spans orders of magnitude
    x, fx = _brent_minimize(lambda t: neg(np.exp(t)),
                            np.log(lo), np.log(hi), tol=tol)
    alpha = float(np.exp(x))
    p.set_category_rates(_cats(alpha, R, mode))
    return alpha, -fx


def optimize_pinv(engine: TreeEngine, lo: float = 1e-6, hi: float = 0.99,
                  tol: float = 1e-5, params_index: int = 0):
    """Brent optimization of the invariant-sites proportion (+I). Each
    trial is one device eval; applies the best pinv; returns
    (best pinv, logL)."""
    p = engine.partition

    def neg(pinv):
        p.update_invariant_sites_proportion(params_index, float(pinv))
        return -engine.loglikelihood()

    x, fx = _brent_minimize(neg, lo, hi, tol=tol)
    p.update_invariant_sites_proportion(params_index, float(x))
    return float(x), -fx
