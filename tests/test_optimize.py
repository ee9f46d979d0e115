"""Gradient-based optimization layer: correctness of the differentiable
likelihood (finite-difference check, oracle parity at optimized values) and
actual logL improvement on perturbed parameters."""
import numpy as np
import pytest
import jax
import jax.numpy as jnp

import oracle
from libpll2_jax import Partition, TreeEngine, compute_gamma_cats
from libpll2_jax.io import maps
from libpll2_jax.optimize import make_loglikelihood_fn, maximize_loglikelihood
from libpll2_jax.trees import create_operations, random_utree, traverse
from libpll2_jax.utils import simulate_alignment

N_TAXA, N_SITES = 14, 400
TRUE_FREQS = [0.35, 0.15, 0.2, 0.3]
TRUE_SUBST = [1.0, 3.0, 0.7, 1.1, 2.5, 1.0]


@pytest.fixture(scope="module")
def data():
    tree = random_utree([f"t{i}" for i in range(N_TAXA)], seed=55)
    headers, seqs = simulate_alignment(tree, N_SITES, TRUE_FREQS,
                                       TRUE_SUBST, alpha=0.9, seed=55)
    return tree, dict(zip(headers, seqs))


def _engine(tree, by_label, freqs, subst):
    part = Partition(tree.tip_count, tree.inner_count, 4, N_SITES, 1,
                     tree.edge_count, 4, tree.inner_count)
    for tip in tree.tips():
        part.set_tip_states(tip.clv_index, maps.map_nt, by_label[tip.label])
    part.set_frequencies(0, freqs)
    part.set_subst_params(0, subst)
    part.set_category_rates(compute_gamma_cats(0.9, 4))
    return TreeEngine(part, tree, pallas=False)


def test_gradient_matches_finite_differences(data):
    tree, by_label = data
    eng = _engine(tree, by_label, TRUE_FREQS, TRUE_SUBST)
    fn, params = make_loglikelihood_fn(eng, ("branches", "subst", "freqs"))
    g = jax.grad(fn)(params)
    eps = 1e-6
    for key in ("log_branches", "log_subst"):
        flat = np.asarray(params[key], np.float64).ravel()
        gflat = np.asarray(g[key], np.float64).ravel()
        for idx in (0, len(flat) - 1):
            for sign, delta in ((1, eps), (-1, -eps)):
                pass
            pp = dict(params)
            v = flat.copy()
            v[idx] += eps
            pp[key] = jnp.asarray(v.reshape(params[key].shape),
                                  params[key].dtype)
            up = float(fn(pp))
            v[idx] -= 2 * eps
            pp[key] = jnp.asarray(v.reshape(params[key].shape),
                                  params[key].dtype)
            dn = float(fn(pp))
            fd = (up - dn) / (2 * eps)
            assert gflat[idx] == pytest.approx(fd, rel=2e-3, abs=1e-4), \
                f"{key}[{idx}]"


def test_optimize_branches_improves_and_matches_oracle(data):
    tree, by_label = data
    # perturb: halve every branch length
    eng = _engine(tree, by_label, TRUE_FREQS, TRUE_SUBST)
    eng.branches = eng.branches * 0.4
    lk0 = eng.loglikelihood()
    lk, params, hist = maximize_loglikelihood(eng, ("branches",),
                                              steps=150)
    assert lk > lk0 + 1.0

    # oracle parity at the optimized branch lengths
    if oracle.available():
        ref = oracle.OraclePartition(tree.tip_count, tree.inner_count, 4,
                                     N_SITES, 1, tree.edge_count, 4,
                                     tree.inner_count)
        for tip in tree.tips():
            ref.set_tip_states(tip.clv_index, "nt", by_label[tip.label])
        ref.set_frequencies(0, TRUE_FREQS)
        ref.set_subst_params(0, TRUE_SUBST)
        ref.set_category_rates(compute_gamma_cats(0.9, 4))
        trav = traverse(tree.vroot)
        ops, _, pmat_idx = create_operations(trav)
        blens = np.asarray(eng.branches)[np.asarray(pmat_idx)]
        ref.update_prob_matrices([0] * 4, pmat_idx, blens)
        ref.update_partials([(o.parent_clv_index, o.parent_scaler_index,
                              o.child1_clv_index, o.child1_matrix_index,
                              o.child1_scaler_index, o.child2_clv_index,
                              o.child2_matrix_index, o.child2_scaler_index)
                             for o in ops])
        root = tree.vroot
        lk_ref = ref.edge_loglikelihood(
            root.clv_index, root.scaler_index, root.back.clv_index,
            root.back.scaler_index, root.pmatrix_index, [0] * 4)
        ref.destroy()
        np.testing.assert_allclose(lk, lk_ref, rtol=1e-8)


def test_optimize_model_recovers_parameters(data):
    tree, by_label = data
    # start from a wrong model; optimizing subst+freqs should approach
    # truth. NOT exactly JC: repeated eigenvalues break the eigh gradient
    # (see optimize.py caveat).
    eng = _engine(tree, by_label, [0.26, 0.24, 0.25, 0.25],
                  [1.0, 1.1, 0.9, 1.05, 0.95, 1.0])
    lk0 = eng.loglikelihood()
    lk, params, _ = maximize_loglikelihood(
        eng, ("branches", "subst", "freqs"), steps=250, learning_rate=0.05)
    assert lk > lk0 + 5.0
    f = np.asarray(eng.partition.frequencies[0])
    # recovered frequencies correlate with the generating ones
    assert np.corrcoef(f, TRUE_FREQS)[0, 1] > 0.9


def test_newton_all_branches_matches_gradient_optimum(data):
    """Per-edge Newton smoothing (classic consumer loop) reaches at least
    the gradient optimizer's logL on perturbed branch lengths."""
    from libpll2_jax.optimize import newton_optimize_branches

    tree, by_label = data
    # perturb all branch lengths
    seen = set()
    for node in tree.nodes():
        for h in ([node] if node.is_tip() else list(node.ring())):
            if h.back is not None and id(h) not in seen:
                seen.add(id(h)), seen.add(id(h.back))
                h.length = h.back.length = h.length * 0.3 + 0.02

    eng = _engine(tree, by_label, TRUE_FREQS, TRUE_SUBST)
    lk0 = eng.loglikelihood()
    lk_grad, _, _ = maximize_loglikelihood(eng, ("branches",), steps=300,
                                           learning_rate=0.05)

    part = eng.partition   # reuse (state fully recomputed per traversal)
    lk_newton = newton_optimize_branches(part, tree, [0] * 4, passes=3)
    assert lk_newton > lk0 + 1.0
    assert lk_newton >= lk_grad - 0.5


def test_optimize_gamma_shape_recovers_truth():
    """Brent over alpha recovers the generating shape (within the
    statistical wobble of a finite alignment) and beats neighboring
    alphas; scipy's bounded Brent agrees with the self-contained one."""
    from libpll2_jax.optimize import optimize_gamma_shape
    from libpll2_jax.trees import random_utree
    from libpll2_jax.utils import simulate_alignment
    from libpll2_jax.io import maps

    true_alpha = 0.6
    tree = random_utree([f"t{i}" for i in range(12)], seed=5)
    headers, seqs = simulate_alignment(tree, 2000, [0.3, 0.2, 0.2, 0.3],
                                       [1, 2.2, 0.8, 1.1, 2.6, 1],
                                       alpha=true_alpha, seed=5)
    by = dict(zip(headers, seqs))
    part = Partition(tree.tip_count, tree.inner_count, 4, 2000, 1,
                     tree.edge_count, 4, tree.inner_count)
    for t in tree.tips():
        part.set_tip_states(t.clv_index, maps.map_nt, by[t.label])
    part.set_frequencies(0, [0.3, 0.2, 0.2, 0.3])
    part.set_subst_params(0, [1, 2.2, 0.8, 1.1, 2.6, 1])
    part.set_category_rates(compute_gamma_cats(2.0, 4))   # start far off
    eng = TreeEngine(part, tree, pallas=False)
    alpha, lk = optimize_gamma_shape(eng)
    assert 0.3 < alpha < 1.2, alpha
    # the optimum beats nearby alphas
    for trial in (alpha * 0.7, alpha * 1.4):
        part.set_category_rates(compute_gamma_cats(trial, 4))
        assert eng.loglikelihood() < lk + 1e-6
    # restore + verify the applied optimum is reproducible
    part.set_category_rates(compute_gamma_cats(alpha, 4))
    np.testing.assert_allclose(eng.loglikelihood(), lk, rtol=1e-10)


def test_optimize_pinv():
    from libpll2_jax.optimize import optimize_pinv
    from libpll2_jax.trees import random_utree
    from libpll2_jax.utils import simulate_alignment
    from libpll2_jax.io import maps

    tree = random_utree([f"t{i}" for i in range(10)], seed=9)
    headers, seqs = simulate_alignment(tree, 800, [0.25] * 4,
                                       [1, 2, 1, 1, 2, 1], alpha=0.9,
                                       seed=9)
    # inject truly invariant columns (a +I signal)
    seqs = ["A" * 200 + s[200:] for s in seqs]
    by = dict(zip(headers, seqs))
    part = Partition(tree.tip_count, tree.inner_count, 4, 800, 1,
                     tree.edge_count, 4, tree.inner_count)
    for t in tree.tips():
        part.set_tip_states(t.clv_index, maps.map_nt, by[t.label])
    part.set_frequencies(0, [0.25] * 4)
    part.set_subst_params(0, [1, 2, 1, 1, 2, 1])
    part.set_category_rates(compute_gamma_cats(0.9, 4))
    eng = TreeEngine(part, tree, pallas=False)
    lk0 = eng.loglikelihood()
    pinv, lk = optimize_pinv(eng)
    assert 0.05 < pinv < 0.6, pinv
    assert lk > lk0 + 1.0
    np.testing.assert_allclose(eng.loglikelihood(), lk, rtol=1e-10)


def test_maximize_fused_parity_with_grad_path(data):
    """Model-parameter optimization on the FUSED execution path (batched
    central-difference Adam): reaches the fp64
    differentiable optimizer's optimum without ever leaving the Pallas
    kernel. Parity: final logL within fp32 noise, params within ~2%."""
    from libpll2_jax.optimize import maximize_fused

    tree, by_label = data
    start_f = [0.26, 0.24, 0.25, 0.25]
    start_s = [1.0, 1.1, 0.9, 1.05, 0.95, 1.0]

    eng64 = _engine(tree, by_label, start_f, start_s)
    lk64, _, _ = maximize_loglikelihood(eng64, ("subst", "freqs"),
                                        steps=300, learning_rate=0.05)

    part = Partition(tree.tip_count, tree.inner_count, 4, N_SITES, 1,
                     tree.edge_count, 4, tree.inner_count, dtype="float32")
    for tip in tree.tips():
        part.set_tip_states(tip.clv_index, maps.map_nt, by_label[tip.label])
    part.set_frequencies(0, start_f)
    part.set_subst_params(0, start_s)
    part.set_category_rates(compute_gamma_cats(0.9, 4))
    eng = TreeEngine(part, tree, pallas="interpret")
    assert eng.execution_path == "fused"
    lk0 = eng.loglikelihood()
    # maximize_loglikelihood must auto-route to the fused FD path
    lk, params, hist = maximize_loglikelihood(eng, ("subst", "freqs"),
                                              steps=300,
                                              learning_rate=0.05)
    assert lk > lk0 + 5.0
    assert abs(lk - lk64) < 0.05, (lk, lk64)
    np.testing.assert_allclose(np.asarray(part.subst_params[0]),
                               np.asarray(eng64.partition.subst_params[0]),
                               rtol=0.03)
    np.testing.assert_allclose(np.asarray(part.frequencies[0]),
                               np.asarray(eng64.partition.frequencies[0]),
                               rtol=0.02)
    # the applied params reproduce the reported optimum through the
    # engine's own loglikelihood (fp32 eval noise)
    assert abs(eng.loglikelihood() - lk) < 2e-2
    # branches on a Pallas engine belong to the Newton machinery
    import libpll2_jax.constants as C
    with pytest.raises(C.PllError):
        maximize_loglikelihood(eng, ("branches",))
    # direct maximize_fused with a subst_template (HKY: one free ts/tv)
    lk_hky, p_hky, _ = maximize_fused(eng, ("subst",),
                                      subst_template=[0, 1, 0, 0, 1, 0],
                                      steps=80)
    s = np.asarray(part.subst_params[0])
    np.testing.assert_allclose(s[[0, 2, 3, 5]], s[0], rtol=1e-6)
    np.testing.assert_allclose(s[1], s[4], rtol=1e-6)
    assert lk_hky < lk + 0.5     # nested model cannot beat GTR


def test_pooled_partition_guards():
    """Dense-buffer consumers reject pooled site-repeats partitions with
    a clear error instead of an AttributeError on clv=None."""
    import jax.numpy as jnp
    from libpll2_jax import constants as C
    from libpll2_jax.optimize import (make_loglikelihood_fn,
                                      newton_smooth_all)
    from libpll2_jax.trees import random_utree
    from libpll2_jax.utils import simulate_alignment
    from libpll2_jax.io import maps

    tree = random_utree([f"t{i}" for i in range(8)], seed=3)
    headers, seqs = simulate_alignment(tree, 128, [0.25] * 4,
                                       [1, 2, 1, 1, 2, 1], alpha=1.0,
                                       seed=3)
    by = dict(zip(headers, seqs))
    part = Partition(tree.tip_count, tree.inner_count, 4, 128, 1,
                     tree.edge_count, 4, tree.inner_count,
                     site_repeats=True)
    for t in tree.tips():
        part.set_tip_states(t.clv_index, maps.map_nt, by[t.label])
    part.set_frequencies(0, [0.25] * 4)
    part.set_subst_params(0, [1, 2, 1, 1, 2, 1])
    part.set_category_rates(compute_gamma_cats(1.0, 4))
    eng = TreeEngine(part, tree, pallas=False)
    with pytest.raises(C.PllError):
        make_loglikelihood_fn(eng, ("branches",))
    with pytest.raises(C.PllError):
        newton_smooth_all(eng, tree)
