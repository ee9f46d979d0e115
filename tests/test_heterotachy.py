"""Per-branch heterotachy (reference: examples/heterotachy): different
rate matrices on different branches. Validates both API levels:

  * step-by-step Partition (two update_prob_matrices calls, one per
    branch class — the reference client pattern) against the oracle;
  * TreeEngine(edge_params=...) fused path against the step-by-step
    result and across execution modes.
"""
import numpy as np
import pytest

import oracle
from libpll2_jax import Partition, TreeEngine, compute_gamma_cats
from libpll2_jax.io import maps
from libpll2_jax.trees import create_operations, random_utree, traverse
from libpll2_jax.utils.simulate import simulate_alignment

N_TAXA = 14
N_SITES = 384   # 128-aligned for the fused-kernel eligibility check
FREQS0 = [0.3, 0.25, 0.2, 0.25]
SUBST0 = [1.2, 3.0, 0.8, 1.1, 2.6, 1.0]
FREQS1 = [0.2, 0.3, 0.3, 0.2]
SUBST1 = [0.7, 1.1, 2.4, 0.9, 1.6, 1.0]


def _problem(seed=19):
    tree = random_utree([f"t{i}" for i in range(N_TAXA)], seed=seed)
    headers, seqs = simulate_alignment(tree, N_SITES, FREQS0, SUBST0,
                                       alpha=0.8, seed=seed)
    trav = traverse(tree.vroot)
    ops, branches, pidx = create_operations(trav)
    # branch classes: alternate models by pmatrix index parity
    edge_params = np.array([i % 2 for i in range(tree.edge_count)],
                           dtype=np.int32)
    return tree, headers, seqs, ops, branches, pidx, edge_params


def _fill_models(impl, oracle_mode=False):
    rates = compute_gamma_cats(0.8, 4)
    impl.set_frequencies(0, FREQS0)
    impl.set_subst_params(0, SUBST0)
    impl.set_frequencies(1, FREQS1)
    impl.set_subst_params(1, SUBST1)
    impl.set_category_rates(rates)


def _eval_stepwise(impl, tree, ops, branches, pidx, edge_params,
                   is_oracle=False):
    """Reference client pattern: one update_prob_matrices call per branch
    class (examples/heterotachy)."""
    for model in (0, 1):
        sel = [i for i, m in enumerate(pidx) if edge_params[m] == model]
        mats = [pidx[i] for i in sel]
        brs = [branches[i] for i in sel]
        impl.update_prob_matrices([model] * 4, mats, brs)
    if is_oracle:
        impl.update_partials([(o.parent_clv_index, o.parent_scaler_index,
                               o.child1_clv_index, o.child1_matrix_index,
                               o.child1_scaler_index, o.child2_clv_index,
                               o.child2_matrix_index,
                               o.child2_scaler_index) for o in ops])
    else:
        impl.update_partials(ops)
    root = tree.vroot
    rm = int(edge_params[root.pmatrix_index])
    args = (root.clv_index, root.scaler_index, root.back.clv_index,
            root.back.scaler_index, root.pmatrix_index, [rm] * 4)
    if is_oracle:
        return impl.edge_loglikelihood(*args)
    return impl.compute_edge_loglikelihood(*args)


def _build(tree, headers, seqs, oracle_mode=False):
    by = dict(zip(headers, seqs))
    if oracle_mode:
        impl = oracle.OraclePartition(tree.tip_count, tree.inner_count, 4,
                                      N_SITES, 2, tree.edge_count, 4,
                                      tree.inner_count)
        for t in tree.tips():
            impl.set_tip_states(t.clv_index, "nt", by[t.label])
    else:
        impl = Partition(tree.tip_count, tree.inner_count, 4, N_SITES, 2,
                         tree.edge_count, 4, tree.inner_count)
        for t in tree.tips():
            impl.set_tip_states(t.clv_index, maps.map_nt, by[t.label])
    _fill_models(impl)
    return impl


@pytest.mark.skipif(not oracle.available(), reason="reference unavailable")
def test_heterotachy_stepwise_vs_oracle():
    tree, headers, seqs, ops, branches, pidx, ep = _problem()
    ref = _build(tree, headers, seqs, oracle_mode=True)
    lk_ref = _eval_stepwise(ref, tree, ops, branches, pidx, ep,
                            is_oracle=True)
    ref.destroy()
    part = _build(tree, headers, seqs)
    lk = _eval_stepwise(part, tree, ops, branches, pidx, ep)
    np.testing.assert_allclose(lk, lk_ref, rtol=1e-10)


def test_engine_edge_params_matches_stepwise():
    tree, headers, seqs, ops, branches, pidx, ep = _problem()
    part = _build(tree, headers, seqs)
    lk_sbs = _eval_stepwise(part, tree, ops, branches, pidx, ep)

    part2 = _build(tree, headers, seqs)
    eng = TreeEngine(part2, tree, edge_params=ep, pallas=False)
    lk_eng = eng.loglikelihood()
    np.testing.assert_allclose(lk_eng, lk_sbs, rtol=1e-10)
    # and a two-model tree genuinely differs from a single-model one
    part3 = _build(tree, headers, seqs)
    lk_single = TreeEngine(part3, tree, pallas=False).loglikelihood()
    assert abs(lk_eng - lk_single) > 0.1


def test_engine_edge_params_newton_and_modes():
    tree, headers, seqs, ops, branches, pidx, ep = _problem(seed=23)
    import jax.numpy as jnp

    def mk(dtype=None):
        by = dict(zip(headers, seqs))
        part = Partition(tree.tip_count, tree.inner_count, 4, N_SITES, 2,
                         tree.edge_count, 4, tree.inner_count, dtype=dtype)
        for t in tree.tips():
            part.set_tip_states(t.clv_index, maps.map_nt, by[t.label])
        _fill_models(part)
        return part

    e_scan = TreeEngine(mk(), tree, edge_params=ep, pallas=False,
                        level_schedule=False)
    e_lvl = TreeEngine(mk(), tree, edge_params=ep, pallas=False)
    lk1, lk2 = e_scan.loglikelihood(), e_lvl.loglikelihood()
    np.testing.assert_allclose(lk1, lk2, rtol=1e-12)
    # newton loop runs and improves
    lk0 = e_lvl.loglikelihood()
    lkn, d1, d2 = e_lvl.newton_loop(5)
    assert np.isfinite(lkn) and lkn >= lk0 - 1e-9
    # fused Pallas kernel path (fp32, interpret) agrees to fp32 accuracy
    e_pl = TreeEngine(mk(jnp.float32), tree, edge_params=ep,
                      pallas="interpret")
    assert e_pl.use_fused
    np.testing.assert_allclose(e_pl.loglikelihood(), lk1, rtol=1e-5)


def test_engine_edge_params_with_site_repeats():
    """Per-branch models compose with pooled site repeats: the repeats
    engine's logL matches the step-by-step heterotachy result (classes
    are model-independent, so compression cannot change the math)."""
    tree, headers, seqs, ops, branches, pidx, ep = _problem(seed=31)
    part = _build(tree, headers, seqs)
    lk_sbs = _eval_stepwise(part, tree, ops, branches, pidx, ep)

    by = dict(zip(headers, seqs))
    part_r = Partition(tree.tip_count, tree.inner_count, 4, N_SITES, 2,
                       tree.edge_count, 4, tree.inner_count,
                       site_repeats=True)
    for t in tree.tips():
        part_r.set_tip_states(t.clv_index, maps.map_nt, by[t.label])
    _fill_models(part_r)
    eng = TreeEngine(part_r, tree, edge_params=ep)
    assert eng.repeats_mode
    lk_rep = eng.loglikelihood()
    np.testing.assert_allclose(lk_rep, lk_sbs, rtol=1e-10)
    # newton loop over the repeats pool honors per-edge models
    lkn, d1, d2 = eng.newton_loop(4)
    assert np.isfinite(lkn) and lkn >= lk_rep - 1e-9


def test_evaluate_topologies_edge_params():
    """Batched candidate scoring must use the per-edge models AND each
    candidate's own root-edge model for the likelihood mixing — scoring
    the engine's own topology must reproduce loglikelihood() exactly
    (regression: candidates were scored with the homogeneous model,
    ~40 logL units off on a two-model tree)."""
    tree, headers, seqs, ops, branches, pidx, ep = _problem(seed=41)
    part = _build(tree, headers, seqs)
    eng = TreeEngine(part, tree, edge_params=ep, pallas=False,
                     level_schedule=False)
    lk = eng.loglikelihood()
    vr = tree.vroot
    cand = [(ops, branches, pidx,
             (vr.clv_index, vr.scaler_index, vr.back.clv_index,
              vr.back.scaler_index, vr.pmatrix_index))]
    scores = eng.evaluate_topologies(cand)
    np.testing.assert_allclose(scores[0], lk, rtol=1e-10)

    # fused-kernel path too (fp32 tolerance)
    import jax.numpy as jnp
    part2 = Partition(tree.tip_count, tree.inner_count, 4, N_SITES, 2,
                      tree.edge_count, 4, tree.inner_count,
                      dtype=jnp.float32)
    by = dict(zip(headers, seqs))
    for t in tree.tips():
        part2.set_tip_states(t.clv_index, maps.map_nt, by[t.label])
    _fill_models(part2)
    eng2 = TreeEngine(part2, tree, edge_params=ep, pallas="interpret")
    assert eng2.use_fused
    lk2 = eng2.loglikelihood()
    scores2 = eng2.evaluate_topologies(cand)
    np.testing.assert_allclose(scores2[0], lk2, rtol=1e-5)

    # repeats path: per-candidate root model
    part3 = Partition(tree.tip_count, tree.inner_count, 4, N_SITES, 2,
                      tree.edge_count, 4, tree.inner_count,
                      site_repeats=True)
    for t in tree.tips():
        part3.set_tip_states(t.clv_index, maps.map_nt, by[t.label])
    _fill_models(part3)
    eng3 = TreeEngine(part3, tree, edge_params=ep)
    assert eng3.repeats_mode
    lk3 = eng3.loglikelihood()
    scores3 = eng3.evaluate_topologies(cand)
    np.testing.assert_allclose(scores3[0], lk3, rtol=1e-10)


def test_loop_k0_preserves_root_rows():
    """loglikelihood_loop(0)/newton_loop(0) must not corrupt the stored
    root CLV rows with the loop carry's zero initializer."""
    import jax.numpy as jnp
    tree, headers, seqs, ops, branches, pidx, ep = _problem(seed=47)
    by = dict(zip(headers, seqs))
    part = Partition(tree.tip_count, tree.inner_count, 4, N_SITES, 1,
                     tree.edge_count, 4, tree.inner_count,
                     dtype=jnp.float32)
    for t in tree.tips():
        part.set_tip_states(t.clv_index, maps.map_nt, by[t.label])
    part.set_frequencies(0, FREQS0)
    part.set_subst_params(0, SUBST0)
    part.set_category_rates(compute_gamma_cats(0.8, 4))
    eng = TreeEngine(part, tree, pallas="interpret")
    assert eng.use_fused
    lk = eng.loglikelihood()
    root_row = np.asarray(part.clv[tree.vroot.clv_index]).copy()
    assert np.abs(root_row).sum() > 0
    acc = eng.loglikelihood_loop(0)
    assert acc == 0.0
    np.testing.assert_array_equal(np.asarray(part.clv[tree.vroot.clv_index]),
                                  root_row)
