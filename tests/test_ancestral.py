"""Likelihood-based marginal ancestral state probabilities vs the oracle
(reference: /root/reference/src/likelihood.c:639-830,
pll_compute_node_ancestral)."""
import numpy as np
import pytest

import oracle
from test_core_m0 import build_random_scenario

pytestmark = pytest.mark.skipif(not oracle.available(),
                                reason="reference oracle not built")


@pytest.mark.parametrize("states,rate_cats,long_branches", [
    (4, 4, False),
    (4, 4, True),          # per-site scalers trigger; must cancel exactly
    (20, 2, False),
])
def test_node_ancestral_vs_oracle(states, rate_cats, long_branches):
    ref, part, ops, pidx = build_random_scenario(
        10, 53, states, rate_cats, seed=5, long_branches=long_branches)
    root, root_sc = ops[-1][0], ops[-1][1]
    # across the edge to an inner child, and to a tip
    for other, osc, mat in ((ops[-1][2], ops[-1][4], ops[-1][3]),
                            (ops[-1][5], ops[-1][7], ops[-1][6])):
        anc_ref = ref.node_ancestral(root, root_sc, other, osc, mat, pidx)
        anc = part.compute_node_ancestral(root, root_sc, other, osc, mat,
                                          pidx)
        np.testing.assert_allclose(anc, anc_ref, rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(anc.sum(axis=1), 1.0, rtol=1e-12)
    ref.destroy()


def test_node_ancestral_repeats_matches_dense():
    """The reference refuses repeats partitions (likelihood.c:668-674);
    here the pooled class columns are expanded per site, so the repeats
    answer must equal the dense one."""
    ref_d, dense, ops, pidx = build_random_scenario(8, 40, 4, 4, seed=7)
    ref_r, rep, ops_r, _ = build_random_scenario(8, 40, 4, 4, seed=7,
                                                 site_repeats=True)
    root, root_sc = ops[-1][0], ops[-1][1]
    other, osc, mat = ops[-1][2], ops[-1][4], ops[-1][3]
    a_dense = dense.compute_node_ancestral(root, root_sc, other, osc, mat,
                                           pidx)
    a_rep = rep.compute_node_ancestral(root, root_sc, other, osc, mat, pidx)
    np.testing.assert_allclose(a_rep, a_dense, rtol=1e-10, atol=1e-14)
    ref_d.destroy()
    ref_r.destroy()


def test_site_rate_posteriors():
    """Per-site rate posteriors validated against an independent
    computation: L_r(s) from R separate single-category evaluations,
    posterior = softmax over log(w_r) + lnl_r(s). Also checks fast and
    pooled engines agree."""
    import jax.numpy as jnp
    from libpll2_jax import Partition, TreeEngine, compute_gamma_cats
    from libpll2_jax.io import maps
    from libpll2_jax.trees import random_utree
    from libpll2_jax.utils import simulate_alignment

    FREQS = [0.3, 0.2, 0.2, 0.3]
    SUBST = [1, 2.5, 0.8, 1.1, 2.5, 1]
    tree = random_utree([f"t{i}" for i in range(10)], seed=51)
    headers, seqs = simulate_alignment(tree, 300, FREQS, SUBST,
                                       alpha=0.5, seed=51)
    by = dict(zip(headers, seqs))
    rates = compute_gamma_cats(0.5, 4)

    def build(rate_set, repeats=False, dtype=None):
        part = Partition(tree.tip_count, tree.inner_count, 4, 300, 1,
                         tree.edge_count, len(rate_set),
                         tree.inner_count, site_repeats=repeats,
                         dtype=dtype)
        for t in tree.tips():
            part.set_tip_states(t.clv_index, maps.map_nt, by[t.label])
        part.set_frequencies(0, FREQS)
        part.set_subst_params(0, SUBST)
        part.set_category_rates(rate_set)
        return part

    eng = TreeEngine(build(rates), tree, pallas=False)
    post, site_rate = eng.site_rate_posteriors()
    assert post.shape[0] == 5             # 4 Gamma cats + the +I class
    np.testing.assert_allclose(post[:, :300].sum(axis=0), 1.0, rtol=1e-9)
    assert np.all(post[4, :300] == 0.0)   # pinv = 0: no invariant mass

    # independent reference: per-category likelihoods via 4 single-rate
    # evaluations (w_r = 1/4 each in the mixture)
    lnls = []
    for r in rates:
        e1 = TreeEngine(build(np.array([r])), tree, pallas=False)
        _, per = e1.loglikelihood_persite()
        lnls.append(np.asarray(per)[:300])     # weights are all 1
    lnls = np.stack(lnls)                      # log L_r(s)
    ref = np.exp(lnls - lnls.max(axis=0))
    ref = ref / ref.sum(axis=0)
    np.testing.assert_allclose(post[:4, :300], ref, rtol=1e-6,
                               atol=1e-10)

    # the pooled-repeats engine gives identical posteriors
    eng_r = TreeEngine(build(rates, repeats=True), tree, pallas=False)
    post_r, _ = eng_r.site_rate_posteriors()
    np.testing.assert_allclose(post_r[:, :300], post[:, :300], rtol=1e-9)

    # +I: the invariant class takes pinv*f(inv)/Z mass at constant-capable
    # sites and the Gamma posteriors renormalize under (1-pinv)
    part_i = build(rates)
    part_i.update_invariant_sites_proportion(0, 0.3)
    eng_i = TreeEngine(part_i, tree, pallas=False)
    post_i, rate_i = eng_i.site_rate_posteriors()
    np.testing.assert_allclose(post_i[:, :300].sum(axis=0), 1.0,
                               rtol=1e-9)
    inv_sites = np.asarray(part_i.invariant[:300]) >= 0
    assert inv_sites.any()
    assert np.all(post_i[4, :300][inv_sites] > 0)
    assert np.all(post_i[4, :300][~inv_sites] == 0)
    # independent check at one invariant-capable site; +I stretches the
    # Gamma rates by 1/(1-pinv) inside the P-matrices, so the
    # single-category reference evals must use the stretched rates
    sidx = int(np.argmax(inv_sites))
    state = int(part_i.invariant[sidx])
    f = np.asarray(part_i.frequencies[0])
    lr = []
    for r in rates:
        e1 = TreeEngine(build(np.array([r / 0.7])), tree, pallas=False)
        _, per = e1.loglikelihood_persite()
        lr.append(np.exp(np.asarray(per)[sidx]))
    z = 0.25 * 0.7 * np.sum(lr) + 0.3 * f[state]
    np.testing.assert_allclose(post_i[4, sidx], 0.3 * f[state] / z,
                               rtol=1e-5)
    assert rate_i[sidx] < site_rate[sidx] + 1e-9

    # the dense-fused-over-pooled engine path (fp32) agrees too
    eng_f = TreeEngine(build(rates, repeats=True, dtype=jnp.float32),
                       tree, pallas="interpret")
    assert eng_f.repeats_dense_fused
    post_f, _ = eng_f.site_rate_posteriors()
    np.testing.assert_allclose(post_f[:, :300], post[:, :300],
                               rtol=5e-4, atol=1e-5)

    # sanity: mean site rate near 1 (Gamma normalization)
    assert 0.5 < site_rate[:300].mean() < 1.5
