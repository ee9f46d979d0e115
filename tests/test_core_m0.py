"""M0 validation: gamma rates, P-matrices, CLVs, root/edge logL vs reference.

Every test drives the reference library (built from /root/reference as a
ctypes oracle) through the same scenario and requires <=1e-8 agreement.
"""
import numpy as np
import pytest

import oracle
from libpll2_jax import Operation, Partition, compute_gamma_cats
from libpll2_jax import constants as C
from libpll2_jax.io import maps
from libpll2_jax.ops import eigen as ops_eigen

pytestmark = pytest.mark.skipif(not oracle.available(),
                                reason="reference not available")

RNG = np.random.default_rng(42)
NT = "ACGT"


def random_seq(n, alphabet=NT + "-NRYK", rng=RNG):
    return "".join(rng.choice(list(alphabet), size=n))


# --------------------------------------------------------------------- gamma
@pytest.mark.parametrize("alpha", [0.02, 0.1, 0.5, 1.0, 3.7, 50.0])
@pytest.mark.parametrize("cats", [1, 2, 4, 8])
@pytest.mark.parametrize("mode", [C.GAMMA_RATES_MEAN, C.GAMMA_RATES_MEDIAN])
def test_gamma_cats(alpha, cats, mode):
    ours = compute_gamma_cats(alpha, cats, mode)
    ref = oracle.gamma_cats(alpha, cats, mode)
    np.testing.assert_allclose(ours, ref, rtol=1e-9, atol=1e-12)


def test_gamma_invalid_alpha():
    with pytest.raises(C.PllError) as e:
        compute_gamma_cats(0.0, 4)
    assert e.value.errno == C.ERROR_PARAM_INVALID


# ------------------------------------------------------------------- pmatrix
@pytest.mark.parametrize("states", [4, 20])
def test_pmatrix_vs_oracle(states):
    nparams = states * (states - 1) // 2
    freqs = RNG.dirichlet(np.ones(states))
    params = RNG.uniform(0.1, 5.0, size=nparams)
    rates = compute_gamma_cats(0.75, 4)
    brlens = [0.0, 1e-9, 0.001, 0.1, 1.0, 10.0]

    ref = oracle.OraclePartition(2, 1, states, 4, 1, len(brlens), 4, 0)
    ref.set_frequencies(0, freqs)
    ref.set_subst_params(0, params)
    ref.set_category_rates(rates)
    ref.update_prob_matrices([0] * 4, list(range(len(brlens))), brlens)

    part = Partition(2, 1, states, 4, 1, len(brlens), 4, 0)
    part.set_frequencies(0, freqs)
    part.set_subst_params(0, params)
    part.set_category_rates(rates)
    part.update_prob_matrices([0] * 4, list(range(len(brlens))), brlens)

    for m in range(len(brlens)):
        np.testing.assert_allclose(part.get_pmatrix(m), ref.get_pmatrix(m),
                                   rtol=1e-9, atol=1e-12,
                                   err_msg=f"pmatrix {m} brlen={brlens[m]}")
    ref.destroy()


def test_pmatrix_zero_freq_state_elimination():
    """IQ-TREE near-zero-frequency trick (models.c:258-291)."""
    states = 4
    freqs = np.array([0.5, 0.5 - 2e-7, 1e-7, 1e-7])
    params = RNG.uniform(0.5, 2.0, size=6)
    ref = oracle.OraclePartition(2, 1, states, 4, 1, 1, 1, 0)
    ref.set_frequencies(0, freqs)
    ref.set_subst_params(0, params)
    ref.set_category_rates([1.0])
    ref.update_prob_matrices([0], [0], [0.42])

    part = Partition(2, 1, states, 4, 1, 1, 1, 0)
    part.set_frequencies(0, freqs)
    part.set_subst_params(0, params)
    part.set_category_rates([1.0])
    part.update_prob_matrices([0], [0], [0.42])
    np.testing.assert_allclose(part.get_pmatrix(0), ref.get_pmatrix(0),
                               rtol=1e-8, atol=1e-10)
    ref.destroy()


# ------------------------------------------------- the 00010_NMDU scenario
def scenario_00010(attrs=0, **kw):
    """5-taxon hand-built tree from test/src/00010_NMDU_lkcalc.c:33-140."""
    seqs = ["WAC-CTA-ATCT", "CCC-TTA-ATGT", "A-C-TAG-CTCT",
            "CTCTTAA-A-CG", "CAC-TCA-A-TG"]
    ops = [
        (5, -1, 0, 1, -1, 1, 1, -1),
        (6, -1, 5, 0, -1, 2, 1, -1),
        (7, -1, 3, 1, -1, 4, 1, -1),
    ]
    brlens = [0.1, 0.2, 1.0, 1.0]
    freqs = [0.3, 0.4, 0.1, 0.2]
    titv = 2.5
    subst = [1, titv, 1, 1, titv, 1]
    rates = compute_gamma_cats(0.5, 4)

    ref = oracle.OraclePartition(5, 4, 4, 12, 1, 7, 4, 0, attributes=attrs)
    part = Partition(5, 4, 4, 12, 1, 7, 4, 0, **kw)
    for impl, setter in ((ref, "set_tip_states"), (part, "set_tip_states")):
        pass
    for i, s in enumerate(seqs):
        ref.set_tip_states(i, "nt", s)
        part.set_tip_states(i, maps.map_nt, s)
    for impl in (ref, part):
        impl.set_frequencies(0, freqs)
        impl.set_subst_params(0, subst)
        impl.set_category_rates(rates)
        impl.update_prob_matrices([0] * 4, [0, 1, 2, 3], brlens)
    ref.update_partials(ops)
    part.update_partials([Operation(*o) for o in ops])
    return ref, part, ops


def test_lkcalc_00010_clvs_and_edge_logl():
    ref, part, _ = scenario_00010()
    for node in (5, 6, 7):
        np.testing.assert_allclose(part.get_clv(node), ref.get_clv(node),
                                   rtol=1e-9, atol=1e-13,
                                   err_msg=f"CLV {node}")
    lk_ref, per_ref = ref.edge_loglikelihood(6, -1, 7, -1, 0, [0] * 4,
                                             persite=True)
    lk, per = part.compute_edge_loglikelihood(6, -1, 7, -1, 0, [0] * 4,
                                              persite=True)
    np.testing.assert_allclose(lk, lk_ref, rtol=1e-10)
    np.testing.assert_allclose(per, per_ref, rtol=1e-10, atol=1e-12)
    # against the shipped golden output (test/out/00010_NMDU_lkcalc.out)
    assert f"{lk:.6f}" == "-58.887310"  # test/out/00010_NMDU_lkcalc.out
    ref.destroy()


def test_lkcalc_00010_tip_inner_refresh():
    ref, part, _ = scenario_00010()
    op = (7, -1, 6, 0, -1, 3, 1, -1)
    ref.update_partials([op])
    part.update_partials([Operation(*op)])
    lk_ref = ref.edge_loglikelihood(7, -1, 4, -1, 1, [0] * 4)
    lk = part.compute_edge_loglikelihood(7, -1, 4, -1, 1, [0] * 4)
    np.testing.assert_allclose(lk, lk_ref, rtol=1e-10)
    ref.destroy()


# -------------------------------------------- randomized full-tree scenarios
def build_random_scenario(n_tips, n_sites, states, rate_cats, *,
                          attrs=0, pinv=0.0, seed=0, long_branches=False,
                          weights=None, rate_weights=None, **kw):
    """Random caterpillar-ish tree with scalers, driven on both engines."""
    rng = np.random.default_rng(seed)
    alphabet = NT if states == 4 else maps.AA_ORDER
    seqs = ["".join(rng.choice(list(alphabet + "-"), size=n_sites))
            for _ in range(n_tips)]
    if pinv > 0:
        # guarantee invariant columns so +I has something to detect
        seqs = [alphabet[:4] + s[4:] for s in seqs]

    n_inner = n_tips - 1  # rooted-style chain of joins
    n_edges = 2 * n_inner
    nparams = states * (states - 1) // 2
    freqs = rng.dirichlet(np.ones(states) * 5)
    subst = rng.uniform(0.2, 3.0, size=nparams)
    rates = compute_gamma_cats(float(rng.uniform(0.2, 2.0)), rate_cats)
    scale = 40.0 if long_branches else 1.0
    brlens = rng.uniform(0.01, 0.4, size=n_edges) * scale

    mapname = "nt" if states == 4 else "aa"
    charmap = maps.map_nt if states == 4 else maps.map_aa

    ref = oracle.OraclePartition(n_tips, n_inner, states, n_sites, 1,
                                 n_edges, rate_cats, n_inner,
                                 attributes=attrs)
    part = Partition(n_tips, n_inner, states, n_sites, 1, n_edges,
                     rate_cats, n_inner,
                     rate_scalers=bool(attrs & oracle.ATTRIB_RATE_SCALERS),
                     **kw)
    for i, s in enumerate(seqs):
        ref.set_tip_states(i, mapname, s)
        part.set_tip_states(i, charmap, s)
    for impl in (ref, part):
        impl.set_frequencies(0, freqs)
        impl.set_subst_params(0, subst)
        impl.set_category_rates(rates)
        if rate_weights is not None:
            impl.set_category_weights(rate_weights)
        if weights is not None:
            impl.set_pattern_weights(weights)
    if pinv > 0:
        ref.set_invariant_proportion(0, pinv)
        part.update_invariant_sites_proportion(0, pinv)

    pidx = [0] * rate_cats
    for impl in (ref, part):
        impl.update_prob_matrices(pidx, list(range(n_edges)), brlens)

    # chain: node n_tips joins tips 0,1; node n_tips+k joins (prev, tip k+2)
    ops = []
    for k in range(n_inner):
        parent = n_tips + k
        c1 = n_tips + k - 1 if k > 0 else 0
        c2 = k + 1
        ops.append((parent, k, c1, 2 * k, (k - 1) if k > 0 else -1,
                    c2, 2 * k + 1, -1))
    ref.update_partials(ops)
    part.update_partials([Operation(*o) for o in ops])
    return ref, part, ops, pidx


@pytest.mark.parametrize("states,rate_cats", [(4, 4), (20, 2)])
def test_random_tree_root_and_edge(states, rate_cats):
    ref, part, ops, pidx = build_random_scenario(
        12, 37, states, rate_cats, seed=1)
    root = ops[-1][0]
    root_sc = ops[-1][1]
    lk_ref, per_ref = ref.root_loglikelihood(root, root_sc, pidx,
                                             persite=True)
    lk, per = part.compute_root_loglikelihood(root, root_sc, pidx,
                                              persite=True)
    np.testing.assert_allclose(lk, lk_ref, rtol=1e-10)
    np.testing.assert_allclose(per, per_ref, rtol=1e-9, atol=1e-12)

    # edge between root and its first child (an inner node)
    c1, m1, s1 = ops[-1][2], ops[-1][3], ops[-1][4]
    elk_ref = ref.edge_loglikelihood(root, root_sc, c1, s1, m1, pidx)
    elk = part.compute_edge_loglikelihood(root, root_sc, c1, s1, m1, pidx)
    np.testing.assert_allclose(elk, elk_ref, rtol=1e-10)
    ref.destroy()


def test_scaling_long_tree_per_site():
    """Force scaler activity on a 60-taxon chain with long branches."""
    ref, part, ops, pidx = build_random_scenario(
        220, 23, 4, 4, seed=2, long_branches=True)
    root, root_sc = ops[-1][0], ops[-1][1]
    scal_ref = ref.get_scaler(root_sc)
    scal = part.get_scaler(root_sc)
    assert scal_ref.sum() > 0, "scenario failed to trigger scaling"
    np.testing.assert_array_equal(scal, scal_ref)
    lk_ref = ref.root_loglikelihood(root, root_sc, pidx)
    lk = part.compute_root_loglikelihood(root, root_sc, pidx)
    np.testing.assert_allclose(lk, lk_ref, rtol=1e-10)
    ref.destroy()


def test_scaling_per_rate():
    ref, part, ops, pidx = build_random_scenario(
        220, 23, 4, 4, seed=3, long_branches=True,
        attrs=oracle.ATTRIB_RATE_SCALERS)
    root, root_sc = ops[-1][0], ops[-1][1]
    scal_ref = ref.get_scaler(root_sc).reshape(23, 4).T  # ref: [site, rate]
    scal = part.get_scaler(root_sc)
    assert scal_ref.sum() > 0
    np.testing.assert_array_equal(scal, scal_ref)
    # edge logL exercises the capped per-rate undo
    c1, m1, s1 = ops[-1][2], ops[-1][3], ops[-1][4]
    elk_ref = ref.edge_loglikelihood(root, root_sc, c1, s1, m1, pidx)
    elk = part.compute_edge_loglikelihood(root, root_sc, c1, s1, m1, pidx)
    np.testing.assert_allclose(elk, elk_ref, rtol=1e-10)
    ref.destroy()


def test_invariant_sites_and_pinv():
    # guarantee some invariant columns
    rng = np.random.default_rng(7)
    ref, part, ops, pidx = build_random_scenario(8, 40, 4, 4, seed=4,
                                                 pinv=0.25)
    assert part.count_invariant_sites() > 0
    np.testing.assert_array_equal(
        part.invariant[:40],
        np.ctypeslib.as_array(ref.p.invariant, shape=(40,)))
    root, root_sc = ops[-1][0], ops[-1][1]
    lk_ref, per_ref = ref.root_loglikelihood(root, root_sc, pidx,
                                             persite=True)
    lk, per = part.compute_root_loglikelihood(root, root_sc, pidx,
                                              persite=True)
    np.testing.assert_allclose(per, per_ref, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(lk, lk_ref, rtol=1e-10)
    ref.destroy()


def test_pattern_weights():
    w = np.arange(1, 38)
    ref, part, ops, pidx = build_random_scenario(6, 37, 4, 4, seed=5,
                                                 weights=w)
    root, root_sc = ops[-1][0], ops[-1][1]
    lk_ref = ref.root_loglikelihood(root, root_sc, pidx)
    lk = part.compute_root_loglikelihood(root, root_sc, pidx)
    np.testing.assert_allclose(lk, lk_ref, rtol=1e-10)
    ref.destroy()


def test_sites_padding_invariance():
    """Padded site columns must not change any result."""
    _, part_a, ops, pidx = build_random_scenario(10, 33, 4, 4, seed=6)
    ref, part_b, _, _ = build_random_scenario(10, 33, 4, 4, seed=6,
                                              sites_alignment=128)
    root, root_sc = ops[-1][0], ops[-1][1]
    lk_ref = ref.root_loglikelihood(root, root_sc, pidx)
    for p in (part_a, part_b):
        np.testing.assert_allclose(
            p.compute_root_loglikelihood(root, root_sc, pidx),
            lk_ref, rtol=1e-10)
    ref.destroy()


# --------------------------------------------------------------- eigen decomp
def test_eigen_reconstructs_rate_matrix():
    states = 20
    freqs = RNG.dirichlet(np.ones(states))
    params = RNG.uniform(0.05, 4.0, size=states * (states - 1) // 2)
    es = ops_eigen.update_eigen(params, freqs)
    s = ops_eigen.build_rate_matrix_sym(params, freqs)
    # Q = sqrtPi^-1 S sqrtPi ; P'(0) = Q = inv_evecs diag(lambda) evecs
    q = np.diag(freqs ** -0.5) @ s @ np.diag(freqs ** 0.5)
    recon = es.inv_evecs @ np.diag(es.eigenvals) @ es.evecs
    np.testing.assert_allclose(recon, q, rtol=1e-8, atol=1e-10)


def test_alpha_cats_logl_sweep():
    """alpha-cats.c analog (/root/reference/test/src/alpha-cats.c): full
    logL agreement across a grid of Gamma shapes x category counts x
    discretization modes on one fixed 5-taxon scenario."""
    rng = np.random.default_rng(11)
    n_tips, n_sites = 5, 20
    seqs = [random_seq(n_sites, alphabet=NT, rng=rng)
            for _ in range(n_tips)]
    freqs = [0.3, 0.25, 0.2, 0.25]
    subst = [1.0, 2.5, 1.0, 1.0, 2.5, 1.0]     # HKY-style titv=2.5
    n_inner, n_edges = n_tips - 1, 2 * (n_tips - 1)
    brlens = rng.uniform(0.05, 0.5, size=n_edges)
    ops = []
    for k in range(n_inner):
        parent = n_tips + k
        c1 = n_tips + k - 1 if k > 0 else 0
        ops.append((parent, k, c1, 2 * k, (k - 1) if k > 0 else -1,
                    k + 1, 2 * k + 1, -1))

    for cats in (1, 2, 4, 16):
        pidx = [0] * cats
        for alpha in (0.1, 0.75, 1.0, 100.0):
            for mode in (C.GAMMA_RATES_MEAN, C.GAMMA_RATES_MEDIAN):
                rates = compute_gamma_cats(alpha, cats, mode)
                ref = oracle.OraclePartition(n_tips, n_inner, 4, n_sites,
                                             1, n_edges, cats, n_inner)
                part = Partition(n_tips, n_inner, 4, n_sites, 1, n_edges,
                                 cats, n_inner)
                for i, s in enumerate(seqs):
                    ref.set_tip_states(i, "nt", s)
                    part.set_tip_states(i, maps.map_nt, s)
                for impl in (ref, part):
                    impl.set_frequencies(0, freqs)
                    impl.set_subst_params(0, subst)
                    impl.set_category_rates(rates)
                    impl.update_prob_matrices(pidx, list(range(n_edges)),
                                              brlens)
                ref.update_partials(ops)
                part.update_partials([Operation(*o) for o in ops])
                root, root_sc = ops[-1][0], ops[-1][1]
                lk_ref = ref.root_loglikelihood(root, root_sc, pidx)
                lk = part.compute_root_loglikelihood(root, root_sc, pidx)
                np.testing.assert_allclose(lk, lk_ref, rtol=1e-10,
                                           err_msg=f"alpha={alpha} "
                                           f"cats={cats} mode={mode}")
                ref.destroy()


def test_set_tip_states_batch_matches_per_tip():
    """set_tip_states_batch is bit-identical to per-tip installs (it
    exists because one eager device update per tip costs seconds of
    dispatch overhead at 1000 taxa)."""
    from libpll2_jax.trees import random_utree
    from libpll2_jax.utils import simulate_alignment

    tree = random_utree([f"t{i}" for i in range(12)], seed=3)
    h, s = simulate_alignment(tree, 200, [0.25] * 4, [1, 2, 1, 1, 2, 1],
                              alpha=0.9, seed=3)
    by = dict(zip(h, s))

    def mk():
        return Partition(tree.tip_count, tree.inner_count, 4, 200, 1,
                         tree.edge_count, 4, tree.inner_count)

    p1, p2 = mk(), mk()
    for t in tree.tips():
        p1.set_tip_states(t.clv_index, maps.map_nt, by[t.label])
    p2.set_tip_states_batch(maps.map_nt,
                            [by[t.label] for t in tree.tips()],
                            tip_indices=[t.clv_index
                                         for t in tree.tips()])
    np.testing.assert_array_equal(np.asarray(p1.clv), np.asarray(p2.clv))
    np.testing.assert_array_equal(p1.tip_states, p2.tip_states)
    assert np.all(p2._tips_set[:tree.tip_count])


def test_set_tip_states_batch_length_mismatch_raises():
    tree_n = 6
    part = Partition(tree_n, tree_n - 2, 4, 64, 1, 2 * tree_n - 3, 4,
                     tree_n - 2)
    with pytest.raises(C.PllError):
        part.set_tip_states_batch(maps.map_nt, ["A" * 64] * 4,
                                  tip_indices=[0, 1])
