"""M3 validation: ascertainment-bias corrections (Lewis / Felsenstein /
Stamatakis) for logL and branch-length derivatives, vs the reference oracle
(scenario of test/src/asc-bias.c: each correction type on the same
partition, derivatives over a range of branch lengths)."""
import numpy as np
import pytest

import oracle
from libpll2_jax import Partition, compute_gamma_cats
from libpll2_jax import constants as C
from libpll2_jax.io import maps
from libpll2_jax.trees import (create_operations, random_alignment,
                               random_utree, traverse)

pytestmark = pytest.mark.skipif(not oracle.available(),
                                reason="reference not available")

N_TAXA = 40
N_SITES = 200
FREQS = [0.1, 0.2, 0.3, 0.4]
SUBST = [1, 5, 1, 1, 5, 1]
INVAR_WEIGHTS = [50, 40, 60, 20]
BRANCH_LENGTHS = [0.0001, 0.001, 0.01, 0.1, 1.0, 10.0, 100.0]


@pytest.fixture(scope="module")
def setup():
    headers, seqs = random_alignment(N_TAXA, N_SITES, seed=3)
    tree = random_utree(headers, seed=3)
    by_label = dict(zip(headers, seqs))
    rates = compute_gamma_cats(0.75, 4)

    ref = oracle.OraclePartition(
        tree.tip_count, tree.inner_count, 4, N_SITES, 1, tree.edge_count,
        4, tree.inner_count, attributes=oracle.ATTRIB_AB_FLAG)
    part = Partition(tree.tip_count, tree.inner_count, 4, N_SITES, 1,
                     tree.edge_count, 4, tree.inner_count,
                     asc_bias=C.AscBias.LEWIS)
    part.set_asc_bias_type(C.AscBias.NONE)
    for tip in tree.tips():
        ref.set_tip_states(tip.clv_index, "nt", by_label[tip.label])
        part.set_tip_states(tip.clv_index, maps.map_nt, by_label[tip.label])
    for impl in (ref, part):
        impl.set_frequencies(0, FREQS)
        impl.set_subst_params(0, SUBST)
        impl.set_category_rates(rates)

    trav = traverse(tree.vroot)
    ops, branches, pmat_idx = create_operations(trav)
    pidx = [0] * 4
    ref.update_prob_matrices(pidx, pmat_idx, branches)
    part.update_prob_matrices(pidx, pmat_idx, branches)
    ref.update_partials([(o.parent_clv_index, o.parent_scaler_index,
                          o.child1_clv_index, o.child1_matrix_index,
                          o.child1_scaler_index, o.child2_clv_index,
                          o.child2_matrix_index, o.child2_scaler_index)
                         for o in ops])
    part.update_partials(ops)
    yield ref, part, tree, pidx
    ref.destroy()


CASES = [
    (C.AscBias.NONE, 0, False),
    (C.AscBias.LEWIS, oracle.ATTRIB_AB_LEWIS, False),
    (C.AscBias.FELSENSTEIN, oracle.ATTRIB_AB_FELSENSTEIN, True),
    (C.AscBias.STAMATAKIS, oracle.ATTRIB_AB_STAMATAKIS, True),
]


@pytest.mark.parametrize("asc,ref_attr,needs_weights", CASES,
                         ids=[c[0].name for c in CASES])
def test_asc_bias_logl(setup, asc, ref_attr, needs_weights):
    ref, part, tree, pidx = setup
    ref.set_asc_bias_type(ref_attr)
    part.set_asc_bias_type(asc)
    if needs_weights:
        ref.set_asc_state_weights(INVAR_WEIGHTS)
        part.set_asc_state_weights(INVAR_WEIGHTS)
    root = tree.vroot
    args = (root.clv_index, root.scaler_index, root.back.clv_index,
            root.back.scaler_index, root.pmatrix_index, pidx)
    lk_ref = ref.edge_loglikelihood(*args)
    lk = part.compute_edge_loglikelihood(*args)
    np.testing.assert_allclose(lk, lk_ref, rtol=1e-10)


@pytest.mark.parametrize("asc,ref_attr,needs_weights", CASES,
                         ids=[c[0].name for c in CASES])
def test_asc_bias_derivatives(setup, asc, ref_attr, needs_weights):
    ref, part, tree, pidx = setup
    ref.set_asc_bias_type(ref_attr)
    part.set_asc_bias_type(asc)
    if needs_weights:
        ref.set_asc_state_weights(INVAR_WEIGHTS)
        part.set_asc_state_weights(INVAR_WEIGHTS)
    root = tree.vroot
    p, c = root.clv_index, root.back.clv_index
    psc, csc = root.scaler_index, root.back.scaler_index

    ref_d = ref.derivatives(p, c, psc, csc, pidx, BRANCH_LENGTHS)
    sumtable = part.update_sumtable(p, c, psc, csc, pidx)
    for blen, (rd1, rd2) in zip(BRANCH_LENGTHS, ref_d):
        d1, d2 = part.compute_likelihood_derivatives(
            sumtable, pidx, blen,
            parent_scaler_index=psc, child_scaler_index=csc)
        np.testing.assert_allclose(
            [d1, d2], [rd1, rd2], rtol=1e-8, atol=1e-10,
            err_msg=f"asc={asc.name} t={blen}")


@pytest.mark.parametrize("asc,ref_attr,needs_weights", CASES[1:],
                         ids=[c[0].name for c in CASES[1:]])
def test_asc_bias_through_fused_engine(asc, ref_attr, needs_weights):
    """The fused TreeEngine must apply the same corrections as the
    step-by-step Partition path (logL and Newton derivatives)."""
    from libpll2_jax import TreeEngine
    from libpll2_jax.trees import random_utree

    headers, seqs = random_alignment(20, 150, seed=5)
    tree = random_utree(headers, seed=5)
    by = dict(zip(headers, seqs))
    rates = compute_gamma_cats(0.75, 4)

    def build():
        part = Partition(tree.tip_count, tree.inner_count, 4, 150, 1,
                         tree.edge_count, 4, tree.inner_count,
                         asc_bias=asc)
        for tip in tree.tips():
            part.set_tip_states(tip.clv_index, maps.map_nt, by[tip.label])
        part.set_frequencies(0, FREQS)
        part.set_subst_params(0, SUBST)
        part.set_category_rates(rates)
        if needs_weights:
            part.set_asc_state_weights(INVAR_WEIGHTS)
        return part

    # partition path
    part = build()
    trav = traverse(tree.vroot)
    ops, branches, pmat_idx = create_operations(trav)
    pidx = [0] * 4
    part.update_prob_matrices(pidx, pmat_idx, branches)
    part.update_partials(ops)
    root = tree.vroot
    lk_ref = part.compute_edge_loglikelihood(
        root.clv_index, root.scaler_index, root.back.clv_index,
        root.back.scaler_index, root.pmatrix_index, pidx)
    st = part.update_sumtable(root.clv_index, root.back.clv_index,
                              root.scaler_index, root.back.scaler_index,
                              pidx)
    blen0 = branches[pmat_idx.index(root.pmatrix_index)]
    d1_ref, d2_ref = part.compute_likelihood_derivatives(
        st, pidx, blen0, parent_scaler_index=root.scaler_index,
        child_scaler_index=root.back.scaler_index)

    # fused engine path
    eng = TreeEngine(build(), tree)
    np.testing.assert_allclose(eng.loglikelihood(), lk_ref, rtol=1e-10)
    lk_e, d1_e, d2_e = eng.newton_step()
    np.testing.assert_allclose([d1_e, d2_e], [d1_ref, d2_ref], rtol=1e-8)


def test_asc_incompatible_with_pinv(setup):
    _, part, _, _ = setup
    part.set_asc_bias_type(C.AscBias.NONE)
    part.prop_invar[0] = 0.2
    with pytest.raises(C.PllError):
        part.set_asc_bias_type(C.AscBias.LEWIS)
    part.prop_invar[0] = 0.0


def test_stamatakis_with_scaled_synthetic_columns():
    """Deep caterpillar forces CLV scaling on the synthetic all-state-k
    columns; the reference adds the scaler-undo term UNWEIGHTED there
    (likelihood.c:95-101) — must match with state weights > 1."""
    from libpll2_jax.trees import parse_newick
    # long branches: the synthetic invariant columns decay only ~P[k,k]
    # per level, so they need t large enough to underflow 2^-256
    # scaling needs ALL rate categories below threshold, so use a large
    # alpha (rates ~1) — with default Gamma the slowest category never
    # underflows on invariant columns
    n = 150
    text = f"t{n-1}:3.0"
    for i in range(n - 2, 1, -1):
        text = f"(t{i}:3.0,{text}):3.0"
    tree = parse_newick(f"(t0:3.0,t1:3.0,{text});")
    headers, seqs = (
        [f"t{i}" for i in range(n)],
        random_alignment(n, 80, seed=17)[1])
    by = dict(zip(headers, seqs))
    rates = compute_gamma_cats(50.0, 4)

    ref = oracle.OraclePartition(n, n - 2, 4, 80, 1, tree.edge_count, 4,
                                 n - 2, attributes=oracle.ATTRIB_AB_FLAG)
    part = Partition(n, n - 2, 4, 80, 1, tree.edge_count, 4, n - 2,
                     asc_bias=C.AscBias.STAMATAKIS)
    for tip in tree.tips():
        ref.set_tip_states(tip.clv_index, "nt", by[tip.label])
        part.set_tip_states(tip.clv_index, maps.map_nt, by[tip.label])
    for impl in (ref, part):
        impl.set_frequencies(0, FREQS)
        impl.set_subst_params(0, SUBST)
        impl.set_category_rates(rates)
    ref.set_asc_bias_type(oracle.ATTRIB_AB_STAMATAKIS)
    ref.set_asc_state_weights(INVAR_WEIGHTS)
    part.set_asc_state_weights(INVAR_WEIGHTS)

    trav = traverse(tree.vroot)
    ops, branches, pmat_idx = create_operations(trav)
    pidx = [0] * 4
    ref.update_prob_matrices(pidx, pmat_idx, branches)
    part.update_prob_matrices(pidx, pmat_idx, branches)
    ref.update_partials([(o.parent_clv_index, o.parent_scaler_index,
                          o.child1_clv_index, o.child1_matrix_index,
                          o.child1_scaler_index, o.child2_clv_index,
                          o.child2_matrix_index, o.child2_scaler_index)
                         for o in ops])
    part.update_partials(ops)
    # scaling must actually hit the synthetic columns
    root = tree.vroot
    sc = part.get_scaler(root.scaler_index)
    assert np.asarray(part.scale_buffer[root.scaler_index])[80:84].sum() > 0
    args = (root.clv_index, root.scaler_index, root.back.clv_index,
            root.back.scaler_index, root.pmatrix_index, pidx)
    np.testing.assert_allclose(part.compute_edge_loglikelihood(*args),
                               ref.edge_loglikelihood(*args), rtol=1e-10)
    ref.destroy()


def test_rng_high_bit_seeds_match_reference():
    """Seeds >= 2^31 exercise glibc's signed truncating division."""
    import ctypes as ct
    from libpll2_jax.utils.rng import GlibcRandom
    lib = oracle.load()
    lib.pll_random_create.restype = ct.c_void_p
    lib.pll_random_create.argtypes = [ct.c_uint]
    lib.pll_random_getint.restype = ct.c_int
    lib.pll_random_getint.argtypes = [ct.c_void_p, ct.c_int]
    for seed in (3000000000, 2 ** 32 - 1, 2 ** 31):
        st = lib.pll_random_create(seed)
        ours = GlibcRandom(seed)
        assert [lib.pll_random_getint(st, 10 ** 6) for _ in range(32)] == \
            [ours.getint(10 ** 6) for _ in range(32)], seed


def test_asc_requires_alloc():
    part = Partition(4, 3, 4, 20, 1, 6, 4, 3)
    with pytest.raises(C.PllError):
        part.set_asc_bias_type(C.AscBias.LEWIS)
