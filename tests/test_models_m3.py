"""M3 validation: empirical AA models (all 20) and LG4M/LG4X per-category
mixture matrices, logL checked against the reference oracle (the reference's
test/src/protein-models.c and examples/lg4 scenarios)."""
import ctypes as ct

import numpy as np
import pytest

import oracle
from libpll2_jax import Partition, TreeEngine, compute_gamma_cats
from libpll2_jax.io import load_fasta, maps
from libpll2_jax.models import (AA_MODEL_NAMES, aa_model, load_aa_model,
                                load_mixture_model, mixture_model)
from libpll2_jax.trees import create_operations, parse_newick, traverse

pytestmark = pytest.mark.skipif(not oracle.available(),
                                reason="reference not available")

LG4_FAS = "/root/reference/examples/lg4/data/example.fas"
LG4_TREE = "/root/reference/examples/lg4/data/example.tree"


def test_model_tables_match_reference_exactly():
    lib = oracle.load()
    for name in AA_MODEL_NAMES:
        rates, freqs = aa_model(name)
        ref_r = np.array((ct.c_double * 190).in_dll(lib,
                                                    f"pll_aa_rates_{name}"))
        ref_f = np.array((ct.c_double * 20).in_dll(lib,
                                                   f"pll_aa_freqs_{name}"))
        np.testing.assert_array_equal(rates, ref_r, err_msg=name)
        np.testing.assert_array_equal(freqs, ref_f, err_msg=name)
    for name in ("lg4m", "lg4x"):
        rates, freqs = mixture_model(name)
        ref_r = np.array((ct.c_double * 760).in_dll(
            lib, f"pll_aa_rates_{name}")).reshape(4, 190)
        ref_f = np.array((ct.c_double * 80).in_dll(
            lib, f"pll_aa_freqs_{name}")).reshape(4, 20)
        np.testing.assert_array_equal(rates, ref_r, err_msg=name)
        np.testing.assert_array_equal(freqs, ref_f, err_msg=name)


def _setup(n_matrices):
    headers, seqs = load_fasta(LG4_FAS)
    tree = parse_newick(open(LG4_TREE).read())
    by_label = dict(zip(headers, seqs))
    n_tips, n_inner = tree.tip_count, tree.inner_count
    sites = len(seqs[0])
    ref = oracle.OraclePartition(n_tips, n_inner, 20, sites, n_matrices,
                                 tree.edge_count, 4, n_inner)
    part = Partition(n_tips, n_inner, 20, sites, n_matrices,
                     tree.edge_count, 4, n_inner)
    for tip in tree.tips():
        ref.set_tip_states(tip.clv_index, "aa", by_label[tip.label])
        part.set_tip_states(tip.clv_index, maps.map_aa, by_label[tip.label])
    return ref, part, tree


def _both_logl(ref, part, tree, pidx):
    trav = traverse(tree.vroot)
    ops, branches, pmat_idx = create_operations(trav)
    ref.update_prob_matrices(pidx, pmat_idx, branches)
    part.update_prob_matrices(pidx, pmat_idx, branches)
    ref.update_partials([(o.parent_clv_index, o.parent_scaler_index,
                          o.child1_clv_index, o.child1_matrix_index,
                          o.child1_scaler_index, o.child2_clv_index,
                          o.child2_matrix_index, o.child2_scaler_index)
                         for o in ops])
    part.update_partials(ops)
    root = tree.vroot
    args = (root.clv_index, root.scaler_index, root.back.clv_index,
            root.back.scaler_index, root.pmatrix_index, pidx)
    return ref.edge_loglikelihood(*args), part.compute_edge_loglikelihood(*args)


@pytest.mark.parametrize("name", AA_MODEL_NAMES)
def test_empirical_model_logl(name):
    ref, part, tree = _setup(1)
    rates, freqs = aa_model(name)
    ref.set_subst_params(0, rates)
    ref.set_frequencies(0, freqs)
    load_aa_model(part, name)
    gam = compute_gamma_cats(1.0, 4)
    ref.set_category_rates(gam)
    part.set_category_rates(gam)
    lk_ref, lk = _both_logl(ref, part, tree, [0] * 4)
    np.testing.assert_allclose(lk, lk_ref, rtol=1e-10, err_msg=name)
    ref.destroy()


@pytest.mark.parametrize("name", ["lg4m", "lg4x"])
def test_mixture_model_logl(name):
    """Per-category rate matrices: params_indices = [0,1,2,3]
    (examples/lg4/lg4.c:298-360)."""
    ref, part, tree = _setup(4)
    rates, freqs = mixture_model(name)
    for k in range(4):
        ref.set_subst_params(k, rates[k])
        ref.set_frequencies(k, freqs[k])
    load_mixture_model(part, name)
    gam = compute_gamma_cats(0.9, 4)
    ref.set_category_rates(gam)
    part.set_category_rates(gam)
    lk_ref, lk = _both_logl(ref, part, tree, [0, 1, 2, 3])
    np.testing.assert_allclose(lk, lk_ref, rtol=1e-10, err_msg=name)
    ref.destroy()
