"""Regression tests for the round-2 review findings:

  * bootstrap replicate logLs are computed host-side in float64;
  * the fused kernel reads only the P-matrix rows its op table names, so
    a large P-matrix table (many edges or edge classes) changes nothing;
  * make_loglikelihood_fn rejects a subst_template with an empty class
    (previously a silent NaN warm start).
"""
import numpy as np
import pytest

from libpll2_jax import Partition, TreeEngine, compute_gamma_cats
from libpll2_jax import constants as C
from libpll2_jax.bootstrap import bootstrap_loglikelihoods
from libpll2_jax.io import maps
from libpll2_jax.optimize import make_loglikelihood_fn
from libpll2_jax.trees import random_utree
from libpll2_jax.utils.simulate import simulate_alignment

FREQS = [0.3, 0.25, 0.2, 0.25]
SUBST = [1.2, 3.0, 0.8, 1.1, 2.6, 1.0]


def _setup(n_taxa=10, n_sites=256, prob_matrices_factor=1):
    tree = random_utree([f"t{i}" for i in range(n_taxa)], seed=11)
    headers, seqs = simulate_alignment(tree, n_sites, FREQS, SUBST,
                                       alpha=0.9, seed=11)
    part = Partition(tree.tip_count, tree.inner_count, 4, n_sites, 1,
                     tree.edge_count * prob_matrices_factor, 4,
                     tree.inner_count)
    by_label = dict(zip(headers, seqs))
    for tip in tree.tips():
        part.set_tip_states(tip.clv_index, maps.map_nt, by_label[tip.label])
    part.set_frequencies(0, FREQS)
    part.set_subst_params(0, SUBST)
    part.set_category_rates(compute_gamma_cats(0.9, 4))
    return tree, part


def test_bootstrap_logls_are_float64_host_sums():
    tree, part = _setup()
    eng = TreeEngine(part, tree, pallas=False)
    logls, W = bootstrap_loglikelihoods(eng, 16, seed=3)
    _, per = eng.loglikelihood_persite()
    expect = W @ np.asarray(per[:part.sites], np.float64)
    # exact float64 host matmul: identical to the explicit reduction
    np.testing.assert_allclose(logls, expect, rtol=0, atol=1e-9)
    assert logls.dtype == np.float64


def test_fused_kernel_large_pmatrix_table():
    from libpll2_jax.ops import pallas_fused as pf
    # a P-matrix table far larger than the tree needs (identity rows
    # beyond the real edges): the kernel must produce the same root rows
    # bit for bit as with the exact-size table
    n_sites = 256
    tree, part = _setup(n_taxa=8, n_sites=n_sites, prob_matrices_factor=1)
    from libpll2_jax.trees import create_operations, traverse
    ops, branches, pmat_idx = create_operations(traverse(tree.vroot))
    table, n_slots = pf.pack_fused_schedule(
        ops, part.tips, (tree.vroot.clv_index, tree.vroot.back.clv_index))
    assert table is not None
    part.update_prob_matrices([0] * 4, list(pmat_idx), list(branches))
    big_e = 4096
    pm_small = np.asarray(part.pmatrix, np.float32)
    pm_big = np.zeros((big_e, 4, 4, 4), np.float32)
    pm_big[:pm_small.shape[0]] = pm_small
    pm_big[pm_small.shape[0]:] = np.eye(4, dtype=np.float32)
    codes = pf.tip_code_matrix(part)
    import jax.numpy as jnp
    kw = dict(rates=4, states=4, n_slots=n_slots,
              threshold=2.0 ** -32, factor=2.0 ** 32, interpret=True)
    out_big = pf.fused_traversal(jnp.asarray(codes), jnp.asarray(pm_big),
                                 jnp.asarray(table), **kw)
    out_small = pf.fused_traversal(jnp.asarray(codes),
                                   jnp.asarray(pm_small),
                                   jnp.asarray(table), **kw)
    for a, b in zip(out_big, out_small):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_subst_template_missing_class_raises():
    tree, part = _setup()
    eng = TreeEngine(part, tree, pallas=False)
    # class 0 never used: previously a NaN warm start
    with pytest.raises(C.PllError):
        make_loglikelihood_fn(eng, optimize=("subst",),
                              subst_template=[1, 1, 1, 2, 2, 2])
    # a middle class missing must raise too
    with pytest.raises(C.PllError):
        make_loglikelihood_fn(eng, optimize=("subst",),
                              subst_template=[0, 0, 0, 2, 2, 2])
