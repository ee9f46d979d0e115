"""Bootstrap logL linearity: W @ lnl must equal a full re-evaluation with
the replicate's pattern weights (the consumers' per-replicate pipeline),
for plain and Lewis-asc engines, plain and site-repeats storage."""
import numpy as np
import pytest

from libpll2_jax import Partition, TreeEngine, compute_gamma_cats
from libpll2_jax import constants as C
from libpll2_jax.bootstrap import bootstrap_loglikelihoods
from libpll2_jax.io import maps
from libpll2_jax.trees import random_utree
from libpll2_jax.utils import simulate_alignment

N_TAXA, N_SITES = 16, 384


def _build(tree, by, asc=None, repeats=False):
    kw = {}
    if asc is not None:
        kw["asc_bias"] = asc
    if repeats:
        kw["site_repeats"] = True
    part = Partition(tree.tip_count, tree.inner_count, 4, N_SITES, 1,
                     tree.edge_count, 4, tree.inner_count, **kw)
    for t in tree.tips():
        part.set_tip_states(t.clv_index, maps.map_nt, by[t.label])
    part.set_frequencies(0, [0.3, 0.2, 0.2, 0.3])
    part.set_subst_params(0, [1, 2.2, 0.8, 1.1, 2.6, 1])
    part.set_category_rates(compute_gamma_cats(0.9, 4))
    if asc is not None:
        part.set_asc_state_weights([3, 2, 2, 3])
    return part


@pytest.fixture(scope="module")
def data():
    tree = random_utree([f"t{i}" for i in range(N_TAXA)], seed=55)
    headers, seqs = simulate_alignment(tree, N_SITES, [0.3, 0.2, 0.2, 0.3],
                                       [1, 2.2, 0.8, 1.1, 2.6, 1],
                                       alpha=0.9, seed=55)
    return tree, dict(zip(headers, seqs))


@pytest.mark.parametrize("asc", [None, C.AscBias.LEWIS])
def test_bootstrap_matches_reweighted_eval(data, asc):
    tree, by = data
    eng = TreeEngine(_build(tree, by, asc=asc), tree, pallas=False)
    logls, W = bootstrap_loglikelihoods(eng, 5, seed=3)
    assert W.shape == (5, N_SITES)
    assert np.allclose(W.sum(axis=1), N_SITES)
    for r in range(5):
        part_r = _build(tree, by, asc=asc)
        part_r.set_pattern_weights(W[r].astype(np.int64))
        lk_r = TreeEngine(part_r, tree, pallas=False).loglikelihood()
        np.testing.assert_allclose(logls[r], lk_r, rtol=1e-9)


def test_bootstrap_with_site_repeats(data):
    tree, by = data
    eng = TreeEngine(_build(tree, by, repeats=True), tree)
    assert eng.repeats_mode
    logls, W = bootstrap_loglikelihoods(eng, 3, seed=7)
    for r in range(3):
        part_r = _build(tree, by)
        part_r.set_pattern_weights(W[r].astype(np.int64))
        lk_r = TreeEngine(part_r, tree, pallas=False).loglikelihood()
        np.testing.assert_allclose(logls[r], lk_r, rtol=1e-9)


def test_bootstrap_rejects_nonlinear_asc(data):
    tree, by = data
    eng = TreeEngine(_build(tree, by, asc=C.AscBias.FELSENSTEIN), tree,
                     pallas=False)
    with pytest.raises(C.PllError):
        bootstrap_loglikelihoods(eng, 2)
