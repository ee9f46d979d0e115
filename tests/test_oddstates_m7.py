"""Odd/unusual alphabets vs the oracle: 5-state (the reference's odd5_map
padding stress), binary, and 10-state genotype models — logL and
derivatives. (reference: test/src/derivatives-oddstates.c, common.c odd5)"""
import ctypes as ct

import numpy as np
import pytest

import oracle
from libpll2_jax import Partition, compute_gamma_cats
from libpll2_jax.io import maps
from libpll2_jax.trees import create_operations, random_utree, traverse

pytestmark = pytest.mark.skipif(not oracle.available(),
                                reason="reference not available")

# the reference's odd5 map: states 0-4 <- chars A,C,G,T,X; '-' = all
ODD5 = np.zeros(256, dtype=np.uint64)
for i, ch in enumerate("ACGTX"):
    ODD5[ord(ch)] = ODD5[ord(ch.lower())] = 1 << i
ODD5[ord('-')] = 31

N_TAXA, N_SITES = 10, 120


def _random_seqs(alphabet, seed):
    rng = np.random.default_rng(seed)
    chars = np.array(list(alphabet))
    return ["".join(chars[rng.integers(0, len(chars), N_SITES)])
            for _ in range(N_TAXA)]


def _oracle_map(table):
    arr = (ct.c_ulonglong * 256)(*[int(v) for v in table])
    return arr


@pytest.mark.parametrize("states,alphabet,table", [
    (5, "ACGTX", ODD5),
    (2, "01", maps.map_bin),
    (10, "ACGTMRWSYK", maps.map_gt10),
], ids=["odd5", "binary", "gt10"])
def test_odd_alphabet_logl_and_derivatives(states, alphabet, table):
    tree = random_utree([f"t{i}" for i in range(N_TAXA)], seed=71)
    seqs = _random_seqs(alphabet, seed=71)
    rng = np.random.default_rng(71)
    freqs = rng.dirichlet(np.ones(states) * 10)
    subst = rng.uniform(0.5, 2.0, size=states * (states - 1) // 2)
    rates = compute_gamma_cats(0.8, 4)

    ref = oracle.OraclePartition(N_TAXA, N_TAXA - 2, states, N_SITES, 1,
                                 tree.edge_count, 4, N_TAXA - 2)
    part = Partition(N_TAXA, N_TAXA - 2, states, N_SITES, 1,
                     tree.edge_count, 4, N_TAXA - 2)
    lib = oracle.load()
    omap = _oracle_map(table)
    for i, (tip, seq) in enumerate(zip(tree.tips(), seqs)):
        r = lib.pll_set_tip_states(ref.ptr, tip.clv_index, omap,
                                   seq.encode())
        assert r == 1
        part.set_tip_states(tip.clv_index, table, seq)
    for impl in (ref, part):
        impl.set_frequencies(0, freqs)
        impl.set_subst_params(0, subst)
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
    root = tree.vroot
    args = (root.clv_index, root.scaler_index, root.back.clv_index,
            root.back.scaler_index, root.pmatrix_index, pidx)
    np.testing.assert_allclose(part.compute_edge_loglikelihood(*args),
                               ref.edge_loglikelihood(*args), rtol=1e-10)

    # derivatives at several lengths (derivatives-oddstates.c)
    ref_d = ref.derivatives(root.clv_index, root.back.clv_index,
                            root.scaler_index, root.back.scaler_index,
                            pidx, [0.01, 0.1, 1.0])
    st = part.update_sumtable(root.clv_index, root.back.clv_index,
                              root.scaler_index, root.back.scaler_index,
                              pidx)
    for blen, (rd1, rd2) in zip([0.01, 0.1, 1.0], ref_d):
        d1, d2 = part.compute_likelihood_derivatives(st, pidx, blen)
        np.testing.assert_allclose([d1, d2], [rd1, rd2], rtol=1e-8,
                                   atol=1e-10)
    ref.destroy()
