"""Reference stress scenarios ported into the validation matrix:

  * scaling.c — a 2000-taxon tree at extreme Gamma shapes across
    DNA / AA / odd-5 alphabets, per-site vs per-rate scalers, logL +
    derivatives parity vs the oracle
    (reference: /root/reference/test/src/scaling.c:22-80);
  * partial-traversal.c — branch change -> callback-pruned partial
    traversal recomputes only invalidated CLVs
    (reference: /root/reference/test/src/partial-traversal.c);
  * rooted-tipinner.c — rooted evaluation where a root child is a tip
    (reference: /root/reference/test/src/rooted-tipinner.c).
"""
import ctypes as ct

import numpy as np
import pytest

import oracle
from libpll2_jax import Partition, compute_gamma_cats
from libpll2_jax.io import maps
from libpll2_jax.models import aa_data
from libpll2_jax.trees import (create_operations, parse_newick_rooted,
                               random_utree, rtree, traverse)

pytestmark = pytest.mark.skipif(not oracle.available(),
                                reason="reference not available")

N_SITES = 17                     # scaling.c N_SITES
N_TAXA_BIG = 2000                # scaling.c 2000.tree scale

# scaling.c alphabets + models
NT_ALPHABET = "ACGT-"
AA_ALPHABET = "GALMFWKQESPVICYHRNDT-"
ODD_ALPHABET = "ABCDE-"
NT_FREQS = [0.4, 0.4, 0.1, 0.1]
NT_SUBST = [0.1, 10., 10., 0.1, 0.1, 1]
ODD_FREQS = [0.3, 0.25, 0.1, 0.2, 0.15]
ODD_SUBST = [1.452176, 0.937951, 0.462880, 0.617729, 1.745312,
             0.937951, 0.462880, 0.617729, 1.745312, 1.000000]

ODD5 = np.zeros(256, dtype=np.uint64)
for _i, _ch in enumerate("ABCDE"):
    ODD5[ord(_ch)] = ODD5[ord(_ch.lower())] = 1 << _i
ODD5[ord('-')] = 31


def _scaling_seq(i: int, alphabet: str) -> str:
    """scaling.c:85-93 synthetic tip data: highly repetitive for the
    first 1500 taxa, shifted cycles after."""
    n = len(alphabet)
    return "".join(alphabet[j % n] if i < 1500 else alphabet[(i + j) % n]
                   for j in range(N_SITES))


@pytest.fixture(scope="module")
def big_tree():
    return random_utree([f"t{i}" for i in range(N_TAXA_BIG)], seed=2000)


def _build_pair(tree, datatype, rate_scalers):
    """(oracle partition, library partition) with scaling.c data/models."""
    if datatype == "nt":
        states, alphabet = 4, NT_ALPHABET
        freqs, subst = NT_FREQS, NT_SUBST
        table, mapname = maps.map_nt, "nt"
    elif datatype == "aa":
        states, alphabet = 20, AA_ALPHABET
        freqs = aa_data.AA_FREQS_LG
        subst = aa_data.AA_RATES_LG
        table, mapname = maps.map_aa, "aa"
    else:
        states, alphabet = 5, ODD_ALPHABET
        freqs, subst = ODD_FREQS, ODD_SUBST
        table, mapname = ODD5, None
    attrs = oracle.ATTRIB_RATE_SCALERS if rate_scalers else 0
    ref = oracle.OraclePartition(tree.tip_count, tree.inner_count, states,
                                 N_SITES, 1, tree.edge_count, 4,
                                 tree.inner_count, attributes=attrs)
    part = Partition(tree.tip_count, tree.inner_count, states, N_SITES, 1,
                     tree.edge_count, 4, tree.inner_count,
                     rate_scalers=rate_scalers)
    lib = oracle.load()
    omap = (ct.c_ulonglong * 256)(*[int(v) for v in np.asarray(
        table, dtype=np.uint64)]) if mapname is None else None
    for tip in tree.tips():
        seq = _scaling_seq(tip.clv_index, alphabet)
        if mapname is None:
            assert lib.pll_set_tip_states(ref.ptr, tip.clv_index, omap,
                                          seq.encode()) == 1
        else:
            ref.set_tip_states(tip.clv_index, mapname, seq)
        part.set_tip_states(tip.clv_index, table, seq)
    for impl in (ref, part):
        impl.set_frequencies(0, freqs)
        impl.set_subst_params(0, subst)
    return ref, part


@pytest.mark.parametrize("datatype", ["nt", "aa", "odd"])
@pytest.mark.parametrize("alpha", [0.05, 99.0])
@pytest.mark.parametrize("rate_scalers", [False, True],
                         ids=["site-scalers", "rate-scalers"])
def test_scaling_2000_taxa(big_tree, datatype, alpha, rate_scalers):
    """Deep-tree underflow stress: a 2000-taxon traversal accumulates
    thousands of scaling events; logL and d1/d2 must match the oracle in
    the same scaler mode at both Gamma extremes."""
    tree = big_tree
    ref, part = _build_pair(tree, datatype, rate_scalers)
    rates = compute_gamma_cats(alpha, 4)
    ref.set_category_rates(rates)
    part.set_category_rates(rates)

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
    lk_ref = ref.edge_loglikelihood(*args)
    lk = part.compute_edge_loglikelihood(*args)
    # at extreme Gamma shapes the per-site-scaler mode may genuinely
    # underflow to -inf on a 2000-taxon tree — parity means matching the
    # reference EXACTLY, including -inf (scaling.c golden outputs)
    if np.isinf(lk_ref):
        assert np.isinf(lk) and lk < 0
    else:
        np.testing.assert_allclose(lk, lk_ref, rtol=1e-9)
    # scaling must actually trigger for this test to bite
    if part.rate_scalers:
        scaled = np.asarray(part.get_scaler(0)).size and np.asarray(
            part.scale_buffer[:part.scale_buffers]).sum()
    else:
        scaled = np.asarray(part.scale_buffer[:part.scale_buffers]).sum()
    assert scaled > 100

    if not rate_scalers and np.isfinite(lk_ref):
        # derivatives: per-site mode (scaling.c)
        ref_d = ref.derivatives(root.clv_index, root.back.clv_index,
                                root.scaler_index, root.back.scaler_index,
                                pidx, [0.1])
        st = part.update_sumtable(root.clv_index, root.back.clv_index,
                                  root.scaler_index,
                                  root.back.scaler_index, pidx)
        d1, d2 = part.compute_likelihood_derivatives(st, pidx, 0.1)
        np.testing.assert_allclose([d1, d2], ref_d[0], rtol=1e-6)
    ref.destroy()


def test_partial_traversal_updates_only_invalid():
    """partial-traversal.c: after a branch change, a callback-pruned
    traversal recomputes only CLVs on the path to the root; logL matches
    a full recompute."""
    n = 16
    tree = random_utree([f"t{i}" for i in range(n)], seed=9)
    rng = np.random.default_rng(9)
    from libpll2_jax.utils.simulate import simulate_alignment
    headers, seqs = simulate_alignment(tree, 200, [0.25] * 4,
                                       [1, 2, 1, 1, 2, 1], alpha=0.8,
                                       seed=9)
    by = dict(zip(headers, seqs))
    part = Partition(n, n - 2, 4, 200, 1, tree.edge_count, 4, n - 2)
    for t in tree.tips():
        part.set_tip_states(t.clv_index, maps.map_nt, by[t.label])
    part.set_frequencies(0, [0.25] * 4)
    part.set_subst_params(0, [1, 2, 1, 1, 2, 1])
    part.set_category_rates(compute_gamma_cats(0.8, 4))

    trav = traverse(tree.vroot)
    ops, branches, pmat_idx = create_operations(trav)
    pidx = [0] * 4
    part.update_prob_matrices(pidx, pmat_idx, branches)
    part.update_partials(ops)
    root = tree.vroot

    # pick an inner edge, change its length
    edge = next(h for nd in tree.nodes() if not nd.is_tip()
                for h in nd.ring()
                if h.back is not None and not h.back.is_tip()
                and h is not root and h.back is not root)
    edge.length = edge.back.length = edge.length * 3 + 0.05
    part.update_prob_matrices(pidx, [edge.pmatrix_index], [edge.length])

    # validity: only nodes whose subtree contains the changed edge's
    # CLV-side endpoint need recomputation (the reference marks CLVs via
    # node->data flags and prunes valid subtrees in the callback)
    dirty = {id(h) for h in
             [edge] + [x for x in edge.ring()]}

    def contains_dirty(node):
        if id(node) in dirty or (not node.is_tip() and any(
                id(x) in dirty for x in node.ring())):
            return True
        if node.is_tip():
            return False
        return any(contains_dirty(h.back) for h in list(node.ring())[1:])

    def cbtrav(node):
        return contains_dirty(node)

    ptrav = traverse(root, cbtrav=cbtrav)
    pops, pbr, ppidx = create_operations(ptrav)
    assert 0 < len(pops) < len(ops)          # genuinely partial
    part.update_partials(pops)
    lk_partial = part.compute_edge_loglikelihood(
        root.clv_index, root.scaler_index, root.back.clv_index,
        root.back.scaler_index, root.pmatrix_index, pidx)

    # full recompute for comparison
    part.update_partials(ops)
    lk_full = part.compute_edge_loglikelihood(
        root.clv_index, root.scaler_index, root.back.clv_index,
        root.back.scaler_index, root.pmatrix_index, pidx)
    np.testing.assert_allclose(lk_partial, lk_full, rtol=1e-12)


def test_rooted_tipinner_vs_oracle():
    """rooted-tipinner.c: rooted evaluation where one root child is a
    TIP (tip-inner case at the root) — root logL parity."""
    newick = "((t0:0.11,(t1:0.23,t2:0.09):0.14):0.07,t3:0.31);"
    tree = parse_newick_rooted(newick)
    assert tree.root.right.is_tip() or tree.root.left.is_tip()
    trav = rtree.traverse(tree.root)
    ops, branches, pmat_idx = rtree.create_operations(trav)

    rng = np.random.default_rng(4)
    seqs = ["".join(rng.choice(list("ACGT"), size=150)) for _ in range(4)]
    ref = oracle.OraclePartition(4, 3, 4, 150, 1, len(branches), 4, 3)
    part = Partition(4, 3, 4, 150, 1, len(branches), 4, 3)
    for t in tree.tips():
        ref.set_tip_states(t.clv_index, "nt", seqs[t.clv_index])
        part.set_tip_states(t.clv_index, maps.map_nt, seqs[t.clv_index])
    pidx = [0] * 4
    for impl in (ref, part):
        impl.set_frequencies(0, [0.3, 0.2, 0.2, 0.3])
        impl.set_subst_params(0, [1, 2, 1, 1, 2, 1])
        impl.set_category_rates(compute_gamma_cats(0.9, 4))
        impl.update_prob_matrices(pidx, pmat_idx, branches)
    ref.update_partials([(o.parent_clv_index, o.parent_scaler_index,
                          o.child1_clv_index, o.child1_matrix_index,
                          o.child1_scaler_index, o.child2_clv_index,
                          o.child2_matrix_index, o.child2_scaler_index)
                         for o in ops])
    part.update_partials(ops)
    r = tree.root
    lk_ref, per_ref = ref.root_loglikelihood(r.clv_index, r.scaler_index,
                                             pidx, persite=True)
    lk, per = part.compute_root_loglikelihood(r.clv_index, r.scaler_index,
                                              pidx, persite=True)
    np.testing.assert_allclose(lk, lk_ref, rtol=1e-10)
    np.testing.assert_allclose(per, per_ref, rtol=1e-8)
    ref.destroy()
