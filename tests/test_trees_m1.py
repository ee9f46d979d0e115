"""M1/M2 validation: newick parsing, traversal/operations, full-tree logL on
real data, SPR/NNI moves with rollback, and branch-length derivatives."""
import numpy as np
import pytest

import oracle
from libpll2_jax import Operation, Partition, compute_gamma_cats
from libpll2_jax import constants as C
from libpll2_jax.io import load_fasta, maps
from libpll2_jax.ops import derivatives as ops_deriv
from libpll2_jax.trees import (create_operations, export_newick, moves,
                               parse_newick, parse_newick_rooted, rtree,
                               traverse)

pytestmark = pytest.mark.skipif(not oracle.available(),
                                reason="reference not available")

LG4_FAS = "/root/reference/examples/lg4/data/example.fas"
LG4_TREE = "/root/reference/examples/lg4/data/example.tree"
RNG = np.random.default_rng(11)


def load_lg4_tree():
    return parse_newick(open(LG4_TREE).read())


def test_parse_counts_and_template_indices():
    tree = load_lg4_tree()
    assert tree.tip_count == 21
    assert tree.inner_count == 19
    assert tree.edge_count == 39
    tips = tree.tips()
    assert sorted(n.clv_index for n in tips) == list(range(21))
    inner = [n for n in tree.nodes() if not n.is_tip()]
    assert sorted(n.clv_index for n in inner) == list(range(21, 40))
    assert sorted(n.scaler_index for n in inner) == list(range(19))
    # pmatrix index of a tip edge equals the tip index on both half-edges
    for t in tips:
        assert t.pmatrix_index == t.clv_index
        assert t.back.pmatrix_index == t.pmatrix_index


def test_export_roundtrip():
    tree = load_lg4_tree()
    text = export_newick(tree.vroot)
    # the export format has a top-level bifurcation (utree.c:284-290):
    # re-parsing it requires unrooting, exactly as in the reference
    tree2 = parse_newick(text, unroot=True)
    assert tree2.tip_count == tree.tip_count
    assert export_newick(tree2.vroot) == text
    labels1 = sorted(t.label for t in tree.tips())
    labels2 = sorted(t.label for t in tree2.tips())
    assert labels1 == labels2


def _setup_engines(tree, headers, seqs, states, rate_cats, alpha=1.0,
                   mapname="aa", attrs=0, **kw):
    by_label = dict(zip(headers, seqs))
    n_tips, n_inner = tree.tip_count, tree.inner_count
    n_sites = len(seqs[0])
    n_edges = tree.edge_count
    nparams = states * (states - 1) // 2
    freqs = RNG.dirichlet(np.ones(states) * 10)
    subst = RNG.uniform(0.2, 3.0, size=nparams)
    rates = compute_gamma_cats(alpha, rate_cats)
    charmap = maps.map_aa if mapname == "aa" else maps.map_nt

    ref = oracle.OraclePartition(n_tips, n_inner, states, n_sites, 1,
                                 n_edges, rate_cats, n_inner,
                                 attributes=attrs)
    part = Partition(n_tips, n_inner, states, n_sites, 1, n_edges,
                     rate_cats, n_inner, **kw)
    for tip in tree.tips():
        ref.set_tip_states(tip.clv_index, mapname, by_label[tip.label])
        part.set_tip_states(tip.clv_index, charmap, by_label[tip.label])
    for impl in (ref, part):
        impl.set_frequencies(0, freqs)
        impl.set_subst_params(0, subst)
        impl.set_category_rates(rates)
    return ref, part


def full_traversal_update(ref, part, tree, rate_cats):
    trav = traverse(tree.vroot)
    ops, branches, pmat_idx = create_operations(trav)
    pidx = [0] * rate_cats
    ref.update_prob_matrices(pidx, pmat_idx, branches)
    part.update_prob_matrices(pidx, pmat_idx, branches)
    ref.update_partials([(o.parent_clv_index, o.parent_scaler_index,
                          o.child1_clv_index, o.child1_matrix_index,
                          o.child1_scaler_index, o.child2_clv_index,
                          o.child2_matrix_index, o.child2_scaler_index)
                         for o in ops])
    part.update_partials(ops)
    return trav, ops, pidx


def edge_logl_both(ref, part, tree, pidx):
    root = tree.vroot
    args = (root.clv_index, root.scaler_index,
            root.back.clv_index, root.back.scaler_index,
            root.pmatrix_index)
    return (ref.edge_loglikelihood(*args, pidx),
            part.compute_edge_loglikelihood(*args, pidx))


def test_full_tree_logl_lg4_example_protein():
    """End-to-end: newick + FASTA -> operations -> logL, 20 states, real data."""
    headers, seqs = load_fasta(LG4_FAS)
    tree = load_lg4_tree()
    ref, part = _setup_engines(tree, headers, seqs, 20, 4, alpha=0.75)
    _, ops, pidx = full_traversal_update(ref, part, tree, 4)
    lk_ref, lk = edge_logl_both(ref, part, tree, pidx)
    np.testing.assert_allclose(lk, lk_ref, rtol=1e-10)
    ref.destroy()


def test_partial_traversal_after_clv_invalidation():
    """The SPR-loop pattern: only recompute invalidated CLVs
    (test/src/partial-traversal.c)."""
    headers, seqs = load_fasta(LG4_FAS)
    tree = load_lg4_tree()
    ref, part = _setup_engines(tree, headers, seqs, 20, 2)
    _, ops, pidx = full_traversal_update(ref, part, tree, 2)
    lk_ref0, lk0 = edge_logl_both(ref, part, tree, pidx)

    # pretend only CLVs above some inner node are invalid: partial traversal
    valid = {o.parent_clv_index for o in ops[:len(ops) // 2]}

    def cb(node):
        # prune subtrees whose root CLV is still valid
        return node.is_tip() or node.clv_index not in valid

    trav = traverse(tree.vroot, cbtrav=cb)
    pops, branches, pmat_idx = create_operations(trav)
    assert 0 < len(pops) < len(ops)
    part.update_partials(pops)
    lk = part.compute_edge_loglikelihood(
        tree.vroot.clv_index, tree.vroot.scaler_index,
        tree.vroot.back.clv_index, tree.vroot.back.scaler_index,
        tree.vroot.pmatrix_index, pidx)
    np.testing.assert_allclose(lk, lk0, rtol=1e-12)
    ref.destroy()


def test_spr_move_and_rollback():
    headers, seqs = load_fasta(LG4_FAS)
    tree = load_lg4_tree()
    ref, part = _setup_engines(tree, headers, seqs, 20, 2)
    _, ops, pidx = full_traversal_update(ref, part, tree, 2)
    lk_ref0, lk0 = edge_logl_both(ref, part, tree, pidx)
    np.testing.assert_allclose(lk0, lk_ref0, rtol=1e-10)

    # pick a safe SPR: p inner, r outside the pruned subtree
    inner = [n for n in tree.nodes() if not n.is_tip()]
    p = inner[3]
    candidates = [n for n in tree.nodes()
                  if n not in (p, p.back, p.next, p.next.back,
                               p.next.next, p.next.next.back)
                  and not moves.utree_find(p.back, n)]
    r = candidates[-1]
    rb = moves.Rollback()
    blens, midx = moves.spr(p, r, rb, safe=True)

    # full refresh on both engines with the new topology
    trav, ops2, pidx = full_traversal_update(ref, part, tree, 2)
    lk_ref1, lk1 = edge_logl_both(ref, part, tree, pidx)
    np.testing.assert_allclose(lk1, lk_ref1, rtol=1e-10)

    # rollback and verify we recover the original likelihood
    moves.rollback_move(rb)
    trav, ops3, pidx = full_traversal_update(ref, part, tree, 2)
    lk_ref2, lk2 = edge_logl_both(ref, part, tree, pidx)
    np.testing.assert_allclose(lk2, lk0, rtol=1e-9)
    ref.destroy()


def test_nni_move_and_rollback():
    headers, seqs = load_fasta(LG4_FAS)
    tree = load_lg4_tree()
    ref, part = _setup_engines(tree, headers, seqs, 20, 2)
    _, ops, pidx = full_traversal_update(ref, part, tree, 2)
    lk_ref0, lk0 = edge_logl_both(ref, part, tree, pidx)

    inner_edges = [n for n in tree.nodes()
                   if not n.is_tip() and not n.back.is_tip()]
    p = inner_edges[2]
    rb = moves.Rollback()
    moves.nni(p, C.UTREE_MOVE_NNI_LEFT, rb)
    full_traversal_update(ref, part, tree, 2)
    lk_ref1, lk1 = edge_logl_both(ref, part, tree, pidx)
    np.testing.assert_allclose(lk1, lk_ref1, rtol=1e-10)

    moves.rollback_move(rb)
    full_traversal_update(ref, part, tree, 2)
    _, lk2 = edge_logl_both(ref, part, tree, pidx)
    np.testing.assert_allclose(lk2, lk0, rtol=1e-9)
    ref.destroy()


# ------------------------------------------------------------------- rooted
def test_rooted_tree_root_logl():
    headers, seqs = load_fasta(LG4_FAS)
    # build a rooted tree over a subset of taxa
    sub = headers[:8]
    newick = "(((%s:0.1,%s:0.2):0.1,(%s:0.3,%s:0.1):0.2):0.05,((%s:0.1,%s:0.1):0.3,(%s:0.2,%s:0.1):0.1):0.06);" % tuple(sub)
    tree = parse_newick_rooted(newick)
    assert tree.tip_count == 8 and tree.inner_count == 7
    trav = rtree.traverse(tree.root)
    ops, branches, pmat_idx = rtree.create_operations(trav)
    assert len(ops) == 7 and len(branches) == 14

    n_sites = len(seqs[0])
    by_label = dict(zip(headers, seqs))
    ref = oracle.OraclePartition(8, 7, 20, n_sites, 1, 14, 4, 7)
    part = Partition(8, 7, 20, n_sites, 1, 14, 4, 7)
    freqs = RNG.dirichlet(np.ones(20) * 10)
    subst = RNG.uniform(0.2, 3.0, size=190)
    rates = compute_gamma_cats(0.6, 4)
    for t in tree.tips():
        ref.set_tip_states(t.clv_index, "aa", by_label[t.label])
        part.set_tip_states(t.clv_index, maps.map_aa, by_label[t.label])
    pidx = [0] * 4
    for impl in (ref, part):
        impl.set_frequencies(0, freqs)
        impl.set_subst_params(0, subst)
        impl.set_category_rates(rates)
        impl.update_prob_matrices(pidx, pmat_idx, branches)
    ref.update_partials([(o.parent_clv_index, o.parent_scaler_index,
                          o.child1_clv_index, o.child1_matrix_index,
                          o.child1_scaler_index, o.child2_clv_index,
                          o.child2_matrix_index, o.child2_scaler_index)
                         for o in ops])
    part.update_partials(ops)
    root = tree.root
    lk_ref = ref.root_loglikelihood(root.clv_index, root.scaler_index, pidx)
    lk = part.compute_root_loglikelihood(root.clv_index, root.scaler_index,
                                         pidx)
    np.testing.assert_allclose(lk, lk_ref, rtol=1e-10)
    ref.destroy()


# -------------------------------------------------------------- derivatives
@pytest.mark.parametrize("states,rate_cats,pinv", [(4, 4, 0.0), (20, 2, 0.0),
                                                   (4, 4, 0.3)])
def test_derivatives_vs_oracle(states, rate_cats, pinv):
    headers, seqs = load_fasta(LG4_FAS)
    if states == 4:
        # random DNA data instead
        rng = np.random.default_rng(3)
        seqs = ["ACGT" + "".join(rng.choice(list("ACGT-"), size=40))
                for _ in headers]
    tree = load_lg4_tree()
    ref, part = _setup_engines(tree, headers, seqs, states, rate_cats,
                               mapname="aa" if states == 20 else "nt")
    if pinv > 0:
        ref.set_invariant_proportion(0, pinv)
        part.update_invariant_sites_proportion(0, pinv)
    _, ops, pidx = full_traversal_update(ref, part, tree, rate_cats)

    root = tree.vroot
    p, c = root.clv_index, root.back.clv_index
    psc, csc = root.scaler_index, root.back.scaler_index

    sumtable = part.update_sumtable(p, c, psc, csc, pidx)
    brlens = [0.01, 0.1, root.length, 1.0, 5.0]
    ref_out = ref.derivatives(p, c, psc, csc, pidx, brlens)
    for b, (d1_ref, d2_ref) in zip(brlens, ref_out):
        d1, d2 = part.compute_likelihood_derivatives(sumtable, pidx, b)
        np.testing.assert_allclose(d1, d1_ref, rtol=1e-8, atol=1e-10,
                                   err_msg=f"d1 at brlen {b}")
        np.testing.assert_allclose(d2, d2_ref, rtol=1e-8, atol=1e-10,
                                   err_msg=f"d2 at brlen {b}")
    ref.destroy()


def test_newton_branch_optimization_converges():
    """Newton loop on one branch improves logL (examples/newton pattern)."""
    headers, seqs = load_fasta(LG4_FAS)
    tree = load_lg4_tree()
    ref, part = _setup_engines(tree, headers, seqs, 20, 2)
    _, ops, pidx = full_traversal_update(ref, part, tree, 2)
    root = tree.vroot
    p, c = root.clv_index, root.back.clv_index
    psc, csc = root.scaler_index, root.back.scaler_index
    sumtable = part.update_sumtable(p, c, psc, csc, pidx)

    length = root.length
    for _ in range(30):
        d1, d2 = part.compute_likelihood_derivatives(sumtable, pidx, length)
        if abs(d1) < 1e-10:
            break
        new = float(ops_deriv.newton_step(
            np.float64(length), np.float64(d1), np.float64(d2),
            1e-8, 100.0))
        if abs(new - length) < 1e-12:
            break
        length = new
    d1, d2 = part.compute_likelihood_derivatives(sumtable, pidx, length)
    assert abs(d1) < 1e-6, f"Newton did not converge: d1={d1} at {length}"
    assert d2 > 0, "not at a maximum of logL"

    # the optimized length must beat the original logL
    lk0 = part.compute_edge_loglikelihood(p, psc, c, csc,
                                          root.pmatrix_index, pidx)
    part.update_prob_matrices(pidx, [root.pmatrix_index], [length])
    lk1 = part.compute_edge_loglikelihood(p, psc, c, csc,
                                          root.pmatrix_index, pidx)
    assert lk1 >= lk0 - 1e-9
    ref.destroy()


def test_rf_distance():
    """RF properties: identity 0; one NNI move changes exactly one
    bipartition (RF 2); disjoint caterpillar vs balanced-ish trees are
    far; the normalized metric is in [0, 1]."""
    from libpll2_jax import constants as C
    from libpll2_jax.trees import random_utree, rf_distance
    from libpll2_jax.trees.utils import utree_clone
    from libpll2_jax.trees import moves

    labels = [f"t{i}" for i in range(12)]
    t1 = random_utree(labels, seed=3)
    assert rf_distance(t1, t1) == 0.0
    t2 = utree_clone(t1)
    edge = next(h for n in t2.nodes() if not n.is_tip()
                for h in n.ring()
                if h.back is not None and not h.back.is_tip())
    moves.nni(edge, C.UTREE_MOVE_NNI_LEFT, None)
    assert rf_distance(t1, t2) == 2.0
    t3 = random_utree(labels, seed=99)
    d = rf_distance(t1, t3)
    dn = rf_distance(t1, t3, normalized=True)
    assert d >= 2.0 and 0.0 < dn <= 1.0
    # mismatched taxon sets are rejected
    t4 = random_utree([f"x{i}" for i in range(12)], seed=3)
    import pytest
    with pytest.raises(C.PllError):
        rf_distance(t1, t4)


def test_consensus_and_support():
    """Majority-rule consensus and bootstrap edge support from
    bipartition counting: identical replicates give support 1.0 on every
    split; one divergent replicate lowers exactly the splits it breaks;
    >0.5 splits are pairwise compatible by construction."""
    from libpll2_jax import constants as C
    from libpll2_jax.trees import (edge_support, majority_rule_consensus,
                                   random_utree, tree_bipartitions)
    from libpll2_jax.trees import moves
    from libpll2_jax.trees.utils import utree_clone

    labels = [f"t{i}" for i in range(10)]
    base = random_utree(labels, seed=13)
    reps = [utree_clone(base) for _ in range(4)]
    # perturb one replicate by an NNI
    edge = next(h for n in reps[-1].nodes() if not n.is_tip()
                for h in n.ring()
                if h.back is not None and not h.back.is_tip())
    moves.nni(edge, C.UTREE_MOVE_NNI_LEFT, None)

    sup = edge_support(base, reps)
    assert set(sup) == tree_bipartitions(base)
    vals = sorted(sup.values())
    assert vals[-1] == 1.0 and vals[0] == 0.75     # one NNI breaks 1 split
    assert sum(v < 1.0 for v in sup.values()) == 1

    cons = majority_rule_consensus(reps)
    splits = [s for s, _ in cons]
    assert set(splits) <= tree_bipartitions(base) | \
        tree_bipartitions(reps[-1])
    # every consensus split supported by > half the replicates
    assert all(c > 0.5 for _, c in cons)
