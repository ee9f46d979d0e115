"""Aux component validation: tree clone/integrity/unroot, SVG export,
debug printers, hardware probe, per-branch heterotachy models."""
import io

import numpy as np
import pytest

import oracle
from libpll2_jax import Partition, compute_gamma_cats
from libpll2_jax import constants as C
from libpll2_jax.io import maps
from libpll2_jax.trees import (check_integrity, create_operations,
                               export_newick, export_svg, graph_clone,
                               parse_newick, parse_newick_rooted,
                               random_utree, rtree_unroot, traverse,
                               utree_clone)
from libpll2_jax.utils import (dump, show_clv, show_pmatrix,
                               show_tree_ascii, simulate_alignment)

NEWICK = "((t0:0.1,t1:0.2):0.05,(t2:0.3,(t3:0.1,t4:0.15):0.2):0.1,t5:0.4);"


def test_check_integrity_and_clone():
    tree = parse_newick(NEWICK)
    assert check_integrity(tree)
    clone = utree_clone(tree)
    assert check_integrity(clone)
    assert export_newick(clone.vroot) == export_newick(tree.vroot)
    # clone is a deep copy: mutating it does not affect the original
    clone.vroot.length = 99.0
    assert tree.vroot.length != 99.0


def test_integrity_detects_bad_edge():
    tree = parse_newick(NEWICK)
    tree.vroot.length = 123.0       # desync from back.length
    with pytest.raises(C.PllError):
        check_integrity(tree)


def test_rtree_unroot_logl_equals_parse_unroot():
    text = "((t0:0.1,t1:0.2):0.05,(t2:0.3,t3:0.1):0.2);"
    rt = parse_newick_rooted(text)
    ut = rtree_unroot(rt)
    assert check_integrity(ut)
    ut2 = parse_newick(text, unroot=True)
    labels1 = sorted(t.label for t in ut.tips())
    labels2 = sorted(t.label for t in ut2.tips())
    assert labels1 == labels2
    assert ut.tip_count == 4 and ut.edge_count == 5


def test_svg_export():
    tree = parse_newick(NEWICK)
    svg = export_svg(tree.vroot)
    assert svg.startswith("<svg") and svg.endswith("</svg>")
    for label in ("t0", "t5"):
        assert f">{label}</text>" in svg


def test_debug_printers_and_hardware():
    tree = random_utree([f"t{i}" for i in range(5)], seed=2)
    headers, seqs = simulate_alignment(tree, 10, [0.25] * 4,
                                       [1, 1, 1, 1, 1, 1], seed=2)
    part = Partition(5, 3, 4, 10, 1, 7, 2, 3)
    by_label = dict(zip(headers, seqs))
    for tip in tree.tips():
        part.set_tip_states(tip.clv_index, maps.map_nt, by_label[tip.label])
    part.set_frequencies(0, [0.25] * 4)
    part.set_subst_params(0, [1] * 6)
    part.set_category_rates([0.5, 1.5])
    trav = traverse(tree.vroot)
    ops, br, pm = create_operations(trav)
    part.update_prob_matrices([0, 0], pm, br)
    part.update_partials(ops)

    buf = io.StringIO()
    show_pmatrix(part, 0, file=buf)
    assert len(buf.getvalue().splitlines()) >= 8
    buf = io.StringIO()
    show_clv(part, 5, file=buf)
    assert len(buf.getvalue().splitlines()) == 10
    buf = io.StringIO()
    show_tree_ascii(tree.vroot, file=buf)
    assert "t0" in buf.getvalue()
    buf = io.StringIO()
    info = dump(file=buf)
    assert info.device_count >= 1


@pytest.mark.skipif(not oracle.available(), reason="reference unavailable")
def test_heterotachy_per_branch_models():
    """Different rate matrices on different branches via separate
    update_prob_matrices calls (the reference's examples/heterotachy)."""
    tree = random_utree([f"t{i}" for i in range(8)], seed=7)
    headers, seqs = simulate_alignment(tree, 120, [0.25] * 4,
                                       [1, 2, 1, 1, 2, 1], alpha=1.0,
                                       seed=7)
    by_label = dict(zip(headers, seqs))
    rates = compute_gamma_cats(1.0, 4)
    freqs2 = [0.4, 0.1, 0.3, 0.2]
    subst2 = [2.0, 1.0, 0.5, 1.5, 1.0, 1.0]

    ref = oracle.OraclePartition(8, 6, 4, 120, 2, 13, 4, 6)
    part = Partition(8, 6, 4, 120, 2, 13, 4, 6)
    for tip in tree.tips():
        ref.set_tip_states(tip.clv_index, "nt", by_label[tip.label])
        part.set_tip_states(tip.clv_index, maps.map_nt, by_label[tip.label])
    for impl in (ref, part):
        impl.set_frequencies(0, [0.25] * 4)
        impl.set_subst_params(0, [1, 2, 1, 1, 2, 1])
        impl.set_frequencies(1, freqs2)
        impl.set_subst_params(1, subst2)
        impl.set_category_rates(rates)

    trav = traverse(tree.vroot)
    ops, branches, pmat_idx = create_operations(trav)
    # first half of the edges evolve under model 0, the rest under model 1
    half = len(pmat_idx) // 2
    for impl in (ref, part):
        impl.update_prob_matrices([0] * 4, pmat_idx[:half], branches[:half])
        impl.update_prob_matrices([1] * 4, pmat_idx[half:], branches[half:])
    ref.update_partials([(o.parent_clv_index, o.parent_scaler_index,
                          o.child1_clv_index, o.child1_matrix_index,
                          o.child1_scaler_index, o.child2_clv_index,
                          o.child2_matrix_index, o.child2_scaler_index)
                         for o in ops])
    part.update_partials(ops)
    root = tree.vroot
    args = (root.clv_index, root.scaler_index, root.back.clv_index,
            root.back.scaler_index, root.pmatrix_index, [0] * 4)
    np.testing.assert_allclose(part.compute_edge_loglikelihood(*args),
                               ref.edge_loglikelihood(*args), rtol=1e-10)
    ref.destroy()


@pytest.mark.skipif(not oracle.available(), reason="reference unavailable")
def test_set_tip_clv_partial_likelihood_input():
    """Direct tip CLV input (uncertain tips / partial likelihoods),
    pll_set_tip_clv (pll.c:1063) vs oracle."""
    import ctypes as ct
    from libpll2_jax.trees import create_operations, traverse

    tree = random_utree([f"t{i}" for i in range(6)], seed=19)
    sites, cats = 40, 4
    rng = np.random.default_rng(19)
    rates = compute_gamma_cats(1.0, cats)

    lib = oracle.load()
    lib.pll_set_tip_clv.restype = ct.c_int
    lib.pll_set_tip_clv.argtypes = [ct.POINTER(oracle.PllPartition),
                                    ct.c_uint, ct.POINTER(ct.c_double),
                                    ct.c_int]

    ref = oracle.OraclePartition(6, 4, 4, sites, 1, tree.edge_count, cats, 4)
    part = Partition(6, 4, 4, sites, 1, tree.edge_count, cats, 4)
    for tip in tree.tips():
        clv = rng.uniform(0.1, 1.0, size=(sites, 4))
        r = lib.pll_set_tip_clv(ref.ptr, tip.clv_index,
                                oracle.f64(clv.ravel()), 0)
        assert r == 1
        part.set_tip_clv(tip.clv_index, clv)
    for impl in (ref, part):
        impl.set_frequencies(0, [0.25] * 4)
        impl.set_subst_params(0, [1, 2, 1, 1, 2, 1])
        impl.set_category_rates(rates)
    trav = traverse(tree.vroot)
    ops, branches, pmat_idx = create_operations(trav)
    pidx = [0] * cats
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
    ref.destroy()
