"""M5 validation: Sankoff weighted parsimony and Fitch fast parsimony vs
the reference oracle (test/src parsimony scenarios, examples/parsimony)."""
import ctypes as ct

import numpy as np
import pytest

import oracle
from libpll2_jax import Partition
from libpll2_jax.io import maps
from libpll2_jax.parsimony import FastParsimony, Parsimony
from libpll2_jax.trees import random_utree, traverse
from libpll2_jax.trees.utree import create_pars_buildops
from libpll2_jax.utils.simulate import simulate_alignment

pytestmark = pytest.mark.skipif(not oracle.available(),
                                reason="reference not available")

N_TAXA = 16
N_SITES = 300


@pytest.fixture(scope="module")
def data():
    tree = random_utree([f"t{i}" for i in range(N_TAXA)], seed=21)
    headers, seqs = simulate_alignment(
        tree, N_SITES, [0.25] * 4, [1, 2, 1, 1, 2, 1], alpha=1.0, seed=21)
    return tree, headers, seqs


def unit_cost(states):
    m = np.ones((states, states)) - np.eye(states)
    return m


def test_sankoff_score_vs_oracle(data):
    tree, headers, seqs = data
    by_label = dict(zip(headers, seqs))
    cost = unit_cost(4)

    lib = oracle.load()
    ref = lib.pll_parsimony_create(N_TAXA, 4, N_SITES,
                                   oracle.f64(cost.ravel()),
                                   tree.inner_count * 3, 0)
    assert ref

    pars = Parsimony(N_TAXA, 4, N_SITES, cost, tree.inner_count * 3)
    for tip in tree.tips():
        r = lib.pll_set_parsimony_sequence(ref, tip.clv_index,
                                           oracle.charmap("nt"),
                                           by_label[tip.label].encode())
        assert r == 1
        pars.set_sequence(tip.clv_index, maps.map_nt, by_label[tip.label])

    trav = traverse(tree.vroot)
    # weighted parsimony uses clv-index addressed score buffers (rooted at
    # the traversal root), mirroring examples/parsimony
    ops = [(n.clv_index, n.next.back.clv_index, n.next.next.back.clv_index)
           for n in trav if not n.is_tip()]
    score_ref = lib.pll_parsimony_build(ref, oracle.build_ops(ops), len(ops))

    from libpll2_jax.parsimony import ParsBuildOp
    score = pars.build([ParsBuildOp(*o) for o in ops])
    assert score == pytest.approx(score_ref, abs=1e-9)
    # per-buffer scores agree too
    for n in trav:
        if not n.is_tip():
            assert pars.score(n.clv_index) == pytest.approx(
                lib.pll_parsimony_score(ref, n.clv_index), abs=1e-9)
    lib.pll_parsimony_destroy(ref)


def _oracle_fastparsimony(tree, headers, seqs):
    by_label = dict(zip(headers, seqs))
    part = oracle.OraclePartition(tree.tip_count, tree.inner_count, 4,
                                  N_SITES, 1, tree.edge_count, 1,
                                  tree.inner_count)
    for tip in tree.tips():
        part.set_tip_states(tip.clv_index, "nt", by_label[tip.label])
    lib = oracle.load()
    pars = lib.pll_fastparsimony_init(part.ptr)
    assert pars
    return part, pars, lib


def test_fitch_scores_vs_oracle(data):
    tree, headers, seqs = data
    by_label = dict(zip(headers, seqs))

    ref_part, ref_pars, lib = _oracle_fastparsimony(tree, headers, seqs)

    part = Partition(tree.tip_count, tree.inner_count, 4, N_SITES, 1,
                     tree.edge_count, 1, tree.inner_count)
    for tip in tree.tips():
        part.set_tip_states(tip.clv_index, maps.map_nt, by_label[tip.label])
    fp = FastParsimony(part)

    assert fp.const_cost == ref_pars.contents.const_cost
    assert fp.informative_count == ref_pars.contents.informative_count

    trav = traverse(tree.vroot)
    ops = create_pars_buildops(trav)
    fp.update_vectors(ops)
    lib.pll_fastparsimony_update_vectors(
        ref_pars, oracle.build_ops([(o.parent_score_index,
                                     o.child1_score_index,
                                     o.child2_score_index) for o in ops]),
        len(ops))

    root = tree.vroot
    score_ref = lib.pll_fastparsimony_edge_score(
        ref_pars, root.node_index, root.back.node_index)
    score = fp.edge_score(root.node_index, root.back.node_index)
    assert score == score_ref

    root_ref = lib.pll_fastparsimony_root_score(ref_pars, root.node_index)
    assert fp.root_score(root.node_index) == root_ref

    # per-node costs match along the traversal
    for o in ops:
        assert int(fp.node_cost[o.parent_score_index]) == \
            ref_pars.contents.node_cost[o.parent_score_index]

    lib.pll_parsimony_destroy(ref_pars)
    ref_part.destroy()


def test_batch_insert_scores_match_sequential(data):
    """The vmapped candidate-edge kernel equals one-by-one Fitch joins."""
    tree, headers, seqs = data
    by_label = dict(zip(headers, seqs))
    part = Partition(tree.tip_count, tree.inner_count, 4, N_SITES, 1,
                     tree.edge_count, 1, tree.inner_count)
    for tip in tree.tips():
        part.set_tip_states(tip.clv_index, maps.map_nt, by_label[tip.label])
    fp = FastParsimony(part)
    trav = traverse(tree.vroot)
    fp.update_vectors(create_pars_buildops(trav))

    # candidate edges: all half-edge pairs along the traversal
    e1, e2 = [], []
    for n in trav:
        if n.back is not None:
            e1.append(n.node_index)
            e2.append(n.back.node_index)
    scores = fp.batch_insert_scores(0, np.array(e1), np.array(e2))
    assert scores.shape == (len(e1),)
    assert (scores >= fp.const_cost).all()
