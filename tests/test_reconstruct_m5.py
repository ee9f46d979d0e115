"""Sankoff ancestral-state reconstruction vs the reference oracle
(pll_parsimony_reconstruct on a rooted tree, examples/parsimony flow)."""
import ctypes as ct

import numpy as np
import pytest

import oracle
from libpll2_jax.io import maps
from libpll2_jax.parsimony import Parsimony, ParsBuildOp
from libpll2_jax.trees import parse_newick_rooted, rtree
from libpll2_jax.trees.rtree import create_pars_buildops, create_pars_recops

pytestmark = pytest.mark.skipif(not oracle.available(),
                                reason="reference not available")

NEWICK = "(((A:1,B:1):1,(C:1,D:1):1):1,(E:1,F:1):1);"
SEQS = {"A": "ACGTACGTAC", "B": "ACGTACTTAC", "C": "AGGTACGAAC",
        "D": "AGCTACGAAC", "E": "TCGAACGTAA", "F": "TCGAACGTAT"}


def test_sankoff_reconstruct_matches_oracle():
    tree = parse_newick_rooted(NEWICK)
    tips = tree.tip_count
    sites = len(next(iter(SEQS.values())))
    cost = (np.ones((4, 4)) - np.eye(4)).ravel()

    from libpll2_jax import constants as C
    trav_post = rtree.traverse(tree.root, order=C.TRAVERSE_POSTORDER)
    trav_pre = rtree.traverse(tree.root, order=C.TRAVERSE_PREORDER)
    build_ops = create_pars_buildops(trav_post)
    rec_ops = create_pars_recops(trav_pre)

    lib = oracle.load()
    ref = lib.pll_parsimony_create(tips, 4, sites, oracle.f64(cost),
                                   2 * tips - 1, 2 * tips - 1)
    assert ref
    pars = Parsimony(tips, 4, sites, cost, tips - 1,
                     ancestral_buffers=tips - 1)
    by_label = {t.label: t.clv_index for t in tree.tips()}
    for label, seq in SEQS.items():
        r = lib.pll_set_parsimony_sequence(ref, by_label[label],
                                           oracle.charmap("nt"),
                                           seq.encode())
        assert r == 1
        pars.set_sequence(by_label[label], maps.map_nt, seq)

    ops_t = [(o.parent_score_index, o.child1_score_index,
              o.child2_score_index) for o in build_ops]
    score_ref = lib.pll_parsimony_build(ref, oracle.build_ops(ops_t),
                                        len(ops_t))
    score = pars.build(build_ops)
    assert score == pytest.approx(score_ref)

    rec_t = (oracle.PllParsRecOp * len(rec_ops))()
    for k, o in enumerate(rec_ops):
        (rec_t[k].node_score_index, rec_t[k].node_ancestral_index,
         rec_t[k].parent_score_index, rec_t[k].parent_ancestral_index) = o
    lib.pll_parsimony_reconstruct(ref, oracle.charmap("nt"), rec_t,
                                  len(rec_ops))
    pars.reconstruct(maps.map_nt, rec_ops)

    for o in rec_ops:
        idx = o.node_ancestral_index
        ref_anc = "".join(
            chr(ref.contents.anc_states[idx][s]) for s in range(sites))
        assert pars.ancestral(idx) == ref_anc, f"node {idx}"
    lib.pll_parsimony_destroy(ref)
