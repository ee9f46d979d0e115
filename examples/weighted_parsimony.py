"""Weighted (Sankoff) parsimony with ancestral-state reconstruction
(reference: examples/parsimony/npr-pars.c): build per-node score buffers
bottom-up on a rooted tree under a transition/transversion-weighted cost
matrix, report the minimum total cost, then walk the tree top-down
assigning each inner node its most-parsimonious state per site.
"""
import sys

sys.path.insert(0, ".")

import numpy as np

from libpll2_jax import constants as C
from libpll2_jax.io import maps
from libpll2_jax.parsimony import Parsimony
from libpll2_jax.trees import parse_newick_rooted, rtree
from libpll2_jax.trees.rtree import create_pars_buildops, create_pars_recops

NEWICK = ("((((A:1,B:1)n1:1,(C:1,D:1)n2:1)n5:1,(E:1,F:1)n3:1)n6:1,"
          "(G:1,H:1)n4:1)root;")
SEQS = {"A": "ACGTACGTACGTTTGA", "B": "ACGTACTTACGTTTGA",
        "C": "AGGTACGAACGTATGA", "D": "AGCTACGAACCTATGA",
        "E": "TCGAACGTAAGTATGC", "F": "TCGAACGTATGTATGC",
        "G": "TCGAACGTTTGAATGC", "H": "TCGATCGTTTGAATGC"}

# transitions (A<->G, C<->T) cost 1, transversions 2.5 — the whole point
# of Sankoff over Fitch is an arbitrary cost matrix like this one
TRANSITION, TRANSVERSION = 1.0, 2.5


def cost_matrix():
    cost = np.full((4, 4), TRANSVERSION)
    np.fill_diagonal(cost, 0.0)
    cost[0, 2] = cost[2, 0] = TRANSITION          # A<->G
    cost[1, 3] = cost[3, 1] = TRANSITION          # C<->T
    return cost


def main():
    tree = parse_newick_rooted(NEWICK)
    tips, sites = tree.tip_count, len(next(iter(SEQS.values())))

    trav_post = rtree.traverse(tree.root, order=C.TRAVERSE_POSTORDER)
    trav_pre = rtree.traverse(tree.root, order=C.TRAVERSE_PREORDER)
    build_ops = create_pars_buildops(trav_post)
    rec_ops = create_pars_recops(trav_pre)

    pars = Parsimony(tips, 4, sites, cost_matrix().ravel(), tips - 1,
                     ancestral_buffers=tips - 1)
    by_label = {t.label: t.clv_index for t in tree.tips()}
    for label, seq in SEQS.items():
        pars.set_sequence(by_label[label], maps.map_nt, seq)

    score = pars.build(build_ops)
    print(f"weighted parsimony score: {score:g} "
          f"(ts={TRANSITION:g}, tv={TRANSVERSION:g})")

    pars.reconstruct(maps.map_nt, rec_ops)
    print("ancestral reconstruction:")
    for node in trav_pre:
        if not node.is_tip():
            anc = pars.ancestral(node.clv_index)
            print(f"  {node.label or node.clv_index:>5}: {anc}")
    for label in sorted(SEQS):
        print(f"  {label:>5}: {SEQS[label]}")


if __name__ == "__main__":
    main()
