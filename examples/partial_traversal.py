"""Partial traversals: after a local change, recompute only invalidated
CLVs (reference: examples/../test/src/partial-traversal.c; the SPR inner
loop of SURVEY call stack 3.4).

A callback-pruned traversal emits operations only for nodes whose subtree
contains the changed edge; the resulting logL matches a full recompute.
"""
import sys

sys.path.insert(0, ".")

from libpll2_jax import Partition, compute_gamma_cats
from libpll2_jax.io import maps
from libpll2_jax.trees import create_operations, random_utree, traverse
from libpll2_jax.utils import simulate_alignment


def main():
    tree = random_utree([f"t{i}" for i in range(24)], seed=11)
    headers, seqs = simulate_alignment(tree, 500, [0.25] * 4,
                                       [1, 2, 1, 1, 2, 1], alpha=0.9,
                                       seed=11)
    part = Partition(tree.tip_count, tree.inner_count, 4, 500, 1,
                     tree.edge_count, 4, tree.inner_count)
    by = dict(zip(headers, seqs))
    for t in tree.tips():
        part.set_tip_states(t.clv_index, maps.map_nt, by[t.label])
    part.set_frequencies(0, [0.25] * 4)
    part.set_subst_params(0, [1, 2, 1, 1, 2, 1])
    part.set_category_rates(compute_gamma_cats(0.9, 4))

    trav = traverse(tree.vroot)
    ops, branches, pmat_idx = create_operations(trav)
    pidx = [0] * 4
    part.update_prob_matrices(pidx, pmat_idx, branches)
    part.update_partials(ops)
    root = tree.vroot
    args = (root.clv_index, root.scaler_index, root.back.clv_index,
            root.back.scaler_index, root.pmatrix_index, pidx)
    print(f"full traversal ({len(ops)} ops): "
          f"logL = {part.compute_edge_loglikelihood(*args):.6f}")

    # change one inner branch length
    edge = next(h for nd in tree.nodes() if not nd.is_tip()
                for h in nd.ring()
                if h.back is not None and not h.back.is_tip()
                and h is not root and h.back is not root)
    edge.length = edge.back.length = edge.length * 2 + 0.05
    part.update_prob_matrices(pidx, [edge.pmatrix_index], [edge.length])

    # partial traversal: prune subtrees that do not contain the edge
    dirty = {id(x) for x in edge.ring()}

    def contains_dirty(node):
        if id(node) in dirty or (not node.is_tip() and any(
                id(x) in dirty for x in node.ring())):
            return True
        if node.is_tip():
            return False
        return any(contains_dirty(h.back) for h in list(node.ring())[1:])

    ptrav = traverse(root, cbtrav=contains_dirty)
    pops, _, _ = create_operations(ptrav)
    part.update_partials(pops)
    print(f"partial traversal ({len(pops)} ops): "
          f"logL = {part.compute_edge_loglikelihood(*args):.6f}")

    part.update_partials(ops)       # cross-check with a full recompute
    print(f"full recompute check:    "
          f"logL = {part.compute_edge_loglikelihood(*args):.6f}")


if __name__ == "__main__":
    main()
