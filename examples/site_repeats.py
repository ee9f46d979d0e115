"""Site repeats: identical logL, less work (reference: the fork's headline
feature). Prints the per-node class compression achieved on simulated
data."""
import sys

sys.path.insert(0, ".")

from libpll2_jax import Partition, compute_gamma_cats
from libpll2_jax.io import maps
from libpll2_jax.trees import create_operations, random_utree, traverse
from libpll2_jax.utils import simulate_alignment


def build(tree, headers, seqs, repeats):
    part = Partition(tree.tip_count, tree.inner_count, 4, len(seqs[0]), 1,
                     tree.edge_count, 4, tree.inner_count,
                     site_repeats=repeats)
    by_label = dict(zip(headers, seqs))
    for tip in tree.tips():
        part.set_tip_states(tip.clv_index, maps.map_nt, by_label[tip.label])
    part.set_frequencies(0, [0.25] * 4)
    part.set_subst_params(0, [1, 2, 1, 1, 2, 1])
    part.set_category_rates(compute_gamma_cats(0.9, 4))
    return part


def evaluate(part, tree):
    trav = traverse(tree.vroot)
    ops, branches, pmat_idx = create_operations(trav)
    part.update_prob_matrices([0] * 4, pmat_idx, branches)
    part.update_partials(ops)
    root = tree.vroot
    return part.compute_edge_loglikelihood(
        root.clv_index, root.scaler_index, root.back.clv_index,
        root.back.scaler_index, root.pmatrix_index, [0] * 4), ops


def main():
    tree = random_utree([f"t{i}" for i in range(64)], seed=5)
    headers, seqs = simulate_alignment(tree, 2000, [0.25] * 4,
                                       [1, 2, 1, 1, 2, 1], alpha=0.9,
                                       seed=5)
    lk_plain, ops = evaluate(build(tree, headers, seqs, False), tree)
    part = build(tree, headers, seqs, True)
    lk_rep, _ = evaluate(part, tree)
    total = sum(part.repeats.classes(o.parent_clv_index) for o in ops)
    print(f"plain logL:   {lk_plain:.6f}")
    print(f"repeats logL: {lk_rep:.6f}")
    print(f"class columns computed: {total} of {len(ops) * 2000} "
          f"({100 * total / (len(ops) * 2000):.1f}% of plain work)")


if __name__ == "__main__":
    main()
