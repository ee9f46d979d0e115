"""Newton-Raphson branch-length optimization via the two-phase derivative
engine (reference: examples/newton/)."""
import sys

sys.path.insert(0, ".")

from libpll2_jax import Partition, TreeEngine, compute_gamma_cats
from libpll2_jax.io import maps
from libpll2_jax.trees import random_utree
from libpll2_jax.utils import simulate_alignment


def main():
    tree = random_utree([f"t{i}" for i in range(12)], seed=4)
    headers, seqs = simulate_alignment(tree, 800, [0.25] * 4,
                                       [1, 2, 1, 1, 2, 1], alpha=0.9,
                                       seed=4)
    part = Partition(tree.tip_count, tree.inner_count, 4, 800, 1,
                     tree.edge_count, 4, tree.inner_count)
    by_label = dict(zip(headers, seqs))
    for tip in tree.tips():
        part.set_tip_states(tip.clv_index, maps.map_nt, by_label[tip.label])
    part.set_frequencies(0, [0.25] * 4)
    part.set_subst_params(0, [1, 2, 1, 1, 2, 1])
    part.set_category_rates(compute_gamma_cats(0.9, 4))

    engine = TreeEngine(part, tree)
    for it in range(10):
        lk, d1, d2 = engine.newton_step()
        print(f"iter {it}: logL={lk:.6f}  d1={d1:+.4e}  d2={d2:+.4e}")
        if abs(d1) < 1e-6:
            break


if __name__ == "__main__":
    main()
