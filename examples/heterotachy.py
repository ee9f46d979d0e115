"""Per-branch heterotachy: different rate matrices on different branches
(reference: examples/heterotachy — 3 models applied to branch classes of
a 4-taxon unrooted tree).

Two equivalent APIs are shown:
  1. the reference client pattern: one update_prob_matrices call per
     branch class on the step-by-step Partition;
  2. the fused engine: TreeEngine(edge_params=[...]) computes
     every edge's P-matrix from its own model in one program.
"""
import sys

sys.path.insert(0, ".")

import numpy as np

from libpll2_jax import Partition, TreeEngine, compute_gamma_cats
from libpll2_jax.io import maps
from libpll2_jax.trees import create_operations, parse_newick, traverse

NEWICK = "((A:0.2,B:0.3):0.1,(C:0.1,D:0.4):0.2);"
SEQS = {"A": "CTGAGCTGGGGAAGGCTGAACGCTA", "B": "CTGAGCTGGGAAAGACTGAACGCTA",
        "C": "CTGAGCCGGGAGAGGTTGAACGTTA", "D": "CTCAGCCGGGAAAGGTCGAACGTTA"}
MODELS = [  # (freqs, subst) per branch class
    ([0.25, 0.25, 0.25, 0.25], [1, 1, 1, 1, 1, 1]),
    ([0.3, 0.2, 0.2, 0.3], [1, 2, 1, 1, 2, 1]),
    ([0.2, 0.3, 0.3, 0.2], [0.5, 1.3, 2.1, 0.9, 1.7, 1.0]),
]


def main():
    tree = parse_newick(NEWICK, unroot=True)
    sites = len(next(iter(SEQS.values())))
    trav = traverse(tree.vroot)
    ops, branches, pmat_idx = create_operations(trav)
    # branch classes: cycle the three models over pmatrix indices
    edge_params = np.array([m % len(MODELS)
                            for m in range(tree.edge_count)], np.int32)

    def build():
        part = Partition(tree.tip_count, tree.inner_count, 4, sites,
                         len(MODELS), tree.edge_count, 4, tree.inner_count)
        for tip in tree.tips():
            part.set_tip_states(tip.clv_index, maps.map_nt,
                                SEQS[tip.label])
        for m, (freqs, subst) in enumerate(MODELS):
            part.set_frequencies(m, freqs)
            part.set_subst_params(m, subst)
        part.set_category_rates(compute_gamma_cats(1.0, 4))
        return part

    # 1. reference client pattern: one pmatrix call per branch class
    part = build()
    for model in range(len(MODELS)):
        sel = [i for i, m in enumerate(pmat_idx)
               if edge_params[m] == model]
        part.update_prob_matrices([model] * 4, [pmat_idx[i] for i in sel],
                                  [branches[i] for i in sel])
    part.update_partials(ops)
    root = tree.vroot
    rm = int(edge_params[root.pmatrix_index])
    lk_sbs = part.compute_edge_loglikelihood(
        root.clv_index, root.scaler_index, root.back.clv_index,
        root.back.scaler_index, root.pmatrix_index, [rm] * 4)
    print(f"step-by-step heterotachy logL: {lk_sbs:.6f}")

    # 2. fused engine with a per-edge model table
    eng = TreeEngine(build(), tree, edge_params=edge_params, pallas=False)
    lk_eng = eng.loglikelihood()
    print(f"fused-engine  heterotachy logL: {lk_eng:.6f}")
    assert abs(lk_eng - lk_sbs) < 1e-6

    lk_single = TreeEngine(build(), tree, pallas=False).loglikelihood()
    print(f"single-model (model 0)   logL: {lk_single:.6f}")


if __name__ == "__main__":
    main()
