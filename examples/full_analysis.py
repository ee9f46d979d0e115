"""End-to-end phylogenetic analysis — the full pipeline the reference's
consumers (RAxML-NG et al.) build from libpll, composed here entirely from
this framework:

  1. alignment -> pattern compression
  2. parsimony stepwise-addition starting tree (bit-reproducible)
  3. model optimization on the fused fast path (batched central-
     difference Adam over subst+freqs) + all-branches Newton smoothing
     in one dispatch per pass
  4. NNI hill climbing scored from directional CLVs (streamed round)
  5. bootstrap support from ONE evaluation (logL is weight-linear)
  6. checkpoint of the final model + tree

Usage: python examples/full_analysis.py [seed]
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

# persistent compilation cache: the batched-trial optimizer programs are
# large — cache them across runs
from libpll2_jax.utils.compile_cache import enable_compile_cache

enable_compile_cache()

from libpll2_jax import Partition, TreeEngine, checkpoint, compute_gamma_cats
from libpll2_jax.io import maps
from libpll2_jax.io.compress import compress_site_patterns
from libpll2_jax.optimize import (maximize_fused, maximize_loglikelihood,
                                  newton_smooth_all)
from libpll2_jax.parsimony import FastParsimony
from libpll2_jax.parsimony.stepwise import fastparsimony_stepwise
from libpll2_jax.search import TreeSearch
from libpll2_jax.trees import export_newick, random_utree
from libpll2_jax.trees.utree import reset_template_indices
from libpll2_jax.utils import simulate_alignment


def main(seed=42):
    t0 = time.time()
    # --- data (simulated here; swap in load_fasta for real alignments) ---
    true_tree = random_utree([f"t{i}" for i in range(24)], seed=seed)
    headers, seqs = simulate_alignment(true_tree, 1200, [0.3, 0.2, 0.2, 0.3],
                                       [1.2, 3.5, 0.8, 1.1, 3.0, 1.0],
                                       alpha=0.8, seed=seed)
    n = len(headers)

    # --- 1. pattern compression -----------------------------------------
    comp, weights, _ = compress_site_patterns(seqs, maps.map_nt)
    sites = len(comp[0])
    print(f"[{time.time()-t0:5.1f}s] compressed {len(seqs[0])} sites -> "
          f"{sites} patterns")

    # --- 2. parsimony starting tree -------------------------------------
    pars_part = Partition(n, n - 2, 4, sites, 1, 2 * n - 3, 1, n - 2)
    for i, s in enumerate(comp):
        pars_part.set_tip_states(i, maps.map_nt, s)
    pars_part.set_pattern_weights(weights)
    fp = FastParsimony(pars_part)
    tree, cost = fastparsimony_stepwise([fp], headers, seed)
    print(f"[{time.time()-t0:5.1f}s] stepwise tree: parsimony score {cost}")

    # default branch lengths + fresh template indices for likelihood
    seen = set()
    for node in tree.nodes():
        for h in ([node] if node.is_tip() else list(node.ring())):
            if h.back is not None and id(h) not in seen:
                seen.add(id(h)), seen.add(id(h.back))
                h.length = h.back.length = 0.1
    reset_template_indices(tree.vroot, tree.tip_count)

    # --- likelihood partition -------------------------------------------
    part = Partition(n, n - 2, 4, sites, 1, 2 * n - 3, 4, n - 2)
    by_label = dict(zip(headers, comp))
    for tip in tree.tips():
        part.set_tip_states(tip.clv_index, maps.map_nt, by_label[tip.label])
    part.set_pattern_weights(weights)
    part.set_frequencies(0, [0.25] * 4)
    part.set_subst_params(0, [1.0, 1.1, 0.9, 1.05, 0.95, 1.0])
    part.set_category_rates(compute_gamma_cats(1.0, 4))
    eng = TreeEngine(part, tree)
    print(f"[{time.time()-t0:5.1f}s] starting logL: "
          f"{eng.loglikelihood():.4f} (path: {eng.execution_path})")

    # --- 3. model + branch optimization on the fast path ----------------
    if eng.use_fused:
        # subst/freq trials stay on the fused kernel (2n+1 trials per
        # Adam step as ONE batched program); branches via the one-
        # dispatch all-edges Newton sweep. Two alternations converge to
        # the joint optimum; the second reuses every compiled program.
        hist = []
        for _ in range(2):
            lk, params, h = maximize_fused(eng, ("subst", "freqs"),
                                           steps=75, learning_rate=0.05)
            hist += h
            lk = newton_smooth_all(eng, tree, passes=2)
    else:                       # fp64 validation mode: gradient path
        lk, params, hist = maximize_loglikelihood(
            eng, ("branches", "subst", "freqs"), steps=200,
            learning_rate=0.04)
        eng.apply_branches_to_tree(tree)
    print(f"[{time.time()-t0:5.1f}s] after model+brlen optimization: "
          f"{lk:.4f} ({len(hist)} model steps)")

    # --- 4. NNI hill climbing (streamed directional-CLV scoring) --------
    search = TreeSearch(part, tree)
    lk_search, accepted = search.nni_round_streamed()
    print(f"[{time.time()-t0:5.1f}s] after NNI search: {lk_search:.4f} "
          f"({accepted} moves accepted)")

    # re-smooth branches on the final topology
    eng2 = TreeEngine(part, tree)
    lk_final = newton_smooth_all(eng2, tree, passes=2)
    print(f"[{time.time()-t0:5.1f}s] final logL: {lk_final:.4f}")

    # --- 5. bootstrap ------------------------------------------------------
    from libpll2_jax import bootstrap_loglikelihoods
    logls, _ = bootstrap_loglikelihoods(eng2, 1000, seed=seed)
    print(f"[{time.time()-t0:5.1f}s] 1000 bootstrap replicate logLs from "
          f"one eval: mean {logls.mean():.2f} +- {logls.std():.2f}")

    # --- 6. checkpoint ---------------------------------------------------
    checkpoint.save("analysis.ckpt.npz", part, tree, best_logl=lk_final)
    print(f"[{time.time()-t0:5.1f}s] checkpointed -> analysis.ckpt.npz")
    print(export_newick(tree.vroot)[:100], "...")


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 42)
