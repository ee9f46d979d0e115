"""Model selection on a fixed topology — the ModelTest-NG pattern.

Simulates data under HKY (kappa = 5, skewed frequencies), then fits and
ranks the nested DNA model family by BIC. Expect HKY (or TN93/GTR, which
contain it) to win and JC to rank last.

Usage: python examples/model_selection.py [seed]
"""
import sys
import time

sys.path.insert(0, ".")

from libpll2_jax.modelselect import select_dna_model
from libpll2_jax.trees import random_utree
from libpll2_jax.utils import simulate_alignment


def main(seed=7):
    t0 = time.time()
    tree = random_utree([f"t{i}" for i in range(16)], seed=seed)
    headers, seqs = simulate_alignment(
        tree, 1200, [0.35, 0.15, 0.15, 0.35],
        [1.0, 5.0, 1.0, 1.0, 5.0, 1.0], alpha=0.9, seed=seed)
    rows = select_dna_model(tree, dict(zip(headers, seqs)),
                            criterion="BIC")
    print(f"[{time.time()-t0:5.1f}s] model ranking (BIC):")
    print(f"{'model':6s} {'logL':>12s} {'k':>4s} {'AIC':>12s} "
          f"{'AICc':>12s} {'BIC':>12s}")
    for r in rows:
        print(f"{r['model']:6s} {r['logL']:12.2f} {r['k']:4d} "
              f"{r['AIC']:12.1f} {r['AICc']:12.1f} {r['BIC']:12.1f}")
    best = rows[0]
    print(f"\nselected: {best['model']}  "
          f"(freqs {['%.3f' % f for f in best['freqs']]}, "
          f"rates {['%.2f' % x for x in best['subst']]})")


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 7)
