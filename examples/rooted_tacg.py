"""State-order-agnostic tip CLVs (reference: examples/rooted-tacg/
rooted-tacg.c): encode the tip likelihood vectors in T,A,C,G order —
instead of the standard A,C,G,T — by permuting the frequencies and the
substitution parameters consistently. The engine never sees character
codes on this path (`set_tip_clv` takes raw probabilities), so ANY state
ordering works as long as every model input uses the same one.

The script computes the rooted log-likelihood twice — TACG CLVs with
TACG-ordered model vs standard `set_tip_states` with ACGT — and shows
they agree to machine precision.
"""
import sys

sys.path.insert(0, ".")

import numpy as np

from libpll2_jax import Partition, compute_gamma_cats
from libpll2_jax.io import maps
from libpll2_jax.trees import parse_newick_rooted, rtree

NEWICK = "((A:0.1,B:0.2):0.1,(C:0.1,(D:0.1,E:0.1):0.2):0.15);"
# degenerate characters exercise the mask decoding both ways
SEQS = {"A": "WAAAAB", "B": "CACACD", "C": "AGGACA",
        "D": "CGTAGT", "E": "CGAATT"}

FREQS_ACGT = np.array([0.17, 0.19, 0.25, 0.39])
PARAMS_ACGT = np.array([1.0, 4.5, 1.3, 0.9, 5.2, 1.0])  # AC AG AT CG CT GT
ACGT = "ACGT"
PERM_TACG = [3, 0, 1, 2]                # position k of TACG = ACGT[perm[k]]


def permute_model(freqs, params, perm):
    """Reorder frequencies + upper-triangle exchangeabilities to `perm`."""
    n = len(freqs)
    rate = np.zeros((n, n))
    k = 0
    for i in range(n):
        for j in range(i + 1, n):
            rate[i, j] = rate[j, i] = params[k]
            k += 1
    rate_p = rate[np.ix_(perm, perm)]
    params_p = [rate_p[i, j] for i in range(n) for j in range(i + 1, n)]
    return np.asarray(freqs)[perm], np.asarray(params_p)


def encode(seq, perm):
    """Character -> 0/1 likelihood rows in the permuted state order."""
    out = np.zeros((len(seq), 4))
    for s, ch in enumerate(seq):
        mask = maps.map_nt[ord(ch)]          # ACGT bit mask (bit i = ACGT[i])
        for k, src in enumerate(perm):
            out[s, k] = (mask >> src) & 1
    return out


def evaluate(order_name, perm, use_tip_states):
    tree = parse_newick_rooted(NEWICK)
    trav = rtree.traverse(tree.root)
    ops, branches, pmat_idx = rtree.create_operations(trav)
    sites = len(next(iter(SEQS.values())))

    part = Partition(tree.tip_count, tree.inner_count, 4, sites, 1,
                     len(branches), 4, tree.inner_count)
    freqs, params = permute_model(FREQS_ACGT, PARAMS_ACGT, perm)
    for t in tree.tips():
        if use_tip_states:
            part.set_tip_states(t.clv_index, maps.map_nt, SEQS[t.label])
        else:
            part.set_tip_clv(t.clv_index, encode(SEQS[t.label], perm))
    part.set_frequencies(0, freqs)
    part.set_subst_params(0, params)
    part.set_category_rates(compute_gamma_cats(1.0, 4))
    pidx = [0] * 4
    part.update_prob_matrices(pidx, pmat_idx, branches)
    part.update_partials(ops)
    r = tree.root
    logl, _ = part.compute_root_loglikelihood(r.clv_index, r.scaler_index,
                                              pidx, persite=True)
    order = "".join(ACGT[i] for i in perm)
    print(f"{order_name:28s} (state order {order}): logL = {logl:.10f}")
    return logl


def main():
    l_std = evaluate("standard set_tip_states", [0, 1, 2, 3], True)
    l_tacg = evaluate("custom set_tip_clv", PERM_TACG, False)
    assert abs(l_std - l_tacg) < 1e-9 * abs(l_std)
    print("identical — the kernels are state-order agnostic")


if __name__ == "__main__":
    main()
