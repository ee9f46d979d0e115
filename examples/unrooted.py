"""Full-tree logL on an unrooted tree (reference: examples/newick-fasta-
unrooted/). Usage: python examples/unrooted.py [msa.fa tree.nwk]"""
import sys

sys.path.insert(0, ".")

from libpll2_jax import Partition, TreeEngine, compute_gamma_cats
from libpll2_jax.io import load_fasta, maps
from libpll2_jax.trees import parse_newick, random_alignment, random_utree


def main(msa=None, nwk=None):
    if msa:
        headers, seqs = load_fasta(msa)
        tree = parse_newick(open(nwk).read(), unroot=True)
    else:
        headers, seqs = random_alignment(16, 500, seed=1)
        tree = random_utree(headers, seed=1)

    part = Partition(tree.tip_count, tree.inner_count, 4, len(seqs[0]), 1,
                     tree.edge_count, 4, tree.inner_count)
    by_label = dict(zip(headers, seqs))
    for tip in tree.tips():
        part.set_tip_states(tip.clv_index, maps.map_nt, by_label[tip.label])
    part.set_frequencies(0, [0.25, 0.25, 0.25, 0.25])
    part.set_subst_params(0, [1, 1, 1, 1, 1, 1])          # JC69
    part.set_category_rates(compute_gamma_cats(1.0, 4))

    engine = TreeEngine(part, tree)
    lk = engine.loglikelihood()
    print(f"Log-likelihood: {lk:.6f}")


if __name__ == "__main__":
    main(*sys.argv[1:3])
