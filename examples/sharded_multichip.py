"""Site-sharded SPMD evaluation over a device mesh (the multi-chip path;
reference consumers do this with MPI ranks — here it is one jitted SPMD
program with psum reductions over ICI).

Run on any host: JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8
gives a virtual 8-device mesh."""
import sys

sys.path.insert(0, ".")

import jax

from libpll2_jax import Partition, TreeEngine, compute_gamma_cats
from libpll2_jax.io import maps
from libpll2_jax.parallel import make_mesh, shard_partition
from libpll2_jax.trees import random_utree
from libpll2_jax.utils import simulate_alignment


def main():
    n_dev = len(jax.devices())
    print(f"devices: {n_dev} x {jax.devices()[0].device_kind}")
    mesh = make_mesh()

    tree = random_utree([f"t{i}" for i in range(16)], seed=2)
    sites = 1024 * n_dev
    headers, seqs = simulate_alignment(tree, sites, [0.25] * 4,
                                       [1, 2, 1, 1, 2, 1], alpha=0.9,
                                       seed=2)
    part = Partition(tree.tip_count, tree.inner_count, 4, sites, 1,
                     tree.edge_count, 4, tree.inner_count,
                     sites_alignment=n_dev)
    by_label = dict(zip(headers, seqs))
    for tip in tree.tips():
        part.set_tip_states(tip.clv_index, maps.map_nt, by_label[tip.label])
    part.set_frequencies(0, [0.25] * 4)
    part.set_subst_params(0, [1, 2, 1, 1, 2, 1])
    part.set_category_rates(compute_gamma_cats(0.9, 4))

    shard_partition(part, mesh)            # CLVs sharded on the site axis
    engine = TreeEngine(part, tree)
    print(f"sharded logL: {engine.loglikelihood():.6f}")
    lk, d1, d2 = engine.newton_step()
    print(f"newton step:  logL={lk:.6f} d1={d1:+.3e} d2={d2:+.3e}")


if __name__ == "__main__":
    main()
