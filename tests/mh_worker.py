"""Multi-process worker for test_multihost.py — NOT a test module.

Each invocation is one process of an N-process run:

    python mh_worker.py <process_id> <n_processes> <port> <devices_per_proc>

It wires itself into the process group via libpll2_jax.parallel.multihost,
builds its column block of a DETERMINISTIC global problem (seeded alignment
+ ladder tree, identical in every process), assembles the global sharded
partition, and prints one JSON line with logL / d1 / d2 from the single
SPMD TreeEngine program. test_multihost.py asserts the line is identical
across 1-process-8-device and 2-process-4-device runs (the reference's MPI
process-invariance property, SURVEY §2.3)."""
import json
import os
import sys

N_TAXA = 12
N_SITES = 256


def build_global_problem():
    """Deterministic (seed 7) DNA alignment + ladder newick, identical in
    every process."""
    import numpy as np
    rng = np.random.default_rng(7)
    seqs = ["".join(rng.choice(list("ACGT"), size=N_SITES))
            for _ in range(N_TAXA)]
    labels = [f"t{i}" for i in range(N_TAXA)]
    lens = rng.uniform(0.02, 0.4, size=2 * N_TAXA)
    tree = f"{labels[0]}:{lens[0]:.6f}"
    for i in range(1, N_TAXA):
        tree = f"({tree},{labels[i]}:{lens[i]:.6f}):{lens[N_TAXA + i]:.6f}"
    # unrooted trifurcation at the top is not required; parse_newick
    # handles the rooted form and the engine evaluates the virtual root
    newick = f"({tree},{labels[0]}x:0.1);".replace(
        f"{labels[0]}x", "outg")
    seqs.append("".join(rng.choice(list("ACGT"), size=N_SITES)))
    labels.append("outg")
    subst = rng.uniform(0.3, 2.5, size=6)
    freqs = rng.dirichlet(np.ones(4) * 20)
    return labels, seqs, newick, subst, freqs


def main():
    pid, nproc, port, dev = (int(sys.argv[1]), int(sys.argv[2]),
                             sys.argv[3], int(sys.argv[4]))
    os.environ["XLA_FLAGS"] = (
        f"--xla_force_host_platform_device_count={dev}")
    os.environ["JAX_ENABLE_X64"] = "true"
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

    from libpll2_jax.parallel import multihost
    multihost.initialize(coordinator_address=f"127.0.0.1:{port}",
                         num_processes=nproc, process_id=pid,
                         platform="cpu")
    import jax
    jax.config.update("jax_enable_x64", True)
    import numpy as np

    from libpll2_jax import Partition, TreeEngine, compute_gamma_cats
    from libpll2_jax.io import maps
    from libpll2_jax.parallel import shard_partition
    from libpll2_jax.trees import parse_newick

    labels, seqs, newick, subst, freqs = build_global_problem()
    tree = parse_newick(newick, unroot=True)
    lo, hi = multihost.process_site_block(N_SITES)
    mesh = multihost.global_mesh()
    assert len(mesh.devices.flat) == 8, "expected 8 global devices"

    part = Partition(tree.tip_count, tree.inner_count, 4, hi - lo, 1,
                     tree.edge_count, 4, tree.inner_count,
                     sites_alignment=multihost.owned(mesh))
    by_label = dict(zip(labels, seqs))
    for tip in tree.tips():
        part.set_tip_states(tip.clv_index, maps.map_nt,
                            by_label[tip.label][lo:hi])
    part.set_frequencies(0, freqs)
    part.set_subst_params(0, subst)
    part.set_category_rates(compute_gamma_cats(0.6, 4))
    shard_partition(part, mesh)

    eng = TreeEngine(part, tree)
    lk = eng.loglikelihood()
    lk2, d1, d2 = eng.newton_step()

    # multi-process PER-RATE SCALERS (widened multihost matrix): same
    # global problem with rate_scalers=True — the [K+2, R, S] scaler
    # layout shards on its trailing site axis; psums unchanged
    # (reference core_partials.c:760 per-rate semantics under MPI).
    part_prs = Partition(tree.tip_count, tree.inner_count, 4, hi - lo, 1,
                         tree.edge_count, 4, tree.inner_count,
                         rate_scalers=True,
                         sites_alignment=multihost.owned(mesh))
    for tip in tree.tips():
        part_prs.set_tip_states(tip.clv_index, maps.map_nt,
                                by_label[tip.label][lo:hi])
    part_prs.set_frequencies(0, freqs)
    part_prs.set_subst_params(0, subst)
    part_prs.set_category_rates(compute_gamma_cats(0.6, 4))
    shard_partition(part_prs, mesh)
    eng_prs = TreeEngine(part_prs, tree)
    lk_prs, d1_prs, d2_prs = eng_prs.newton_step()

    # multi-process SITE REPEATS: dense-fused
    # sharded repeats — per-device pooled partitions with LOCAL class
    # tables, fused-kernel evaluation, logL/d1/d2 psums. Each process
    # builds one partition per device it owns over that device's column
    # slice of the same global alignment.
    import jax.numpy as jnp

    from libpll2_jax.parallel import ShardedRepeatsEngine
    from libpll2_jax.parallel.sharding import owned_shards

    n_local = owned_shards(mesh)
    n_global = len(mesh.devices.flat)
    w = N_SITES // n_global
    first = pid * n_local
    parts = []
    for k in range(n_local):
        gdev = first + k
        p = Partition(tree.tip_count, tree.inner_count, 4, w, 1,
                      tree.edge_count, 4, tree.inner_count,
                      site_repeats=True, dtype=jnp.float32)
        for tip in tree.tips():
            p.set_tip_states(tip.clv_index, maps.map_nt,
                             by_label[tip.label][gdev * w:(gdev + 1) * w])
        p.set_frequencies(0, freqs)
        p.set_subst_params(0, subst)
        p.set_category_rates(compute_gamma_cats(0.6, 4))
        parts.append(p)
    eng_r = ShardedRepeatsEngine(tree, parts, mesh, interpret=True)
    assert eng_r.dense_fused
    lk_r, d1_r, d2_r = eng_r.newton_step()

    # multi-PROCESS repeats topology search: one batched SPR round over
    # the 2-process sharded repeats engine (SPMD candidate dispatch +
    # psum; winner applied identically per rank)
    from libpll2_jax.search import TreeSearch as _TS
    s_rep = _TS(None, tree, engine=eng_r)
    lk_rs, acc_rs = s_rep.spr_round_batched(radius=2)

    # multi-process STREAMED SPR round: the schedule
    # build is deterministic host work replicated per rank; the scoring
    # body runs per shard with ONE psum of the per-candidate logL sums.
    # Candidate scores must be bit-identical across process counts.
    from libpll2_jax.ops import spr_stream
    from libpll2_jax.search import TreeSearch

    s = TreeSearch(None, tree, engine=eng)
    assert s._streamed_eligible(), \
        "multi-process mesh must not disqualify the streamed path"
    groups = [(pr, spr_stream.enumerate_targets(pr, 3))
              for pr in _stream_edges(tree)]
    scheds = s._stream_schedules(spr_stream.build_spr_stream, tree,
                                 groups)
    sched = next(iter(scheds.values()))
    scores = s._summed_spr_scores(scheds, 64)
    stream_scores = [float(x) for x in scores[:4]]
    stream_sum = float(scores.sum())
    # and the full round driver end to end (winner verification + move
    # application replicated per rank)
    best_stream, acc_stream = s.spr_round_streamed(radius=3)

    # multi-process PARTITIONED analysis: two
    # site-sharded partitions over the same mesh, joint linked Newton
    # (summed d1/d2, one update applied to every engine) — the
    # consumers' MPI partitioned layout, process-count invariant
    from libpll2_jax.partitioned import PartitionedEngine
    rng2 = np.random.default_rng(21)
    seqs2 = ["".join(rng2.choice(list("ACGT"), size=N_SITES))
             for _ in range(len(labels))]
    by2 = dict(zip(labels, seqs2))
    part_b = Partition(tree.tip_count, tree.inner_count, 4, hi - lo, 1,
                       tree.edge_count, 4, tree.inner_count,
                       sites_alignment=multihost.owned(mesh))
    for tip in tree.tips():
        part_b.set_tip_states(tip.clv_index, maps.map_nt,
                              by2[tip.label][lo:hi])
    part_b.set_frequencies(0, [0.3, 0.2, 0.2, 0.3])
    part_b.set_subst_params(0, [1, 2, 1, 1, 2, 1.0])
    part_b.set_category_rates(compute_gamma_cats(0.9, 4))
    shard_partition(part_b, mesh)
    pe = PartitionedEngine([part, part_b], tree, linked=True)
    lk_pe, d1_pe, d2_pe = pe.newton_step()

    print(json.dumps({"pid": pid, "nproc": nproc, "lk": lk,
                      "lk_pe": lk_pe, "d1_pe": d1_pe, "d2_pe": d2_pe,
                      "lk2": lk2, "d1": d1, "d2": d2,
                      "lk_prs": lk_prs, "d1_prs": d1_prs, "d2_prs": d2_prs,
                      "lk_rep": lk_r, "d1_rep": d1_r, "d2_rep": d2_r,
                      "lk_rep_spr": lk_rs, "acc_rep_spr": acc_rs,
                      "stream_scores": stream_scores,
                      "stream_sum": stream_sum,
                      "stream_n": int(sched.n_candidates),
                      "stream_best": best_stream,
                      "stream_acc": acc_stream}),
          flush=True)


def _stream_edges(tree):
    from libpll2_jax.search import _internal_edges
    return list(_internal_edges(tree))


if __name__ == "__main__":
    main()
