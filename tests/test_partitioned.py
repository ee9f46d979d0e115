"""Multi-partition analyses: summed logL equals the per-partition sum, and
the linked Newton step uses joint derivatives (the consumers'
multi-partition pattern)."""
import numpy as np

from libpll2_jax import Partition, TreeEngine, compute_gamma_cats
from libpll2_jax.io import maps
from libpll2_jax.partitioned import PartitionedEngine
from libpll2_jax.trees import random_utree
from libpll2_jax.utils import simulate_alignment

FREQS = [0.3, 0.2, 0.2, 0.3]
SUBST = [1, 2.2, 0.8, 1.1, 2.6, 1]


def _parts(tree, n_parts=3):
    out = []
    for k in range(n_parts):
        headers, seqs = simulate_alignment(tree, 200 + 50 * k, [0.25] * 4,
                                           [1, 2, 1, 1, 2, 1], alpha=0.9,
                                           seed=60 + k)
        part = Partition(tree.tip_count, tree.inner_count, 4,
                         len(seqs[0]), 1, tree.edge_count, 4,
                         tree.inner_count)
        by = dict(zip(headers, seqs))
        for tip in tree.tips():
            part.set_tip_states(tip.clv_index, maps.map_nt, by[tip.label])
        part.set_frequencies(0, [0.25] * 4)
        part.set_subst_params(0, [1, 2, 1, 1, 2, 1])
        part.set_category_rates(compute_gamma_cats(0.9, 4))
        out.append(part)
    return out


def test_partitioned_logl_is_sum():
    tree = random_utree([f"t{i}" for i in range(10)], seed=61)
    parts = _parts(tree)
    pe = PartitionedEngine(parts, tree)
    expected = sum(TreeEngine(p, tree).loglikelihood() for p in _parts(tree))
    np.testing.assert_allclose(pe.loglikelihood(), expected, rtol=1e-12)


def test_partitioned_linked_newton_improves():
    tree = random_utree([f"t{i}" for i in range(10)], seed=61)
    pe = PartitionedEngine(_parts(tree), tree, linked=True)
    lk0, d1, d2 = pe.newton_step()
    for _ in range(8):
        lk, d1, d2 = pe.newton_step()
    assert lk >= lk0 - 1e-9
    assert abs(d1) < 1e-2
    # linked: every engine carries the same root branch length
    lens = {float(e.branches[int(e.root_idx[4])]) for e in pe.engines}
    assert len(lens) == 1


def test_partitioned_joint_maximize_matches_concatenated():
    """Joint optimization with linked branches and ONE shared model must
    find the same optimum as optimizing the concatenated alignment as a
    single partition (the objectives are mathematically identical)."""
    from libpll2_jax.optimize import maximize_loglikelihood

    tree = random_utree([f"t{i}" for i in range(10)], seed=71)
    h1, s1 = simulate_alignment(tree, 300, FREQS, SUBST, alpha=0.9,
                                seed=71)
    h2, s2 = simulate_alignment(tree, 200, FREQS, SUBST, alpha=0.9,
                                seed=72)

    def build(seqs_by_label, sites):
        part = Partition(tree.tip_count, tree.inner_count, 4, sites, 1,
                         tree.edge_count, 4, tree.inner_count)
        for t in tree.tips():
            part.set_tip_states(t.clv_index, maps.map_nt,
                                seqs_by_label[t.label])
        part.set_frequencies(0, FREQS)
        part.set_subst_params(0, SUBST)
        part.set_category_rates(compute_gamma_cats(0.9, 4))
        return part

    by1, by2 = dict(zip(h1, s1)), dict(zip(h2, s2))
    pe = PartitionedEngine([build(by1, 300), build(by2, 200)], tree,
                           linked=True, pallas=False)
    lk0 = pe.loglikelihood()
    fn, params = pe.make_joint_loglikelihood_fn(("branches",))
    np.testing.assert_allclose(float(fn(params)), lk0, rtol=1e-10)

    final, best, hist = pe.maximize(("branches",), steps=120,
                                    learning_rate=0.05)
    assert final > lk0 + 1.0
    # every engine carries the SAME (linked) optimized branch lengths
    b0 = np.asarray(pe.engines[0].branches)
    b1 = np.asarray(pe.engines[1].branches)
    np.testing.assert_allclose(b0, b1, rtol=1e-12)
    np.testing.assert_allclose(pe.loglikelihood(), final, rtol=1e-9)

    # concatenated single-partition reference optimum
    cat = {k: by1[k] + by2[k] for k in by1}
    part_c = build(cat, 500)
    eng_c = TreeEngine(part_c, tree, pallas=False)
    final_c, _, _ = maximize_loglikelihood(eng_c, ("branches",),
                                           steps=120, learning_rate=0.05)
    np.testing.assert_allclose(final, final_c, rtol=1e-6)


def test_partitioned_per_partition_models():
    """Per-partition subst/freqs optimize independently while branches
    stay linked; the joint objective improves and applies back."""
    tree = random_utree([f"t{i}" for i in range(8)], seed=81)
    h1, s1 = simulate_alignment(tree, 256, [0.4, 0.1, 0.1, 0.4],
                                [1, 4, 1, 1, 4, 1], alpha=0.9, seed=81)
    h2, s2 = simulate_alignment(tree, 256, [0.1, 0.4, 0.4, 0.1],
                                [2, 1, 2, 2, 1, 2], alpha=0.9, seed=82)

    def build(h, s):
        by = dict(zip(h, s))
        part = Partition(tree.tip_count, tree.inner_count, 4, 256, 1,
                         tree.edge_count, 4, tree.inner_count)
        for t in tree.tips():
            part.set_tip_states(t.clv_index, maps.map_nt, by[t.label])
        part.set_frequencies(0, [0.25] * 4)
        part.set_subst_params(0, [1, 1.2, 0.9, 1.1, 1.3, 1.0])
        part.set_category_rates(compute_gamma_cats(0.9, 4))
        return part

    pe = PartitionedEngine([build(h1, s1), build(h2, s2)], tree,
                           linked=True, pallas=False)
    lk0 = pe.loglikelihood()
    final, best, _ = pe.maximize(("branches", "subst", "freqs"),
                                 steps=150, learning_rate=0.05)
    assert final > lk0 + 5.0
    # models diverged toward their partitions' truths
    f0 = pe.engines[0].partition.frequencies[0]
    f1 = pe.engines[1].partition.frequencies[0]
    assert f0[0] > f0[1] and f1[1] > f1[0]
    np.testing.assert_allclose(pe.loglikelihood(), final, rtol=1e-9)


def test_partitioned_topology_search():
    """Multi-partition topology search: TreeSearch driven by a
    PartitionedEngine sums candidate scores across partitions (the
    consumers' partitioned-search pattern) and recovers likelihood lost
    to topology perturbation; the summed score of every candidate equals
    the sum of per-partition evaluations."""
    import numpy as np

    from libpll2_jax import constants as C
    from libpll2_jax.search import TreeSearch, _internal_edges
    from libpll2_jax.trees import moves

    tree = random_utree([f"t{i}" for i in range(10)], seed=77)
    parts = _parts(tree, n_parts=2)
    rng = np.random.default_rng(3)
    for _ in range(3):
        edges = _internal_edges(tree)
        moves.nni(edges[rng.integers(len(edges))],
                  C.UTREE_MOVE_NNI_LEFT, None)
    pe = PartitionedEngine(parts, tree, linked=True)
    lk0 = pe.loglikelihood()
    search = TreeSearch(None, tree, engine=pe)
    lk, acc = search.nni_round_batched()
    assert acc >= 1 and lk > lk0 + 0.5
    # the accepted candidate's summed score equals the refreshed
    # per-engine sum on the new topology
    np.testing.assert_allclose(lk, search.evaluate(), rtol=1e-9)
    np.testing.assert_allclose(
        lk, sum(e.loglikelihood() for e in pe.engines), rtol=1e-9)
    lk2, acc2 = search.spr_round_batched(radius=3)
    assert lk2 >= lk - 1e-6


def test_partitioned_engine_on_mesh():
    """PartitionedEngine over a device mesh:
    every partition's site axis sharded over 8 virtual devices
    (PartitionedEngine.shard), per-partition psums, host-side
    cross-partition sums. logL and the joint linked Newton step must be
    shard-count invariant; widths include a 520-site partition whose
    65-column shards are NOT lane-aligned (internal kernel padding)."""
    import jax.numpy as jnp
    from libpll2_jax.parallel import make_mesh

    tree = random_utree([f"t{i}" for i in range(12)], seed=3)
    cfgs = [(1000, [1, 2.2, 0.8, 1.1, 2.6, 1]),
            (520, [1, 1.5, 1, 1, 1.5, 1])]

    def build(mesh=None):
        parts = []
        for k, (sites, subst) in enumerate(cfgs):
            headers, seqs = simulate_alignment(tree, sites, FREQS, subst,
                                               alpha=0.8, seed=50 + k)
            by = dict(zip(headers, seqs))
            p = Partition(tree.tip_count, tree.inner_count, 4, sites, 1,
                          tree.edge_count, 4, tree.inner_count,
                          dtype=jnp.float32,
                          sites_alignment=(mesh.devices.size
                                           if mesh else 1))
            for t in tree.tips():
                p.set_tip_states(t.clv_index, maps.map_nt, by[t.label])
            p.set_frequencies(0, FREQS)
            p.set_subst_params(0, subst)
            p.set_category_rates(compute_gamma_cats(0.8, 4))
            parts.append(p)
        if mesh is not None:
            PartitionedEngine.shard(parts, mesh)
        return parts

    pe0 = PartitionedEngine(build(), tree, pallas="interpret")
    lk0 = pe0.loglikelihood()
    n0 = pe0.newton_step()

    pe = PartitionedEngine(build(make_mesh(8)), tree, pallas="interpret")
    for e in pe.engines:
        assert e.use_fused and e.fused_mesh is not None, e.execution_path
    np.testing.assert_allclose(pe.loglikelihood(), lk0, rtol=2e-6)
    n1 = pe.newton_step()
    np.testing.assert_allclose(n1[0], n0[0], rtol=2e-6)
    np.testing.assert_allclose(n1[1], n0[1], rtol=1e-3, atol=1e-3)
    # linked update applied identically across sharded engines
    lens = {float(e.branches[int(e.root_idx[4])]) for e in pe.engines}
    assert len(lens) == 1


def test_partitioned_maximize_fused_routing():
    """PartitionedEngine.maximize on Pallas engines routes model groups
    to the per-partition fused FD optimizer (exact decomposition at
    fixed branches) and rejects 'branches' with a clear error."""
    import jax.numpy as jnp
    import pytest
    from libpll2_jax import constants as C

    tree = random_utree([f"t{i}" for i in range(10)], seed=61)

    def build():
        parts = []
        for k in range(2):
            headers, seqs = simulate_alignment(
                tree, 300, FREQS, SUBST, alpha=0.9, seed=70 + k)
            by = dict(zip(headers, seqs))
            p = Partition(tree.tip_count, tree.inner_count, 4, 300, 1,
                          tree.edge_count, 4, tree.inner_count,
                          dtype=jnp.float32)
            for t in tree.tips():
                p.set_tip_states(t.clv_index, maps.map_nt, by[t.label])
            p.set_frequencies(0, [0.25] * 4)
            p.set_subst_params(0, [1, 1.1, 0.9, 1.05, 0.95, 1])
            p.set_category_rates(compute_gamma_cats(0.9, 4))
            parts.append(p)
        return parts

    pe = PartitionedEngine(build(), tree, pallas="interpret")
    assert all(e.use_fused for e in pe.engines)
    lk0 = pe.loglikelihood()
    with pytest.raises(C.PllError):
        pe.maximize(("branches",))
    lk, params, hist = pe.maximize(("subst", "freqs"), steps=120,
                                   learning_rate=0.05)
    assert lk > lk0 + 1.0
    assert "p0:log_subst" in params and "p1:freq_logits" in params
    # reported optimum reproduces through the engines (fp32 noise)
    assert abs(pe.loglikelihood() - lk) < 5e-2


def test_partitioned_streamed_rounds_match_batched():
    """Streamed SPR/NNI rounds driven by a linked PartitionedEngine sum
    per-partition directional-CLV scores (one schedule, one scoring
    program per partition signature); the rounds must accept the same
    moves at the same summed logL as the batched full-traversal
    partitioned rounds."""
    from libpll2_jax import constants as C
    from libpll2_jax.search import TreeSearch, _internal_edges
    from libpll2_jax.trees import moves

    def perturbed():
        tree = random_utree([f"t{i}" for i in range(10)], seed=77)
        parts = _parts(tree, n_parts=2)
        rng = np.random.default_rng(3)
        for _ in range(3):
            edges = _internal_edges(tree)
            moves.nni(edges[rng.integers(len(edges))],
                      C.UTREE_MOVE_NNI_LEFT, None)
        return parts, tree

    parts, tree = perturbed()
    s1 = TreeSearch(None, tree,
                    engine=PartitionedEngine(parts, tree, linked=True))
    s1.evaluate()
    assert s1._streamed_eligible()
    n1, an1 = s1.nni_round_streamed()
    b1, a1 = s1.spr_round_streamed(radius=3)

    parts2, tree2 = perturbed()
    s2 = TreeSearch(None, tree2,
                    engine=PartitionedEngine(parts2, tree2, linked=True))
    n2, an2 = s2.nni_round_batched()
    b2, a2 = s2.spr_round_batched(radius=3)
    assert (an1, a1) == (an2, a2)
    np.testing.assert_allclose(n1, n2, rtol=1e-9)
    np.testing.assert_allclose(b1, b2, rtol=1e-9)

    # unlinked engines stream too: candidate scoring always evaluates
    # the TREE's branch lengths (exactly like the batched path, whose
    # set_topology resets engine branches from the tree per candidate);
    # `linked` only changes how Newton updates apply
    parts3, tree3 = perturbed()
    s3 = TreeSearch(None, tree3,
                    engine=PartitionedEngine(parts3, tree3, linked=False))
    s3.evaluate()
    assert s3._streamed_eligible()
    b3, a3 = s3.spr_round_streamed(radius=3)
    parts4, tree4 = perturbed()
    s4 = TreeSearch(None, tree4,
                    engine=PartitionedEngine(parts4, tree4, linked=False))
    b4, a4 = s4.spr_round_batched(radius=3)
    assert a3 == a4
    np.testing.assert_allclose(b3, b4, rtol=1e-9)


def test_partitioned_streamed_mixed_signatures():
    """Partitions with MISMATCHED buffer signatures (extra pmatrix
    slots / scaler rows — the reference consumers' multi-partition sum
    has no shape restriction, stepwise.c:337-346) stream via one
    schedule per distinct signature built from the same deterministic
    enumeration; round parity with the batched rounds holds."""
    from libpll2_jax import constants as C
    from libpll2_jax.search import TreeSearch, _internal_edges
    from libpll2_jax.trees import moves

    def build(tree, k, extra_pm=0, extra_sc=0):
        headers, seqs = simulate_alignment(
            tree, 128, [0.25] * 4, [1, 2, 1, 1, 2, 1], alpha=0.9,
            seed=80 + k)
        part = Partition(tree.tip_count, tree.inner_count, 4, 128, 1,
                         tree.edge_count + extra_pm, 4,
                         tree.inner_count + extra_sc)
        by = dict(zip(headers, seqs))
        for tip in tree.tips():
            part.set_tip_states(tip.clv_index, maps.map_nt,
                                by[tip.label])
        part.set_frequencies(0, [0.25] * 4)
        part.set_subst_params(0, [1, 2, 1, 1, 2, 1])
        part.set_category_rates(compute_gamma_cats(0.9, 4))
        return part

    def perturbed():
        tree = random_utree([f"t{i}" for i in range(10)], seed=91)
        parts = [build(tree, 0), build(tree, 1, extra_pm=3, extra_sc=2)]
        rng = np.random.default_rng(5)
        for _ in range(3):
            edges = _internal_edges(tree)
            moves.nni(edges[rng.integers(len(edges))],
                      C.UTREE_MOVE_NNI_LEFT, None)
        return parts, tree

    parts, tree = perturbed()
    s1 = TreeSearch(None, tree,
                    engine=PartitionedEngine(parts, tree, linked=True))
    s1.evaluate()
    assert s1._streamed_eligible()
    n1, an1 = s1.nni_round_streamed()
    b1, a1 = s1.spr_round_streamed(radius=3)

    parts2, tree2 = perturbed()
    s2 = TreeSearch(None, tree2,
                    engine=PartitionedEngine(parts2, tree2, linked=True))
    n2, an2 = s2.nni_round_batched()
    b2, a2 = s2.spr_round_batched(radius=3)
    assert (an1, a1) == (an2, a2)
    np.testing.assert_allclose(n1, n2, rtol=1e-9)
    np.testing.assert_allclose(b1, b2, rtol=1e-9)
