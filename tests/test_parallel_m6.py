"""M6 validation: fused TreeEngine and site-axis sharding over a virtual
8-device CPU mesh — shard-count invariance of logL/d1/d2 (the property the
reference's MPI consumers rely on; SURVEY §2.3)."""
import numpy as np
import pytest

import oracle
from libpll2_jax import Partition, TreeEngine, compute_gamma_cats
from libpll2_jax.io import maps
from libpll2_jax.parallel import make_mesh, shard_partition
from libpll2_jax.trees import parse_newick

import jax

pytestmark = pytest.mark.skipif(not oracle.available(),
                                reason="reference not available")

LG4_FAS = "/root/reference/examples/lg4/data/example.fas"
LG4_TREE = "/root/reference/examples/lg4/data/example.tree"
RNG = np.random.default_rng(23)


def build_partition(sites_alignment=1, rate_scalers=False):
    from libpll2_jax.io import load_fasta
    rng = np.random.default_rng(23)   # same params for every build
    headers, seqs = load_fasta(LG4_FAS)
    by_label = dict(zip(headers, seqs))
    tree = parse_newick(open(LG4_TREE).read())
    n_tips, n_inner = tree.tip_count, tree.inner_count
    part = Partition(n_tips, n_inner, 20, len(seqs[0]), 1, tree.edge_count,
                     4, n_inner, sites_alignment=sites_alignment,
                     rate_scalers=rate_scalers)
    for tip in tree.tips():
        part.set_tip_states(tip.clv_index, maps.map_aa, by_label[tip.label])
    part.set_frequencies(0, rng.dirichlet(np.ones(20) * 10))
    part.set_subst_params(0, rng.uniform(0.2, 3.0, size=190))
    part.set_category_rates(compute_gamma_cats(0.75, 4))
    return part, tree


def reference_logl(part, tree):
    """Same model through the step-by-step Partition path."""
    from libpll2_jax.trees import create_operations, traverse
    trav = traverse(tree.vroot)
    ops, branches, pmat_idx = create_operations(trav)
    part.update_prob_matrices([0] * 4, pmat_idx, branches)
    part.update_partials(ops)
    root = tree.vroot
    return part.compute_edge_loglikelihood(
        root.clv_index, root.scaler_index, root.back.clv_index,
        root.back.scaler_index, root.pmatrix_index, [0] * 4)


def test_engine_matches_stepwise_path():
    part, tree = build_partition()
    expected = reference_logl(part, tree)
    part2, _ = build_partition()
    eng = TreeEngine(part2, tree)
    np.testing.assert_allclose(eng.loglikelihood(), expected, rtol=1e-12)


def test_engine_newton_step_improves_logl():
    part, tree = build_partition()
    eng = TreeEngine(part, tree)
    lk0, d1, d2 = eng.newton_step()
    for _ in range(8):
        lk, d1, d2 = eng.newton_step()
    assert lk >= lk0 - 1e-9
    assert abs(d1) < 1e-3  # converged on the root branch


@pytest.mark.parametrize("n_dev", [1, 2, 4, 8])
def test_shard_count_invariance_logl(n_dev):
    assert len(jax.devices()) >= 8, "conftest must force 8 virtual devices"
    mesh = make_mesh(n_dev)
    part, tree = build_partition(sites_alignment=n_dev)
    shard_partition(part, mesh)
    eng = TreeEngine(part, tree)
    sharded = eng.loglikelihood()

    part1, _ = build_partition()
    expected = TreeEngine(part1, tree).loglikelihood()
    np.testing.assert_allclose(sharded, expected, rtol=1e-12)


def test_shard_count_invariance_derivatives():
    mesh = make_mesh(8)
    part, tree = build_partition(sites_alignment=8)
    shard_partition(part, mesh)
    eng = TreeEngine(part, tree)
    _, d1s, d2s = eng.newton_step()

    part1, _ = build_partition()
    _, d1, d2 = TreeEngine(part1, tree).newton_step()
    np.testing.assert_allclose([d1s, d2s], [d1, d2], rtol=1e-10)


def test_sharded_asc_bias_matches_unsharded():
    """Asc corrections involve a static slice of the synthetic columns —
    must survive GSPMD sharding unchanged."""
    from libpll2_jax import constants as C
    from libpll2_jax.trees import random_alignment as _ra, random_utree

    headers, seqs = _ra(12, 156, seed=9)   # 156 + 4 asc = 160 = 8*20
    tree = random_utree(headers, seed=9)
    by = dict(zip(headers, seqs))

    def build(align):
        part = Partition(tree.tip_count, tree.inner_count, 4, 156, 1,
                         tree.edge_count, 4, tree.inner_count,
                         asc_bias=C.AscBias.LEWIS, sites_alignment=align)
        for tip in tree.tips():
            part.set_tip_states(tip.clv_index, maps.map_nt, by[tip.label])
        part.set_frequencies(0, [0.3, 0.2, 0.2, 0.3])
        part.set_subst_params(0, [1, 2, 1, 1, 2, 1])
        part.set_category_rates(compute_gamma_cats(0.75, 4))
        return part

    expected = TreeEngine(build(1), tree).loglikelihood()
    part = build(8)
    shard_partition(part, make_mesh(8))
    sharded = TreeEngine(part, tree).loglikelihood()
    np.testing.assert_allclose(sharded, expected, rtol=1e-12)


def test_sharded_vs_oracle():
    """Sharded fused path reproduces the reference C library end to end."""
    from libpll2_jax.io import load_fasta
    from libpll2_jax.trees import create_operations, traverse
    headers, seqs = load_fasta(LG4_FAS)
    by_label = dict(zip(headers, seqs))
    tree = parse_newick(open(LG4_TREE).read())
    n_tips, n_inner = tree.tip_count, tree.inner_count
    freqs = RNG.dirichlet(np.ones(20) * 10)
    subst = RNG.uniform(0.2, 3.0, size=190)
    rates = compute_gamma_cats(0.75, 4)

    ref = oracle.OraclePartition(n_tips, n_inner, 20, len(seqs[0]), 1,
                                 tree.edge_count, 4, n_inner)
    for tip in tree.tips():
        ref.set_tip_states(tip.clv_index, "aa", by_label[tip.label])
    ref.set_frequencies(0, freqs)
    ref.set_subst_params(0, subst)
    ref.set_category_rates(rates)
    trav = traverse(tree.vroot)
    ops, branches, pmat_idx = create_operations(trav)
    ref.update_prob_matrices([0] * 4, pmat_idx, branches)
    ref.update_partials([(o.parent_clv_index, o.parent_scaler_index,
                          o.child1_clv_index, o.child1_matrix_index,
                          o.child1_scaler_index, o.child2_clv_index,
                          o.child2_matrix_index, o.child2_scaler_index)
                         for o in ops])
    root = tree.vroot
    lk_ref = ref.edge_loglikelihood(root.clv_index, root.scaler_index,
                                    root.back.clv_index,
                                    root.back.scaler_index,
                                    root.pmatrix_index, [0] * 4)
    ref.destroy()

    mesh = make_mesh(8)
    part = Partition(n_tips, n_inner, 20, len(seqs[0]), 1, tree.edge_count,
                     4, n_inner, sites_alignment=8)
    for tip in tree.tips():
        part.set_tip_states(tip.clv_index, maps.map_aa, by_label[tip.label])
    part.set_frequencies(0, freqs)
    part.set_subst_params(0, subst)
    part.set_category_rates(rates)
    shard_partition(part, mesh)
    lk = TreeEngine(part, tree).loglikelihood()
    np.testing.assert_allclose(lk, lk_ref, rtol=1e-10)


def test_newton_loop_matches_stepwise_newton():
    """k chained Newton iterations in one dispatch == k separate steps."""
    part_a, tree = build_partition()
    eng_a = TreeEngine(part_a, tree)
    for _ in range(5):
        last_a = eng_a.newton_step()

    part_b, _ = build_partition()
    eng_b = TreeEngine(part_b, tree)
    last_b = eng_b.newton_loop(5)
    np.testing.assert_allclose(last_b, last_a, rtol=1e-10)
    np.testing.assert_allclose(np.asarray(eng_b.branches),
                               np.asarray(eng_a.branches), rtol=1e-12)


def test_fused_kernel_under_mesh_interpret():
    """The fused whole-traversal Pallas kernel runs under
    a site-sharded mesh via shard_map (interpret mode on the virtual CPU
    mesh) and matches the unsharded XLA result."""
    import jax.numpy as jnp
    from libpll2_jax.trees import random_utree
    from libpll2_jax.utils import simulate_alignment

    FREQS = [0.3, 0.2, 0.2, 0.3]
    SUBST = [1, 2, 1, 1, 2, 1]
    tree = random_utree([f"t{i}" for i in range(10)], seed=31)
    headers, seqs = simulate_alignment(tree, 1024, FREQS, SUBST,
                                       alpha=0.9, seed=31)
    by = dict(zip(headers, seqs))

    def build(mesh_n=None):
        part = Partition(tree.tip_count, tree.inner_count, 4, 1024, 1,
                         tree.edge_count, 4, tree.inner_count,
                         dtype=jnp.float32)
        for t in tree.tips():
            part.set_tip_states(t.clv_index, maps.map_nt, by[t.label])
        part.set_frequencies(0, FREQS)
        part.set_subst_params(0, SUBST)
        part.set_category_rates(compute_gamma_cats(0.9, 4))
        if mesh_n:
            shard_partition(part, make_mesh(mesh_n))
        return part

    ref = TreeEngine(build(), tree, pallas=False).loglikelihood()
    part = build(mesh_n=8)
    eng = TreeEngine(part, tree, pallas="interpret")
    assert eng.use_fused and eng.fused_mesh is not None
    lk = eng.loglikelihood()
    np.testing.assert_allclose(lk, ref, rtol=1e-6)
    # chained loop + newton also execute SPMD
    acc = eng.loglikelihood_loop(2)
    np.testing.assert_allclose(acc, 2 * lk, rtol=1e-6)
    lkn, d1, d2 = eng.newton_step()
    assert np.isfinite(lkn) and np.isfinite(d1) and np.isfinite(d2)


@pytest.mark.parametrize("n_dev", [1, 2, 4, 8])
def test_sharded_repeats_engine_invariance(n_dev):
    """Site-repeats under site sharding: per-device column slices with
    LOCAL class tables, one SPMD program, psum'd root logL — the value
    must be independent of the shard count and equal to the unsharded
    repeats (and dense) answer."""
    from libpll2_jax.parallel import ShardedRepeatsEngine
    from libpll2_jax.trees import random_utree
    from libpll2_jax.utils.simulate import simulate_alignment

    n_taxa, sites = 14, 1024
    tree = random_utree([f"t{i}" for i in range(n_taxa)], seed=31)
    freqs = [0.3, 0.25, 0.2, 0.25]
    subst = [1.2, 3.0, 0.8, 1.1, 2.6, 1.0]
    rates = compute_gamma_cats(0.8, 4)
    headers, seqs = simulate_alignment(tree, sites, freqs, subst,
                                       alpha=0.8, seed=31)
    by_label = dict(zip(headers, seqs))
    ordered = [by_label[t.label] for t in tree.tips()]
    tip_idx = [t.clv_index for t in tree.tips()]

    def make(lo, hi, repeats=True):
        p = Partition(tree.tip_count, tree.inner_count, 4, hi - lo, 1,
                      tree.edge_count, 4, tree.inner_count,
                      site_repeats=repeats)
        for ti, s in zip(tip_idx, ordered):
            p.set_tip_states(ti, maps.map_nt, s[lo:hi])
        p.set_frequencies(0, freqs)
        p.set_subst_params(0, subst)
        p.set_category_rates(rates)
        return p

    lk_full = TreeEngine(make(0, sites), tree, pallas=False).loglikelihood()
    lk_dense = TreeEngine(make(0, sites, repeats=False), tree,
                          pallas=False).loglikelihood()
    np.testing.assert_allclose(lk_full, lk_dense, rtol=1e-10)

    w = sites // n_dev
    mesh = make_mesh(n_dev)
    parts = [make(d * w, (d + 1) * w) for d in range(n_dev)]
    eng = ShardedRepeatsEngine(tree, parts, mesh)
    lk = eng.loglikelihood()
    np.testing.assert_allclose(lk, lk_full, rtol=1e-10)
    # chained loop reuses the pools without drifting
    np.testing.assert_allclose(eng.loglikelihood_loop(3), 3 * lk_full,
                               rtol=1e-10)


def test_sharded_repeats_pallas_interpret():
    """The fused kernel runs per shard inside the SPMD program over dense
    tip codes (interpret mode on the virtual CPU mesh; fp32 like the GPU
    path)."""
    import jax.numpy as jnp
    from libpll2_jax.parallel import ShardedRepeatsEngine
    from libpll2_jax.trees import random_utree
    from libpll2_jax.utils.simulate import simulate_alignment

    n_taxa, sites, n_dev = 10, 512, 4
    tree = random_utree([f"t{i}" for i in range(n_taxa)], seed=33)
    freqs = [0.3, 0.25, 0.2, 0.25]
    subst = [1.2, 3.0, 0.8, 1.1, 2.6, 1.0]
    rates = compute_gamma_cats(0.8, 4)
    headers, seqs = simulate_alignment(tree, sites, freqs, subst,
                                       alpha=0.8, seed=33)
    by_label = dict(zip(headers, seqs))

    def make(lo, hi):
        p = Partition(tree.tip_count, tree.inner_count, 4, hi - lo, 1,
                      tree.edge_count, 4, tree.inner_count,
                      site_repeats=True, dtype=jnp.float32)
        for t in tree.tips():
            p.set_tip_states(t.clv_index, maps.map_nt,
                             by_label[t.label][lo:hi])
        p.set_frequencies(0, freqs)
        p.set_subst_params(0, subst)
        p.set_category_rates(rates)
        return p

    lk_full = TreeEngine(make(0, sites), tree, pallas=False).loglikelihood()
    w = sites // n_dev
    eng = ShardedRepeatsEngine(tree, [make(d * w, (d + 1) * w)
                                      for d in range(n_dev)],
                               make_mesh(n_dev), interpret=True)
    assert eng.dense_fused
    np.testing.assert_allclose(eng.loglikelihood(), lk_full, rtol=2e-5)


def test_sharded_repeats_newton_and_asc():
    """Distributed repeats 'training step': d1/d2 are psum'd weighted
    site sums (reference core_derivatives.c:844-848) and the Newton
    update stays replicated; Lewis asc corrections compose rank-wise
    (sum_w_local * log(1-base) adds up to the global correction)."""
    from libpll2_jax.parallel import ShardedRepeatsEngine
    from libpll2_jax.trees import random_utree
    from libpll2_jax.utils.simulate import simulate_alignment

    n_taxa, sites, n_dev = 12, 768, 4
    tree = random_utree([f"t{i}" for i in range(n_taxa)], seed=37)
    freqs = [0.3, 0.25, 0.2, 0.25]
    subst = [1.2, 3.0, 0.8, 1.1, 2.6, 1.0]
    rates = compute_gamma_cats(0.8, 4)
    headers, seqs = simulate_alignment(tree, sites, freqs, subst,
                                       alpha=0.8, seed=37)
    by_label = dict(zip(headers, seqs))

    def make(lo, hi, asc=None, repeats=True):
        from libpll2_jax.constants import AscBias
        asc = asc or AscBias.NONE
        p = Partition(tree.tip_count, tree.inner_count, 4, hi - lo, 1,
                      tree.edge_count, 4, tree.inner_count,
                      site_repeats=repeats, asc_bias=asc)
        for t in tree.tips():
            p.set_tip_states(t.clv_index, maps.map_nt,
                             by_label[t.label][lo:hi])
        p.set_frequencies(0, freqs)
        p.set_subst_params(0, subst)
        p.set_category_rates(rates)
        return p

    w = sites // n_dev
    mesh = make_mesh(n_dev)

    # Newton: one step, d1/d2 vs the unsharded repeats engine
    ref_eng = TreeEngine(make(0, sites), tree)
    lk_r, d1_r, d2_r = ref_eng.newton_step()
    eng = ShardedRepeatsEngine(tree, [make(d * w, (d + 1) * w)
                                      for d in range(n_dev)], mesh)
    lk, d1, d2 = eng.newton_step()
    np.testing.assert_allclose(lk, lk_r, rtol=1e-10)
    np.testing.assert_allclose(d1, d1_r, rtol=1e-9)
    np.testing.assert_allclose(d2, d2_r, rtol=1e-9)
    # chained iterations track the unsharded engine
    lk3, d13, d23 = eng.newton_loop(3)
    ref_eng.newton_step()
    lk3_r, d13_r, d23_r = ref_eng.newton_step()
    np.testing.assert_allclose(lk3, lk3_r, rtol=1e-10)
    # by iteration 3 Newton has converged (d1 ~ 0): compare absolutely
    np.testing.assert_allclose(d13, d13_r, atol=1e-5)

    # Lewis asc: per-shard corrections must sum to the global one
    from libpll2_jax.constants import AscBias
    ref_asc = TreeEngine(make(0, sites, asc=AscBias.LEWIS), tree)
    lk_asc_r = ref_asc.loglikelihood()
    eng_asc = ShardedRepeatsEngine(
        tree, [make(d * w, (d + 1) * w, asc=AscBias.LEWIS)
               for d in range(n_dev)], mesh)
    np.testing.assert_allclose(eng_asc.loglikelihood(), lk_asc_r,
                               rtol=1e-10)
    # and asc newton derivatives
    lk_a, d1_a, d2_a = eng_asc.newton_step()
    lk_ar, d1_ar, d2_ar = ref_asc.newton_step()
    np.testing.assert_allclose(lk_a, lk_ar, rtol=1e-10)
    np.testing.assert_allclose(d1_a, d1_ar, rtol=1e-9)
    np.testing.assert_allclose(d2_a, d2_ar, rtol=1e-9)


@pytest.mark.parametrize("n_dev", [2, 4])
def test_sharded_repeats_dense_fused(n_dev):
    """Dense-fused sharded repeats: pooled storage
    per shard, but evaluation through the fused kernel on dense tip
    codes inside the SPMD program — logL AND the Newton d1/d2 psums must
    match the unsharded dense engine."""
    import jax.numpy as jnp

    from libpll2_jax.parallel import ShardedRepeatsEngine
    from libpll2_jax.trees import random_utree
    from libpll2_jax.utils.simulate import simulate_alignment

    n_taxa, sites = 12, 1024
    tree = random_utree([f"t{i}" for i in range(n_taxa)], seed=37)
    freqs = [0.3, 0.25, 0.2, 0.25]
    subst = [1.2, 3.0, 0.8, 1.1, 2.6, 1.0]
    rates = compute_gamma_cats(0.7, 4)
    headers, seqs = simulate_alignment(tree, sites, freqs, subst,
                                       alpha=0.7, seed=37)
    by_label = dict(zip(headers, seqs))

    def make(lo, hi, repeats=True):
        p = Partition(tree.tip_count, tree.inner_count, 4, hi - lo, 1,
                      tree.edge_count, 4, tree.inner_count,
                      site_repeats=repeats, dtype=jnp.float32)
        for t in tree.tips():
            p.set_tip_states(t.clv_index, maps.map_nt,
                             by_label[t.label][lo:hi])
        p.set_frequencies(0, freqs)
        p.set_subst_params(0, subst)
        p.set_category_rates(rates)
        return p

    ref_eng = TreeEngine(make(0, sites, repeats=False), tree,
                         pallas=False)
    lk_ref, d1_ref, d2_ref = ref_eng.newton_step()

    w = sites // n_dev
    mesh = make_mesh(n_dev)
    parts = [make(d * w, (d + 1) * w) for d in range(n_dev)]
    eng = ShardedRepeatsEngine(tree, parts, mesh, interpret=True)
    assert eng.dense_fused, "fused path not selected"
    lk = eng.loglikelihood()
    np.testing.assert_allclose(lk, lk_ref, rtol=5e-6)
    np.testing.assert_allclose(eng.loglikelihood_loop(3), 3 * lk,
                               rtol=1e-6)
    lkn, d1, d2 = eng.newton_loop(1)
    np.testing.assert_allclose(lkn, lk_ref, rtol=5e-6)
    np.testing.assert_allclose(d1, d1_ref, rtol=5e-3, atol=5e-2)
    np.testing.assert_allclose(d2, d2_ref, rtol=5e-3, atol=5e-2)
    # pooled fallback agrees with the fused path across the same shards
    pooled = ShardedRepeatsEngine(tree, parts, mesh, dense_fused=False)
    np.testing.assert_allclose(pooled.loglikelihood(), lk, rtol=5e-6)


def test_fused_under_mesh_unaligned_sites():
    """Real alignments whose per-shard width is not tile-aligned (e.g.
    1000 sites over 8 devices = 125 columns each) must still run the
    FUSED kernel under the mesh — the kernel pads each shard's local
    block to its site tile internally, exactly like the single-device
    path. Covers DNA and AA."""
    import jax.numpy as jnp
    from libpll2_jax.trees import random_utree
    from libpll2_jax.utils import simulate_alignment

    for states, sites in ((4, 1000), (20, 648)):
        FREQS = np.full(states, 1.0 / states)
        nsub = states * (states - 1) // 2
        rng = np.random.default_rng(41)
        subst = rng.uniform(0.5, 2.0, size=nsub)
        tree = random_utree([f"t{i}" for i in range(10)], seed=41)
        headers, seqs = simulate_alignment(tree, sites, FREQS, subst,
                                           alpha=0.9, seed=41)
        by = dict(zip(headers, seqs))
        cm = maps.map_nt if states == 4 else maps.map_aa

        def build(mesh_n=None):
            part = Partition(tree.tip_count, tree.inner_count, states,
                             sites, 1, tree.edge_count, 4,
                             tree.inner_count, dtype=jnp.float32,
                             sites_alignment=mesh_n or 1)
            for t in tree.tips():
                part.set_tip_states(t.clv_index, cm, by[t.label])
            part.set_frequencies(0, FREQS)
            part.set_subst_params(0, subst)
            part.set_category_rates(compute_gamma_cats(0.9, 4))
            if mesh_n:
                shard_partition(part, make_mesh(mesh_n))
            return part

        ref = TreeEngine(build(), tree, pallas=False).loglikelihood()
        part = build(mesh_n=8)
        assert part.sites_padded % (128 * 8) != 0   # the old gate failed
        eng = TreeEngine(part, tree, pallas="interpret")
        assert eng.use_fused and eng.fused_mesh is not None, \
            eng.execution_path
        np.testing.assert_allclose(eng.loglikelihood(), ref,
                                   rtol=2e-6 if states == 4 else 1e-5)
        lkn, d1, d2 = eng.newton_step()
        assert np.isfinite(lkn) and np.isfinite(d1) and np.isfinite(d2)


def test_sharded_repeats_topology_search():
    """Multi-chip topology search on the repeats production combo:
    TreeSearch drives a ShardedRepeatsEngine through the batched
    SPR/NNI rounds (evaluate_packed_arrays = one SPMD dispatch + one
    psum per candidate batch). Accepted moves and final logL must match
    a single-device dense-fused repeats search on the same global
    problem."""
    import jax.numpy as jnp

    from libpll2_jax import constants as C
    from libpll2_jax.parallel import ShardedRepeatsEngine
    from libpll2_jax.search import TreeSearch, _internal_edges
    from libpll2_jax.trees import moves, random_utree
    from libpll2_jax.utils.simulate import simulate_alignment

    n_dev, n_taxa, sites = 4, 10, 256
    freqs = [0.3, 0.25, 0.2, 0.25]
    subst = [1.2, 3.0, 0.8, 1.1, 2.6, 1.0]
    rates = compute_gamma_cats(0.7, 4)

    def problem():
        tree = random_utree([f"t{i}" for i in range(n_taxa)], seed=51)
        headers, seqs = simulate_alignment(tree, sites, freqs, subst,
                                           alpha=0.7, seed=51)
        by = dict(zip(headers, seqs))
        # perturb so the search has moves to find
        rng = np.random.default_rng(9)
        for _ in range(3):
            edges = _internal_edges(tree)
            moves.nni(edges[rng.integers(len(edges))],
                      C.UTREE_MOVE_NNI_LEFT, None)
        return tree, by

    def make(tree, by, lo, hi):
        p = Partition(tree.tip_count, tree.inner_count, 4, hi - lo, 1,
                      tree.edge_count, 4, tree.inner_count,
                      site_repeats=True, dtype=jnp.float32)
        for t in tree.tips():
            p.set_tip_states(t.clv_index, maps.map_nt,
                             by[t.label][lo:hi])
        p.set_frequencies(0, freqs)
        p.set_subst_params(0, subst)
        p.set_category_rates(rates)
        return p

    tree, by = problem()
    w = sites // n_dev
    mesh = make_mesh(n_dev)
    eng = ShardedRepeatsEngine(
        tree, [make(tree, by, d * w, (d + 1) * w) for d in range(n_dev)],
        mesh, interpret=True)
    assert eng.dense_fused and eng.use_fused
    s1 = TreeSearch(None, tree, engine=eng)
    assert not s1._streamed_eligible()   # batched path by design
    b1, a1 = s1.spr_round_batched(radius=3)
    n1, an1 = s1.nni_round_batched()

    # single-device dense-fused repeats reference on the global columns
    tree2, by2 = problem()
    p_ref = make(tree2, by2, 0, sites)
    s2 = TreeSearch(p_ref, tree2, pallas="interpret")
    b2, a2 = s2.spr_round_batched(radius=3)
    n2, an2 = s2.nni_round_batched()
    assert (a1, an1) == (a2, an2)
    np.testing.assert_allclose(b1, b2, rtol=2e-5)
    np.testing.assert_allclose(n1, n2, rtol=2e-5)
