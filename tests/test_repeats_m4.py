"""M4 validation: site repeats — class identification, bucketed CLV
kernels, gather-based likelihood/derivatives — against both the plain path
and the reference oracle running with PLL_ATTRIB_SITE_REPEATS."""
import numpy as np
import pytest

import oracle
from libpll2_jax import Operation, Partition, compute_gamma_cats
from libpll2_jax.io import maps
from libpll2_jax.trees import create_operations, random_utree, traverse
from libpll2_jax.utils.simulate import simulate_alignment

pytestmark = pytest.mark.skipif(not oracle.available(),
                                reason="reference not available")

N_TAXA = 24
N_SITES = 600
FREQS = [0.3, 0.25, 0.2, 0.25]
SUBST = [1.2, 3.0, 0.8, 1.1, 2.6, 1.0]
RATES = None  # filled in fixture


def _simulated(seed=11, scale=1.0):
    tree = random_utree([f"t{i}" for i in range(N_TAXA)], seed=seed)
    # stretch branches optionally to force scaling events
    if scale != 1.0:
        seen = set()
        for n in tree.nodes():
            for h in ([n] if n.is_tip() else list(n.ring())):
                if id(h) not in seen and h.back:
                    seen.add(id(h)), seen.add(id(h.back))
                    h.length = h.back.length = h.length * scale
    headers, seqs = simulate_alignment(tree, N_SITES, FREQS, SUBST,
                                       alpha=0.8, seed=seed)
    return tree, headers, seqs


def _build(tree, headers, seqs, repeats: bool, oracle_attrs=None):
    by_label = dict(zip(headers, seqs))
    rates = compute_gamma_cats(0.8, 4)
    if oracle_attrs is not None:
        impl = oracle.OraclePartition(tree.tip_count, tree.inner_count, 4,
                                      N_SITES, 1, tree.edge_count, 4,
                                      tree.inner_count,
                                      attributes=oracle_attrs)
        for tip in tree.tips():
            impl.set_tip_states(tip.clv_index, "nt", by_label[tip.label])
    else:
        impl = Partition(tree.tip_count, tree.inner_count, 4, N_SITES, 1,
                         tree.edge_count, 4, tree.inner_count,
                         site_repeats=repeats)
        for tip in tree.tips():
            impl.set_tip_states(tip.clv_index, maps.map_nt,
                                by_label[tip.label])
    impl.set_frequencies(0, FREQS)
    impl.set_subst_params(0, SUBST)
    impl.set_category_rates(rates)
    return impl


def _evaluate(impl, tree, is_oracle=False):
    trav = traverse(tree.vroot)
    ops, branches, pmat_idx = create_operations(trav)
    pidx = [0] * 4
    impl.update_prob_matrices(pidx, pmat_idx, branches)
    if is_oracle:
        impl.update_partials([(o.parent_clv_index, o.parent_scaler_index,
                               o.child1_clv_index, o.child1_matrix_index,
                               o.child1_scaler_index, o.child2_clv_index,
                               o.child2_matrix_index, o.child2_scaler_index)
                              for o in ops])
    else:
        impl.update_partials(ops)
    root = tree.vroot
    args = (root.clv_index, root.scaler_index, root.back.clv_index,
            root.back.scaler_index, root.pmatrix_index, pidx)
    if is_oracle:
        return impl.edge_loglikelihood(*args, persite=True)
    return impl.compute_edge_loglikelihood(*args, persite=True)


def test_repeats_classes_compress():
    tree, headers, seqs = _simulated()
    part = _build(tree, headers, seqs, repeats=True)
    assert part.repeats is not None
    # tips have at most |alphabet| classes on simulated gap-free data
    for t in range(tree.tip_count):
        assert 0 < part.repeats.ids[t] <= 4
    trav = traverse(tree.vroot)
    ops, _, _ = create_operations(trav)
    from libpll2_jax.repeats import schedule_buckets
    sched = schedule_buckets(part.repeats, ops, N_SITES)
    widths = [w for w, *_ in sched]
    assert min(widths) == 128          # deep nodes land in small buckets
    total_classes = sum(part.repeats.classes(o.parent_clv_index)
                        for o in ops)
    assert total_classes < len(ops) * N_SITES / 2   # real compression


def test_repeats_logl_equals_plain():
    tree, headers, seqs = _simulated()
    lk_p, per_p = _evaluate(_build(tree, headers, seqs, False), tree)
    lk_r, per_r = _evaluate(_build(tree, headers, seqs, True), tree)
    np.testing.assert_allclose(lk_r, lk_p, rtol=1e-12)
    np.testing.assert_allclose(per_r, per_p, rtol=1e-10)


def test_repeats_logl_vs_oracle_repeats():
    tree, headers, seqs = _simulated()
    ref = _build(tree, headers, seqs, False,
                 oracle_attrs=oracle.ATTRIB_SITE_REPEATS)
    lk_ref, per_ref = _evaluate(ref, tree, is_oracle=True)
    ref.destroy()
    lk, per = _evaluate(_build(tree, headers, seqs, True), tree)
    np.testing.assert_allclose(lk, lk_ref, rtol=1e-10)
    np.testing.assert_allclose(per, per_ref, rtol=1e-8)


def test_repeats_with_scaling_caterpillar():
    """A caterpillar tree (depth = taxa) forces CLV underflow scaling;
    repeats scaler propagation must match the plain path."""
    from libpll2_jax.trees import parse_newick
    global N_TAXA, N_SITES
    n = 150
    text = f"t{n-1}:0.1"
    for i in range(n - 2, 1, -1):
        text = f"(t{i}:0.1,{text}):0.1"
    tree = parse_newick(f"(t0:0.1,t1:0.1,{text});")
    headers, seqs = simulate_alignment(tree, 300, FREQS, SUBST,
                                       alpha=0.8, seed=13)
    saved = (N_TAXA, N_SITES)
    N_TAXA, N_SITES = n, 300
    try:
        part_p = _build(tree, headers, seqs, False)
        part_r = _build(tree, headers, seqs, True)
        lk_p, _ = _evaluate(part_p, tree)
        lk_r, _ = _evaluate(part_r, tree)
    finally:
        N_TAXA, N_SITES = saved
    # verify scaling actually happened
    assert np.asarray(part_p.scale_buffer).sum() > 0
    np.testing.assert_allclose(lk_r, lk_p, rtol=1e-12)


def test_repeats_derivatives_equal_plain():
    tree, headers, seqs = _simulated()
    part_p = _build(tree, headers, seqs, False)
    part_r = _build(tree, headers, seqs, True)
    _evaluate(part_p, tree)
    _evaluate(part_r, tree)
    root = tree.vroot
    pidx = [0] * 4
    for part in (part_p, part_r):
        part._sum = part.update_sumtable(
            root.clv_index, root.back.clv_index,
            root.scaler_index, root.back.scaler_index, pidx)
    for blen in (0.01, 0.1, 1.0):
        d_p = part_p.compute_likelihood_derivatives(part_p._sum, pidx, blen)
        d_r = part_r.compute_likelihood_derivatives(part_r._sum, pidx, blen)
        np.testing.assert_allclose(d_r, d_p, rtol=1e-10)


def test_repeats_clv_expansion_matches_plain():
    tree, headers, seqs = _simulated()
    part_p = _build(tree, headers, seqs, False)
    part_r = _build(tree, headers, seqs, True)
    _evaluate(part_p, tree)
    _evaluate(part_r, tree)
    for node in (0, tree.tip_count, tree.tip_count + tree.inner_count - 1):
        np.testing.assert_allclose(part_r.get_clv(node),
                                   part_p.get_clv(node), rtol=1e-12)


def test_repeats_tree_engine_matches_plain():
    """TreeEngine now accepts repeats partitions: fused pooled-storage
    evaluation must match the plain engine and the step-by-step API."""
    from libpll2_jax import TreeEngine
    tree, headers, seqs = _simulated()
    part_r = _build(tree, headers, seqs, True)
    part_p = _build(tree, headers, seqs, False)
    eng_r = TreeEngine(part_r, tree, pallas=False)
    eng_p = TreeEngine(part_p, tree, pallas=False)
    assert eng_r.repeats_mode
    lk_r = eng_r.loglikelihood()
    lk_p = eng_p.loglikelihood()
    np.testing.assert_allclose(lk_r, lk_p, rtol=1e-12)
    # newton loop agrees too
    nr = eng_r.newton_loop(3)
    np_ = eng_p.newton_loop(3)
    np.testing.assert_allclose(nr, np_, rtol=1e-8)
    # chained loop equals k * single (branches fixed)
    acc = eng_r.loglikelihood_loop(3)
    np.testing.assert_allclose(acc, 3 * eng_r.loglikelihood(), rtol=1e-10)


def test_repeats_engine_topology_moves():
    """set_topology + evaluate_topologies on a repeats engine: candidate
    scoring matches a fresh engine evaluation of the moved topology."""
    from libpll2_jax import TreeEngine
    from libpll2_jax import constants as C2
    from libpll2_jax.trees import moves
    tree, headers, seqs = _simulated(seed=12)
    part_r = _build(tree, headers, seqs, True)
    eng = TreeEngine(part_r, tree, pallas=False)
    base = eng.loglikelihood()

    edge = next(h for n in tree.nodes() if not n.is_tip()
                for h in n.ring()
                if h.back is not None and not h.back.is_tip())
    rb = moves.Rollback()
    moves.nni(edge, C2.UTREE_MOVE_NNI_LEFT, rb)
    trav = traverse(tree.vroot)
    ops, br, pidx = create_operations(trav)
    vr = tree.vroot
    ri = (vr.clv_index, vr.scaler_index, vr.back.clv_index,
          vr.back.scaler_index, vr.pmatrix_index)
    scores = eng.evaluate_topologies([(ops, br, pidx, ri)])
    # independent check: fresh partition+engine on the moved topology
    part2 = _build(tree, headers, seqs, True)
    lk_moved = TreeEngine(part2, tree, pallas=False).loglikelihood()
    np.testing.assert_allclose(scores[0], lk_moved, rtol=1e-10)
    moves.rollback_move(rb)
    # engine schedule restored: original topology still evaluates right
    np.testing.assert_allclose(eng.loglikelihood(), base, rtol=1e-10)


ASC_CASES = [
    ("lewis", oracle.ATTRIB_AB_LEWIS, False),
    ("felsenstein", oracle.ATTRIB_AB_FELSENSTEIN, True),
    ("stamatakis", oracle.ATTRIB_AB_STAMATAKIS, True),
]


@pytest.mark.parametrize("asc_name,ref_attr,needs_weights", ASC_CASES,
                         ids=[c[0] for c in ASC_CASES])
def test_repeats_with_asc_bias(asc_name, ref_attr, needs_weights):
    """Site repeats + ascertainment bias, together — the reference sizes
    its repeats tables over sites + asc columns (repeats.c:69,122,201);
    here the synthetic columns join the class domain the same way."""
    from libpll2_jax import constants as C
    from libpll2_jax import TreeEngine
    asc = getattr(C.AscBias, asc_name.upper())
    weights = [50, 40, 60, 20]
    tree, headers, seqs = _simulated(seed=23)
    by_label = dict(zip(headers, seqs))
    rates = compute_gamma_cats(0.8, 4)

    ref = oracle.OraclePartition(
        tree.tip_count, tree.inner_count, 4, N_SITES, 1, tree.edge_count,
        4, tree.inner_count,
        attributes=oracle.ATTRIB_SITE_REPEATS | oracle.ATTRIB_AB_FLAG)
    part = Partition(tree.tip_count, tree.inner_count, 4, N_SITES, 1,
                     tree.edge_count, 4, tree.inner_count,
                     site_repeats=True, asc_bias=asc)
    assert part.repeats is not None       # repeats stayed enabled with asc
    for tip in tree.tips():
        ref.set_tip_states(tip.clv_index, "nt", by_label[tip.label])
        part.set_tip_states(tip.clv_index, maps.map_nt,
                            by_label[tip.label])
    for impl in (ref, part):
        impl.set_frequencies(0, FREQS)
        impl.set_subst_params(0, SUBST)
        impl.set_category_rates(rates)
    ref.set_asc_bias_type(ref_attr)
    if needs_weights:
        ref.set_asc_state_weights(weights)
        part.set_asc_state_weights(weights)

    trav = traverse(tree.vroot)
    ops, branches, pmat_idx = create_operations(trav)
    pidx = [0] * 4
    ref.update_prob_matrices(pidx, pmat_idx, branches)
    part.update_prob_matrices(pidx, pmat_idx, branches)
    ref.update_partials([(o.parent_clv_index, o.parent_scaler_index,
                          o.child1_clv_index, o.child1_matrix_index,
                          o.child1_scaler_index, o.child2_clv_index,
                          o.child2_matrix_index, o.child2_scaler_index)
                         for o in ops])
    part.update_partials(ops)
    root = tree.vroot
    args = (root.clv_index, root.scaler_index, root.back.clv_index,
            root.back.scaler_index, root.pmatrix_index, pidx)
    lk_ref = ref.edge_loglikelihood(*args)
    lk = part.compute_edge_loglikelihood(*args)
    np.testing.assert_allclose(lk, lk_ref, rtol=1e-10)
    ref.destroy()

    # the fused engine path agrees too
    part2 = Partition(tree.tip_count, tree.inner_count, 4, N_SITES, 1,
                      tree.edge_count, 4, tree.inner_count,
                      site_repeats=True, asc_bias=asc)
    for tip in tree.tips():
        part2.set_tip_states(tip.clv_index, maps.map_nt,
                             by_label[tip.label])
    part2.set_frequencies(0, FREQS)
    part2.set_subst_params(0, SUBST)
    part2.set_category_rates(rates)
    if needs_weights:
        part2.set_asc_state_weights(weights)
    eng = TreeEngine(part2, tree, pallas=False)
    np.testing.assert_allclose(eng.loglikelihood(), lk_ref, rtol=1e-10)


def test_repeats_dense_fused_engine():
    """A repeats partition keeps POOLED (compressed) storage but the
    engine evaluates through the dense fused kernel (recomputing
    duplicate class columns inside the kernel instead of permuting
    compressed ones). logL / per-site / Newton must match the pooled
    compute path."""
    from libpll2_jax import TreeEngine
    tree, headers, seqs = _simulated(seed=91)
    part_pool = _build(tree, headers, seqs, repeats=True)
    eng_pool = TreeEngine(part_pool, tree, pallas=False)
    assert eng_pool.repeats_mode and not eng_pool.repeats_dense_fused
    lk_pool, per_pool = eng_pool.loglikelihood_persite()

    import jax.numpy as jnp
    tree_f, headers_f, seqs_f = _simulated(seed=91)
    by_f = dict(zip(headers_f, seqs_f))
    part_f = Partition(tree_f.tip_count, tree_f.inner_count, 4, N_SITES, 1,
                       tree_f.edge_count, 4, tree_f.inner_count,
                       site_repeats=True, dtype=jnp.float32)
    for tip in tree_f.tips():
        part_f.set_tip_states(tip.clv_index, maps.map_nt, by_f[tip.label])
    part_f.set_frequencies(0, FREQS)
    part_f.set_subst_params(0, SUBST)
    part_f.set_category_rates(compute_gamma_cats(0.8, 4))
    eng_f = TreeEngine(part_f, tree_f, pallas="interpret")
    assert eng_f.repeats_dense_fused and eng_f.use_fused
    assert not eng_f.repeats_mode
    # no DENSE buffers exist (the memory win stays; the pooled buffers
    # are not even materialized until the step-by-step API needs them)
    assert part_f.clv is None
    assert part_f.repeats is not None
    lk_f, per_f = eng_f.loglikelihood_persite()
    np.testing.assert_allclose(lk_f, lk_pool, rtol=2e-6)
    np.testing.assert_allclose(per_f, per_pool, rtol=2e-5, atol=1e-4)

    # loops + Newton run through the stub-buffer path
    acc = eng_f.loglikelihood_loop(3)
    np.testing.assert_allclose(acc, 3 * lk_f, rtol=2e-6)
    lkn, d1, d2 = eng_f.newton_loop(3)
    lknp, d1p, d2p = eng_pool.newton_loop(3)
    np.testing.assert_allclose(lkn, lknp, rtol=2e-6)
    np.testing.assert_allclose(d1, d1p, rtol=1e-3, atol=1e-2)

    # batched candidate scoring agrees with single evaluation
    from libpll2_jax.trees import create_operations, traverse
    ops, br, pidx = create_operations(traverse(tree_f.vroot))
    vr = tree_f.vroot
    cand = [(ops, br, pidx, (vr.clv_index, vr.scaler_index,
             vr.back.clv_index, vr.back.scaler_index, vr.pmatrix_index))]
    scores = eng_f.evaluate_topologies(cand)
    np.testing.assert_allclose(scores[0], eng_f.loglikelihood(), rtol=2e-6)


def test_repeats_dense_fused_unfusable_candidate():
    """evaluate_topologies on a dense-fused repeats engine must fall back
    to the pooled per-candidate scorer when a candidate's op list cannot
    run on the fused kernel (regression: the scan fallback ran over the
    1-row stub buffers and returned NaN for the whole batch)."""
    import jax.numpy as jnp
    from libpll2_jax import TreeEngine
    from libpll2_jax.trees import create_operations, traverse

    tree, headers, seqs = _simulated(seed=97)
    by = dict(zip(headers, seqs))
    part = Partition(tree.tip_count, tree.inner_count, 4, N_SITES, 1,
                     tree.edge_count, 4, tree.inner_count,
                     site_repeats=True, dtype=jnp.float32)
    for tip in tree.tips():
        part.set_tip_states(tip.clv_index, maps.map_nt, by[tip.label])
    part.set_frequencies(0, FREQS)
    part.set_subst_params(0, SUBST)
    part.set_category_rates(compute_gamma_cats(0.8, 4))
    eng = TreeEngine(part, tree, pallas="interpret")
    assert eng.repeats_dense_fused
    lk = eng.loglikelihood()

    ops, br, pidx = create_operations(traverse(tree.vroot))
    vr = tree.vroot
    ri = (vr.clv_index, vr.scaler_index, vr.back.clv_index,
          vr.back.scaler_index, vr.pmatrix_index)
    # an unfusable candidate: strip the scaler from one op (the kernel
    # requires a scaler per inner op and rejects the schedule)
    bad = list(ops)
    o = bad[0]
    bad[0] = Operation(o.parent_clv_index, -1, o.child1_clv_index,
                       o.child1_matrix_index, o.child1_scaler_index,
                       o.child2_clv_index, o.child2_matrix_index,
                       o.child2_scaler_index)
    scores = eng.evaluate_topologies([(ops, br, pidx, ri),
                                      (bad, br, pidx, ri)])
    assert np.isfinite(scores[0]), scores
    np.testing.assert_allclose(scores[0], lk, rtol=2e-6)


def test_repeats_with_rate_scalers_vs_oracle():
    """Site repeats x PER-RATE scalers: the
    reference ships the combination explicitly
    (pll_fill_parent_scaler_repeats_per_rate, /root/reference/src/pll.h:703
    invoked at core_partials.c:830,945). A caterpillar tree with a small
    Gamma alpha makes the rate categories underflow at different depths,
    so the per-rate scaler rows genuinely diverge. Covers all three
    compute paths: pooled XLA step-by-step, the engine's pooled mode
    (pallas='pool', the XLA buckets), and the dense-fused fp32 engine."""
    import jax.numpy as jnp
    from libpll2_jax import TreeEngine
    from libpll2_jax.trees import parse_newick

    global N_TAXA, N_SITES
    n = 120
    text = f"t{n-1}:0.1"
    for i in range(n - 2, 1, -1):
        text = f"(t{i}:0.1,{text}):0.1"
    tree = parse_newick(f"(t0:0.1,t1:0.1,{text});")
    headers, seqs = simulate_alignment(tree, 300, FREQS, SUBST,
                                       alpha=0.3, seed=17)
    by = dict(zip(headers, seqs))
    rates = compute_gamma_cats(0.3, 4)

    def build(dtype=None):
        part = Partition(tree.tip_count, tree.inner_count, 4, 300, 1,
                         tree.edge_count, 4, tree.inner_count,
                         site_repeats=True, rate_scalers=True, dtype=dtype)
        for tip in tree.tips():
            part.set_tip_states(tip.clv_index, maps.map_nt, by[tip.label])
        part.set_frequencies(0, FREQS)
        part.set_subst_params(0, SUBST)
        part.set_category_rates(rates)
        return part

    ref = oracle.OraclePartition(
        tree.tip_count, tree.inner_count, 4, 300, 1, tree.edge_count, 4,
        tree.inner_count,
        attributes=oracle.ATTRIB_SITE_REPEATS | oracle.ATTRIB_RATE_SCALERS)
    for tip in tree.tips():
        ref.set_tip_states(tip.clv_index, "nt", by[tip.label])
    ref.set_frequencies(0, FREQS)
    ref.set_subst_params(0, SUBST)
    ref.set_category_rates(rates)
    saved = (N_TAXA, N_SITES)
    N_TAXA, N_SITES = n, 300
    try:
        lk_ref, per_ref = _evaluate(ref, tree, is_oracle=True)
        ref.destroy()

        # 1. pooled XLA step-by-step (fp64)
        part = build()
        lk, per = _evaluate(part, tree)
        # per-rate scalers must actually have fired, non-uniformly
        sc = np.asarray(part.sc_flat)
        assert sc.max() > 0, "no scaling events: test is vacuous"
        assert (sc.max(axis=0) != sc.min(axis=0)).any(), \
            "per-rate scalers never diverged across categories"
        np.testing.assert_allclose(lk, lk_ref, rtol=1e-10)
        np.testing.assert_allclose(np.asarray(per)[:300], per_ref[:300],
                                   rtol=1e-8, atol=1e-10)

        # 2. engine pooled mode: pallas='pool' selects the XLA buckets
        eng_pool = TreeEngine(build(), tree, pallas="pool")
        assert eng_pool.execution_path == "pool"
        np.testing.assert_allclose(eng_pool.loglikelihood(), lk_ref,
                                   rtol=1e-10)

        # 3. dense-fused fp32 engine (per-rate fused kernel over pooled
        # storage)
        eng_f = TreeEngine(build(jnp.float32), tree, pallas="interpret")
        assert eng_f.repeats_dense_fused, eng_f.execution_path
        np.testing.assert_allclose(eng_f.loglikelihood(), lk_ref,
                                   rtol=5e-5)

        # derivatives through the pooled per-rate path vs a plain
        # per-rate partition (fp64 truth)
        plain = Partition(tree.tip_count, tree.inner_count, 4, 300, 1,
                          tree.edge_count, 4, tree.inner_count,
                          rate_scalers=True)
        for tip in tree.tips():
            plain.set_tip_states(tip.clv_index, maps.map_nt,
                                 by[tip.label])
        plain.set_frequencies(0, FREQS)
        plain.set_subst_params(0, SUBST)
        plain.set_category_rates(rates)
        eng_plain = TreeEngine(plain, tree, pallas=False)
        eng_pool2 = TreeEngine(build(), tree, pallas=False)
        lkp, d1p, d2p = eng_plain.newton_step()
        lkr, d1r, d2r = eng_pool2.newton_step()
        np.testing.assert_allclose(lkr, lkp, rtol=1e-10)
        np.testing.assert_allclose(d1r, d1p, rtol=1e-8)
        np.testing.assert_allclose(d2r, d2p, rtol=1e-8)
    finally:
        N_TAXA, N_SITES = saved
