"""Streamed SPR scoring (ops/spr_stream.py) parity vs full evaluation.

Every candidate's streamed logL — composed from directional CLVs, the
corrected remaining-tree CLVs and the half-branch regraft pmatrices —
must equal a from-scratch full-tree evaluation of the APPLIED topology
(reference semantics: moves.spr's relink at utree_moves.c:119-255, edge
logL at likelihood.c:586). fp64 here; the fp32 device path is covered by
the round-parity test + the on-device parity gate.
"""
import numpy as np
import pytest

import jax.numpy as jnp

from libpll2_jax import Partition, TreeEngine, compute_gamma_cats
from libpll2_jax import constants as C
from libpll2_jax.io import maps
from libpll2_jax.ops import spr_stream
from libpll2_jax.search import TreeSearch, _internal_edges
from libpll2_jax.trees import moves, random_alignment, random_utree


def _problem(n_taxa, n_sites, seed=3, states=4, alpha=0.8, pinv=0.0,
             scale_stress=False, dtype=None, sites_alignment=1,
             rate_scalers=False, site_repeats=False, conserved=False):
    alphabet = "ACGT" if states == 4 else "ARNDCQEGHILKMFPSTWYV"
    headers, seqs = random_alignment(n_taxa, n_sites, alphabet=alphabet,
                                     seed=seed)
    if conserved:
        # duplicate columns so the repeats tables genuinely compress
        rng0 = np.random.default_rng(seed + 100)
        src = rng0.integers(0, max(n_sites // 4, 1), size=n_sites)
        seqs = ["".join(s[j] for j in src) for s in seqs]
    if pinv:
        # guarantee invariant columns for the +I machinery
        seqs = [s[:-8] + alphabet[0] * 4 + alphabet[1] * 4 for s in seqs]
    tree = random_utree(headers, seed=seed)
    if scale_stress:
        # long branches + tiny alpha drive per-site underflow scalings
        for node in tree.nodes():
            halves = [node] if node.is_tip() else list(node.ring())
            for h in halves:
                if h.back is not None:
                    h.length = h.back.length = (h.length or 0.1) * 40.0
    part = Partition(tree.tip_count, tree.inner_count, states, n_sites, 1,
                     tree.edge_count, 4, tree.inner_count, dtype=dtype,
                     sites_alignment=sites_alignment,
                     rate_scalers=rate_scalers, site_repeats=site_repeats)
    by = dict(zip(headers, seqs))
    cm = maps.map_nt if states == 4 else maps.map_aa
    for tip in tree.tips():
        part.set_tip_states(tip.clv_index, cm, by[tip.label])
    rng = np.random.default_rng(seed)
    part.set_frequencies(0, rng.dirichlet(np.ones(states) * 10))
    part.set_subst_params(0, rng.uniform(0.5, 2.0,
                                         size=states * (states - 1) // 2))
    part.set_category_rates(compute_gamma_cats(alpha, 4))
    if pinv:
        part.update_invariant_sites_proportion(0, pinv)
    return part, tree


def _asc_problem(n_taxa, n_sites, asc, seed=3):
    headers, seqs = random_alignment(n_taxa, n_sites, seed=seed)
    tree = random_utree(headers, seed=seed)
    part = Partition(tree.tip_count, tree.inner_count, 4, n_sites, 1,
                     tree.edge_count, 4, tree.inner_count,
                     asc_bias=getattr(C.AscBias, asc.upper()))
    by = dict(zip(headers, seqs))
    for tip in tree.tips():
        part.set_tip_states(tip.clv_index, maps.map_nt, by[tip.label])
    rng = np.random.default_rng(seed)
    part.set_frequencies(0, rng.dirichlet(np.ones(4) * 10))
    part.set_subst_params(0, rng.uniform(0.5, 2.0, size=6))
    part.set_category_rates(compute_gamma_cats(0.8, 4))
    part.set_asc_state_weights([2, 3, 1, 2])
    return part, tree


def _stream_all(part, tree, eng, radius, chunk=64):
    from libpll2_jax.search import TreeSearch as _TS
    groups = [(pr, spr_stream.enumerate_targets(pr, radius))
              for pr in list(_internal_edges(tree))]
    sched = spr_stream.build_spr_stream(
        tree, groups, _TS._n_rows(part), part.scale_buffers,
        part.prob_matrices)
    margs = eng._model_args()
    pw, invariant = eng._site_args()
    clv_arg, sc_arg, base = _TS._stream_base(part)
    totals = spr_stream.spr_stream_scores(
        clv_arg, sc_arg, *margs,
        spr_stream.ops_from_table(sched.post_table),
        jnp.asarray(sched.post_valid),
        spr_stream.ops_from_table(sched.up_table),
        jnp.asarray(sched.up_valid),
        spr_stream.ops_from_table(sched.a_table),
        jnp.asarray(sched.a_valid),
        jnp.asarray(sched.blen_full, part.dtype),
        jnp.asarray(sched.merged_len, part.dtype),
        jnp.asarray(sched.half_len, part.dtype),
        jnp.asarray(sched.cand_rows), pw, invariant,
        part.scale_threshold, part.scale_factor,
        n_aux=sched.n_aux, n_arows=sched.n_arows, chunk=chunk,
        rate_scalers=part.rate_scalers, base=base,
        asc_type=eng.asc_type, n_real=eng.n_real)
    return sched, np.asarray(totals)[:sched.n_candidates]


def _full_scores(tree, eng, pairs):
    out = np.zeros(len(pairs))
    for i, (p, r) in enumerate(pairs):
        rb = moves.Rollback()
        moves.spr(p, r, rb, safe=True)
        eng.set_topology(tree)
        out[i] = eng.loglikelihood()
        moves.rollback_move(rb)
    return out


@pytest.mark.parametrize("states,pinv", [
    (4, 0.0),
    (4, 0.3),
    (20, 0.0),
])
def test_streamed_scores_match_full_eval(states, pinv):
    part, tree = _problem(13, 64, seed=5, states=states, pinv=pinv)
    eng = TreeEngine(part, tree, level_schedule=True, pallas=False)
    sched, scores = _stream_all(part, tree, eng, radius=4)
    assert sched.n_candidates > 20
    full = _full_scores(tree, eng, sched.pairs)
    np.testing.assert_allclose(scores, full, rtol=1e-9, atol=1e-7)


def test_streamed_scores_fp32_scaling_stress():
    """fp32 (threshold 2^-32) at 40 taxa underflows without the per-site
    scalers; parity with the fp64 full evaluation proves the streamed
    composition propagates and undoes scaler counts correctly."""
    part32, tree32 = _problem(40, 64, seed=7, dtype=jnp.float32)
    eng32 = TreeEngine(part32, tree32, level_schedule=True, pallas=False)
    sched32, scores32 = _stream_all(part32, tree32, eng32, radius=4)

    part64, tree64 = _problem(40, 64, seed=7)
    eng64 = TreeEngine(part64, tree64, level_schedule=True, pallas=False)
    groups64 = [(pr, spr_stream.enumerate_targets(pr, 4))
                for pr in list(_internal_edges(tree64))]
    pairs64 = [(p, t) for p, ts in groups64 for t, _, _ in ts]
    assert len(pairs64) == sched32.n_candidates
    full64 = _full_scores(tree64, eng64, pairs64)
    # per-site likelihoods ~2^-50 here: far below the fp32 threshold, so
    # agreement with fp64 is impossible unless scaling engaged
    assert float(np.max(full64) / 64) < -30
    assert np.all(np.isfinite(scores32))
    np.testing.assert_allclose(scores32, full64, rtol=5e-4)


@pytest.mark.parametrize("states,rate_scalers", [
    (4, False),
    (4, True),
    (20, False),
])
def test_streamed_scores_match_full_eval_repeats(states, rate_scalers):
    """Site-repeats partitions on the streamed path (the RAxML-NG
    production combo, reference repeats.c:299 under the op consumer of
    partials.c:245): the scorer rebuilds a dense base from the tip rows
    in-program, so the pooled storage keeps its memory win while every
    candidate is scored from directional CLVs. Parity vs the engine's
    pooled full evaluation per candidate."""
    part, tree = _problem(13, 64, seed=5, states=states,
                          site_repeats=True, conserved=True,
                          rate_scalers=rate_scalers)
    assert part.repeats is not None
    eng = TreeEngine(part, tree, level_schedule=True, pallas=False)
    sched, scores = _stream_all(part, tree, eng, radius=4)
    assert sched.n_candidates > 20
    full = _full_scores(tree, eng, sched.pairs)
    np.testing.assert_allclose(scores, full, rtol=1e-9, atol=1e-7)


@pytest.mark.parametrize("asc", ["lewis", "felsenstein", "stamatakis"])
def test_streamed_scores_match_full_eval_asc(asc):
    """Ascertainment-bias partitions on the streamed path: the synthetic
    all-state-k columns ride the directional/corrected passes like
    ordinary sites and the per-candidate correction is applied in the
    epilogue (reference likelihood.c:24-117). Parity vs the engine's
    full asc evaluation per candidate, for all three correction types."""
    part, tree = _asc_problem(12, 96, asc, seed=7)
    eng = TreeEngine(part, tree, level_schedule=True, pallas=False)
    sched, scores = _stream_all(part, tree, eng, radius=4)
    assert sched.n_candidates > 15
    full = _full_scores(tree, eng, sched.pairs)
    np.testing.assert_allclose(scores, full, rtol=1e-9, atol=1e-7)


def test_streamed_round_matches_batched_asc():
    part, tree = _asc_problem(14, 80, "lewis", seed=9)
    s1 = TreeSearch(part, tree)
    s1._ensure_engine()
    assert s1._streamed_eligible()     # asc must NOT fall back
    best1, acc1 = s1.spr_round_streamed(radius=4)
    part2, tree2 = _asc_problem(14, 80, "lewis", seed=9)
    s2 = TreeSearch(part2, tree2)
    best2, acc2 = s2.spr_round_batched(radius=4)
    assert acc1 == acc2
    np.testing.assert_allclose(best1, best2, rtol=1e-9)


def test_streamed_round_matches_batched_round_repeats():
    part, tree = _problem(16, 96, seed=11, site_repeats=True,
                          conserved=True)
    s1 = TreeSearch(part, tree)
    s1._ensure_engine()
    assert s1._streamed_eligible()     # repeats must NOT fall back
    best1, acc1 = s1.spr_round_streamed(radius=4)

    part2, tree2 = _problem(16, 96, seed=11, site_repeats=True,
                            conserved=True)
    s2 = TreeSearch(part2, tree2)
    best2, acc2 = s2.spr_round_batched(radius=4)
    assert acc1 == acc2
    np.testing.assert_allclose(best1, best2, rtol=1e-9)


def test_nni_streamed_round_matches_batched_repeats():
    part, tree = _problem(16, 96, seed=17, site_repeats=True,
                          conserved=True)
    s1 = TreeSearch(part, tree)
    best1, acc1 = s1.nni_round_streamed()
    part2, tree2 = _problem(16, 96, seed=17, site_repeats=True,
                            conserved=True)
    s2 = TreeSearch(part2, tree2)
    best2, acc2 = s2.nni_round_batched()
    assert acc1 == acc2
    np.testing.assert_allclose(best1, best2, rtol=1e-9)


def test_streamed_candidate_set_matches_radius_targets():
    from libpll2_jax.search import _radius_targets
    part, tree = _problem(16, 32, seed=9)
    for pr in _internal_edges(tree):
        want = [id(t) for t in _radius_targets(pr, 4)]
        got = [id(t) for t, _, _ in spr_stream.enumerate_targets(pr, 4)]
        assert got == want


def test_streamed_round_matches_batched_round():
    part, tree = _problem(16, 96, seed=11)
    s1 = TreeSearch(part, tree)
    best1, acc1 = s1.spr_round_streamed(radius=4)

    part2, tree2 = _problem(16, 96, seed=11)
    s2 = TreeSearch(part2, tree2)
    best2, acc2 = s2.spr_round_batched(radius=4)
    assert acc1 == acc2
    np.testing.assert_allclose(best1, best2, rtol=1e-9)


def test_streamed_round_matches_batched_subsampled():
    # max_candidates subsampling consumes the rng exactly like the
    # batched round, so both score the same candidate subsets and
    # accept the same moves
    part, tree = _problem(16, 96, seed=13)
    s1 = TreeSearch(part, tree)
    best1, acc1 = s1.spr_round_streamed(radius=4, max_candidates=3,
                                        seed=5)
    part2, tree2 = _problem(16, 96, seed=13)
    s2 = TreeSearch(part2, tree2)
    best2, acc2 = s2.spr_round_batched(radius=4, max_candidates=3,
                                       seed=5)
    assert acc1 == acc2
    np.testing.assert_allclose(best1, best2, rtol=1e-9)


def test_nni_streamed_scores_match_full_eval():
    part, tree = _problem(13, 64, seed=5)
    eng = TreeEngine(part, tree, level_schedule=True, pallas=False)
    edges = list(_internal_edges(tree))
    sched = spr_stream.build_nni_stream(
        tree, edges, part.clv.shape[0], part.scale_buffers,
        part.prob_matrices)
    margs = eng._model_args()
    pw, invariant = eng._site_args()
    totals = spr_stream.nni_stream_scores(
        part.clv, part.scale_buffer, *margs,
        spr_stream.ops_from_table(sched.post_table),
        jnp.asarray(sched.post_valid),
        spr_stream.ops_from_table(sched.up_table),
        jnp.asarray(sched.up_valid),
        jnp.asarray(sched.blen_full, part.dtype),
        jnp.asarray(sched.cand_rows), pw, invariant,
        part.scale_threshold, part.scale_factor,
        n_aux=sched.n_aux, n_arows=sched.n_arows, chunk=64)
    scores = np.asarray(totals)[:sched.n_candidates]
    assert sched.n_candidates == 2 * len(edges)
    full = np.zeros_like(scores)
    for i, (edge, kind) in enumerate(sched.pairs):
        moves.nni(edge, kind, None)
        eng.set_topology(tree)
        full[i] = eng.loglikelihood()
        moves.nni(edge, kind, None)          # involution: undo
    np.testing.assert_allclose(scores, full, rtol=1e-9, atol=1e-7)


def test_nni_streamed_round_matches_batched():
    part, tree = _problem(16, 96, seed=17)
    s1 = TreeSearch(part, tree)
    best1, acc1 = s1.nni_round_streamed()
    part2, tree2 = _problem(16, 96, seed=17)
    s2 = TreeSearch(part2, tree2)
    best2, acc2 = s2.nni_round_batched()
    assert acc1 == acc2
    np.testing.assert_allclose(best1, best2, rtol=1e-9)


def test_streamed_rounds_no_recompile_at_established_shapes():
    """Streamed-round program shapes are bucketed AND monotone per
    search (wave-count floors carry the historical max, candidate /
    merged-pmatrix counts pad to powers of two), so rounds recompile
    only while the tree is outgrowing every previously seen depth
    bucket — never on a mere wobble. After one post-perturbation round
    has established the grown shapes, further perturbed rounds must be
    compile-free."""
    import logging

    import jax as _jax
    from libpll2_jax.trees import moves as _mv
    from libpll2_jax import constants as _C

    part, tree = _problem(20, 96, seed=21)
    s = TreeSearch(part, tree)
    s.spr_round_streamed(radius=3)
    s.nni_round_streamed()

    rng = np.random.default_rng(3)

    def perturb(k):
        for _ in range(k):
            edges = _internal_edges(tree)
            _mv.nni(edges[rng.integers(len(edges))],
                    _C.UTREE_MOVE_NNI_LEFT, None)

    # heavy perturbation: this round may compile once (depth grew past
    # the historical bucket; the floors absorb it for all later rounds)
    perturb(5)
    s.spr_round_streamed(radius=3)
    s.nni_round_streamed()

    compiles = []

    class _Counter(logging.Handler):
        def emit(self, record):
            msg = record.getMessage()
            if msg.startswith("Finished XLA compilation"):
                compiles.append(msg)

    handler = _Counter()
    logger = logging.getLogger("jax._src.dispatch")
    _jax.config.update("jax_log_compiles", True)
    logger.addHandler(handler)
    try:
        perturb(2)
        s.spr_round_streamed(radius=3)
        s.nni_round_streamed()
    finally:
        logger.removeHandler(handler)
        _jax.config.update("jax_log_compiles", False)
    assert compiles == [], f"streamed rounds recompiled: {compiles}"


def test_streamed_rounds_under_mesh_match_single_device():
    """Site-sharded partitions run the streamed scoring per shard with
    one logL psum; rounds on an 8-device mesh must accept the same
    moves at the same logL as the single-device rounds."""
    import jax
    from libpll2_jax.parallel import make_mesh, shard_partition

    part, tree = _problem(16, 128, seed=23, sites_alignment=8)
    mesh = make_mesh(devices=jax.devices("cpu")[:8])
    shard_partition(part, mesh)
    s = TreeSearch(part, tree)
    s.evaluate()
    assert s._streamed_eligible()       # mesh does NOT force a fallback
    b_spr, a_spr = s.spr_round_streamed(radius=4)
    b_nni, a_nni = s.nni_round_streamed()

    part2, tree2 = _problem(16, 128, seed=23)
    s2 = TreeSearch(part2, tree2)
    b_spr2, a_spr2 = s2.spr_round_streamed(radius=4)
    b_nni2, a_nni2 = s2.nni_round_streamed()
    assert (a_spr, a_nni) == (a_spr2, a_nni2)
    np.testing.assert_allclose(b_spr, b_spr2, rtol=1e-9)
    np.testing.assert_allclose(b_nni, b_nni2, rtol=1e-9)

    # per-rate scaler buffers shard on their trailing site axis
    part3, tree3 = _problem(16, 128, seed=23, sites_alignment=8,
                            rate_scalers=True)
    shard_partition(part3, mesh)
    s3 = TreeSearch(part3, tree3)
    s3.evaluate()
    assert s3._streamed_eligible()
    b3, a3 = s3.nni_round_streamed()
    part4, tree4 = _problem(16, 128, seed=23, rate_scalers=True)
    s4 = TreeSearch(part4, tree4)
    b4, a4 = s4.nni_round_streamed()
    assert a3 == a4
    np.testing.assert_allclose(b3, b4, rtol=1e-9)


def test_streamed_round_fallback_on_asc():
    # asc-bias partitions are ineligible: the round must still work
    # (delegating to the batched full-traversal scorer)
    headers, seqs = random_alignment(8, 48, seed=2)
    tree = random_utree(headers, seed=2)
    part = Partition(tree.tip_count, tree.inner_count, 4, 48, 1,
                     tree.edge_count, 4, tree.inner_count,
                     asc_bias=C.AscBias.LEWIS)
    by = dict(zip(headers, seqs))
    for tip in tree.tips():
        part.set_tip_states(tip.clv_index, maps.map_nt, by[tip.label])
    part.set_frequencies(0, [0.3, 0.2, 0.2, 0.3])
    part.set_subst_params(0, [1, 2, 1, 1, 2, 1.0])
    part.set_category_rates(compute_gamma_cats(0.8, 4))
    s = TreeSearch(part, tree)
    best, acc = s.spr_round_streamed(radius=3)
    assert np.isfinite(best)


def test_native_schedule_matches_python_builder():
    """The native whole-round schedule builder (pllnative.cpp
    pll_nat_spr_stream_{enum,build}) must reproduce the Python
    build_spr_stream BIT-EXACTLY — tables, waves, candidate rows and
    order, subsample rng consumption — across full and subsampled
    rounds. The streamed-round tests above already exercise the native
    path end to end (search prefers it); this pins the equivalence."""
    from libpll2_jax import native
    from libpll2_jax.search import _internal_edges

    if native.load() is None:
        pytest.skip("native library unavailable")
    for n_taxa, seed, radius, maxc in ((16, 3, 4, None), (16, 7, 3, 2),
                                       (40, 5, 5, 3), (7, 2, 2, None)):
        part, tree = _problem(n_taxa, 16, seed=seed)
        args = (part.clv.shape[0], part.scale_buffers,
                part.prob_matrices)

        rng1 = np.random.default_rng(5)
        groups = []
        for pr in _internal_edges(tree):
            ts = spr_stream.enumerate_targets(pr, radius)
            kept = None
            if maxc and len(ts) > maxc:
                kept = list(rng1.permutation(len(ts))[:maxc])
            groups.append((pr, ts, kept))
        sp = spr_stream.build_spr_stream(tree, groups, *args)

        rng2 = np.random.default_rng(5)
        sn = spr_stream.build_spr_stream_native(
            tree, radius, *args, max_candidates=maxc, rng=rng2)
        assert sn is not None
        for f in ("post_table", "post_valid", "up_table", "up_valid",
                  "a_table", "a_valid", "cand_rows", "half_len",
                  "blen_full", "merged_len"):
            np.testing.assert_array_equal(
                getattr(sp, f), getattr(sn, f),
                err_msg=f"{f} taxa={n_taxa} r={radius} maxc={maxc}")
        assert sp.n_candidates == sn.n_candidates
        assert (sp.n_aux, sp.n_arows) == (sn.n_aux, sn.n_arows)
        assert len(sp.pairs) == len(sn.pairs)
        for (p1, t1), (p2, t2) in zip(sp.pairs, sn.pairs):
            assert p1 is p2 and t1 is t2


def test_streamed_scores_match_full_eval_rate_scalers():
    """PER-RATE scaler mode (reference core_partials.c:760 /
    pll.h:703): the streamed composition must sum [R, S] scaler
    buffers, track the merge event per rate and undo with the capped
    per-rate factors (core_likelihood.c:1463) — parity with full
    per-rate evaluations."""
    part, tree = _problem(13, 64, seed=5, rate_scalers=True)
    eng = TreeEngine(part, tree, level_schedule=True, pallas=False)
    sched, scores = _stream_all(part, tree, eng, radius=4)
    assert sched.n_candidates > 20
    full = _full_scores(tree, eng, sched.pairs)
    np.testing.assert_allclose(scores, full, rtol=1e-9, atol=1e-7)


def test_streamed_scores_rate_scalers_fp32_stress():
    """fp32 per-rate mode under scaling stress: agreement with the fp64
    full evaluation requires per-rate counts to propagate through all
    three passes and the candidate composition."""
    part32, tree32 = _problem(40, 64, seed=7, dtype=jnp.float32,
                              rate_scalers=True, alpha=0.45)
    eng32 = TreeEngine(part32, tree32, level_schedule=True, pallas=False)
    sched32, scores32 = _stream_all(part32, tree32, eng32, radius=4)

    part64, tree64 = _problem(40, 64, seed=7, alpha=0.45)
    eng64 = TreeEngine(part64, tree64, level_schedule=True, pallas=False)
    groups64 = [(pr, spr_stream.enumerate_targets(pr, 4))
                for pr in list(_internal_edges(tree64))]
    pairs64 = [(p, t) for p, ts in groups64 for t, _, _ in ts]
    full64 = _full_scores(tree64, eng64, pairs64)
    assert np.all(np.isfinite(scores32))
    np.testing.assert_allclose(scores32, full64, rtol=5e-4)


def test_streamed_rounds_rate_scalers_match_batched():
    """Per-rate partitions are streamed-eligible; rounds must accept the
    same moves at the same logL as the batched full-traversal rounds."""
    part, tree = _problem(16, 96, seed=11, rate_scalers=True)
    s1 = TreeSearch(part, tree)
    s1.evaluate()
    assert s1._streamed_eligible()
    b1, a1 = s1.spr_round_streamed(radius=4)
    n1, an1 = s1.nni_round_streamed()

    part2, tree2 = _problem(16, 96, seed=11, rate_scalers=True)
    s2 = TreeSearch(part2, tree2)
    b2, a2 = s2.spr_round_batched(radius=4)
    n2, an2 = s2.nni_round_batched()
    assert (a1, an1) == (a2, an2)
    np.testing.assert_allclose(b1, b2, rtol=1e-9)
    np.testing.assert_allclose(n1, n2, rtol=1e-9)


@pytest.mark.parametrize("seed", [203, 206, 210, 217, 225, 228])
def test_streamed_round_fuzz_matches_batched(seed):
    """Randomized attribute-combination fuzz for the streamed rounds
    (round-5 sweep: 30 seeds clean, incl. repeats / per-rate scalers /
    asc draws); a compact sample is pinned here. Streamed and batched
    rounds must accept the same moves at the same logL for ANY eligible
    configuration."""
    rng = np.random.default_rng(seed)
    states = int(rng.choice([4, 4, 20]))
    n = int(rng.integers(8, 15))
    n_sites = int(rng.integers(48, 160))
    repeats = bool(rng.integers(0, 3) == 0)
    rate_scalers = bool(rng.integers(0, 4) == 0)
    alpha = float(rng.uniform(0.3, 2.0))
    asc = None
    if not rate_scalers and not repeats and rng.integers(0, 3) == 0:
        asc = C.AscBias(int(rng.integers(1, 4)))
    alphabet = "ACGT" if states == 4 else "ARNDCQEGHILKMFPSTWYV"
    headers, seqs = random_alignment(n, n_sites, alphabet=alphabet,
                                     seed=seed)
    if repeats:
        src = rng.integers(0, max(n_sites // 3, 1), size=n_sites)
        seqs = ["".join(s[j] for j in src) for s in seqs]

    def build():
        rng2 = np.random.default_rng(seed + 1)
        tree = random_utree(headers, seed=seed)
        kw = {}
        if repeats:
            kw["site_repeats"] = True
        if rate_scalers:
            kw["rate_scalers"] = True
        if asc:
            kw["asc_bias"] = asc
        part = Partition(n, n - 2, states, n_sites, 1, 2 * n - 3, 4,
                         n - 2, **kw)
        by = dict(zip(headers, seqs))
        cm = maps.map_nt if states == 4 else maps.map_aa
        for t in tree.tips():
            part.set_tip_states(t.clv_index, cm, by[t.label])
        part.set_frequencies(0, rng2.dirichlet(np.ones(states) * 10))
        part.set_subst_params(
            0, rng2.uniform(0.5, 2.0, states * (states - 1) // 2))
        part.set_category_rates(compute_gamma_cats(alpha, 4))
        if asc:
            part.set_asc_state_weights([2] * states)
        return part, tree

    p1, t1 = build()
    s1 = TreeSearch(p1, t1)
    b1, a1 = s1.spr_round_streamed(radius=3, seed=2)
    p2, t2 = build()
    s2 = TreeSearch(p2, t2)
    b2, a2 = s2.spr_round_batched(radius=3, seed=2)
    assert a1 == a2
    np.testing.assert_allclose(b1, b2, rtol=1e-9)
