"""Topology search: NNI/SPR hill climbing recovers likelihood lost to
random topology perturbations (the reference consumers' search-loop
pattern, test/src/partial-traversal.c)."""
import numpy as np
import pytest

from libpll2_jax import Partition, compute_gamma_cats
from libpll2_jax import constants as C
from libpll2_jax.io import maps
from libpll2_jax.search import TreeSearch, _internal_edges
from libpll2_jax.trees import moves, random_utree
from libpll2_jax.utils import simulate_alignment

N_TAXA, N_SITES = 12, 500


def _setup(perturb: int):
    tree = random_utree([f"t{i}" for i in range(N_TAXA)], seed=33)
    headers, seqs = simulate_alignment(tree, N_SITES, [0.25] * 4,
                                       [1, 3, 1, 1, 3, 1], alpha=0.9,
                                       seed=33)
    rng = np.random.default_rng(1)
    for _ in range(perturb):
        edges = _internal_edges(tree)
        edge = edges[rng.integers(len(edges))]
        moves.nni(edge, C.UTREE_MOVE_NNI_LEFT, None)

    part = Partition(tree.tip_count, tree.inner_count, 4, N_SITES, 1,
                     tree.edge_count, 4, tree.inner_count)
    by_label = dict(zip(headers, seqs))
    for tip in tree.tips():
        part.set_tip_states(tip.clv_index, maps.map_nt, by_label[tip.label])
    part.set_frequencies(0, [0.25] * 4)
    part.set_subst_params(0, [1, 3, 1, 1, 3, 1])
    part.set_category_rates(compute_gamma_cats(0.9, 4))
    return part, tree


def test_nni_round_improves_perturbed_tree():
    part, tree = _setup(perturb=3)
    search = TreeSearch(part, tree)
    lk0 = search.evaluate()
    lk, accepted = search.nni_round()
    assert accepted >= 1
    assert lk > lk0 + 1.0


def test_search_converges_and_rollback_is_clean():
    part, tree = _setup(perturb=2)
    search = TreeSearch(part, tree)
    lk_final = search.run(max_rounds=5, use_spr=True)
    # converged: one more NNI round accepts nothing
    lk_again, accepted = search.nni_round()
    assert accepted == 0
    np.testing.assert_allclose(lk_again, lk_final, rtol=1e-12)


def test_batched_nni_matches_sequential():
    """One-dispatch candidate scoring finds the same optimum as
    move-by-move rescoring."""
    part_a, tree_a = _setup(perturb=3)
    lk_seq, _ = TreeSearch(part_a, tree_a).nni_round()
    # sequential is first-improvement, batched is steepest-ascent: both
    # must converge to at least the same likelihood on this easy recovery
    part_b, tree_b = _setup(perturb=3)
    lk_bat, accepted = TreeSearch(part_b, tree_b).nni_round_batched()
    assert accepted >= 1
    assert lk_bat >= lk_seq - 1e-6


def test_evaluate_topologies_agrees_with_single_eval():
    from libpll2_jax import TreeEngine
    from libpll2_jax.trees import create_operations
    from libpll2_jax.trees.utree import traverse

    part, tree = _setup(perturb=1)
    eng = TreeEngine(part, tree, level_schedule=False, pallas=False)
    trav = traverse(tree.vroot)
    ops, br, pidx = create_operations(trav)
    scores = eng.evaluate_topologies([(ops, br, pidx, tree.vroot)] * 3)
    single = eng.loglikelihood()
    np.testing.assert_allclose(scores, [single] * 3, rtol=1e-12)


def test_search_on_true_tree_accepts_nothing_worse():
    part, tree = _setup(perturb=0)
    search = TreeSearch(part, tree)
    lk0 = search.evaluate()
    lk, accepted = search.nni_round()
    assert lk >= lk0 - 1e-9


def test_spr_round_batched_recovers_tree():
    """Batched steepest-ascent SPR reaches at least the sequential SPR
    likelihood on an easy recovery problem, with far fewer dispatches."""
    part_a, tree_a = _setup(perturb=3)
    lk_seq, _ = TreeSearch(part_a, tree_a).spr_round()
    part_b, tree_b = _setup(perturb=3)
    s = TreeSearch(part_b, tree_b)
    lk_bat, accepted = s.spr_round_batched(batch=32)
    assert accepted >= 1
    assert lk_bat >= lk_seq - 1e-6


def test_spr_radius_targets_valid():
    """Radius-limited enumeration: every target is a valid regraft (not
    in the pruned subtree, not the identity neighborhood) and a subset
    of the full filtered target set."""
    from libpll2_jax.search import _all_edges, _radius_targets

    tree = random_utree([f"t{i}" for i in range(24)], seed=7)
    for p in _internal_edges(tree)[:8]:
        full = set()
        for r in _all_edges(tree):
            if r in (p, p.back, p.next, p.next.back,
                     p.next.next, p.next.next.back):
                continue
            if moves.utree_find(p.back, r) or r.back is None:
                continue
            full.add(id(r))
            full.add(id(r.back))
        rt = _radius_targets(p, 5)
        assert rt, "radius enumeration found no targets"
        assert len({id(r) for r in rt}) == len(rt)      # no duplicates
        for r in rt:
            assert id(r) in full or id(r.back) in full


def test_spr_radius_round_improves():
    part, tree = _setup(perturb=4)
    search = TreeSearch(part, tree)
    lk0 = search.evaluate()
    lk, accepted = search.spr_round_batched(radius=4)
    assert accepted >= 1 and lk > lk0 + 0.5


def test_search_no_recompile_across_rounds():
    """The no-recompile invariant of the search loop: after the first
    (warm) round, later NNI/SPR rounds reuse the already-compiled
    programs — topology is data, candidate counts pad to a bounded set
    of buckets (reference consumers' pattern: partial-traversal.c reuses
    one likelihood program across every move)."""
    import logging

    import jax

    part, tree = _setup(perturb=5)
    search = TreeSearch(part, tree)
    search.evaluate()
    # warm round compiles the candidate-batch program buckets
    search.nni_round_batched()
    search.spr_round_batched(radius=4, max_candidates=8)

    compiles = []

    class _Counter(logging.Handler):
        def emit(self, record):
            msg = record.getMessage()
            if msg.startswith("Finished XLA compilation"):
                compiles.append(msg)

    handler = _Counter()
    logger = logging.getLogger("jax._src.dispatch")
    old_level = logger.level
    jax.config.update("jax_log_compiles", True)
    logger.addHandler(handler)
    try:
        # perturb again so the rounds do real work on a NEW topology
        rng = np.random.default_rng(9)
        for _ in range(3):
            edges = _internal_edges(tree)
            moves.nni(edges[rng.integers(len(edges))],
                      C.UTREE_MOVE_NNI_LEFT, None)
        search.nni_round_batched()
        search.spr_round_batched(radius=4, max_candidates=8)
    finally:
        logger.removeHandler(handler)
        logger.setLevel(old_level)
        jax.config.update("jax_log_compiles", False)
    assert compiles == [], f"search rounds recompiled: {compiles}"


def test_packed_candidates_match_object_pipeline():
    """eng.pack_candidate + evaluate_packed (the search loop's one-pass
    fast path) returns the same scores as evaluate_topologies over the
    Operation-object pipeline, and spr_round_batched picks it up on the
    fused path."""
    import jax.numpy as jnp

    from libpll2_jax import TreeEngine
    from libpll2_jax.trees import create_operations, traverse

    tree32 = random_utree([f"t{i}" for i in range(N_TAXA)], seed=33)
    headers, seqs = simulate_alignment(tree32, N_SITES, [0.25] * 4,
                                       [1, 3, 1, 1, 3, 1], alpha=0.9,
                                       seed=33)
    by = dict(zip(headers, seqs))
    part32 = Partition(tree32.tip_count, tree32.inner_count, 4, N_SITES,
                       1, tree32.edge_count, 4, tree32.inner_count,
                       dtype=jnp.float32)
    for tip in tree32.tips():
        part32.set_tip_states(tip.clv_index, maps.map_nt, by[tip.label])
    part32.set_frequencies(0, [0.25] * 4)
    part32.set_subst_params(0, [1, 3, 1, 1, 3, 1])
    part32.set_category_rates(compute_gamma_cats(0.9, 4))
    eng = TreeEngine(part32, tree32, pallas="interpret")
    assert eng.use_fused
    # a few NNI variants, both pipelines
    packed, objs = [], []
    for edge in _internal_edges(tree32)[:4]:
        rb = moves.Rollback()
        moves.nni(edge, C.UTREE_MOVE_NNI_LEFT, rb)
        vr = tree32.vroot
        pc = eng.pack_candidate(vr)
        assert pc is not None
        packed.append(pc)
        trav = traverse(vr)
        ops, br, pidx = create_operations(trav)
        objs.append((ops, br, pidx,
                     (vr.clv_index, vr.scaler_index, vr.back.clv_index,
                      vr.back.scaler_index, vr.pmatrix_index)))
        moves.rollback_move(rb)
    sp = eng.evaluate_packed(packed)
    so = eng.evaluate_topologies(objs)
    np.testing.assert_allclose(sp, so, rtol=1e-6)
    # the round uses the packed path end-to-end on the fused engine
    search = TreeSearch(part32, tree32, pallas="interpret")
    lk0 = search.evaluate()
    assert search._engine.use_fused
    lk, acc = search.spr_round_batched(radius=3)
    assert lk >= lk0
