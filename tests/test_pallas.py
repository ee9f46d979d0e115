"""Fused traversal kernel validation (ops/pallas_fused.py, Pallas
interpret mode on CPU): exact equality with the XLA level path in fp32,
including underflow-scaling cases."""
import numpy as np
import pytest
import jax.numpy as jnp

from libpll2_jax import Partition, TreeEngine, compute_gamma_cats
from libpll2_jax.io import maps
from libpll2_jax.trees import parse_newick, random_utree
from libpll2_jax.utils import simulate_alignment

FREQS = [0.3, 0.2, 0.2, 0.3]
SUBST = [1, 2, 1, 1, 2, 1]

KERNELS = ["interpret"]


def _build(tree, headers, seqs, sites, states=4, rate_cats=4):
    by = dict(zip(headers, seqs))
    part = Partition(tree.tip_count, tree.inner_count, states, sites, 1,
                     tree.edge_count, rate_cats, tree.inner_count,
                     dtype=jnp.float32)
    cm = maps.map_nt if states == 4 else maps.map_aa
    for t in tree.tips():
        part.set_tip_states(t.clv_index, cm, by[t.label])
    part.set_frequencies(0, FREQS if states == 4 else
                         np.full(states, 1.0 / states))
    part.set_subst_params(0, SUBST if states == 4 else
                          np.ones(states * (states - 1) // 2))
    part.set_category_rates(compute_gamma_cats(0.9, rate_cats))
    return part


@pytest.mark.parametrize("kernel", KERNELS)
def test_pallas_matches_xla_random_tree(kernel):
    tree = random_utree([f"t{i}" for i in range(12)], seed=5)
    headers, seqs = simulate_alignment(tree, 256, FREQS, SUBST,
                                       alpha=0.9, seed=5)
    e_xla = TreeEngine(_build(tree, headers, seqs, 256), tree, pallas=False)
    e_pl = TreeEngine(_build(tree, headers, seqs, 256), tree,
                      pallas=kernel)
    assert e_pl.use_pallas
    assert e_pl.use_fused == (kernel == "interpret")
    np.testing.assert_array_equal(e_pl.loglikelihood(),
                                  e_xla.loglikelihood())


@pytest.mark.parametrize("kernel", KERNELS)
def test_pallas_matches_xla_with_scaling(kernel):
    """Caterpillar topology forces fp32 underflow scaling (2^-64 window)."""
    n = 80
    text = f"t{n-1}:0.1"
    for i in range(n - 2, 1, -1):
        text = f"(t{i}:0.1,{text}):0.1"
    tree = parse_newick(f"(t0:0.1,t1:0.1,{text});")
    headers, seqs = simulate_alignment(tree, 128, FREQS, SUBST,
                                       alpha=0.9, seed=3)
    p_xla = _build(tree, headers, seqs, 128)
    p_pl = _build(tree, headers, seqs, 128)
    e_xla = TreeEngine(p_xla, tree, pallas=False)
    e_pl = TreeEngine(p_pl, tree, pallas=kernel)
    lk_x = e_xla.loglikelihood()
    lk_p = e_pl.loglikelihood()
    # scaling must actually trigger for this test to mean anything
    n_scaled = int(np.asarray(
        p_xla.scale_buffer[:p_xla.scale_buffers]).sum())
    assert n_scaled > 0
    np.testing.assert_array_equal(lk_p, lk_x)
    # fused kernel materializes only the root edge rows
    root = tree.vroot
    for idx in (root.scaler_index, root.back.scaler_index):
        if idx >= 0:
            np.testing.assert_array_equal(
                np.asarray(p_pl.scale_buffer[idx]),
                np.asarray(p_xla.scale_buffer[idx]))


@pytest.mark.parametrize("kernel", KERNELS)
def test_pallas_matches_xla_20_states(kernel):
    from libpll2_jax.models import load_aa_model
    tree = random_utree([f"t{i}" for i in range(8)], seed=3)
    headers, seqs = simulate_alignment(tree, 256, [1 / 20] * 20,
                                       [1.0] * 190, alpha=1.0, seed=3)
    by = dict(zip(headers, seqs))

    def build():
        part = Partition(tree.tip_count, tree.inner_count, 20, 256, 1,
                         tree.edge_count, 4, tree.inner_count,
                         dtype=jnp.float32)
        for t in tree.tips():
            part.set_tip_states(t.clv_index, maps.map_aa, by[t.label])
        load_aa_model(part, "lg")
        part.set_category_rates(compute_gamma_cats(1.0, 4))
        return part

    e_xla = TreeEngine(build(), tree, pallas=False)
    e_pl = TreeEngine(build(), tree, pallas=kernel)
    assert e_pl.use_pallas
    np.testing.assert_array_equal(e_pl.loglikelihood(),
                                  e_xla.loglikelihood())


@pytest.mark.parametrize("kernel", KERNELS)
def test_pallas_newton_matches_xla(kernel):
    tree = random_utree([f"t{i}" for i in range(10)], seed=9)
    headers, seqs = simulate_alignment(tree, 128, FREQS, SUBST,
                                       alpha=0.9, seed=9)
    e_xla = TreeEngine(_build(tree, headers, seqs, 128), tree, pallas=False)
    e_pl = TreeEngine(_build(tree, headers, seqs, 128), tree,
                      pallas=kernel)
    np.testing.assert_array_equal(e_pl.newton_step(), e_xla.newton_step())


def test_fused_evaluate_topologies_matches_scan():
    """The batched multi-topology scorer must agree between the fused
    kernel path and the XLA scan path for NNI-style candidates."""
    from libpll2_jax.trees import create_operations, traverse
    from libpll2_jax.trees import moves
    from libpll2_jax import constants as C

    tree = random_utree([f"t{i}" for i in range(10)], seed=2)
    headers, seqs = simulate_alignment(tree, 128, FREQS, SUBST,
                                       alpha=0.9, seed=2)
    e_f = TreeEngine(_build(tree, headers, seqs, 128), tree,
                     pallas="interpret")
    e_x = TreeEngine(_build(tree, headers, seqs, 128), tree, pallas=False)
    assert e_f.use_fused

    candidates = []
    inner = [n for n in tree.nodes() if not n.is_tip()]
    for node in inner[:3]:
        for h in node.ring():
            if h.back is not None and not h.back.is_tip():
                rb = moves.Rollback()
                moves.nni(h, C.UTREE_MOVE_NNI_LEFT, rb)
                trav = traverse(tree.vroot)
                ops, br, pidx = create_operations(trav)
                vr = tree.vroot
                ri = (vr.clv_index, vr.scaler_index, vr.back.clv_index,
                      vr.back.scaler_index, vr.pmatrix_index)
                candidates.append((ops, br, pidx, ri))
                moves.rollback_move(rb)
                break
    assert len(candidates) >= 2
    sf = e_f.evaluate_topologies(candidates)
    sx = e_x.evaluate_topologies(candidates)
    # the scan path and the fused kernel are different execution plans;
    # fp32 rounding may differ by ~1 ulp in the site accumulation
    np.testing.assert_allclose(sf, sx, rtol=1e-6)


def test_fused_newton_loop_matches_xla():
    tree = random_utree([f"t{i}" for i in range(10)], seed=11)
    headers, seqs = simulate_alignment(tree, 128, FREQS, SUBST,
                                       alpha=0.9, seed=11)
    e_xla = TreeEngine(_build(tree, headers, seqs, 128), tree, pallas=False)
    e_f = TreeEngine(_build(tree, headers, seqs, 128), tree,
                     pallas="interpret")
    assert e_f.use_fused
    lk_f, d1_f, d2_f = e_f.newton_loop(4)
    lk_x, d1_x, d2_x = e_xla.newton_loop(4)
    np.testing.assert_allclose(lk_f, lk_x, rtol=1e-6)
    # at convergence d1 ~ 0; compare with absolute fp32 tolerance
    np.testing.assert_allclose(d1_f, d1_x, atol=1e-4)
    np.testing.assert_allclose(d2_f, d2_x, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.asarray(e_f.branches),
                               np.asarray(e_xla.branches), rtol=1e-5)


def test_fused_loglikelihood_loop_matches_single():
    tree = random_utree([f"t{i}" for i in range(8)], seed=13)
    headers, seqs = simulate_alignment(tree, 128, FREQS, SUBST,
                                       alpha=0.9, seed=13)
    e_f = TreeEngine(_build(tree, headers, seqs, 128), tree,
                     pallas="interpret")
    assert e_f.use_fused
    single = e_f.loglikelihood()
    acc = e_f.loglikelihood_loop(3)
    np.testing.assert_allclose(acc, 3 * single, rtol=1e-6)


def test_fused_stays_fused_when_tip_clv_set():
    """Raw-probability tips (pll_set_tip_clv) stay on the fused path:
    their f32 rows stream from device memory while every other tip keeps the
    bitmask decode (see tests/test_fused_modes.py for the full matrix)."""
    tree = random_utree([f"t{i}" for i in range(8)], seed=7)
    headers, seqs = simulate_alignment(tree, 128, FREQS, SUBST,
                                       alpha=0.9, seed=7)
    rng = np.random.default_rng(0)
    vals = rng.uniform(0.1, 1.0, size=(128, 4))
    tip = next(iter(tree.tips()))
    part = _build(tree, headers, seqs, 128)
    part.set_tip_clv(tip.clv_index, vals)
    part2 = _build(tree, headers, seqs, 128)
    part2.set_tip_clv(tip.clv_index, vals)
    e = TreeEngine(part, tree, pallas="interpret")
    assert e.use_fused
    e_ref = TreeEngine(part2, tree, pallas=False)
    np.testing.assert_allclose(e.loglikelihood(), e_ref.loglikelihood(),
                               rtol=1e-6)


def test_fused_tile_size_bit_identical():
    """The kernel's site tile is a launch shape, not a semantic: root CLVs
    and scalers must be BIT-IDENTICAL for every tile (each site's FMA
    order is the same), including an unaligned width the wrapper pads.
    A scaling-stressed caterpillar keeps the scaler semantics honest."""
    from libpll2_jax.ops import pallas_fused as pf
    from libpll2_jax.ops import pmatrix as op_pm
    from libpll2_jax.trees import create_operations, traverse

    n = 60
    text = f"t{n-1}:0.1"
    for i in range(n - 2, 1, -1):
        text = f"(t{i}:0.1,{text}):0.1"
    tree = parse_newick(f"(t0:0.1,t1:0.1,{text});")
    sites = 200
    headers, seqs = simulate_alignment(tree, sites, FREQS, SUBST,
                                       alpha=0.9, seed=11)
    part = _build(tree, headers, seqs, sites)
    ops, br, pmi = create_operations(traverse(tree.vroot))
    root = tree.vroot
    table, n_slots = pf.pack_fused_schedule(
        ops, part.tips, (root.clv_index, root.back.clv_index))
    assert table is not None
    part._ensure_eigen([0])
    blen = jnp.zeros(part.prob_matrices, jnp.float32).at[
        np.asarray(pmi)].set(jnp.asarray(br, jnp.float32))
    pm = op_pm.update_prob_matrices(
        jnp.asarray(part.eigenvals, jnp.float32),
        jnp.asarray(part.inv_eigenvecs, jnp.float32),
        jnp.asarray(part.eigenvecs, jnp.float32),
        jnp.asarray(part.prop_invar, jnp.float32),
        jnp.asarray(part.rates, jnp.float32),
        jnp.asarray([0] * 4, np.int32), blen)
    codes = jnp.asarray(pf.tip_code_matrix(part))
    kw = dict(rates=4, states=4, n_slots=n_slots,
              threshold=part.scale_threshold, factor=part.scale_factor,
              interpret=True)
    outs = [pf.fused_traversal(codes, pm, jnp.asarray(table), tile=t, **kw)
            for t in (32, 64, 256)]
    # scaling must actually trigger for the comparison to mean anything
    assert int(np.asarray(outs[0][2]).sum()) > 0
    assert outs[0][0].shape == (4, 4, sites)
    for other in outs[1:]:
        for a, b in zip(outs[0], other):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_fused_plane_layout_engine_end_to_end():
    """Engine logL through the fused kernel at 1024-site DNA (many site
    tiles) agrees with the XLA path (the fused path's FMA order differs
    from XLA's einsum by at most 1 ulp at this size)."""
    tree = random_utree([f"t{i}" for i in range(16)], seed=9)
    headers, seqs = simulate_alignment(tree, 1024, FREQS, SUBST,
                                       alpha=0.7, seed=9)
    e_xla = TreeEngine(_build(tree, headers, seqs, 1024), tree,
                       pallas=False)
    e_pl = TreeEngine(_build(tree, headers, seqs, 1024), tree,
                      pallas="interpret")
    assert e_pl.use_fused
    np.testing.assert_allclose(e_pl.loglikelihood(),
                               e_xla.loglikelihood(), rtol=1e-6)


def test_fused_unaligned_sites():
    """Real alignments are never lane-aligned: at sites=999 the fused
    kernel pads its tip-code matrix to the site tile internally and the
    engine slices the root rows back — logL, per-site output and a
    Newton loop must match the XLA scan path (and via it, the oracle)."""
    tree = random_utree([f"t{i}" for i in range(18)], seed=33)
    sites = 999
    headers, seqs = simulate_alignment(tree, sites, FREQS, SUBST,
                                       alpha=0.8, seed=33)
    part_f = _build(tree, headers, seqs, sites)
    eng_f = TreeEngine(part_f, tree, pallas="interpret")
    assert eng_f.use_fused, "unaligned sites must stay fused-eligible"
    lk_f, per_f = eng_f.loglikelihood_persite()

    part_x = _build(tree, headers, seqs, sites)
    eng_x = TreeEngine(part_x, tree, pallas=False)
    lk_x, per_x = eng_x.loglikelihood_persite()
    np.testing.assert_allclose(lk_f, lk_x, rtol=2e-6)
    np.testing.assert_allclose(per_f, per_x, rtol=2e-5, atol=1e-4)

    # loop + newton paths run through the padded kernel too
    acc = eng_f.loglikelihood_loop(3)
    np.testing.assert_allclose(acc, 3 * lk_f, rtol=2e-6)
    lkn, d1, d2 = eng_f.newton_loop(3)
    lknx, d1x, d2x = eng_x.newton_loop(3)
    np.testing.assert_allclose(lkn, lknx, rtol=2e-6)
    np.testing.assert_allclose(d1, d1x, rtol=1e-3, atol=1e-2)
