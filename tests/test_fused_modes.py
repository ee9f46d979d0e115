"""Fused-kernel support for the two attribute modes that once were
silent fast-path exclusions:

  * per-rate scalers (PLL_ATTRIB_RATE_SCALERS, reference
    core_partials.c:760-771 / core_likelihood.c:442-489): each rate block
    underflow-scales independently, one scaler row per rate;
  * raw-probability tips (pll_set_tip_clv, reference pll.c:959-1024):
    treated as ordinary CLV rows streamed from device memory, every other
    tip keeps the packed bitmask decode.

All comparisons run the fused kernel in interpret mode on CPU against the
XLA path (which is itself oracle-validated in test_core_m0 /
test_matrix_m7), demanding bit-equality for logL where the reduction
order is shared.
"""
import numpy as np
import pytest
import jax.numpy as jnp

from libpll2_jax import Partition, TreeEngine, compute_gamma_cats
from libpll2_jax import constants as C
from libpll2_jax.io import maps
from libpll2_jax.trees import parse_newick, random_utree
from libpll2_jax.utils import simulate_alignment

FREQS = [0.3, 0.2, 0.2, 0.3]
SUBST = [1, 2, 1, 1, 2, 1]


def _caterpillar(n):
    text = f"t{n-1}:0.1"
    for i in range(n - 2, 1, -1):
        text = f"(t{i}:0.1,{text}):0.1"
    return parse_newick(f"(t0:0.1,t1:0.1,{text});")


def _build(tree, headers, seqs, sites, states=4, rate_scalers=False,
           alpha=0.9):
    by = dict(zip(headers, seqs))
    part = Partition(tree.tip_count, tree.inner_count, states, sites, 1,
                     tree.edge_count, 4, tree.inner_count,
                     dtype=jnp.float32, rate_scalers=rate_scalers)
    cm = maps.map_nt if states == 4 else maps.map_aa
    for t in tree.tips():
        part.set_tip_states(t.clv_index, cm, by[t.label])
    part.set_frequencies(0, FREQS if states == 4 else
                         np.full(states, 1.0 / states))
    part.set_subst_params(0, SUBST if states == 4 else
                          np.ones(states * (states - 1) // 2))
    part.set_category_rates(compute_gamma_cats(alpha, 4))
    return part


def test_fused_rate_scalers_matches_xla():
    """Deep caterpillar at fp32 forces scaling; the fused kernel's
    per-rate counters and capped undo must reproduce the XLA path
    bit for bit."""
    tree = _caterpillar(80)
    headers, seqs = simulate_alignment(tree, 128, FREQS, SUBST,
                                       alpha=0.9, seed=3)
    p_x = _build(tree, headers, seqs, 128, rate_scalers=True)
    p_f = _build(tree, headers, seqs, 128, rate_scalers=True)
    e_x = TreeEngine(p_x, tree, pallas=False)
    e_f = TreeEngine(p_f, tree, pallas="interpret")
    assert e_f.execution_path == "fused"
    lk_x = e_x.loglikelihood()
    lk_f = e_f.loglikelihood()
    np.testing.assert_array_equal(lk_f, lk_x)
    # the mode must be genuinely per-rate: at alpha=0.9 the slow and fast
    # Gamma categories underflow at different depths, so the root scaler
    # rows must differ BETWEEN rates somewhere
    root = tree.vroot
    sc = np.asarray(p_x.scale_buffer[root.scaler_index])      # [R, S]
    assert sc.shape[0] == 4
    assert (sc.max(axis=0) != sc.min(axis=0)).any()
    # and the fused kernel's root scaler rows must equal XLA's exactly
    for idx in (root.scaler_index, root.back.scaler_index):
        if idx >= 0:
            np.testing.assert_array_equal(
                np.asarray(p_f.scale_buffer[idx]),
                np.asarray(p_x.scale_buffer[idx]))


def test_fused_rate_scalers_tile_bit_identical():
    """Every site tile must give bit-identical results in per-rate mode."""
    from libpll2_jax.ops import pallas_fused as pf
    from libpll2_jax.ops import pmatrix as op_pm
    from libpll2_jax.trees import create_operations, traverse

    tree = _caterpillar(60)
    sites = 256
    headers, seqs = simulate_alignment(tree, sites, FREQS, SUBST,
                                       alpha=0.9, seed=11)
    part = _build(tree, headers, seqs, sites, rate_scalers=True)
    ops, br, pmi = create_operations(traverse(tree.vroot))
    root = tree.vroot
    table, n_slots = pf.pack_fused_schedule(
        ops, part.tips, (root.clv_index, root.back.clv_index))
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
              interpret=True, rate_scalers=True)
    small = pf.fused_traversal(codes, pm, jnp.asarray(table), tile=32,
                               **kw)
    large = pf.fused_traversal(codes, pm, jnp.asarray(table), tile=128,
                               **kw)
    assert small[2].shape == (4, sites)
    assert int(np.asarray(small[2]).sum()) > 0
    for a, b in zip(small, large):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_fused_tip_clv_matches_xla():
    """A raw-probability tip keeps the engine on the fused path and the
    whole pipeline (logL, per-site, Newton) matches XLA."""
    tree = random_utree([f"t{i}" for i in range(8)], seed=7)
    headers, seqs = simulate_alignment(tree, 128, FREQS, SUBST,
                                       alpha=0.9, seed=7)
    rng = np.random.default_rng(0)
    vals = rng.uniform(0.1, 1.0, size=(128, 4))
    tip = next(iter(tree.tips()))
    p_x = _build(tree, headers, seqs, 128)
    p_x.set_tip_clv(tip.clv_index, vals)
    p_f = _build(tree, headers, seqs, 128)
    p_f.set_tip_clv(tip.clv_index, vals)
    e_x = TreeEngine(p_x, tree, pallas=False)
    e_f = TreeEngine(p_f, tree, pallas="interpret")
    assert e_f.execution_path == "fused"
    lk_x, per_x = e_x.loglikelihood_persite()
    lk_f, per_f = e_f.loglikelihood_persite()
    # raw probability tips don't share the integer-decode FMA structure,
    # so the fused kernel may differ from XLA's einsum by ~1 ulp per site
    np.testing.assert_allclose(lk_f, lk_x, rtol=1e-6)
    np.testing.assert_allclose(per_f, per_x, rtol=2e-5, atol=1e-4)
    nx = e_x.newton_step()
    nf = e_f.newton_step()
    np.testing.assert_allclose(nf, nx, rtol=1e-6, atol=1e-4)


def test_fused_tip_clv_aa_multiple_tips_unaligned():
    """20-state kernel with TWO raw tips at a non-tile-aligned
    site count (internal padding): logL must match XLA bit for bit."""
    tree = random_utree([f"t{i}" for i in range(8)], seed=3)
    sites = 200
    headers, seqs = simulate_alignment(tree, sites, [1 / 20] * 20,
                                       [1.0] * 190, alpha=1.0, seed=3)
    rng = np.random.default_rng(5)
    tips = sorted(tree.tips(), key=lambda t: t.clv_index)
    v1 = rng.uniform(0.05, 1.0, size=(sites, 20))
    v2 = rng.uniform(0.05, 1.0, size=(sites, 20))

    def build():
        p = _build(tree, headers, seqs, sites, states=20, alpha=1.0)
        p.set_tip_clv(tips[1].clv_index, v1)
        p.set_tip_clv(tips[5].clv_index, v2)
        return p

    e_x = TreeEngine(build(), tree, pallas=False)
    e_f = TreeEngine(build(), tree, pallas="interpret")
    assert e_f.execution_path == "fused"
    np.testing.assert_allclose(e_f.loglikelihood(),
                               e_x.loglikelihood(), rtol=1e-6)


def test_fused_tip_clv_with_rate_scalers_loops():
    """Combined mode: raw tip + per-rate scalers through the device-resident
    loglikelihood and Newton loops."""
    tree = _caterpillar(48)
    headers, seqs = simulate_alignment(tree, 128, FREQS, SUBST,
                                       alpha=0.9, seed=13)
    rng = np.random.default_rng(2)
    vals = rng.uniform(0.1, 1.0, size=(128, 4))
    tip = next(iter(tree.tips()))

    def build():
        p = _build(tree, headers, seqs, 128, rate_scalers=True)
        p.set_tip_clv(tip.clv_index, vals)
        return p

    e_x = TreeEngine(build(), tree, pallas=False)
    e_f = TreeEngine(build(), tree, pallas="interpret")
    assert e_f.execution_path == "fused"
    np.testing.assert_allclose(e_f.loglikelihood_loop(3),
                               e_x.loglikelihood_loop(3), rtol=1e-6)
    nx = e_x.newton_loop(4)
    nf = e_f.newton_loop(4)
    np.testing.assert_allclose(nf[0], nx[0], rtol=1e-6)
    np.testing.assert_allclose(nf[1], nx[1], atol=1e-3)


def test_fused_tip_clv_membership_change_raises():
    """Adding a NEW raw tip after the engine packed its schedule must
    raise (the op table encodes which tips stream CLV rows); updating an
    EXISTING raw tip's values must re-upload and change the logL."""
    tree = random_utree([f"t{i}" for i in range(8)], seed=9)
    headers, seqs = simulate_alignment(tree, 128, FREQS, SUBST,
                                       alpha=0.9, seed=9)
    rng = np.random.default_rng(3)
    tips = sorted(tree.tips(), key=lambda t: t.clv_index)
    part = _build(tree, headers, seqs, 128)
    part.set_tip_clv(tips[0].clv_index, rng.uniform(0.1, 1, (128, 4)))
    eng = TreeEngine(part, tree, pallas="interpret")
    assert eng.execution_path == "fused"
    lk1 = eng.loglikelihood()
    # value update on the SAME tip: allowed, logL changes
    part.set_tip_clv(tips[0].clv_index, rng.uniform(0.1, 1, (128, 4)))
    lk2 = eng.loglikelihood()
    assert lk1 != lk2
    # new raw tip: schedule is stale -> explicit error, not silent wrong
    part.set_tip_clv(tips[3].clv_index, rng.uniform(0.1, 1, (128, 4)))
    with pytest.raises(C.PllError):
        eng.loglikelihood()
    # rebuilding re-encodes the table and works again
    eng2 = TreeEngine(part, tree, pallas="interpret")
    assert eng2.execution_path == "fused"
    assert np.isfinite(eng2.loglikelihood())


def test_fused_rate_scalers_evaluate_topologies():
    """Batched multi-topology scoring (SPR/NNI rounds) in per-rate mode."""
    from libpll2_jax.trees import create_operations, traverse
    from libpll2_jax.trees import moves

    tree = random_utree([f"t{i}" for i in range(10)], seed=2)
    headers, seqs = simulate_alignment(tree, 128, FREQS, SUBST,
                                       alpha=0.9, seed=2)
    e_f = TreeEngine(_build(tree, headers, seqs, 128, rate_scalers=True),
                     tree, pallas="interpret")
    e_x = TreeEngine(_build(tree, headers, seqs, 128, rate_scalers=True),
                     tree, pallas=False)
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
    np.testing.assert_allclose(e_f.evaluate_topologies(candidates),
                               e_x.evaluate_topologies(candidates),
                               rtol=1e-6)


def test_fused_rate_scalers_sharded_mesh():
    """Per-rate scalers under an 8-device site-sharded mesh (shard_map):
    logL/d1/d2 must match the unsharded XLA result."""
    from libpll2_jax.parallel import make_mesh, shard_partition

    tree = _caterpillar(40)
    sites = 1024
    headers, seqs = simulate_alignment(tree, sites, FREQS, SUBST,
                                       alpha=0.9, seed=21)

    p_ref = _build(tree, headers, seqs, sites, rate_scalers=True)
    e_ref = TreeEngine(p_ref, tree, pallas=False)

    p_sh = _build(tree, headers, seqs, sites, rate_scalers=True)
    shard_partition(p_sh, make_mesh(8))
    e_sh = TreeEngine(p_sh, tree, pallas="interpret")
    assert e_sh.execution_path == "fused"
    np.testing.assert_allclose(e_sh.loglikelihood(), e_ref.loglikelihood(),
                               rtol=1e-6)
    nx = e_ref.newton_step()
    ns = e_sh.newton_step()
    np.testing.assert_allclose(ns, nx, rtol=1e-5, atol=1e-3)


def test_fused_20_states_fp32_accuracy():
    """20 states padded to the kernel's 32-row tensors: the exact-fp32 FMA
    contraction must land within fp32 distance of the fp64 XLA answer
    (the padded rows and columns are zero and must contribute nothing)."""
    tree = random_utree([f"t{i}" for i in range(24)], seed=5)
    headers, seqs = simulate_alignment(
        tree, 512, np.full(20, 0.05), np.ones(190), alpha=0.9, seed=5)

    def build(dtype):
        part = _build(tree, headers, seqs, 512, states=20)
        if dtype == jnp.float32:
            return part
        by = dict(zip(headers, seqs))
        p64 = Partition(tree.tip_count, tree.inner_count, 20, 512, 1,
                        tree.edge_count, 4, tree.inner_count,
                        dtype=jnp.float64)
        for t in tree.tips():
            p64.set_tip_states(t.clv_index, maps.map_aa, by[t.label])
        p64.set_frequencies(0, np.full(20, 0.05))
        p64.set_subst_params(0, np.ones(190))
        p64.set_category_rates(compute_gamma_cats(0.9, 4))
        return p64

    ref = TreeEngine(build(jnp.float64), tree, pallas=False,
                     level_schedule=False).loglikelihood()
    eng = TreeEngine(build(jnp.float32), tree, pallas="interpret")
    assert eng.execution_path == "fused"
    assert abs(eng.loglikelihood() - ref) <= abs(ref) * 1e-6


def test_fused_rate_scalers_many_categories_aa():
    """Per-rate scalers at 10 categories and 20 states: the kernel keeps
    one scaler row per rate, with no category bound."""
    tree = _caterpillar(30)
    headers, seqs = simulate_alignment(
        tree, 96, np.full(20, 0.05), np.ones(190), alpha=0.5, seed=4)
    by = dict(zip(headers, seqs))

    def build():
        part = Partition(tree.tip_count, tree.inner_count, 20, 96, 1,
                         tree.edge_count, 10, tree.inner_count,
                         dtype=jnp.float32, rate_scalers=True)
        for t in tree.tips():
            part.set_tip_states(t.clv_index, maps.map_aa, by[t.label])
        part.set_frequencies(0, np.full(20, 0.05))
        part.set_subst_params(0, np.ones(190))
        part.set_category_rates(compute_gamma_cats(0.5, 10))
        return part

    e_f = TreeEngine(build(), tree, pallas="interpret")
    assert e_f.execution_path == "fused"
    e_x = TreeEngine(build(), tree, pallas=False)
    np.testing.assert_allclose(e_f.loglikelihood(), e_x.loglikelihood(),
                               rtol=1e-6)


@pytest.mark.parametrize("mode", ["levels-kernel", "levels-interpret",
                                  "pool-interpret", "fast"])
def test_removed_pallas_modes_raise(mode):
    """The per-level and pooled-repeats kernels are gone: asking for them
    (or for any unknown mode) raises instead of silently downgrading."""
    tree = random_utree([f"t{i}" for i in range(6)], seed=5)
    headers, seqs = simulate_alignment(
        tree, 128, FREQS, SUBST, alpha=0.9, seed=5)
    part = _build(tree, headers, seqs, 128)
    with pytest.raises(C.PllError):
        TreeEngine(part, tree, pallas=mode)


def test_pallas_true_off_gpu_raises():
    """pallas=True compiles the kernel for a GPU; on the CPU backend it
    raises rather than falling back to XLA."""
    tree = random_utree([f"t{i}" for i in range(6)], seed=5)
    headers, seqs = simulate_alignment(
        tree, 128, FREQS, SUBST, alpha=0.9, seed=5)
    part = _build(tree, headers, seqs, 128)
    with pytest.raises(C.PllError, match="GPU"):
        TreeEngine(part, tree, pallas=True)
