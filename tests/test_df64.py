"""df64 (double-single) certified final evaluation (ops/df64.py).

The reference's golden matrix is all-fp64 (reference
test/runtest.py:45-57); the df64 path certifies that class of accuracy
on fp32-only hardware: error-free-transformation arithmetic end to end
(host-fp64 P-matrices exactly split, df64 pruning/logs, fp64 host
finish). Budget here: 1e-10 relative vs the fp64 engine — on the real
chip the gate case `dna_df64` holds 1e-8 (measured ~1e-15)."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from libpll2_jax import (Partition, TreeEngine, compute_gamma_cats,
                         loglikelihood_df64)
from libpll2_jax import constants as C
from libpll2_jax.io import maps
from libpll2_jax.ops import df64
from libpll2_jax.trees import parse_newick, random_utree
from libpll2_jax.utils import simulate_alignment


def test_primitives_vs_fp64():
    rng = np.random.default_rng(0)
    a64 = rng.uniform(0.1, 10, 2048)
    b64 = rng.uniform(0.1, 10, 2048)
    A = tuple(jnp.asarray(v) for v in df64.split_f64(a64))
    B = tuple(jnp.asarray(v) for v in df64.split_f64(b64))

    def rel(pair, ref):
        got = (np.asarray(pair[0], np.float64)
               + np.asarray(pair[1], np.float64))
        return np.abs((got - ref) / ref).max()

    assert rel(df64.mul(A, B), a64 * b64) < 1e-13
    assert rel(df64.add(A, B), a64 + b64) < 1e-13
    assert rel(df64.div(A, B), a64 / b64) < 1e-13
    x64 = np.concatenate([rng.uniform(1e-30, 1e-5, 1024),
                          rng.uniform(0.1, 8.0, 1024)])
    X = tuple(jnp.asarray(v) for v in df64.split_f64(x64))
    assert rel(df64.log(X), np.log(x64)) < 1e-11


def _build(tree, h, s, dtype, states=4, alpha=0.5, seed=11):
    part = Partition(tree.tip_count, tree.inner_count, states,
                     len(s[0]), 1, tree.edge_count, 4, tree.inner_count,
                     dtype=dtype)
    by = dict(zip(h, s))
    cm = maps.map_nt if states == 4 else maps.map_aa
    for tip in tree.tips():
        part.set_tip_states(tip.clv_index, cm, by[tip.label])
    rng = np.random.default_rng(seed)
    part.set_frequencies(0, rng.dirichlet(np.ones(states) * 10))
    part.set_subst_params(0, rng.uniform(0.5, 2.0,
                                         states * (states - 1) // 2))
    part.set_category_rates(compute_gamma_cats(alpha, 4))
    return part


def test_df64_matches_fp64_scaling_stress():
    """Deep caterpillar at alpha 0.5: many scaling events; df64 on the
    fp32-dtype partition must match the fp64 engine to ~1e-10 where
    plain fp32 manages ~1e-7."""
    n = 96
    text = f"t{n-1}:0.3"
    for i in range(n - 2, 1, -1):
        text = f"(t{i}:0.3,{text}):0.3"
    tree = parse_newick(f"(t0:0.3,t1:0.3,{text});")
    h, s = simulate_alignment(tree, 384, [0.25] * 4, [1, 2, 1, 1, 2, 1],
                              alpha=0.5, seed=5)
    ref = TreeEngine(_build(tree, h, s, jnp.float64), tree,
                     pallas=False).loglikelihood()
    got = loglikelihood_df64(_build(tree, h, s, jnp.float32), tree)
    assert abs(got - ref) / abs(ref) < 1e-10


def test_df64_matches_fp64_random_tree_aa():
    tree = random_utree([f"t{i}" for i in range(10)], seed=7)
    h, s = simulate_alignment(tree, 192, [1 / 20] * 20, [1.0] * 190,
                              alpha=1.0, seed=7)
    ref = TreeEngine(_build(tree, h, s, jnp.float64, states=20,
                            alpha=1.0), tree, pallas=False
                     ).loglikelihood()
    got = loglikelihood_df64(_build(tree, h, s, jnp.float32, states=20,
                                    alpha=1.0), tree)
    assert abs(got - ref) / abs(ref) < 1e-10


def test_df64_scope_errors():
    tree = random_utree([f"t{i}" for i in range(6)], seed=3)
    h, s = simulate_alignment(tree, 64, [0.25] * 4, [1, 2, 1, 1, 2, 1],
                              alpha=1.0, seed=3)
    part = Partition(tree.tip_count, tree.inner_count, 4, 64, 1,
                     tree.edge_count, 4, tree.inner_count,
                     rate_scalers=True)
    by = dict(zip(h, s))
    for tip in tree.tips():
        part.set_tip_states(tip.clv_index, maps.map_nt, by[tip.label])
    part.set_frequencies(0, [0.25] * 4)
    part.set_subst_params(0, [1, 2, 1, 1, 2, 1])
    part.set_category_rates(compute_gamma_cats(1.0, 4))
    with pytest.raises(C.PllError):
        loglikelihood_df64(part, tree)


def test_df64_rejects_scalerless_inner_node():
    """An inner node with scaler_index = SCALE_BUFFER_NONE breaks the
    scaler-count chain (the reference's fill_parent_scaler has the same
    structural loss, pll.c:1183, but its 2^-256 window rarely fires);
    under the df64 path's aggressive 2^-16 window the silent loss would
    be ~16*ln2 per dropped count, so the certified evaluation REFUSES
    such op lists instead of returning an inflated logL (review
    finding, round 5)."""
    from libpll2_jax.trees.utree import SCALE_BUFFER_NONE

    n = 64
    text = f"t{n-1}:0.3"
    for i in range(n - 2, 1, -1):
        text = f"(t{i}:0.3,{text}):0.3"
    tree = parse_newick(f"(t0:0.3,t1:0.3,{text});")
    h, s = simulate_alignment(tree, 256, [0.25] * 4, [1, 2, 1, 1, 2, 1],
                              alpha=0.5, seed=9)
    victim = next(nd for nd in tree.nodes()
                  if not nd.is_tip() and nd.scaler_index == 10)
    for half in victim.ring():
        half.scaler_index = SCALE_BUFFER_NONE
    with pytest.raises(C.PllError):
        loglikelihood_df64(_build(tree, h, s, jnp.float32), tree)
