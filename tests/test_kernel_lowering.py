"""The fused traversal kernel as the GPU compiler receives it.

The CPU cannot compile for the card, but it can lower the kernel through
the Pallas Triton route for a CUDA target: that runs every check the
route makes before PTX (power-of-two tensors, supported primitives,
block shapes), for each alphabet and mode the engine uses. The
`gpu`-marked test compiles and runs it on a card (skips elsewhere)."""
import numpy as np
import pytest
import jax
import jax.numpy as jnp

from libpll2_jax.ops import pallas_fused as pf


def _lower(states, rates=4, rate_scalers=False, ctips=False, vmap=False):
    n_tips, sites = 10, 300
    codes = jnp.ones((n_tips, sites), jnp.int32)
    pm = jnp.ones((17, rates, states, states), jnp.float32)
    table = jnp.zeros((9, 8), jnp.int32)
    ct = jnp.ones((3, states, sites), jnp.float32) if ctips else None

    def f(c, p, t):
        return pf.fused_traversal(c, p, t, rates=rates, states=states,
                                  n_slots=5, threshold=2.0 ** -32,
                                  factor=2.0 ** 32,
                                  rate_scalers=rate_scalers, tip_clvs=ct)
    if vmap:
        f = jax.vmap(f, in_axes=(None, 0, 0))
        pm, table = pm[None].repeat(2, 0), table[None].repeat(2, 0)
    with jax.enable_x64(False):
        return jax.jit(f).trace(codes, pm, table).lower(
            lowering_platforms=("cuda",)).as_text()


@pytest.mark.parametrize("states,kw", [
    (4, {}),
    (20, {}),
    (5, {}),
    (4, dict(rates=12, rate_scalers=True)),
    (20, dict(ctips=True, vmap=True)),
], ids=["dna", "aa", "odd5", "dna-rate12-per-rate", "aa-tipclv-vmap"])
def test_kernel_lowers_for_cuda(states, kw):
    text = _lower(states, **kw)
    assert "pll_fused_traversal" in text


def test_kernel_tile_and_state_padding():
    """Tensor shapes the route needs: power-of-two states and tiles."""
    assert [pf.padded_states(s) for s in (2, 4, 5, 20, 32)] == \
        [2, 4, 8, 32, 32]
    for s in (4, 5, 20):
        t = pf.kernel_grain(s)
        assert t & (t - 1) == 0 and t >= 16


@pytest.mark.gpu
def test_kernel_on_gpu_matches_levels(gpu_device):
    """Compiled kernel vs the XLA levels path on the card, fp32."""
    from libpll2_jax import Partition, TreeEngine, compute_gamma_cats
    from libpll2_jax.io import maps
    from libpll2_jax.trees import random_utree
    from libpll2_jax.utils import simulate_alignment

    tree = random_utree([f"t{i}" for i in range(32)], seed=3)
    headers, seqs = simulate_alignment(tree, 2000, [0.3, 0.2, 0.2, 0.3],
                                       [1, 2, 1, 1, 2, 1], alpha=0.8,
                                       seed=3)
    by = dict(zip(headers, seqs))

    def build():
        part = Partition(tree.tip_count, tree.inner_count, 4, 2000, 1,
                         tree.edge_count, 4, tree.inner_count,
                         dtype=jnp.float32)
        for t in tree.tips():
            part.set_tip_states(t.clv_index, maps.map_nt, by[t.label])
        part.set_frequencies(0, [0.3, 0.2, 0.2, 0.3])
        part.set_subst_params(0, [1, 2, 1, 1, 2, 1])
        part.set_category_rates(compute_gamma_cats(0.8, 4))
        return part

    with jax.enable_x64(False):
        fused = TreeEngine(build(), tree)
        assert fused.execution_path == "fused"
        levels = TreeEngine(build(), tree, pallas=False)
        np.testing.assert_allclose(fused.loglikelihood(),
                                   levels.loglikelihood(), rtol=1e-6)
