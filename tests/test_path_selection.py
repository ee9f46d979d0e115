"""TreeEngine path selection by platform, with the backend reported as a
GPU (no evaluation runs: the compiled kernel needs a real card)."""
import jax
import jax.numpy as jnp
import pytest

from libpll2_jax import Partition, TreeEngine, compute_gamma_cats
from libpll2_jax import constants as C
from libpll2_jax.io import maps
from libpll2_jax.trees import random_utree
from libpll2_jax.utils import simulate_alignment


def _build(dtype, repeats=False):
    tree = random_utree([f"t{i}" for i in range(8)], seed=61)
    headers, seqs = simulate_alignment(tree, 256, [0.25] * 4,
                                       [1, 2, 1, 1, 2, 1], alpha=0.9,
                                       seed=61)
    by = dict(zip(headers, seqs))
    part = Partition(tree.tip_count, tree.inner_count, 4, 256, 1,
                     tree.edge_count, 4, tree.inner_count, dtype=dtype,
                     site_repeats=repeats)
    for t in tree.tips():
        part.set_tip_states(t.clv_index, maps.map_nt, by[t.label])
    part.set_frequencies(0, [0.25] * 4)
    part.set_subst_params(0, [1, 2, 1, 1, 2, 1])
    part.set_category_rates(compute_gamma_cats(0.9, 4))
    return part, tree


@pytest.mark.parametrize("backend,dtype,repeats,pallas,want", [
    ("gpu", jnp.float32, False, "auto", "fused"),
    ("gpu", jnp.float32, False, True, "fused"),
    ("gpu", jnp.float64, False, "auto", "levels"),
    ("gpu", jnp.float32, True, "auto", "repeats-dense-fused"),
    ("gpu", jnp.float32, True, "pool", "pool"),
    ("cpu", jnp.float32, False, "auto", "levels"),
    ("cpu", jnp.float32, True, "auto", "pool"),
], ids=["gpu-auto", "gpu-true", "gpu-fp64", "gpu-repeats", "gpu-pool",
        "cpu-auto", "cpu-repeats"])
def test_auto_path_by_backend(monkeypatch, backend, dtype, repeats, pallas,
                              want):
    part, tree = _build(dtype, repeats)
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    eng = TreeEngine(part, tree, pallas=pallas)
    assert eng.execution_path == want
    assert eng.pallas_interpret is False


def test_mesh_platform_decides_under_a_mesh(monkeypatch):
    """Under a mesh the mesh's devices decide, not the default backend:
    a CPU mesh in a GPU process takes the XLA path."""
    from libpll2_jax.parallel import make_mesh, shard_partition
    part, tree = _build(jnp.float32)
    shard_partition(part, make_mesh(2))
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert TreeEngine(part, tree).execution_path == "levels"
    with pytest.raises(C.PllError):
        TreeEngine(part, tree, pallas=True)
