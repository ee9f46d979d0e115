"""Regression tests for the round-1 review findings:

  * repeats schedule cache key must include matrix/scaler indices;
  * set_tip_clv on a repeats partition resets that tip's class mapping;
  * update_partials(update_repeats=False) reuses the cached schedule;
  * checkpoints persist tips set via set_tip_clv;
  * encode_msa reports illegal non-ASCII bytes as PllError.
"""
import numpy as np
import pytest

from libpll2_jax import Partition, checkpoint, compute_gamma_cats
from libpll2_jax import constants as C
from libpll2_jax.io import compress, maps
from libpll2_jax.trees import create_operations, random_utree, traverse
from libpll2_jax.utils.simulate import simulate_alignment

N_TAXA = 12
N_SITES = 200
FREQS = [0.3, 0.25, 0.2, 0.25]
SUBST = [1.2, 3.0, 0.8, 1.1, 2.6, 1.0]


def _setup(repeats: bool, prob_matrices_factor: int = 1):
    tree = random_utree([f"t{i}" for i in range(N_TAXA)], seed=5)
    headers, seqs = simulate_alignment(tree, N_SITES, FREQS, SUBST,
                                       alpha=0.8, seed=5)
    part = Partition(tree.tip_count, tree.inner_count, 4, N_SITES, 1,
                     tree.edge_count * prob_matrices_factor, 4,
                     tree.inner_count, site_repeats=repeats)
    by_label = dict(zip(headers, seqs))
    for tip in tree.tips():
        part.set_tip_states(tip.clv_index, maps.map_nt, by_label[tip.label])
    part.set_frequencies(0, FREQS)
    part.set_subst_params(0, SUBST)
    part.set_category_rates(compute_gamma_cats(0.8, 4))
    return tree, part


def _eval(part, tree, matrix_offset=0, branch_scale=1.0):
    trav = traverse(tree.vroot)
    ops, branches, pidx = create_operations(trav)
    pidx = [i + matrix_offset for i in pidx]
    for op in ops:
        op.child1_matrix_index += matrix_offset
        op.child2_matrix_index += matrix_offset
    part.update_prob_matrices([0] * 4, pidx,
                              np.asarray(branches) * branch_scale)
    part.update_partials(ops)
    root = tree.vroot
    return part.compute_edge_loglikelihood(
        root.clv_index, root.scaler_index, root.back.clv_index,
        root.back.scaler_index, root.pmatrix_index + matrix_offset, [0] * 4)


def test_repeat_key_includes_matrix_indices():
    """Same topology, different pmatrix slots: the cached schedule must not
    reuse stale matrix indices (ADVICE medium, partition.py:421)."""
    tree, rep = _setup(repeats=True, prob_matrices_factor=2)
    _, plain = _setup(repeats=False, prob_matrices_factor=2)
    E = tree.edge_count
    lk_a = _eval(rep, tree, matrix_offset=0)
    # second model: same CLV indices, pmatrices in slots E.., branches x3
    lk_b = _eval(rep, tree, matrix_offset=E, branch_scale=3.0)
    ref_a = _eval(plain, tree, matrix_offset=0)
    ref_b = _eval(plain, tree, matrix_offset=E, branch_scale=3.0)
    assert lk_a == pytest.approx(ref_a, rel=1e-10)
    assert lk_b == pytest.approx(ref_b, rel=1e-10)
    assert abs(lk_a - lk_b) > 1.0      # the two models genuinely differ


def test_set_tip_clv_resets_repeat_classes():
    """Overwriting a states-tip with raw probabilities must reset its class
    mapping (ADVICE low, partition.py:255)."""
    tree, rep = _setup(repeats=True)
    _, plain = _setup(repeats=False)
    tip = next(iter(tree.tips()))
    rng = np.random.default_rng(0)
    probs = rng.uniform(0.05, 1.0, size=(N_SITES, 4))
    rep.set_tip_clv(tip.clv_index, probs)
    plain.set_tip_clv(tip.clv_index, probs)
    assert rep.repeats.ids[tip.clv_index] == 0
    lk_rep = _eval(rep, tree)
    lk_plain = _eval(plain, tree)
    assert lk_rep == pytest.approx(lk_plain, rel=1e-10)


def test_update_repeats_false_reuses_schedule():
    tree, rep = _setup(repeats=True)
    trav = traverse(tree.vroot)
    ops, branches, pidx = create_operations(trav)
    rep.update_prob_matrices([0] * 4, pidx, branches)
    rep.update_partials(ops)
    sched = rep._repeat_schedule
    rep.update_partials(ops, update_repeats=False)
    assert rep._repeat_schedule is sched
    root = tree.vroot
    lk = rep.compute_edge_loglikelihood(
        root.clv_index, root.scaler_index, root.back.clv_index,
        root.back.scaler_index, root.pmatrix_index, [0] * 4)
    assert np.isfinite(lk)


def test_checkpoint_persists_tip_clvs(tmp_path):
    tree, part = _setup(repeats=False)
    tip = next(iter(tree.tips()))
    rng = np.random.default_rng(1)
    probs = rng.uniform(0.05, 1.0, size=(N_SITES, 4))
    part.set_tip_clv(tip.clv_index, probs)
    lk0 = _eval(part, tree)
    path = str(tmp_path / "ck.npz")
    checkpoint.save(path, part, tree)
    part2, tree2, _ = checkpoint.load(path)
    lk1 = _eval(part2, tree2)
    assert lk1 == pytest.approx(lk0, rel=1e-12)


def test_encode_msa_illegal_byte_is_pll_error():
    with pytest.raises(C.PllError):
        compress.encode_msa(["AC\xffG"], maps.map_nt)
    with pytest.raises(C.PllError):
        # decode_states path via set_tip_states
        _, part = _setup(repeats=False)
        part.set_tip_states(0, maps.map_nt, "A" * (N_SITES - 1) + "\xff")


def test_execution_path_introspection():
    """TreeEngine.execution_path names the selected compute path — the
    eligibility downgrades are silent, so this is the diagnostic."""
    import jax.numpy as jnp
    from libpll2_jax import Partition, TreeEngine, compute_gamma_cats
    from libpll2_jax.io import maps
    from libpll2_jax.trees import random_utree
    from libpll2_jax.utils import simulate_alignment

    tree = random_utree([f"t{i}" for i in range(8)], seed=61)
    headers, seqs = simulate_alignment(tree, 256, [0.25] * 4,
                                       [1, 2, 1, 1, 2, 1], alpha=0.9,
                                       seed=61)
    by = dict(zip(headers, seqs))

    def build(dtype=None, repeats=False):
        part = Partition(tree.tip_count, tree.inner_count, 4, 256, 1,
                         tree.edge_count, 4, tree.inner_count,
                         dtype=dtype, site_repeats=repeats)
        for t in tree.tips():
            part.set_tip_states(t.clv_index, maps.map_nt, by[t.label])
        part.set_frequencies(0, [0.25] * 4)
        part.set_subst_params(0, [1, 2, 1, 1, 2, 1])
        part.set_category_rates(compute_gamma_cats(0.9, 4))
        return part

    assert TreeEngine(build(), tree, pallas=False).execution_path \
        == "levels"
    assert TreeEngine(build(), tree, pallas=False,
                      level_schedule=False).execution_path == "scan"
    assert TreeEngine(build(jnp.float32), tree,
                      pallas="interpret").execution_path == "fused"
    assert TreeEngine(build(repeats=True), tree,
                      pallas=False).execution_path == "pool"
    assert TreeEngine(build(jnp.float32, repeats=True), tree,
                      pallas="interpret").execution_path \
        == "repeats-dense-fused"
    assert TreeEngine(build(jnp.float32, repeats=True), tree,
                      pallas="pool").execution_path == "pool"
    with pytest.raises(C.PllError):
        TreeEngine(build(jnp.float32, repeats=True), tree,
                   pallas="pool-interpret")
