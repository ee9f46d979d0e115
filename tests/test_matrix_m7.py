"""M7: the execution-mode validation matrix.

The reference cross-checks every SIMD kernel and data-reuse mode against
the same golden output ({CPU,SSE,AVX,AVX2} x {plain,tip-pattern,repeats},
test/runtest.py:45-57). The analog here: one scenario evaluated under every
execution mode x dtype x data-reuse combination must produce the same
logL (and match the oracle in fp64)."""
import numpy as np
import pytest
import jax.numpy as jnp

import oracle
from libpll2_jax import Partition, TreeEngine, compute_gamma_cats
from libpll2_jax.io import maps
from libpll2_jax.trees import create_operations, random_utree, traverse
from libpll2_jax.utils import simulate_alignment

N_TAXA, N_SITES = 20, 384
FREQS = [0.3, 0.2, 0.2, 0.3]
SUBST = [1.0, 2.5, 0.8, 1.2, 2.0, 1.0]


@pytest.fixture(scope="module")
def scenario():
    tree = random_utree([f"t{i}" for i in range(N_TAXA)], seed=77)
    headers, seqs = simulate_alignment(tree, N_SITES, FREQS, SUBST,
                                       alpha=0.8, seed=77)
    return tree, dict(zip(headers, seqs))


def _partition(tree, by_label, dtype, repeats=False):
    part = Partition(tree.tip_count, tree.inner_count, 4, N_SITES, 1,
                     tree.edge_count, 4, tree.inner_count, dtype=dtype,
                     site_repeats=repeats)
    for tip in tree.tips():
        part.set_tip_states(tip.clv_index, maps.map_nt, by_label[tip.label])
    part.set_frequencies(0, FREQS)
    part.set_subst_params(0, SUBST)
    part.set_category_rates(compute_gamma_cats(0.8, 4))
    return part


@pytest.fixture(scope="module")
def golden(scenario):
    """fp64 logL from the reference oracle."""
    if not oracle.available():
        pytest.skip("reference not available")
    tree, by_label = scenario
    ref = oracle.OraclePartition(tree.tip_count, tree.inner_count, 4,
                                 N_SITES, 1, tree.edge_count, 4,
                                 tree.inner_count)
    for tip in tree.tips():
        ref.set_tip_states(tip.clv_index, "nt", by_label[tip.label])
    ref.set_frequencies(0, FREQS)
    ref.set_subst_params(0, SUBST)
    ref.set_category_rates(compute_gamma_cats(0.8, 4))
    trav = traverse(tree.vroot)
    ops, branches, pmat_idx = create_operations(trav)
    ref.update_prob_matrices([0] * 4, pmat_idx, branches)
    ref.update_partials([(o.parent_clv_index, o.parent_scaler_index,
                          o.child1_clv_index, o.child1_matrix_index,
                          o.child1_scaler_index, o.child2_clv_index,
                          o.child2_matrix_index, o.child2_scaler_index)
                         for o in ops])
    root = tree.vroot
    lk = ref.edge_loglikelihood(root.clv_index, root.scaler_index,
                                root.back.clv_index, root.back.scaler_index,
                                root.pmatrix_index, [0] * 4)
    ref.destroy()
    return lk


MODES = [
    # (id, dtype, engine kwargs, repeats)
    ("scan-f64", jnp.float64, dict(level_schedule=False, pallas=False),
     False),
    ("levels-f64", jnp.float64, dict(level_schedule=True, pallas=False),
     False),
    ("scan-f32", jnp.float32, dict(level_schedule=False, pallas=False),
     False),
    ("levels-f32", jnp.float32, dict(level_schedule=True, pallas=False),
     False),
    ("pallas-f32", jnp.float32, dict(pallas="interpret"), False),
    ("repeats-f64", jnp.float64, None, True),
    ("repeats-f32", jnp.float32, None, True),
]


@pytest.mark.parametrize("mode_id,dtype,ekw,repeats", MODES,
                         ids=[m[0] for m in MODES])
def test_mode_matrix(scenario, golden, mode_id, dtype, ekw, repeats):
    tree, by_label = scenario
    part = _partition(tree, by_label, dtype, repeats=repeats)
    if ekw is not None:
        eng = TreeEngine(part, tree, **ekw)
        if mode_id == "pallas-f32":
            assert eng.use_pallas
        lk = eng.loglikelihood()
    else:
        # repeats run through the partition path
        trav = traverse(tree.vroot)
        ops, branches, pmat_idx = create_operations(trav)
        part.update_prob_matrices([0] * 4, pmat_idx, branches)
        part.update_partials(ops)
        root = tree.vroot
        lk = part.compute_edge_loglikelihood(
            root.clv_index, root.scaler_index, root.back.clv_index,
            root.back.scaler_index, root.pmatrix_index, [0] * 4)
    rtol = 1e-10 if dtype == jnp.float64 else 2e-5
    np.testing.assert_allclose(lk, golden, rtol=rtol, err_msg=mode_id)


# ---------------------------------------------------------------------------
# The widened attribute grid: alphabet x scaler
# mode x ascertainment bias, each evaluated through the production fp32
# paths against a per-cell fp64 oracle golden — the analog of the
# reference's full runtest attribute matrix (test/runtest.py:45-57).
# ---------------------------------------------------------------------------
import ctypes as _ct

_ODD5 = np.zeros(256, dtype=np.uint64)
for _i, _ch in enumerate("ACGTX"):
    _ODD5[ord(_ch)] = _ODD5[ord(_ch.lower())] = 1 << _i
_ODD5[ord('-')] = 31

_GRID_SITES = 256


def _grid_alphabet(name):
    """(states, charmap, oracle_map_or_name, freqs, subst, seqs, tree)."""
    rng = np.random.default_rng(91)
    tree = random_utree([f"g{i}" for i in range(16)], seed=91)
    if name == "dna":
        states, cm, om = 4, maps.map_nt, "nt"
        freqs, subst = FREQS, SUBST
        headers, seqs = simulate_alignment(tree, _GRID_SITES, freqs,
                                           subst, alpha=0.8, seed=91)
        seqs = [dict(zip(headers, seqs))[t.label] for t in tree.tips()]
        return states, cm, om, freqs, subst, seqs, tree
    if name == "aa":
        states, cm, om = 20, maps.map_aa, "aa"
        alphabet = "ARNDCQEGHILKMFPSTWYV"
    else:
        states, cm, om = 5, _ODD5, _ODD5
        alphabet = "ACGTX"
    freqs = rng.dirichlet(np.ones(states) * 10)
    subst = rng.uniform(0.5, 2.0, size=states * (states - 1) // 2)
    chars = np.array(list(alphabet))
    seqs = ["".join(chars[rng.integers(0, states, _GRID_SITES)])
            for _ in tree.tips()]
    return states, cm, om, freqs, subst, seqs, tree


_GOLDEN_CACHE = {}


def _grid_golden(alphabet, asc):
    """fp64 oracle logL for (alphabet, asc) — scalers don't change it."""
    key = (alphabet, asc)
    if key in _GOLDEN_CACHE:
        return _GOLDEN_CACHE[key]
    states, cm, om, freqs, subst, seqs, tree = _grid_alphabet(alphabet)
    attrs = oracle.ATTRIB_AB_FLAG if asc else 0
    ref = oracle.OraclePartition(tree.tip_count, tree.inner_count, states,
                                 _GRID_SITES, 1, tree.edge_count, 4,
                                 tree.inner_count, attributes=attrs)
    lib = oracle.load()
    omap = (om if isinstance(om, str)
            else (_ct.c_ulonglong * 256)(*[int(v) for v in om]))
    for tip, seq in zip(tree.tips(), seqs):
        if isinstance(omap, str):
            ref.set_tip_states(tip.clv_index, omap, seq)
        else:
            assert lib.pll_set_tip_states(ref.ptr, tip.clv_index, omap,
                                          seq.encode()) == 1
    ref.set_frequencies(0, freqs)
    ref.set_subst_params(0, subst)
    ref.set_category_rates(compute_gamma_cats(0.8, 4))
    if asc:
        ref.set_asc_bias_type(oracle.ATTRIB_AB_LEWIS)
    trav = traverse(tree.vroot)
    ops, branches, pmat_idx = create_operations(trav)
    ref.update_prob_matrices([0] * 4, pmat_idx, branches)
    ref.update_partials([(o.parent_clv_index, o.parent_scaler_index,
                          o.child1_clv_index, o.child1_matrix_index,
                          o.child1_scaler_index, o.child2_clv_index,
                          o.child2_matrix_index, o.child2_scaler_index)
                         for o in ops])
    root = tree.vroot
    lk = ref.edge_loglikelihood(root.clv_index, root.scaler_index,
                                root.back.clv_index,
                                root.back.scaler_index,
                                root.pmatrix_index, [0] * 4)
    ref.destroy()
    _GOLDEN_CACHE[key] = lk
    return lk


@pytest.mark.parametrize("mode", ["levels", "fused"])
@pytest.mark.parametrize("asc", [False, True], ids=["noasc", "lewis"])
@pytest.mark.parametrize("rate_sc", [False, True], ids=["site", "rate"])
@pytest.mark.parametrize("alphabet", ["dna", "aa", "odd5"])
def test_attribute_grid(alphabet, rate_sc, asc, mode):
    if not oracle.available():
        pytest.skip("reference not available")
    import libpll2_jax.constants as C

    if asc and rate_sc:
        # unsupported by design, mirroring the reference: asc corrections
        # need plain per-site scalers (partition.py:158, reference pll.c
        # rejects PLL_ATTRIB_RATE_SCALERS with asc bias)
        pytest.skip("rate scalers + asc rejected (reference parity)")
    golden = _grid_golden(alphabet, asc)
    states, cm, om, freqs, subst, seqs, tree = _grid_alphabet(alphabet)
    kwargs = {}
    if asc:
        kwargs["asc_bias"] = C.AscBias.LEWIS
    part = Partition(tree.tip_count, tree.inner_count, states,
                     _GRID_SITES, 1, tree.edge_count, 4,
                     tree.inner_count, dtype=jnp.float32,
                     rate_scalers=rate_sc, **kwargs)
    for tip, seq in zip(tree.tips(), seqs):
        part.set_tip_states(tip.clv_index, cm, seq)
    part.set_frequencies(0, freqs)
    part.set_subst_params(0, subst)
    part.set_category_rates(compute_gamma_cats(0.8, 4))
    ekw = (dict(level_schedule=True, pallas=False) if mode == "levels"
           else dict(pallas="interpret"))
    eng = TreeEngine(part, tree, **ekw)
    if mode == "fused":
        assert eng.use_fused, "fused path not selected for this cell"
    lk = eng.loglikelihood()
    np.testing.assert_allclose(
        lk, golden, rtol=3e-5,
        err_msg=f"{alphabet}/{'rate' if rate_sc else 'site'}/"
                f"{'lewis' if asc else 'noasc'}/{mode}")


def test_per_rate_scalers_many_categories():
    """Per-rate scalers beyond 8 Gamma categories:
    the reference's per-rate machinery is category-count-agnostic
    (/root/reference/src/core_partials.c:760-771). Here 12 categories
    must (a) match the oracle on the XLA levels path, and (b) run the
    fused kernel for DNA and (c) for AA (one scaler row per rate, no
    category bound)."""
    if not oracle.available():
        pytest.skip("reference not available")
    from libpll2_jax.trees import parse_newick

    R = 12
    n = 100
    text = f"t{n-1}:0.1"
    for i in range(n - 2, 1, -1):
        text = f"(t{i}:0.1,{text}):0.1"
    tree = parse_newick(f"(t0:0.1,t1:0.1,{text});")
    headers, seqs = simulate_alignment(tree, 256, FREQS, SUBST,
                                       alpha=0.3, seed=23)
    by = dict(zip(headers, seqs))
    rates = compute_gamma_cats(0.3, R)

    def build(dtype=None):
        part = Partition(tree.tip_count, tree.inner_count, 4, 256, 1,
                         tree.edge_count, R, tree.inner_count,
                         rate_scalers=True, dtype=dtype)
        for tip in tree.tips():
            part.set_tip_states(tip.clv_index, maps.map_nt, by[tip.label])
        part.set_frequencies(0, FREQS)
        part.set_subst_params(0, SUBST)
        part.set_category_rates(rates)
        return part

    ref = oracle.OraclePartition(tree.tip_count, tree.inner_count, 4, 256,
                                 1, tree.edge_count, R, tree.inner_count,
                                 attributes=oracle.ATTRIB_RATE_SCALERS)
    for tip in tree.tips():
        ref.set_tip_states(tip.clv_index, "nt", by[tip.label])
    ref.set_frequencies(0, FREQS)
    ref.set_subst_params(0, SUBST)
    ref.set_category_rates(rates)
    trav = traverse(tree.vroot)
    ops, branches, pmat_idx = create_operations(trav)
    ref.update_prob_matrices([0] * R, pmat_idx, branches)
    ref.update_partials([(o.parent_clv_index, o.parent_scaler_index,
                          o.child1_clv_index, o.child1_matrix_index,
                          o.child1_scaler_index, o.child2_clv_index,
                          o.child2_matrix_index, o.child2_scaler_index)
                         for o in ops])
    root = tree.vroot
    lk_ref = ref.edge_loglikelihood(
        root.clv_index, root.scaler_index, root.back.clv_index,
        root.back.scaler_index, root.pmatrix_index, [0] * R)
    ref.destroy()

    # (a) fp64 levels path
    eng_lv = TreeEngine(build(), tree, pallas=False)
    assert eng_lv.execution_path == "levels"
    np.testing.assert_allclose(eng_lv.loglikelihood(), lk_ref, rtol=1e-10)
    # per-rate counts must actually diverge across categories
    sc = np.asarray(eng_lv.partition.scale_buffer)
    assert sc.max() > 0 and (sc.max(axis=1) != sc.min(axis=1)).any()

    # (b) DNA fused kernel at 12 categories
    eng_f = TreeEngine(build(jnp.float32), tree, pallas="interpret")
    assert eng_f.execution_path == "fused", eng_f.execution_path
    np.testing.assert_allclose(eng_f.loglikelihood(), lk_ref, rtol=5e-5)

    # (c) AA at 12 categories: fused as well
    aa_part = Partition(8, 6, 20, 128, 1, 13, R, 6,
                        rate_scalers=True, dtype=jnp.float32)
    aa_tree = random_utree([f"a{i}" for i in range(8)], seed=5)
    rng = np.random.default_rng(5)
    for tip in aa_tree.tips():
        aa_part.set_tip_states(
            tip.clv_index, maps.map_aa,
            "".join(rng.choice(list("ARNDCQEGHILKMFPSTWYV"), size=128)))
    aa_part.set_frequencies(0, np.full(20, 0.05))
    aa_part.set_subst_params(0, np.ones(190))
    aa_part.set_category_rates(compute_gamma_cats(0.5, R))
    eng_aa = TreeEngine(aa_part, aa_tree, pallas="interpret")
    assert eng_aa.execution_path == "fused", eng_aa.execution_path
    assert np.isfinite(eng_aa.loglikelihood())
