"""Randomized configuration fuzz vs the oracle.

The deterministic suite covers each feature's own scenarios; this test
sweeps random COMBINATIONS — alphabet x rate categories x category
weights x +I x pattern weights x branch-length regime x asc-bias x
per-rate scalers x site repeats — building the identical problem in the
reference library (ctypes oracle) and here, and asserting total + per-
site logL parity. 18 seeded draws; every failure message carries the
drawn configuration for replay.
"""
import numpy as np
import pytest

import oracle
from libpll2_jax import Operation, Partition, compute_gamma_cats
from libpll2_jax import constants as C
from libpll2_jax.io import maps
from libpll2_jax.trees import create_operations, random_utree, traverse

pytestmark = pytest.mark.skipif(not oracle.available(),
                                reason="reference not available")

ASC_TYPE = {C.AscBias.LEWIS: oracle.ATTRIB_AB_LEWIS,
            C.AscBias.FELSENSTEIN: oracle.ATTRIB_AB_FELSENSTEIN,
            C.AscBias.STAMATAKIS: oracle.ATTRIB_AB_STAMATAKIS}


def _draw_config(rng):
    states = int(rng.choice([4, 4, 4, 20]))       # DNA-weighted
    cfg = dict(
        states=states,
        n_taxa=int(rng.integers(6, 20)),
        sites=int(rng.integers(40, 320)),
        rate_cats=int(rng.choice([1, 2, 4])),
        alpha=float(rng.uniform(0.15, 4.0)),
        gamma_median=bool(rng.integers(0, 2)),
        cat_weights=bool(rng.integers(0, 2)),
        pinv=float(rng.choice([0.0, 0.0, 0.25])),
        pattern_weights=bool(rng.integers(0, 2)),
        long_branches=bool(rng.integers(0, 4) == 0),
        rate_scalers=bool(rng.integers(0, 4) == 0),
        asc=None,
        repeats=bool(rng.integers(0, 3) == 0),
    )
    if not cfg["rate_scalers"] and cfg["pinv"] == 0.0:
        cfg["asc"] = rng.choice([None, C.AscBias.LEWIS,
                                 C.AscBias.FELSENSTEIN,
                                 C.AscBias.STAMATAKIS])
    return cfg


def _random_seq(rng, n, states):
    if states == 4:
        alphabet = list("ACGT") * 5 + list("RYN-")
    else:
        alphabet = list("ARNDCQEGHILKMFPSTWYV") + ["X", "-"]
    return "".join(rng.choice(alphabet, size=n))


@pytest.mark.parametrize("seed", range(18))
def test_fuzz_config_vs_oracle(seed):
    rng = np.random.default_rng(1000 + seed)
    cfg = _draw_config(rng)
    n, sites, states, R = (cfg["n_taxa"], cfg["sites"], cfg["states"],
                           cfg["rate_cats"])
    tree = random_utree([f"t{i}" for i in range(n)], seed=seed)
    if cfg["long_branches"]:
        seen = set()
        for nd in tree.nodes():
            for h in ([nd] if nd.is_tip() else list(nd.ring())):
                if h.back is not None and id(h) not in seen:
                    seen.add(id(h)), seen.add(id(h.back))
                    h.length = h.back.length = h.length * 25.0
    seqs = [_random_seq(rng, sites, states) for _ in range(n)]
    if cfg["pinv"] > 0:            # guarantee invariant columns
        const = "A" if states == 4 else "L"
        seqs = [const * 6 + s[6:] for s in seqs]

    nparams = states * (states - 1) // 2
    freqs = rng.dirichlet(np.ones(states) * 8)
    subst = rng.uniform(0.3, 2.5, size=nparams)
    mode = (C.GAMMA_RATES_MEDIAN if cfg["gamma_median"]
            else C.GAMMA_RATES_MEAN)
    rates = (compute_gamma_cats(cfg["alpha"], R, mode) if R > 1
             else np.ones(1))
    cat_w = (rng.dirichlet(np.ones(R) * 6) if cfg["cat_weights"]
             else np.full(R, 1.0 / R))
    pw = (rng.integers(0, 5, size=sites) if cfg["pattern_weights"]
          else np.ones(sites, dtype=np.int64))
    if pw.sum() == 0:
        pw[0] = 1

    attrs = oracle.ATTRIB_AB_FLAG if cfg["asc"] is not None else 0
    if cfg["rate_scalers"]:
        attrs |= oracle.ATTRIB_RATE_SCALERS
    if cfg["repeats"]:
        attrs |= oracle.ATTRIB_SITE_REPEATS

    mapname = "nt" if states == 4 else "aa"
    charmap = maps.map_nt if states == 4 else maps.map_aa
    kwargs = {}
    if cfg["asc"] is not None:
        kwargs["asc_bias"] = cfg["asc"]
    ref = oracle.OraclePartition(n, n - 2, states, sites, 1,
                                 2 * n - 3, R, n - 2, attributes=attrs)
    part = Partition(n, n - 2, states, sites, 1, 2 * n - 3, R, n - 2,
                     rate_scalers=cfg["rate_scalers"],
                     site_repeats=cfg["repeats"], **kwargs)
    for i, s in enumerate(seqs):
        ref.set_tip_states(i, mapname, s)
        part.set_tip_states(i, charmap, s)
    for impl in (ref, part):
        impl.set_frequencies(0, freqs)
        impl.set_subst_params(0, subst)
        impl.set_category_rates(rates)
        impl.set_category_weights(cat_w)
        impl.set_pattern_weights(pw)
    if cfg["asc"] is not None:
        asc_w = rng.integers(1, 4, size=states)
        ref.set_asc_bias_type(ASC_TYPE[cfg["asc"]])
        ref.set_asc_state_weights(asc_w)
        part.set_asc_state_weights(asc_w)
    if cfg["pinv"] > 0:
        ref.set_invariant_proportion(0, cfg["pinv"])
        part.update_invariant_sites_proportion(0, cfg["pinv"])

    trav = traverse(tree.vroot)
    ops, branches, pmat_idx = create_operations(trav)
    pidx = [0] * R
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
    lk_ref, per_ref = ref.edge_loglikelihood(*args, persite=True)
    lk, per = part.compute_edge_loglikelihood(*args, persite=True)
    ref.destroy()
    msg = f"config: {cfg}"
    if np.isinf(lk_ref):
        assert np.isinf(lk) and lk < 0, msg
        return
    np.testing.assert_allclose(lk, lk_ref, rtol=1e-9, err_msg=msg)
    np.testing.assert_allclose(np.asarray(per)[:sites], per_ref[:sites],
                               rtol=1e-8, atol=1e-10, err_msg=msg)


@pytest.mark.parametrize("seed", range(8))
def test_fuzz_engine_paths(seed):
    """Random configurations through every ELIGIBLE engine execution
    path — scan, levels, fused (interpret), pool (fp64 and fp32),
    repeats-dense-fused — must agree on logL and d1/d2
    within dtype-justified tolerances."""
    import jax.numpy as jnp
    from libpll2_jax import Partition, TreeEngine

    rng = np.random.default_rng(3000 + seed)
    n = int(rng.integers(6, 16))
    sites = int(rng.integers(60, 400))
    R = int(rng.choice([1, 2, 4]))
    states = int(rng.choice([4, 4, 20]))
    long_b = bool(rng.integers(0, 3) == 0)
    tree = random_utree([f"t{i}" for i in range(n)], seed=seed)
    if long_b:
        for nd in tree.nodes():
            for h in ([nd] if nd.is_tip() else list(nd.ring())):
                if h.back is not None:
                    h.length = h.length * 20.0
    seqs = [_random_seq(rng, sites, states) for _ in range(n)]
    freqs = rng.dirichlet(np.ones(states) * 8)
    subst = rng.uniform(0.3, 2.5, size=states * (states - 1) // 2)
    rates = (compute_gamma_cats(float(rng.uniform(0.2, 3.0)), R)
             if R > 1 else np.ones(1))
    charmap = maps.map_nt if states == 4 else maps.map_aa

    def build(dtype=None, repeats=False):
        part = Partition(n, n - 2, states, sites, 1, 2 * n - 3, R, n - 2,
                         dtype=dtype, site_repeats=repeats)
        for i, s in enumerate(seqs):
            part.set_tip_states(i, charmap, s)
        part.set_frequencies(0, freqs)
        part.set_subst_params(0, subst)
        part.set_category_rates(rates)
        return part

    engines = {
        "scan": TreeEngine(build(), tree, pallas=False,
                           level_schedule=False),
        "levels": TreeEngine(build(), tree, pallas=False),
        "fused": TreeEngine(build(jnp.float32), tree, pallas="interpret"),
        "pool": TreeEngine(build(repeats=True), tree, pallas=False),
        "pool32": TreeEngine(build(jnp.float32, repeats=True), tree,
                             pallas="pool"),
        "rdf": TreeEngine(build(jnp.float32, repeats=True), tree,
                          pallas="interpret"),
    }
    ref_lk = None
    msg = f"seed={seed} n={n} sites={sites} R={R} states={states}"
    results = {}
    for name, eng in engines.items():
        lk, d1, d2 = eng.newton_step()
        results[name] = (lk, d1, d2)
        if name == "scan":
            ref_lk = (lk, d1, d2)
            continue
        tol = 1e-9 if eng.partition.dtype == jnp.float64 else 5e-5
        if np.isinf(ref_lk[0]):
            assert np.isinf(lk) or eng.partition.dtype == jnp.float32, msg
            continue
        np.testing.assert_allclose(lk, ref_lk[0], rtol=tol,
                                   err_msg=f"{name}: {msg}")
        np.testing.assert_allclose(d1, ref_lk[1], rtol=max(tol * 100, 1e-7),
                                   atol=abs(ref_lk[1]) * 1e-2 + 1e-2,
                                   err_msg=f"{name}: {msg}")


@pytest.mark.parametrize("seed", range(6))
def test_fuzz_stream_placement(seed):
    """Random (alphabet, rate cats, alpha, branch regime, gappy queries):
    the streaming placer's per-edge logL surface must match the
    full-traversal place() path for every edge."""
    from libpll2_jax.placement import EdgePlacer
    from libpll2_jax.trees import export_newick, parse_newick, prune_tip
    from libpll2_jax.utils import simulate_alignment

    rng = np.random.default_rng(7000 + seed)
    states = int(rng.choice([4, 4, 20]))
    n_taxa = int(rng.integers(8, 18))
    sites = int(rng.integers(120, 520))
    rate_cats = int(rng.choice([1, 4]))
    alpha = float(rng.uniform(0.3, 2.5))
    freqs = rng.dirichlet(np.ones(states) * 8)
    subst = rng.uniform(0.4, 2.5, size=states * (states - 1) // 2)
    full = random_utree([f"t{i}" for i in range(n_taxa)],
                        seed=9000 + seed)
    if rng.integers(0, 3) == 0:      # stretched branches: scaling events
        for nd in full.nodes():
            for h in ([nd] if nd.is_tip() else list(nd.ring())):
                if h.back is not None:
                    h.length = h.back.length = min(h.length * 4.0, 1.2)
    headers, seqs = simulate_alignment(full, sites, freqs, subst,
                                       alpha=alpha, seed=9000 + seed)
    by = dict(zip(headers, seqs))
    victim = f"t{int(rng.integers(0, n_taxa))}"
    node = prune_tip(full, victim)
    ref_tree = parse_newick(export_newick(
        node if not node.is_tip() else node.back))
    ref_by = {k: v for k, v in by.items() if k != victim}
    placer = EdgePlacer(ref_tree, ref_by, states=states,
                        rate_cats=rate_cats,
                        pendant_length=float(rng.uniform(0.01, 0.3)))
    placer.partition.set_frequencies(0, freqs)
    placer.partition.set_subst_params(0, subst)
    placer.partition.set_category_rates(
        compute_gamma_cats(alpha, rate_cats) if rate_cats > 1
        else np.ones(1))
    q = list(by[victim])
    gaps = rng.random(sites) < rng.uniform(0, 0.4)
    for i in np.flatnonzero(gaps):
        q[i] = "-"
    q = "".join(q)
    single = sorted(placer.place(q), key=lambda r: r["edge"])
    stream = sorted(placer.place_stream({"q": q}, chunk=4)["q"],
                    key=lambda r: r["edge"])
    np.testing.assert_allclose(
        [r["logL"] for r in stream], [r["logL"] for r in single],
        rtol=3e-5, err_msg=f"seed={seed} states={states} taxa={n_taxa} "
                           f"sites={sites} R={rate_cats} alpha={alpha:.2f}")
