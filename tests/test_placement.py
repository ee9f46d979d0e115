"""EPA-style placement: a pruned taxon is placed back onto its true
attachment edge, with all candidate edges scored in one dispatch."""
import numpy as np
import pytest

from libpll2_jax import Partition, compute_gamma_cats
from libpll2_jax.io import maps
from libpll2_jax.placement import EdgePlacer
from libpll2_jax.trees import parse_newick, random_utree, export_newick
from libpll2_jax.utils import simulate_alignment

FREQS = [0.3, 0.2, 0.2, 0.3]
SUBST = [1, 2.5, 0.8, 1.1, 2.5, 1]


def _prune_tip(tree, label):
    """prune_tip, returning both joined neighbors (the true attachment
    edge of the removed taxon connects the two clades)."""
    from libpll2_jax.trees import prune_tip
    node = prune_tip(tree, label)
    return node, node.back


def test_place_recovers_pruned_taxon():
    full = random_utree([f"t{i}" for i in range(14)], seed=17)
    headers, seqs = simulate_alignment(full, 1200, FREQS, SUBST,
                                       alpha=0.9, seed=17)
    by = dict(zip(headers, seqs))
    victim = "t5"
    a, b = _prune_tip(full, victim)
    ref_tree = parse_newick(export_newick(a if not a.is_tip() else b))
    ref_by = {k: v for k, v in by.items() if k != victim}

    placer = EdgePlacer(ref_tree, ref_by)
    placer.set_model(FREQS, SUBST, alpha=0.9)
    rows = placer.place(by[victim])
    assert len(rows) == 2 * 13 - 3
    assert abs(sum(r["lwr"] for r in rows) - 1.0) < 1e-9
    best = rows[0]
    # the true attachment edge joins the two clades the victim's old
    # neighbor connected: one of its endpoints subtends {a-side labels}
    side_labels = {n for n in (a.label, b.label) if n}
    assert best["lwr"] > 0.25, rows[:3]
    # the winner's logL must dominate a random distant edge clearly
    assert best["logL"] > rows[-1]["logL"] + 2.0
    # and the true edge (by construction the pruned neighbor joined a<->b)
    names = set(best["edge_nodes"])
    assert side_labels & names or best["lwr"] > 0.5, (best, side_labels)


def test_place_two_queries_reuse_engine():
    full = random_utree([f"t{i}" for i in range(10)], seed=23)
    headers, seqs = simulate_alignment(full, 600, FREQS, SUBST,
                                       alpha=1.0, seed=23)
    by = dict(zip(headers, seqs))
    ref_by = {k: v for k, v in by.items() if k not in ("t3",)}
    a, b = _prune_tip(full, "t3")
    ref_tree = parse_newick(export_newick(a if not a.is_tip() else b))
    placer = EdgePlacer(ref_tree, ref_by)
    placer.set_model(FREQS, SUBST, alpha=1.0)
    r1 = placer.place(by["t3"], top_k=3)
    # placing a COPY of an existing reference taxon should put it on
    # that taxon's pendant edge with high weight
    r2 = placer.place(ref_by["t7"], top_k=3)
    assert "t7" in set(r2[0]["edge_nodes"]), r2
    assert len(r1) == 3 and r1[0]["lwr"] >= r1[1]["lwr"]


def test_placement_logl_matches_oracle():
    """Per-edge placement logL equals the reference library evaluating
    the identical grafted tree (CLAUDE.md numeric parity rule)."""
    import oracle
    if not oracle.available():
        pytest.skip("reference not available")
    full = random_utree([f"t{i}" for i in range(9)], seed=29)
    headers, seqs = simulate_alignment(full, 400, FREQS, SUBST,
                                       alpha=0.8, seed=29)
    by = dict(zip(headers, seqs))
    a, b = _prune_tip(full, "t2")
    ref_tree = parse_newick(export_newick(a if not a.is_tip() else b))
    ref_by = {k: v for k, v in by.items() if k != "t2"}

    placer = EdgePlacer(ref_tree, ref_by, pendant_length=0.07)
    placer.set_model(FREQS, SUBST, alpha=0.8)
    rows = placer.place(by["t2"])
    by_edge = {r["edge"]: r["logL"] for r in rows}

    # drive the reference through the SAME candidate operation lists
    n = placer.n_ref
    E = len(placer.edges)
    sites = len(next(iter(ref_by.values())))
    ref = oracle.OraclePartition(n + 1, n, 4, sites, 1, E + 2, 4, n)
    labels = [t.label for t in placer.tree.tips()]
    for i, lab in enumerate(labels):
        ref.set_tip_states(i, "nt", ref_by[lab])
    ref.set_tip_states(n, "nt", by["t2"])
    ref.set_frequencies(0, FREQS)
    ref.set_subst_params(0, SUBST)
    ref.set_category_rates(compute_gamma_cats(0.8, 4))
    pidx = [0] * 4
    for e in (0, E // 2, E - 1):
        ops, branches, pmat_idx, ri = placer._candidates[e]
        ref.update_prob_matrices(pidx, pmat_idx, branches)
        ref.update_partials([(o.parent_clv_index, o.parent_scaler_index,
                              o.child1_clv_index, o.child1_matrix_index,
                              o.child1_scaler_index, o.child2_clv_index,
                              o.child2_matrix_index, o.child2_scaler_index)
                             for o in ops])
        lk_ref = ref.edge_loglikelihood(ri[0], ri[1], ri[2], ri[3], ri[4],
                                        pidx)
        np.testing.assert_allclose(by_edge[e], lk_ref, rtol=1e-9)
    ref.destroy()


import pytest as _pytest


@_pytest.mark.parametrize("mode", ["fallback", "fused"])
def test_place_batch_matches_place(mode):
    """Batched (query x edge) grid scoring equals per-query placement —
    through the fused kernel (fp32, interpret) and through the fp64
    fallback loop."""
    import jax.numpy as jnp

    full = random_utree([f"t{i}" for i in range(10)], seed=43)
    headers, seqs = simulate_alignment(full, 512, FREQS, SUBST,
                                       alpha=0.9, seed=43)
    by = dict(zip(headers, seqs))
    a, b = _prune_tip(full, "t6")
    ref_tree = parse_newick(export_newick(a if not a.is_tip() else b))
    ref_by = {k: v for k, v in by.items() if k != "t6"}

    kw = (dict(dtype=jnp.float32, pallas="interpret")
          if mode == "fused" else {})
    placer = EdgePlacer(ref_tree, ref_by, **kw)
    placer.set_model(FREQS, SUBST, alpha=0.9)
    single = placer.place(by["t6"])
    if mode == "fused":
        assert placer._engine.use_fused
    queries = {"t6": by["t6"], "t6b": by["t6"]}
    batch = placer.place_batch(queries, chunk=2)
    np.testing.assert_allclose(
        [r["logL"] for r in batch["t6"]],
        [r["logL"] for r in single], rtol=1e-5)
    assert batch["t6"][0]["edge"] == single[0]["edge"]
    np.testing.assert_allclose(
        [r["logL"] for r in batch["t6b"]],
        [r["logL"] for r in batch["t6"]], rtol=1e-12)


def test_jplace_export():
    """jplace v3 output: every edge annotated exactly once with its
    candidate index; placements reference valid edges; round-trips
    through json."""
    import json
    import re
    from libpll2_jax.placement import to_jplace

    full = random_utree([f"t{i}" for i in range(8)], seed=3)
    headers, seqs = simulate_alignment(full, 256, FREQS, SUBST,
                                       alpha=0.9, seed=3)
    by = dict(zip(headers, seqs))
    a, b = _prune_tip(full, "t1")
    ref_tree = parse_newick(export_newick(a if not a.is_tip() else b))
    ref_by = {k: v for k, v in by.items() if k != "t1"}
    placer = EdgePlacer(ref_tree, ref_by)
    placer.set_model(FREQS, SUBST, alpha=0.9)
    res = {"t1": placer.place(by["t1"])}
    jp = json.loads(json.dumps(to_jplace(placer, res, top_k=3)))
    edges = [int(x) for x in re.findall(r"\{(\d+)\}", jp["tree"])]
    n_edges = len(placer.edges)
    assert sorted(edges) == list(range(n_edges))
    assert jp["version"] == 3 and len(jp["placements"]) == 1
    p = jp["placements"][0]["p"]
    assert len(p) == 3
    for edge_num, lnl, lwr, distal, pendant in p:
        assert 0 <= edge_num < n_edges
        assert np.isfinite(lnl) and 0 <= lwr <= 1
        assert distal >= 0 and pendant == placer.pendant_length


def test_place_stream_matches_place():
    """Streaming scorer (precomputed attachment tensors) returns the
    same per-edge logL surface as the full-traversal place() path."""
    full = random_utree([f"t{i}" for i in range(16)], seed=41)
    headers, seqs = simulate_alignment(full, 768, FREQS, SUBST,
                                       alpha=0.7, seed=41)
    by = dict(zip(headers, seqs))
    a, b = _prune_tip(full, "t2")
    ref_tree = parse_newick(export_newick(a if not a.is_tip() else b))
    ref_by = {k: v for k, v in by.items() if k != "t2"}
    placer = EdgePlacer(ref_tree, ref_by)
    placer.set_model(FREQS, SUBST, alpha=0.7)
    single = sorted(placer.place(by["t2"]), key=lambda r: r["edge"])
    # three queries incl. a gappy one and a reference copy
    gappy = by["t2"][:300] + "-" * 168 + by["t2"][468:]
    res = placer.place_stream({"q": by["t2"], "g": gappy,
                               "c": ref_by["t7"]}, chunk=4)
    stream = sorted(res["q"], key=lambda r: r["edge"])
    np.testing.assert_allclose([r["logL"] for r in stream],
                               [r["logL"] for r in single], rtol=2e-5)
    best_q = max(res["q"], key=lambda r: r["logL"])
    best_s = max(single, key=lambda r: r["logL"])
    assert best_q["edge"] == best_s["edge"]
    # a copy of t7 lands on t7's pendant edge
    best_c = max(res["c"], key=lambda r: r["logL"])
    assert "t7" in set(best_c["edge_nodes"])


def test_place_stream_scaling_events():
    """Deep stretched tree forces per-site rescaling: the streaming
    scorer's scaler-count correction must reproduce place()'s logL."""
    n = 40
    text = "t2:0.9"
    for i in range(3, n):
        text = f"({text},t{i}:0.9):0.9"
    full = parse_newick(f"(t0:0.4,t1:0.4,{text});")
    headers, seqs = simulate_alignment(full, 384, FREQS, SUBST,
                                       alpha=0.6, seed=43)
    by = dict(zip(headers, seqs))
    a, b = _prune_tip(full, "t9")
    ref_tree = parse_newick(export_newick(a if not a.is_tip() else b))
    ref_by = {k: v for k, v in by.items() if k != "t9"}
    placer = EdgePlacer(ref_tree, ref_by)
    placer.set_model(FREQS, SUBST, alpha=0.6)
    single = sorted(placer.place(by["t9"]), key=lambda r: r["edge"])
    stream = sorted(placer.place_stream({"q": by["t9"]})["q"],
                    key=lambda r: r["edge"])
    np.testing.assert_allclose([r["logL"] for r in stream],
                               [r["logL"] for r in single], rtol=2e-5)


def test_place_stream_aa():
    from libpll2_jax.models import load_aa_model

    full = random_utree([f"t{i}" for i in range(10)], seed=47)
    headers, seqs = simulate_alignment(full, 320, [1 / 20] * 20,
                                       [1.0] * 190, alpha=1.0, seed=47)
    by = dict(zip(headers, seqs))
    a, b = _prune_tip(full, "t4")
    ref_tree = parse_newick(export_newick(a if not a.is_tip() else b))
    ref_by = {k: v for k, v in by.items() if k != "t4"}
    placer = EdgePlacer(ref_tree, ref_by, states=20)
    load_aa_model(placer.partition, "lg")
    placer.partition.set_category_rates(
        __import__("libpll2_jax").compute_gamma_cats(1.0, 4))
    placer._engine = None
    placer._stream = None
    single = sorted(placer.place(by["t4"]), key=lambda r: r["edge"])
    stream = sorted(placer.place_stream({"q": by["t4"]})["q"],
                    key=lambda r: r["edge"])
    np.testing.assert_allclose([r["logL"] for r in stream],
                               [r["logL"] for r in single], rtol=2e-5)


def test_place_stream_rejects_pinv():
    import pytest as _pytest

    from libpll2_jax import constants as C

    full = random_utree([f"t{i}" for i in range(8)], seed=51)
    headers, seqs = simulate_alignment(full, 256, FREQS, SUBST,
                                       alpha=0.9, seed=51)
    by = dict(zip(headers, seqs))
    placer = EdgePlacer(full, by)
    placer.set_model(FREQS, SUBST, alpha=0.9)
    placer.partition.update_invariant_sites()
    placer.partition.update_invariant_sites_proportion(0, 0.2)
    with _pytest.raises(C.PllError):
        placer.place_stream({"q": by["t0"]})


def test_place_stream_jplace():
    """place_stream rows feed to_jplace unchanged."""
    import json

    from libpll2_jax.placement import to_jplace

    full = random_utree([f"t{i}" for i in range(8)], seed=3)
    headers, seqs = simulate_alignment(full, 256, FREQS, SUBST,
                                       alpha=0.9, seed=3)
    by = dict(zip(headers, seqs))
    a, b = _prune_tip(full, "t1")
    ref_tree = parse_newick(export_newick(a if not a.is_tip() else b))
    ref_by = {k: v for k, v in by.items() if k != "t1"}
    placer = EdgePlacer(ref_tree, ref_by)
    placer.set_model(FREQS, SUBST, alpha=0.9)
    res = placer.place_stream({"t1": by["t1"]}, top_k=3)
    jp = json.loads(json.dumps(to_jplace(placer, res, top_k=3)))
    assert len(jp["placements"][0]["p"]) == 3


def test_place_stream_invalidates_on_branch_change():
    """Changing reference branch lengths must re-prepare the attachment
    tensors, not score against stale ones."""
    full = random_utree([f"t{i}" for i in range(10)], seed=59)
    headers, seqs = simulate_alignment(full, 256, FREQS, SUBST,
                                       alpha=0.9, seed=59)
    by = dict(zip(headers, seqs))
    a, b = _prune_tip(full, "t3")
    ref_tree = parse_newick(export_newick(a if not a.is_tip() else b))
    ref_by = {k: v for k, v in by.items() if k != "t3"}
    placer = EdgePlacer(ref_tree, ref_by)
    placer.set_model(FREQS, SUBST, alpha=0.9)
    before = placer.place_stream({"q": by["t3"]})["q"]
    for h in placer.edges:
        h.length = h.back.length = h.length * 3.0
    after = placer.place_stream({"q": by["t3"]})["q"]
    fresh = sorted(placer.place(by["t3"]), key=lambda r: r["edge"])
    np.testing.assert_allclose(
        [r["logL"] for r in sorted(after, key=lambda r: r["edge"])],
        [r["logL"] for r in fresh], rtol=2e-5)
    assert any(abs(x["logL"] - y["logL"]) > 1.0
               for x, y in zip(sorted(before, key=lambda r: r["edge"]),
                               sorted(after, key=lambda r: r["edge"])))


def test_to_jplace_mixed_length_rows():
    """Merged results with DIFFERENT row counts (e.g. place_stream
    calls with different top_k) must emit min(len(rows), top_k) rows
    PER query — the vectorized writer only engages on uniform row
    counts (review finding, round 5)."""
    import json

    from libpll2_jax.placement import to_jplace

    tree = random_utree([f"t{i}" for i in range(8)], seed=4)
    headers, seqs = simulate_alignment(tree, 128, [0.25] * 4,
                                       [1, 2, 1, 1, 2, 1], alpha=0.9,
                                       seed=4)
    by = dict(zip(headers, seqs))
    placer = EdgePlacer(tree, by)
    placer.set_model([0.25] * 4, [1, 2, 1, 1, 2, 1], alpha=0.9)
    placer.prepare_stream()
    long_rows = placer.place_stream({"qA": by["t1"]})
    short_rows = placer.place_stream({"qB": by["t2"]}, top_k=3)
    merged = {"qA": long_rows["qA"], "qB": short_rows["qB"]}
    jp = to_jplace(placer, merged, top_k=7)
    counts = {p["n"][0]: len(p["p"]) for p in jp["placements"]}
    assert counts == {"qA": 7, "qB": 3}
    json.dumps(jp)                      # serializable end to end
