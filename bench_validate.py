"""On-device numerical parity gate: the fp32 production paths on the
default device are asserted against the library's fp64 path on the CPU
backend, across the attribute matrix (levels / fused kernel x DNA / AA /
odd-5 x plain / scaling-stressed / asc-bias / per-rate scalers / tip-CLV
tips / heterotachy / rooted / site-repeats incl. 20-state / streamed SPR /
df64) — the analog of the reference's 12-attribute-combo golden matrix
(/root/reference/test/runtest.py:45-57).

One process: the fp32 half runs first in the production configuration (no
x64) on the default device; then x64 is switched on and the fp64
references run on the CPU device. Only this process touches the card. The
CPU fp64 values are themselves oracle-validated by the test suite, so
agreement certifies the fp32 device paths end to end.

    python bench_validate.py [--out VALIDATE.json]

Exit code 0 = all cases within fp32-justified tolerances.

TOLERANCE POLICY (one budget per error class, applied uniformly):
  * logL relative: TOL_LOGL = 5e-5. Per-site logs carry ~1e-7 relative
    fp32 round-off; a weighted sum over up to 2048 sites and ~10 scaling
    undo events accumulates to ~1e-6-1e-5.
  * d1/d2 relative: TOL_D1 = 5e-3 with ATOL_D1 = 5e-2 absolute floor —
    derivatives are DIFFERENCES of same-magnitude fp32 sums, so 2-3
    digits cancel near optima; cases are constructed away from
    pathological conditioning (branch lengths >= 0.02: at ~0.001 d2
    reaches ~1e6 and fp32 d1 loses 3+ digits to cancellation — a
    conditioning property, not a kernel bug, so the gate does not
    measure it).
  Every case class (DNA/AA/odd-5, scalers, repeats, asc, heterotachy,
  rooted) is held to the SAME two budgets — except the df64 certified
  final evaluation (`dna_df64`, ops/df64.py), which carries its own
  TOL_LOGL = 1e-8 (error-free-transformation arithmetic end to end, the
  reference's all-fp64 golden bar).

The 20-state repeats d1 case (`aa_repeats`) is the one most sensitive to
the device's exp/expm1 accuracy (a systematic bias in the diagonal
exponentials is amplified by cancellation in d1); the P-matrix and
derivative tables use plain `jnp.exp` / `jnp.expm1`.
"""
from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

# logL is a weighted sum of per-site logs: fp32 round-off accumulates to
# ~1e-6 relative; the 2**-32 window scaling adds no systematic error.
TOL_LOGL = 5e-5
TOL_D1 = 5e-3         # derivatives lose ~2-3 digits near extrema
ATOL_D1 = 5e-2


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def _odd5_map():
    import numpy as np
    m = np.zeros(256, dtype=np.uint64)
    for i, ch in enumerate("ACGTX"):
        m[ord(ch)] = m[ord(ch.lower())] = np.uint64(1 << i)
    m[ord("-")] = np.uint64(31)
    return m


def _build(tree, headers, seqs, states, sites, dtype, asc=None,
           alpha=0.8, repeats=False, rate_scalers=False, charmap=None,
           tip_clv=0, rate_matrices=1, rooted=False, rate_cats=4):
    import numpy as np
    from libpll2_jax import Partition, compute_gamma_cats
    from libpll2_jax import constants as C
    from libpll2_jax.io import maps

    by = dict(zip(headers, seqs))
    kwargs = {}
    if asc:
        kwargs["asc_bias"] = getattr(C.AscBias, asc.upper())
    if repeats:
        kwargs["site_repeats"] = True
    if rate_scalers:
        kwargs["rate_scalers"] = True
    inner = tree.inner_count
    edges = 2 * tree.tip_count - 2 if rooted else tree.edge_count
    part = Partition(tree.tip_count, inner, states, sites,
                     rate_matrices, edges, rate_cats, inner, dtype=dtype,
                     **kwargs)
    if charmap is None:
        charmap = maps.map_nt if states == 4 else maps.map_aa
    tips = list(tree.tips())
    part.set_tip_states_batch(charmap, [by[t.label] for t in tips],
                              tip_indices=[t.clv_index for t in tips])
    rng = np.random.default_rng(11)
    if states == 20:
        from libpll2_jax.models import load_aa_model
        load_aa_model(part, "lg")
    else:
        for m in range(rate_matrices):
            part.set_frequencies(m, rng.dirichlet(np.ones(states) * 10))
            part.set_subst_params(
                m, rng.uniform(0.5, 2.0,
                               size=states * (states - 1) // 2))
    part.set_category_rates(compute_gamma_cats(alpha, rate_cats))
    if asc:
        part.set_asc_state_weights([2] * states)
    # raw-probability tips (pll_set_tip_clv): smear each observed state
    # over the alphabet — the uncertain-query regime of EPA-style
    # placement (reference pll.c:959-1024 treats these as ordinary CLVs)
    for t in tips[:tip_clv]:
        seq = by[t.label]
        prob = np.full((sites, states), 0.3 / states)
        for j, ch in enumerate(seq[:sites]):
            code = int(charmap[ord(ch)])
            for b in range(states):
                if code >> b & 1:
                    prob[j, b] += 0.7
        part.set_tip_clv(t.clv_index, prob)
    return part


def _problems():
    """[(name, tree, headers, seqs, build_kwargs, engine_kwargs)] —
    build_kwargs feed _build (states/sites/asc/alpha/repeats/...),
    engine_kwargs feed TreeEngine (edge_params for heterotachy)."""
    import numpy as np
    from libpll2_jax.trees import (parse_newick, parse_newick_rooted,
                                   random_utree)
    from libpll2_jax.utils import simulate_alignment

    cases = []

    def add(name, tree, h, s, states, sites, asc=None, alpha=0.8, **kw):
        eng = {}
        if "edge_params" in kw:
            eng["edge_params"] = kw.pop("edge_params")
        cases.append((name, tree, h, s,
                      dict(states=states, sites=sites, asc=asc,
                           alpha=alpha, **kw), eng))

    t1 = random_utree([f"t{i}" for i in range(24)], seed=4)
    h1, s1 = simulate_alignment(t1, 1024, [0.3, 0.2, 0.2, 0.3],
                                [1, 2, 1, 1, 2, 1], alpha=0.8, seed=4)
    add("dna_random", t1, h1, s1, 4, 1024)

    # caterpillar with stretched branches: forces many fp32 scaling events
    n = 96
    text = f"t{n-1}:0.3"
    for i in range(n - 2, 1, -1):
        text = f"(t{i}:0.3,{text}):0.3"
    t2 = parse_newick(f"(t0:0.3,t1:0.3,{text});")
    h2, s2 = simulate_alignment(t2, 512, [0.25] * 4, [1, 2, 1, 1, 2, 1],
                                alpha=0.5, seed=5)
    add("dna_scaling", t2, h2, s2, 4, 512, alpha=0.5)
    # per-rate scalers on the SAME deep problem: the robustness mode that
    # matters most on FTZ fp32 hardware (reference
    # core_partials.c:760-771); every rate block rescales independently
    add("dna_rate_scalers", t2, h2, s2, 4, 512, alpha=0.5,
        rate_scalers=True)

    # site repeats x PER-RATE scalers (the reference ships the combo:
    # pll_fill_parent_scaler_repeats_per_rate, pll.h:703): same deep
    # caterpillar, low alpha so the rate blocks underflow at different
    # depths and the per-rate scaler rows genuinely diverge
    h2b, s2b = simulate_alignment(t2, 512, [0.25] * 4, [1, 2, 1, 1, 2, 1],
                                  alpha=0.3, seed=15)
    add("dna_rep_rate", t2, h2b, s2b, 4, 512, alpha=0.3,
        repeats=True, rate_scalers=True)

    # per-rate scalers at 12 categories: one scaler row per rate in the
    # kernel (category-count-agnostic, reference core_partials.c:760-771)
    add("dna_rate12", t2, h2b, s2b, 4, 512, alpha=0.3,
        rate_scalers=True, rate_cats=12)

    t3 = random_utree([f"t{i}" for i in range(12)], seed=6)
    h3, s3 = simulate_alignment(t3, 512, [1 / 20] * 20, [1.0] * 190,
                                alpha=1.0, seed=6)
    add("aa_lg", t3, h3, s3, 20, 512, alpha=1.0)
    # raw-probability tips (pll_set_tip_clv) stream f32 rows from device
    # memory on the fused path; 3 of 12 tips are uncertain queries
    add("aa_tipclv", t3, h3, s3, 20, 512, alpha=1.0, tip_clv=3)

    add("dna_asc_lewis", t1, h1, s1, 4, 1024, asc="lewis")

    # per-branch heterotachy: two rate matrices, edges alternate
    add("dna_heterotachy", t1, h1, s1, 4, 1024, rate_matrices=2,
        edge_params=(np.arange(t1.edge_count, dtype=np.int32) % 2))

    # odd 5-state alphabet (the reference's odd5 map,
    # test/src/derivatives-oddstates.c): exercises the kernel's state
    # padding (5 -> 8 rows)
    t6 = random_utree([f"t{i}" for i in range(16)], seed=12)
    rng = np.random.default_rng(12)
    chars = np.array(list("ACGTX"))
    s6 = ["".join(chars[rng.integers(0, 5, 640)]) for _ in range(16)]
    h6 = [f"t{i}" for i in range(16)]
    add("odd5", t6, h6, s6, 5, 640, charmap=_odd5_map())

    # site repeats: conserved alignment (strong class compression) so the
    # pooled storage actually permutes on the device
    t4 = random_utree([f"t{i}" for i in range(48)], seed=8)
    for nd in t4.nodes():
        for h in ([nd] if nd.is_tip() else list(nd.ring())):
            if h.back is not None:
                h.length = h.back.length = max(h.length * 0.15, 0.001)
    h4, s4 = simulate_alignment(t4, 896, [0.25] * 4, [1, 2, 1, 1, 2, 1],
                                alpha=0.6, seed=8)
    add("dna_repeats", t4, h4, s4, 4, 896, alpha=0.6, repeats=True)

    # 20-state repeats: conserved AA alignment through both repeats
    # paths (pool scan / dense-fused over pools)
    t7 = random_utree([f"t{i}" for i in range(24)], seed=13)
    for nd in t7.nodes():
        for h in ([nd] if nd.is_tip() else list(nd.ring())):
            if h.back is not None:
                # conserved (strong compression) but NOT near-zero: at
                # ~0.001 lengths d2 ~ 1e6 and the fp32 d1 loses 3 digits
                # to cancellation, tripping the gate on conditioning
                # rather than on kernel correctness
                h.length = h.back.length = max(h.length * 0.3, 0.02)
    h7, s7 = simulate_alignment(t7, 640, [1 / 20] * 20, [1.0] * 190,
                                alpha=0.9, seed=13)
    add("aa_repeats", t7, h7, s7, 20, 640, alpha=0.9, repeats=True)

    # deep random tree: ~10 levels of scaling activity; guards the fp32
    # window invariant threshold^2 > 2^-126 (a 2^-64 window silently
    # flushes whole sites to zero between scale checks on flush-to-zero
    # hardware and returns -inf at this depth)
    t5 = random_utree([f"t{i}" for i in range(768)], seed=9)
    h5, s5 = simulate_alignment(t5, 2048, [0.3, 0.2, 0.2, 0.3],
                                [1, 2, 1, 1, 2, 1], alpha=0.8, seed=9)
    add("dna_deep", t5, h5, s5, 4, 2048)

    # streamed SPR scoring (ops/spr_stream.py) on the scaling-stressed
    # caterpillar: every radius-3 candidate's logL composed from
    # directional CLVs + corrected chains, fp32 on chip vs fp64 CPU —
    # certifies the search fast path end to end (scaler propagation
    # through the up/corrected passes included)
    add("dna_stream", t2, h2, s2, 4, 512, alpha=0.5, stream=3)
    # the same streamed candidate set under PER-RATE scalers
    # (core_partials.c:760 under the search fast path)
    add("dna_stream_prs", t2, h2, s2, 4, 512, alpha=0.5, stream=3,
        rate_scalers=True)

    # df64 certified final evaluation on the scaling-stressed
    # caterpillar: error-free-transformation arithmetic end to end
    # (ops/df64.py) held to TOL 1e-8 — the reference's all-fp64 golden
    # bar (/root/reference/test/runtest.py:45-57)
    add("dna_df64", t2, h2, s2, 4, 512, alpha=0.5, df64=True)

    # streamed SPR on a SITE-REPEATS partition (the RAxML-NG production
    # combo, reference repeats.c:299 + test/src/partial-traversal.c):
    # pooled storage, dense tip-row base in-program; the winner verifies
    # through the production engine path on the device
    add("dna_rep_stream", t4, h4, s4, 4, 896, alpha=0.6, repeats=True,
        stream=3)

    # rooted tree (rtree path: step-by-step update_partials +
    # compute_root_loglikelihood, reference test/src/rooted.c analog)
    sub = [f"r{i}" for i in range(8)]
    newick = ("(((%s:0.1,%s:0.2):0.1,(%s:0.3,%s:0.1):0.2):0.05,"
              "((%s:0.1,%s:0.1):0.3,(%s:0.2,%s:0.1):0.1):0.06);"
              % tuple(sub))
    t8 = parse_newick_rooted(newick)
    rng = np.random.default_rng(14)
    s8 = ["".join(np.array(list("ACGT"))[rng.integers(0, 4, 768)])
          for _ in range(8)]
    add("dna_rooted", t8, sub, s8, 4, 768, rooted=True)
    return cases


def _stream_summary(part, tree, radius: int):
    """Streamed-SPR certification triple set: (max, mean) over the full
    radius-limited candidate scores (deterministic enumeration,
    identical on both sides) PLUS the re-verified WINNER — the argmax
    move applied to the tree and priced by a full engine evaluation with
    one Newton d1/d2 on the root branch (the production search's
    verify-before-accept step, search.spr_round_streamed). Returns
    (best, mean, win_lk, win_d1, win_d2)."""
    import jax.numpy as jnp
    import numpy as np
    from libpll2_jax import TreeEngine
    from libpll2_jax.ops import spr_stream
    from libpll2_jax.search import TreeSearch, _internal_edges
    from libpll2_jax.trees import moves

    eng = TreeEngine(part, tree, level_schedule=True, pallas=False)
    groups = [(pr, spr_stream.enumerate_targets(pr, radius))
              for pr in _internal_edges(tree)]
    sched = spr_stream.build_spr_stream(
        tree, groups, TreeSearch._n_rows(part), part.scale_buffers,
        part.prob_matrices)
    margs = eng._model_args()
    pw, invariant = eng._site_args()
    clv_arg, sc_arg, base = TreeSearch._stream_base(part)
    totals = spr_stream.spr_stream_scores(
        clv_arg, sc_arg, *margs,
        spr_stream.ops_from_table(sched.post_table),
        jnp.asarray(sched.post_valid),
        spr_stream.ops_from_table(sched.up_table),
        jnp.asarray(sched.up_valid),
        spr_stream.ops_from_table(sched.a_table),
        jnp.asarray(sched.a_valid),
        jnp.asarray(sched.blen_full, part.dtype),
        jnp.asarray(sched.merged_len, part.dtype),
        jnp.asarray(sched.half_len, part.dtype),
        jnp.asarray(sched.cand_rows), pw, invariant,
        part.scale_threshold, part.scale_factor,
        n_aux=sched.n_aux, n_arows=sched.n_arows, base=base,
        rate_scalers=part.rate_scalers)
    scores = np.asarray(totals)[:sched.n_candidates]
    # re-verify the winner: apply the argmax move (deterministic on both
    # sides — the enumeration order is identical and fp32-vs-fp64 argmax
    # agreement over well-separated candidates holds on these cases),
    # then one full evaluation + Newton d1/d2 on the new topology
    pr, t = sched.pairs[int(np.argmax(scores))]
    rb = moves.Rollback()
    moves.spr(pr, t, rb, safe=True)
    eng2 = TreeEngine(part, tree)        # production path selection
    win_lk, win_d1, win_d2 = eng2.newton_step()
    moves.rollback_move(rb)              # keep the shared tree fixture
    return (float(scores.max()), float(scores.mean()),
            float(win_lk), float(win_d1), float(win_d2))


def _rooted_logl(part, tree):
    """Step-by-step rooted evaluation (rtree traversal +
    compute_root_loglikelihood) — the reference's rooted.c flow."""
    from libpll2_jax.trees import rtree
    trav = rtree.traverse(tree.root)
    ops, branches, pmat_idx = rtree.create_operations(trav)
    part.update_prob_matrices([0] * 4, pmat_idx, branches)
    part.update_partials(ops)
    return part.compute_root_loglikelihood(
        tree.root.clv_index, tree.root.scaler_index, [0] * 4)


def _modes(platform: str, repeats: bool = False):
    """(mode, TreeEngine kwargs) for every fp32 path that exists on the
    platform. The fused kernel is compiled on a GPU and interpreted on
    the CPU; the per-op scan runs on the CPU only (on a device it is the
    fp64 reference's path, and the test suite covers it in fp32)."""
    kernel = dict(pallas=True if platform == "gpu" else "interpret")
    if repeats:
        # the XLA pool scan, and the default dense fused kernel over the
        # pooled storage
        return [("pool", dict(pallas=False)), ("fused", kernel)]
    modes = [("levels", dict(level_schedule=True, pallas=False)),
             ("fused", kernel)]
    if platform == "cpu":
        modes.insert(0, ("scan", dict(level_schedule=False, pallas=False)))
    return modes


def fp32_results():
    """Run every (case, mode) in fp32 on the default device. Call it
    before x64 is switched on (the production configuration)."""
    import jax
    import jax.numpy as jnp
    from libpll2_jax import TreeEngine

    target = jax.devices()[0]
    log(f"fp32 device: {target.platform} ({target.device_kind})")
    out = []
    for (name, tree, headers, seqs, bkw, ekw) in _problems():
        bkw = dict(bkw)
        if bkw.get("rooted"):
            log(f"  {name}: fp32 rooted ...")
            p32 = _build(tree, headers, seqs, dtype=jnp.float32, **bkw)
            out.append({"case": name, "mode": "root", "kernel": "xla",
                        "lk": _rooted_logl(p32, tree),
                        "d1": 0.0, "d2": 0.0})
            continue
        if bkw.get("df64"):
            log(f"  {name}: df64 certified final evaluation ...")
            bkw.pop("df64")
            from libpll2_jax import loglikelihood_df64
            p32 = _build(tree, headers, seqs, dtype=jnp.float32, **bkw)
            out.append({"case": name, "mode": "df64", "kernel": "xla",
                        "lk": loglikelihood_df64(p32, tree),
                        "d1": 0.0, "d2": 0.0, "tol_logl": 1e-8})
            continue
        if bkw.get("stream"):
            log(f"  {name}: fp32 streamed SPR scores + winner ...")
            radius = bkw.pop("stream")
            p32 = _build(tree, headers, seqs, dtype=jnp.float32, **bkw)
            best, mean, wlk, wd1, wd2 = _stream_summary(p32, tree, radius)
            out.append({"case": name, "mode": "stream", "kernel": "xla",
                        "lk": best, "d1": mean, "d2": 0.0})
            # the accepted winner re-verified with a full evaluation and
            # real Newton d1/d2: the stream rows certify more than scores
            out.append({"case": name + "_win", "mode": "strmwin",
                        "kernel": "xla", "lk": wlk, "d1": wd1, "d2": wd2})
            continue
        rep = bkw.get("repeats", False)
        for mode, kw in _modes(target.platform, repeats=rep):
            log(f"  {name}: fp32 {mode} ...")
            p32 = _build(tree, headers, seqs, dtype=jnp.float32, **bkw)
            e32 = TreeEngine(p32, tree, **kw, **ekw)
            lk, d1, d2 = e32.newton_step()
            out.append({"case": name, "mode": mode,
                        "kernel": e32.execution_path,
                        "lk": lk, "d1": d1, "d2": d2})
    return target.platform, out


def fp64_references():
    """{case: (logL, d1, d2)} from the fp64 path on the CPU device.
    Switches x64 on for the rest of the process."""
    import jax
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    from libpll2_jax import TreeEngine

    refs = {}
    with jax.default_device(jax.devices("cpu")[0]):
        for (name, tree, headers, seqs, bkw, ekw) in _problems():
            bkw = dict(bkw)
            log(f"  {name}: fp64 reference on cpu ...")
            if bkw.get("df64"):
                bkw.pop("df64")
                p64 = _build(tree, headers, seqs, dtype=jnp.float64, **bkw)
                e64 = TreeEngine(p64, tree, pallas=False)
                refs[name] = (e64.loglikelihood(), 0.0, 0.0)
                continue
            if bkw.get("stream"):
                radius = bkw.pop("stream")
                p64 = _build(tree, headers, seqs, dtype=jnp.float64, **bkw)
                best, mean, wlk, wd1, wd2 = _stream_summary(p64, tree,
                                                            radius)
                refs[name] = (best, mean, 0.0)
                refs[name + "_win"] = (wlk, wd1, wd2)
                continue
            p64 = _build(tree, headers, seqs, dtype=jnp.float64, **bkw)
            if bkw.get("rooted"):
                refs[name] = (_rooted_logl(p64, tree), 0.0, 0.0)
                continue
            e64 = TreeEngine(p64, tree, pallas=False, **ekw)
            refs[name] = e64.newton_step()
    return refs


def compare(rows, refs):
    """Each fp32 row against its fp64 reference under the gate's budgets;
    returns the rows with their errors and an `ok` flag."""
    import numpy as np
    results = []
    for row in rows:
        ref_lk, ref_d1, ref_d2 = refs[row["case"]]
        rel = abs(row["lk"] - ref_lk) / abs(ref_lk)
        d1_err = abs(row["d1"] - ref_d1) / max(abs(ref_d1),
                                               ATOL_D1 / TOL_D1)
        d2_err = abs(row["d2"] - ref_d2) / max(abs(ref_d2),
                                               ATOL_D1 / TOL_D1)
        # per-row override: the df64 certified path is held to 1e-8
        tol_logl = row.get("tol_logl", TOL_LOGL)
        ok = bool(rel < tol_logl and d1_err < TOL_D1
                  and d2_err < TOL_D1 and np.isfinite(row["lk"]))
        results.append({**row, "ref_logl": ref_lk, "rel_err": rel,
                        "d1_err": d1_err, "d2_err": d2_err, "ok": ok})
        log(f"  {row['case']:16s} {row['mode']:7s} {row['kernel']:19s} "
            f"logL={row['lk']:14.4f} rel={rel:.2e} d1={d1_err:.2e} "
            f"d2={d2_err:.2e} {'OK' if ok else 'FAIL'}")
    return results


def run_gate():
    """fp32 on the default device, then fp64 on the CPU device, then the
    comparison: {"device", "cases", "passed", "ok", "results"}."""
    platform, rows = fp32_results()
    results = compare(rows, fp64_references())
    n_ok = sum(r["ok"] for r in results)
    return {"device": platform, "cases": len(results), "passed": n_ok,
            "ok": n_ok == len(results), "results": results}


def main(argv):
    # the fp64 references need the CPU backend beside the device
    plats = os.environ.get("JAX_PLATFORMS")
    if plats and "cpu" not in plats.split(","):
        os.environ["JAX_PLATFORMS"] = plats + ",cpu"
    from libpll2_jax.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    summary = run_gate()
    if "--out" in argv:
        with open(argv[argv.index("--out") + 1], "w") as fh:
            json.dump(summary, fh, indent=1)
    print(json.dumps({"metric": "parity_cases_passed",
                      "value": summary["passed"], "unit": "cases",
                      "cases": summary["cases"],
                      "device": summary["device"]}), flush=True)
    return 0 if summary["ok"] else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
