"""Smoke test of the likelihood engine on NVIDIA GPUs, at real widths.

    python chip_smoke.py              # one GPU: phases 1-5
    python chip_smoke.py --chips 4    # four GPUs: the site-sharded phase only

Phases on one card, each through the entry points a user calls:
  1. DNA GTR+G4, 128 taxa x 16384 sites: TreeEngine (default path),
     loglikelihood + newton_step;
  2. LG+G4 (20 states), 128 x 8192, the same;
  3. site repeats, 246 x 4465 (conserved alignment): the same; then
     EdgePlacer.place_batch of 8 pruned-out queries on a 100-taxon x
     1024-site reference tree;
  4. the parity gate of bench_validate.py, every case;
  5. one pass of examples/flagship_1000.py's pipeline (1000 x 4000):
     stepwise -> model optimization -> streamed SPR/NNI -> bootstrap ->
     checkpoint -> df64; the final fp32 logL must match the df64 one.
With --chips 4, in one process over four cards: a site-sharded eval +
Newton at 128 x 65536, one ShardedRepeatsEngine eval and one streamed SPR
round, each compared with the same problem on one card.

Phases 1-3 and the sharded phase are compared with the plain reference,
the XLA scan path in fp64 (pallas=False, level_schedule=False; for
placement, per-query fp64 place() on the XLA path), computed
on the CPU backend of this same process after every device phase (only
this process touches the cards). Tolerances are the parity gate's: logL
relative 5e-5; d1/d2 relative 5e-3 with an absolute floor of 5e-2.

Prints the card's name and power limit, one line per phase (execution
path, compile seconds, errors against their tolerances) and, last, one
JSON line {"ok": true, "device": {...}}. Exits non-zero, printing no
result, when JAX finds no GPU or any phase fails.
"""
from __future__ import annotations

import json
import os
import sys
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

TOL_LOGL = 5e-5
TOL_D = 5e-3
ATOL_D = 5e-2
SEED = 7

# problem sizes (taxa, sites) per phase; tests shrink them to rehearse the
# phases on the CPU
SIZES = {"dna": (128, 16384), "aa": (128, 8192), "repeats": (246, 4465),
         "placement": (100, 1024, 8), "flagship": (1000, 4000),
         "sharded": (128, 65536), "sharded_repeats": (246, 4464)}
# TreeEngine arguments of the device phases ({} = the default path; the
# CPU rehearsal asks for the kernel in interpret mode)
ENGINE_KW = {}


def log(*a):
    print(*a, flush=True)


def rel_err(x, ref):
    return abs(x - ref) / abs(ref)


def d_err(x, ref):
    return abs(x - ref) / max(abs(ref), ATOL_D / TOL_D)


# --- problems (data made from the seed) -------------------------------------

def _model(part, states, seed):
    import numpy as np
    from libpll2_jax import compute_gamma_cats
    if states == 20:
        from libpll2_jax.models import load_aa_model
        load_aa_model(part, "lg")
    else:
        rng = np.random.default_rng(seed)
        part.set_frequencies(0, rng.dirichlet(np.ones(4) * 10))
        part.set_subst_params(0, rng.uniform(0.5, 2.0, size=6))
    part.set_category_rates(compute_gamma_cats(0.8, 4))


def make_data(states, taxa, sites, seed=SEED, conserved=False):
    """(tree, headers, seqs) simulated on a random tree."""
    import numpy as np
    from libpll2_jax.trees import random_utree
    from libpll2_jax.utils import simulate_alignment
    tree = random_utree([f"t{i}" for i in range(taxa)], seed=seed)
    if conserved:
        # short branches: strong subtree repetition (the regime site
        # repeats target)
        seen = set()
        for nd in tree.nodes():
            for h in ([nd] if nd.is_tip() else list(nd.ring())):
                if h.back is not None and id(h) not in seen:
                    seen.add(id(h)), seen.add(id(h.back))
                    h.length = h.back.length = h.length * 0.15 + 0.001
    if states == 20:
        freqs, subst = np.full(20, 0.05), np.ones(190)
    else:
        freqs, subst = [0.3, 0.2, 0.2, 0.3], [1, 2, 1, 1, 2, 1]
    headers, seqs = simulate_alignment(tree, sites, freqs, subst,
                                       alpha=0.8, seed=seed)
    return tree, headers, seqs


def make_partition(data, states, dtype, lo=0, hi=None, **kw):
    from libpll2_jax import Partition
    from libpll2_jax.io import maps
    tree, headers, seqs = data
    hi = len(seqs[0]) if hi is None else hi
    part = Partition(tree.tip_count, tree.inner_count, states, hi - lo, 1,
                     tree.edge_count, 4, tree.inner_count, dtype=dtype,
                     **kw)
    by = dict(zip(headers, seqs))
    cm = maps.map_nt if states == 4 else maps.map_aa
    tips = list(tree.tips())
    part.set_tip_states_batch(cm, [by[t.label][lo:hi] for t in tips],
                              tip_indices=[t.clv_index for t in tips])
    _model(part, states, SEED)
    return part


def fp64_reference(data, states):
    """(logL, d1, d2) of the plain reference: fp64 XLA scan path."""
    import jax.numpy as jnp
    from libpll2_jax import TreeEngine
    part = make_partition(data, states, jnp.float64)
    eng = TreeEngine(part, data[0], pallas=False, level_schedule=False)
    eng.loglikelihood()
    return eng.newton_step()


# --- measurement helpers -----------------------------------------------------

def first_call(fn):
    """(value, seconds of the first call, seconds of a repeat call)."""
    t0 = time.perf_counter()
    out = fn()
    t1 = time.perf_counter()
    fn()
    t2 = time.perf_counter()
    return out, t1 - t0, t2 - t1


def per_eval_ms(eng, k1=5, k2=25, reps=3):
    """Device time of one evaluation: k chained evaluations in one
    dispatch, two trip counts differenced, median of `reps`."""
    eng.loglikelihood_loop(1)

    def run(k):
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            eng.loglikelihood_loop(k)
            ts.append(time.perf_counter() - t0)
        return sorted(ts)[len(ts) // 2]
    return (run(k2) - run(k1)) / (k2 - k1) * 1e3


def eval_and_newton(eng):
    """((logL, d1, d2), compile seconds): loglikelihood (first call
    timed), then one newton_step at the same branch lengths."""
    lk, t_first, t_again = first_call(eng.loglikelihood)
    _, d1, d2 = eng.newton_step()
    return (lk, d1, d2), max(t_first - t_again, 0.0)


# --- phases ------------------------------------------------------------------
# A device phase returns (report dict, reference thunk or None). The thunk
# runs later on the CPU backend under x64 and returns the fp64 values the
# phase's `values` are compared with.

def engine_phase(name, states, taxa, sites, conserved=False, repeats=False,
                 time_levels=False):
    import jax.numpy as jnp
    from libpll2_jax import TreeEngine
    data = make_data(states, taxa, sites, conserved=conserved)
    kw = dict(site_repeats=True) if repeats else {}
    eng = TreeEngine(make_partition(data, states, jnp.float32, **kw),
                     data[0], **ENGINE_KW)
    values, compile_s = eval_and_newton(eng)
    rep = {"phase": name, "execution_path": eng.execution_path,
           "compile_s": round(compile_s, 2), "values": values}
    want = "repeats-dense-fused" if repeats else "fused"
    rep["path_ok"] = eng.execution_path == want
    if time_levels:
        # the hand-written kernel beside what XLA makes of the plain
        # levels path, same problem, same card
        lv = TreeEngine(make_partition(data, states, jnp.float32), data[0],
                        pallas=False)
        rep["ms_per_eval"] = {eng.execution_path: per_eval_ms(eng),
                              "levels": per_eval_ms(lv)}
    return rep, (lambda: fp64_reference(data, states))


def placement_phase():
    """EdgePlacer.place_batch (the fused kernel over query x edge grids)
    on a reference tree with pruned-out queries; each query's best
    placement logL against per-query fp64 place() on the CPU."""
    from libpll2_jax import EdgePlacer
    from libpll2_jax.trees import export_newick, parse_newick, prune_tip
    taxa, sites, n_q = SIZES["placement"]
    full, headers, seqs = make_data(4, taxa + n_q, sites)
    by = dict(zip(headers, seqs))
    queries = [f"t{i}" for i in range(0, taxa + n_q, (taxa + n_q) // n_q)]
    queries = queries[:n_q]
    for q in queries:
        keep = prune_tip(full, q)
    ref_newick = export_newick(keep)
    ref_by = {k: v for k, v in by.items() if k not in queries}

    def placer(**kw):
        pl = EdgePlacer(parse_newick(ref_newick), ref_by, **kw)
        pl.set_model([0.3, 0.2, 0.2, 0.3], [1, 2, 1, 1, 2, 1], alpha=0.8)
        return pl

    import jax.numpy as jnp
    dev = placer(dtype=jnp.float32, **ENGINE_KW)
    qs = {q: by[q] for q in queries}
    res, t_first, t_again = first_call(lambda: dev.place_batch(qs,
                                                               top_k=1))
    path = dev._ensure_engine().execution_path
    rep = {"phase": f"placement {taxa}x{sites}, {n_q} queries",
           "execution_path": path,
           "compile_s": round(max(t_first - t_again, 0.0), 2),
           "values": tuple(res[q][0]["logL"] for q in queries),
           "value_names": tuple(f"logL {q}" for q in queries),
           "path_ok": path == "fused"}

    def reference():
        ref = placer(dtype=jnp.float64, pallas=False)
        return tuple(ref.place(by[q], top_k=1)[0]["logL"]
                     for q in queries)
    return rep, reference


def gate_phase():
    import bench_validate
    platform, rows = bench_validate.fp32_results()
    rep = {"phase": "4 parity gate", "execution_path":
           sorted({r["kernel"] for r in rows}), "compile_s": None,
           "cases": len(rows), "path_ok": platform == "gpu"}

    def reference():
        return bench_validate.compare(rows,
                                      bench_validate.fp64_references())
    return rep, reference


def flagship_phase():
    sys.path.insert(0, os.path.join(HERE, "examples"))
    import flagship_1000
    stages = []
    t0 = time.perf_counter()
    taxa, sites = SIZES["flagship"]
    info = flagship_1000.run(taxa=taxa, sites=sites, stages=stages)
    err = rel_err(info["logl"], info["df64_logl"])
    rep = {"phase": f"5 flagship {taxa}x{sites}",
           "execution_path": "pipeline",
           "compile_s": None, "wall_s": round(time.perf_counter() - t0, 2),
           "stages": stages, "path_ok": True,
           "checks": [("fp32 logL vs on-card df64", err, TOL_LOGL)]}
    return rep, None


def sharded_phase():
    """Four cards, one process: site-sharded eval + Newton, sharded site
    repeats, one streamed SPR round under the mesh — each against the
    same problem on one card."""
    import jax.numpy as jnp
    from libpll2_jax import TreeEngine
    from libpll2_jax import constants as C
    from libpll2_jax.parallel import (ShardedRepeatsEngine, make_mesh,
                                      shard_partition)
    from libpll2_jax.search import TreeSearch
    from libpll2_jax.trees import export_newick, moves, parse_newick
    mesh = make_mesh(4)
    reps = []
    taxa, sites = SIZES["sharded"]

    # (a) sharded eval + Newton
    data = make_data(4, taxa, sites)
    part = make_partition(data, 4, jnp.float32, sites_alignment=4)
    shard_partition(part, mesh)
    eng = TreeEngine(part, data[0], **ENGINE_KW)
    values, compile_s = eval_and_newton(eng)
    shards = part.clv.addressable_shards
    spread = sorted({s.device.id for s in shards})
    widths = sorted({s.data.shape[-1] for s in shards})
    stats = [d.memory_stats() or {} for d in mesh.devices.flat]
    in_use = [st.get("bytes_in_use", 0) for st in stats]
    one = TreeEngine(make_partition(data, 4, jnp.float32), data[0],
                     **ENGINE_KW)
    one_values, _ = eval_and_newton(one)
    reps.append(({"phase": f"S1 sharded eval+newton {taxa}x{sites}",
                  "execution_path": eng.execution_path,
                  "compile_s": round(compile_s, 2), "values": values,
                  "one_card": one_values, "shard_devices": spread,
                  "shard_widths": widths, "bytes_in_use": in_use,
                  "path_ok": (eng.execution_path == "fused"
                              and len(spread) == 4
                              and widths == [sites // 4]
                              and min(in_use) >= 0.5 * max(in_use))},
                 lambda: fp64_reference(data, 4)))

    # (b) ShardedRepeatsEngine over four equal column slices
    rtaxa, rsites = SIZES["sharded_repeats"]
    rdata = make_data(4, rtaxa, rsites, conserved=True)
    w = rsites // 4
    parts = [make_partition(rdata, 4, jnp.float32, lo=d * w,
                            hi=(d + 1) * w, site_repeats=True)
             for d in range(4)]
    reng = ShardedRepeatsEngine(rdata[0], parts, mesh,
                                interpret=bool(ENGINE_KW))
    lk_r, t_first, t_again = first_call(reng.loglikelihood)
    one_r = TreeEngine(make_partition(rdata, 4, jnp.float32,
                                      site_repeats=True), rdata[0],
                       **ENGINE_KW)
    reps.append(({"phase": f"S2 sharded repeats {rtaxa}x{rsites}",
                  "execution_path": ("dense-fused" if reng.dense_fused
                                     else "pool"),
                  "compile_s": round(max(t_first - t_again, 0.0), 2),
                  "values": (lk_r,), "one_card": (one_r.loglikelihood(),),
                  "path_ok": reng.dense_fused},
                 lambda: fp64_reference(rdata, 4)[:1]))

    # (c) one streamed SPR round under the mesh, from the simulating
    # tree with two NNIs applied, against the same round on one card
    sdata = make_data(4, taxa, sites, seed=SEED + 1)
    inner = [h for n in sdata[0].nodes() if not n.is_tip()
             for h in n.ring() if h.back is not None
             and not h.back.is_tip()]
    for h in (inner[3], inner[len(inner) // 2]):
        moves.nni(h, C.UTREE_MOVE_NNI_LEFT, moves.Rollback())
    start = export_newick(sdata[0].vroot)

    def round_on(sharded):
        tree = parse_newick(start)
        part = make_partition((tree,) + sdata[1:], 4, jnp.float32,
                              sites_alignment=4)
        if sharded:
            shard_partition(part, mesh)
        search = TreeSearch(part, tree,
                            engine=TreeEngine(part, tree, **ENGINE_KW))
        t0 = time.perf_counter()
        lk, acc = search.spr_round_streamed(radius=3)
        return lk, acc, time.perf_counter() - t0, tree

    lk4, acc4, wall4, tree4 = round_on(True)
    lk1, acc1, _, _ = round_on(False)
    reps.append(({"phase": f"S3 streamed SPR round {taxa}x{sites} (mesh)",
                  "execution_path": "streamed", "compile_s": None,
                  "wall_s": round(wall4, 2), "values": (lk4,),
                  "one_card": (lk1,), "accepted": [acc4, acc1],
                  "path_ok": acc4 == acc1 and acc4 > 0},
                 lambda: (fp64_tree_logl(tree4, sdata),)))
    return reps


def fp64_tree_logl(tree, data):
    import jax.numpy as jnp
    from libpll2_jax import TreeEngine
    part = make_partition((tree,) + tuple(data[1:]), 4, jnp.float64)
    return TreeEngine(part, tree, pallas=False,
                      level_schedule=False).loglikelihood()


# --- driver -------------------------------------------------------------------

def run_phases(chips):
    """[(report, reference thunk)] — device phases in order; a phase that
    raises is reported as failed and the rest still run."""
    if chips == 4:
        specs = [("S sharded", sharded_phase)]
    else:
        specs = [
            ("1 DNA GTR+G4", lambda: engine_phase(
                "1 DNA GTR+G4 %dx%d" % SIZES["dna"], 4, *SIZES["dna"],
                time_levels=True)),
            ("2 LG+G4", lambda: engine_phase(
                "2 LG+G4 %dx%d" % SIZES["aa"], 20, *SIZES["aa"],
                time_levels=True)),
            ("3 repeats", lambda: engine_phase(
                "3 repeats %dx%d" % SIZES["repeats"], 4,
                *SIZES["repeats"], conserved=True, repeats=True)),
            ("3b placement", placement_phase),
            ("5 flagship", flagship_phase),
            ("4 parity gate", gate_phase),
        ]
    out = []
    for name, fn in specs:
        t0 = time.perf_counter()
        try:
            res = fn()
            out.extend(res if isinstance(res, list) else [res])
        except Exception:
            traceback.print_exc()
            out.append(({"phase": name, "error": "raised",
                         "path_ok": False}, None))
        log(f"[{name}] device part done in "
            f"{time.perf_counter() - t0:.1f} s")
    return out


def check(rep, ref):
    """Fill rep["checks"] from the fp64 reference; True when all pass."""
    checks = list(rep.get("checks", []))
    if ref is not None and "cases" in rep:
        for row in ref:
            checks.append((f"gate {row['case']}/{row['mode']}",
                           max(row["rel_err"] / row.get("tol_logl",
                                                        TOL_LOGL),
                               row["d1_err"] / TOL_D,
                               row["d2_err"] / TOL_D), 1.0))
    elif ref is not None:
        names = rep.get("value_names", ("logL", "d1", "d2"))

        def err_tol(name, x, r):
            if name.startswith("logL"):
                return rel_err(x, r), TOL_LOGL
            return d_err(x, r), TOL_D
        for name, x, r in zip(names, rep["values"], ref):
            checks.append((f"{name} vs fp64",) + err_tol(name, x, r))
        for name, x, r in zip(names, rep.get("one_card", ()),
                              rep["values"]):
            checks.append((f"{name} 4 cards vs 1 card",)
                          + err_tol(name, x, r))
    rep["checks"] = [(n, float(e), t) for n, e, t in checks]
    ok = rep.get("path_ok", False) and "error" not in rep and all(
        e <= t for _, e, t in checks)
    if ref is None and "values" in rep:
        ok = False                      # a compared phase lost its reference
    rep["ok"] = bool(ok)
    return rep["ok"]


def report(phases):
    """Compute every fp64 reference on the CPU backend (x64 from here
    on), check each phase and print its lines; True when all pass."""
    import jax
    jax.config.update("jax_enable_x64", True)
    all_ok = True
    with jax.default_device(jax.devices("cpu")[0]):
        for rep, thunk in phases:
            ref = None
            if thunk is not None:
                try:
                    ref = thunk()
                except Exception:
                    traceback.print_exc()
                    rep["error"] = "reference raised"
            ok = check(rep, ref)
            all_ok &= ok
            worst = max((e / t for _, e, t in rep["checks"]), default=0.0)
            log(f"PHASE {rep['phase']}: {'PASS' if ok else 'FAIL'} "
                f"path={rep.get('execution_path')} "
                f"compile_s={rep.get('compile_s')} worst err/tol="
                f"{worst:.3g}")
            detail = {k: v for k, v in rep.items()
                      if k not in ("phase", "checks")}
            log("  " + json.dumps(detail, default=str))
            for n, e, t in rep["checks"]:
                if "gate" not in n or e > t:
                    log(f"  {n}: err {e:.3e} (tol {t:g})"
                        f" {'ok' if e <= t else 'FAIL'}")
    return all_ok


def main(argv):
    chips = 1
    if "--chips" in argv:
        chips = int(argv[argv.index("--chips") + 1])
        if chips not in (1, 4):
            print("--chips takes 1 or 4", file=sys.stderr)
            return 2
    # the fp64 references run on the CPU backend of this process
    plats = os.environ.get("JAX_PLATFORMS")
    if plats and "cpu" not in plats.split(","):
        os.environ["JAX_PLATFORMS"] = plats + ",cpu"
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu" or len(devs) < chips:
        print(f"no GPU for this run (found {len(devs)} "
              f"{devs[0].platform} device(s)); nothing measured",
              file=sys.stderr)
        return 2
    from libpll2_jax.utils.compile_cache import enable_compile_cache
    from libpll2_jax.utils.hardware import card_info
    enable_compile_cache()
    card = card_info()
    log(card)
    log(f"jax {jax.__version__}: {len(devs)} x {devs[0].device_kind}")

    all_ok = report(run_phases(chips))
    if not all_ok:
        print("chip smoke FAILED", file=sys.stderr)
        return 1
    log(card)                 # nvidia-smi's name, power.limit per card
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
