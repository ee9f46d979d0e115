"""Benchmark suite over the library's stages; writes BENCHMARKS.md (a
generated report, not a record: speed records live in the ledger).

    python tools/benchmarks.py [--quick]

Device-side timings use k-chained evaluations inside one dispatch (see
bench.py) to cancel the per-dispatch host cost. Every row is a
measurement of the device named in the report's header.
"""
from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, ".")
HERE = os.path.dirname(os.path.abspath(__file__))

import jax
import jax.numpy as jnp
import numpy as np

from libpll2_jax import Partition, TreeEngine, compute_gamma_cats
from libpll2_jax.io import maps
from libpll2_jax.models import load_aa_model
from libpll2_jax.parsimony import FastParsimony
from libpll2_jax.parsimony.stepwise import fastparsimony_stepwise
from libpll2_jax.trees import random_utree
from libpll2_jax.utils import simulate_alignment

QUICK = "--quick" in sys.argv
RESULTS = []


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def build(n_taxa, sites, states=4, rate_cats=4, seed=7, model=None,
          repeats=False, conserved=False, **kw):
    tree = random_utree([f"t{i}" for i in range(n_taxa)], seed=seed)
    freqs = np.full(states, 1.0 / states)
    subst = np.ones(states * (states - 1) // 2)
    if states == 4:
        subst = np.array([1, 2, 1, 1, 2, 1.0])
    headers, seqs = simulate_alignment(tree, sites, freqs, subst,
                                       alpha=0.9, seed=seed)
    if conserved:
        # duplicate columns so the repeats tables genuinely compress
        rng0 = np.random.default_rng(seed + 100)
        src = rng0.integers(0, max(sites // 4, 1), size=sites)
        seqs = ["".join(s[j] for j in src) for s in seqs]
    part = Partition(tree.tip_count, tree.inner_count, states, sites, 1,
                     tree.edge_count, rate_cats, tree.inner_count,
                     site_repeats=repeats, **kw)
    by = dict(zip(headers, seqs))
    cm = maps.map_nt if states == 4 else maps.map_aa
    tips = list(tree.tips())
    part.set_tip_states_batch(cm, [by[t.label] for t in tips],
                              tip_indices=[t.clv_index for t in tips])
    if model:
        load_aa_model(part, model)
    else:
        part.set_frequencies(0, freqs)
        part.set_subst_params(0, subst)
    part.set_category_rates(compute_gamma_cats(0.9, rate_cats))
    return part, tree, headers, seqs


def chained_time(run_loop, reps=5, target=0.4, k_max=200_000):
    """Per-iteration device time via two chained trip counts.

    `run_loop(k)` must execute k chained device-side iterations in ONE
    dispatch and block until done (trip counts are traced, so any k
    reuses one compilation). The per-dispatch host cost jitters, so the
    trip counts are picked adaptively such that
    the k2-k1 difference spans ~`target` seconds of device time — far
    above the noise floor — then each count takes a min over `reps` and
    the difference is re-measured until it comes out positive."""
    run_loop(1)                                    # compile
    t0 = time.perf_counter()
    run_loop(1)
    base = time.perf_counter() - t0                # ~dispatch latency
    k_est = 64
    t0 = time.perf_counter()
    run_loop(k_est)
    dt_est = max((time.perf_counter() - t0 - base) / k_est, 1e-7)
    # k_max bounds the LARGER trip count (k2): the cap exists to keep the
    # total launch count per dispatch sane on multi-launch paths
    k1 = min(max(4, int(target / (4 * dt_est))), max(4, k_max // 5))
    k2 = 5 * k1

    def run(k):
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            run_loop(k)
            best = min(best, time.perf_counter() - t0)
        return best

    for _ in range(4):
        dt = (run(k2) - run(k1)) / (k2 - k1)
        if dt > 0:
            return dt
        log("  (negative timing difference — dispatch noise; retrying)")
    return max(dt, 1e-9)


def device_time(eng, **kw):
    return chained_time(eng.loglikelihood_loop, **kw)


def record(name, value, unit, note=""):
    RESULTS.append(dict(name=name, value=value, unit=unit, note=note))
    log(f"  {name}: {value:.4g} {unit}  {note}")


def bench_unrooted():
    log("[1] unrooted DNA GTR+G4 (64 taxa x 4096 sites)")
    part, tree, *_ = build(64, 4096)
    eng = TreeEngine(part, tree)
    dt = device_time(eng)
    su = tree.inner_count * 4096
    record("dna_logl_evals_per_sec", 1 / dt, "evals/s",
           f"pallas={eng.use_pallas}")
    record("dna_site_updates_per_sec", su / dt, "site-updates/s")


def bench_newton():
    log("[2] Newton branch optimization (32 taxa x 2048 sites)")
    part, tree, *_ = build(32, 2048, seed=9)
    eng = TreeEngine(part, tree)
    dt = chained_time(eng.newton_loop)
    record("newton_steps_per_sec", 1 / dt, "steps/s",
           "full eval + sumtable + d1/d2 + update, device-side")


def bench_protein():
    log("[3] 20-state LG (64 x 2048 and 128 x 8192 sites)")
    for taxa, sites in ((64, 2048), (128, 8192)):
        part, tree, *_ = build(taxa, sites, states=20, model="lg", seed=11)
        eng = TreeEngine(part, tree)
        dt = device_time(eng)
        record(f"aa_{taxa}x{sites}_site_updates_per_sec",
               tree.inner_count * sites / dt, "site-updates/s",
               f"{dt*1e3:.3f} ms/traversal; path {eng.execution_path}")


def bench_path_matrix():
    """Every execution path x scaler mode at one size: eligibility decides
    the path, so the matrix prices each configuration. Also records the
    first-call time (trace + compile + run) per path. The fused kernel is
    compiled on a GPU and interpreted on the CPU."""
    log("[1b] execution-path matrix (48 taxa x 2048 sites, GTR+G4)")
    su = 46 * 2048
    kernel = True if jax.default_backend() == "gpu" else "interpret"
    combos = [("fused", dict(pallas=kernel), False),
              ("fused", dict(pallas=kernel), True),
              ("levels", dict(pallas=False), False),
              ("levels", dict(pallas=False), True),
              ("scan", dict(pallas=False, level_schedule=False), False)]
    for want, kw, rsc in combos:
        tag = "rate" if rsc else "site"
        try:
            part, tree, *_ = build(48, 2048, seed=21, rate_scalers=rsc)
            t0 = time.perf_counter()
            eng = TreeEngine(part, tree, **kw)
            eng.loglikelihood_loop(1)
            compile_s = time.perf_counter() - t0
            path = eng.execution_path
            if path != want:
                log(f"  (requested {want} resolved to {path})")
            # the XLA paths launch many programs per eval: cap the
            # chained trip count
            dt = device_time(eng,
                             k_max=200_000 if path == "fused" else 2000)
        except Exception as e:                       # noqa: BLE001
            log(f"  (path {want}/{tag} failed: {type(e).__name__}: {e})")
            continue
        record(f"path_{path}_{tag}_scalers", su / dt, "site-updates/s",
               f"{dt*1e3:.3f} ms/eval; first-call {compile_s:.1f} s")


def bench_repeats():
    """Site repeats vs plain at the reference's flagship repeats size
    (246 taxa x 4465 sites, test/testdata/246x4465.fas scale); the
    alignment is simulated at low divergence (conserved real-data regime
    where the reference reports 1.2-1.5x + -30% memory, README.md:12-14).
    """
    n_taxa, sites = (64, 1024) if QUICK else (246, 4465)
    log(f"[4] site repeats vs plain ({n_taxa} taxa x {sites} sites)")
    from libpll2_jax.ops import partials as ops_partials
    from libpll2_jax.partition import pack_operations
    from libpll2_jax.trees import create_operations, traverse

    def make(repeats):
        tree = random_utree([f"t{i}" for i in range(n_taxa)], seed=13)
        # conserved data: short branches -> strong subtree repetition
        seen = set()
        for nd in tree.nodes():
            for h in ([nd] if nd.is_tip() else list(nd.ring())):
                if h.back is not None and id(h) not in seen:
                    seen.add(id(h)), seen.add(id(h.back))
                    h.length = h.back.length = h.length * 0.15 + 0.001
        subst = np.array([1, 2, 1, 1, 2, 1.0])
        headers, seqs = simulate_alignment(tree, sites, [0.25] * 4, subst,
                                           alpha=0.7, seed=13)
        part = Partition(tree.tip_count, tree.inner_count, 4, sites, 1,
                         tree.edge_count, 4, tree.inner_count,
                         site_repeats=repeats)
        by = dict(zip(headers, seqs))
        for t in tree.tips():
            part.set_tip_states(t.clv_index, maps.map_nt, by[t.label])
        part.set_frequencies(0, [0.25] * 4)
        part.set_subst_params(0, subst)
        part.set_category_rates(compute_gamma_cats(0.7, 4))
        return part, tree

    def run_mode(repeats):
        part, tree = make(repeats)
        trav = traverse(tree.vroot)
        ops, branches, pmat_idx = create_operations(trav)
        part.update_prob_matrices([0] * 4, pmat_idx, branches)
        part.update_partials(ops)        # builds schedule / warms
        pmat = part.pmatrix
        thr, fac = part.scale_threshold, part.scale_factor
        # pmat and the schedule flow in as jit arguments (a closed-over
        # device array would become a constant of the program)
        if repeats:
            sched = part._repeat_schedule
            profs = part._repeat_profiles
            body = lambda c, pm, sc_: \
                ops_partials.update_partials_repeats_pool(
                    c[0], c[1], pm, sc_, thr, fac, profiles=profs)
            clv0, sc0 = part.clv_flat, part.sc_flat
        else:
            sched = pack_operations(ops, scratch_clv=part.nodes)
            body = lambda c, pm, sc_: ops_partials.update_partials(
                c[0], c[1], pm, sc_, thr, fac)
            clv0, sc0 = part.clv, part.scale_buffer

        @jax.jit
        def loop(k, clv, sc, pm, sc_):
            out = jax.lax.fori_loop(
                0, k, lambda i, c: body(c, pm, sc_), (clv, sc))
            # scalar summary: float() on it below is a device sync
            return jnp.sum(out[1])

        float(loop(1, clv0, sc0, pmat, sched))

        def run(k):
            best = float("inf")
            for _ in range(3):
                t0 = time.perf_counter()
                float(loop(k, clv0, sc0, pmat, sched))
                best = min(best, time.perf_counter() - t0)
            return best

        # wide trip-count spread: small k differences drown in dispatch
        # noise
        dt = max((run(60) - run(12)) / 48, 1e-9)
        work = None
        if repeats:
            work = sum(part.repeats.classes(o.parent_clv_index)
                       for o in ops) / (len(ops) * sites)
        return dt, work, part.clv_bytes()

    dt_plain, _, bytes_plain = run_mode(False)
    dt_rep, work, bytes_rep = run_mode(True)
    record("repeats_pool_speedup", dt_plain / dt_rep, "x",
           f"pooled XLA path vs dense XLA scan (class columns"
           f" = {100 * work:.0f}% of plain work; "
           f"plain {dt_plain*1e3:.2f} ms vs pool {dt_rep*1e3:.2f} ms)")
    record("repeats_memory_ratio", bytes_rep / bytes_plain, "x",
           f"CLV+scaler bytes {bytes_rep/2**20:.0f} MiB vs "
           f"{bytes_plain/2**20:.0f} MiB dense")

    # engine level: repeats partitions EVALUATE through the dense fused
    # kernel by default (compressed storage, dense math) — the memory win
    # should now come at ~zero eval-speed cost vs a dense partition
    part_d, tree_d = make(False)
    part_r, tree_r = make(True)
    ed = TreeEngine(part_d, tree_d)
    er = TreeEngine(part_r, tree_r)
    dt_d = device_time(ed)
    dt_r = device_time(er)
    record("repeats_engine_vs_dense", dt_d / dt_r, "x",
           f"repeats-storage engine {dt_r*1e3:.2f} ms vs dense engine "
           f"{dt_d*1e3:.2f} ms per eval (both on the fused kernel: "
           f"fused={er.repeats_dense_fused}/{ed.use_fused}); memory at "
           f"{bytes_rep / bytes_plain:.2f}x")


def _reference_stepwise_time(headers, seqs, sites, seed=42):
    """Time pll_fastparsimony_stepwise in the natively-compiled reference
    (reference: /root/reference/src/stepwise.c:391)."""
    import ctypes as ct
    from pathlib import Path
    sys.path.insert(0, "tests")
    import oracle
    if not oracle.available():
        return None, None
    fast_lib = Path(".refbuild/libpll_ref_fast.so")
    if fast_lib.exists():
        oracle.LIB_PATH = fast_lib
        oracle._lib = None
    lib = oracle.load()
    lib.pll_fastparsimony_stepwise.restype = ct.c_void_p
    lib.pll_fastparsimony_stepwise.argtypes = [
        ct.POINTER(ct.POINTER(oracle.PllParsimony)),
        ct.POINTER(ct.c_char_p), ct.POINTER(ct.c_uint), ct.c_uint,
        ct.c_uint]
    try:
        lib.pll_utree_destroy.argtypes = [ct.c_void_p, ct.c_void_p]
        destroy_tree = lib.pll_utree_destroy
    except AttributeError:
        destroy_tree = None        # fast lib built without graph teardown
    n = len(headers)
    part = oracle.OraclePartition(n, n - 2, 4, sites, 1, 2 * n - 3, 1,
                                  n - 2)
    for i, s in enumerate(seqs):
        part.set_tip_states(i, "nt", s)
    labels = (ct.c_char_p * n)(*[h.encode() for h in headers])
    best = float("inf")
    cost = ct.c_uint()
    for _ in range(2):
        pars = lib.pll_fastparsimony_init(part.ptr)
        plist = (ct.POINTER(oracle.PllParsimony) * 1)(pars)
        t0 = time.perf_counter()
        tree_ptr = lib.pll_fastparsimony_stepwise(plist, labels,
                                                  ct.byref(cost), 1, seed)
        best = min(best, time.perf_counter() - t0)
        if destroy_tree is not None:
            destroy_tree(tree_ptr, None)
        lib.pll_parsimony_destroy(pars)
    part.destroy()
    return best, cost.value


def bench_newton_sweep():
    log("[4b] all-branches Newton sweep (64 taxa x 2048 sites)")
    from libpll2_jax.optimize import newton_smooth_all
    from libpll2_jax.ops import branch_sweep
    from libpll2_jax.partition import pack_operations
    from libpll2_jax.trees import create_operations, traverse
    import jax.numpy as jnp

    part, tree, *_ = build(64, 2048, seed=17)
    eng = TreeEngine(part, tree, pallas=False)
    eng.loglikelihood()
    trav = traverse(tree.vroot)
    operations, branches, pmatrix_indices = create_operations(trav)
    steps, n_aux = branch_sweep.build_smoothing_schedule(
        tree, part.nodes, part.scale_buffers, part.prob_matrices)
    ops = pack_operations(operations, scratch_clv=part.nodes)
    blen = np.zeros(part.prob_matrices)
    blen[np.asarray(pmatrix_indices)] = np.asarray(branches)
    margs = eng._model_args()
    sargs = eng._site_args()

    def run(passes):
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            out = branch_sweep.newton_sweep(
                part.clv, part.scale_buffer, part.pmatrix,
                jnp.asarray(blen, part.dtype), *margs, ops,
                jnp.asarray(steps), *sargs,
                part.scale_threshold, part.scale_factor,
                passes=passes, iterations=8, n_aux=n_aux)
            float(out[1].ravel()[0])    # readback = true device sync
            best = min(best, time.perf_counter() - t0)
        return best

    run(1)                      # compile both trip counts
    run(5)
    dt = max((run(5) - run(1)) / 4, 1e-9)
    edges = tree.edge_count
    record("newton_sweep_edges_per_sec", edges / dt, "edges/s",
           f"{dt*1e3:.1f} ms per all-{edges}-edges pass (8 Newton "
           "iters/edge), one dispatch for the whole multi-pass sweep")


def bench_spr():
    log("[4c] batched steepest-ascent SPR round (24 taxa x 1024 sites)")
    from libpll2_jax.search import TreeSearch
    from libpll2_jax.trees import moves
    import jax.numpy as jnp

    part, tree, *_ = build(24, 1024, seed=19,
                           dtype=jnp.float32)
    # perturb: random NNIs so SPR has something to find
    rng = np.random.default_rng(3)
    inner = [h for n in tree.nodes() if not n.is_tip() for h in n.ring()
             if h.back is not None and not h.back.is_tip()]
    for h in list(inner)[:4]:
        try:
            moves.nni(h, 1, None)
        except Exception:
            pass
    s = TreeSearch(part, tree)
    s.evaluate()                               # compile single eval
    t0 = time.perf_counter()
    lk, accepted = s.spr_round_batched()       # whole neighborhood/dispatch
    dt_first = time.perf_counter() - t0
    # later rounds: batched scorers compiled — the steady-state per-round
    # cost a search loop actually pays (best of 3; jit tracing of the
    # shapes an accepted move touches can straggle into round 2)
    best = None
    for _ in range(3):
        t0 = time.perf_counter()
        lk2, accepted2 = s.spr_round_batched()
        dt_i = time.perf_counter() - t0
        if best is None or dt_i < best[0]:
            best = (dt_i, accepted2, lk2)
    dt, accepted2, lk2 = best
    record("spr_round_seconds", dt, "s",
           f"steepest-ascent round (warm, best of 3), {accepted2} moves "
           f"accepted, logL {lk2:.1f}; first round incl. batch compiles "
           f"{dt_first:.1f} s ({accepted} moves, logL {lk:.1f})")


def bench_spr_1000():
    """Search at production scale: radius-limited SPR
    over a 1000-taxon tree, one compiled program bucket reused across
    rounds (no-recompile invariant pinned by
    tests/test_search.py::test_search_no_recompile_across_rounds)."""
    if QUICK:
        return
    log("[4e] 1000-taxon radius-SPR round (1000 taxa x 1024 sites)")
    import jax.numpy as jnp

    from libpll2_jax.search import TreeSearch, _internal_edges
    from libpll2_jax.trees import moves

    part, tree, *_ = build(1000, 1024, seed=29, dtype=jnp.float32)
    rng = np.random.default_rng(4)
    edges = _internal_edges(tree)
    for i in rng.permutation(len(edges))[:12]:
        try:
            moves.nni(edges[i], 1, None)
        except Exception:
            pass
    s = TreeSearch(part, tree)
    s.evaluate()
    # host/device split: everything inside evaluate_packed* (stack, pad,
    # transfer, dispatch, block) counts as the DEVICE stage; the rest of
    # the round (enumeration + native candidate construction + move
    # bookkeeping) is host
    eng = s._engine
    dev = [0.0]

    def _timed(orig):
        def run(*a, **k):
            t0 = time.perf_counter()
            out = orig(*a, **k)
            dev[0] += time.perf_counter() - t0
            return out
        return run

    eng.evaluate_packed_arrays = _timed(eng.evaluate_packed_arrays)
    eng.evaluate_packed = _timed(eng.evaluate_packed)
    t0 = time.perf_counter()
    lk1, acc1 = s.spr_round_batched(radius=5, max_candidates=2, seed=1)
    dt_first = time.perf_counter() - t0
    dev[0] = 0.0
    t0 = time.perf_counter()
    lk2, acc2 = s.spr_round_batched(radius=5, max_candidates=2, seed=2)
    dt = time.perf_counter() - t0
    host = dt - dev[0]
    record("spr_round_1000_seconds", dt, "s",
           f"radius-5 round, ~2000 candidates x 998-op traversals via "
           f"the native C++ candidate builder; host {host:.2f} s "
           f"({host / dt:.0%}) / device+transfer {dev[0]:.2f} s "
           f"({dev[0] / dt:.0%}); {acc2} moves, logL {lk2:.1f}; "
           f"first round (incl. compiles) {dt_first:.1f} s "
           f"({acc1} moves, logL {lk1:.1f})")
    record("spr_round_1000_host_share", host / dt, "fraction",
           "host share of the warm round (target < 0.30)")


def bench_search_1000_streamed():
    """Streamed (directional-CLV) candidate scoring at production scale:
    the reference consumers' partial-traversal rescoring pattern
    (test/src/partial-traversal.c) as one batched program — ~3
    op-equivalents per SPR candidate / ~5 per NNI instead of a full
    998-op traversal (libpll2_jax/ops/spr_stream.py)."""
    if QUICK:
        return
    log("[4f] 1000-taxon STREAMED rounds (directional-CLV scoring)")
    import jax.numpy as jnp

    from libpll2_jax.ops import spr_stream
    from libpll2_jax.search import TreeSearch, _internal_edges
    from libpll2_jax.trees import moves

    part, tree, *_ = build(1000, 1024, seed=29, dtype=jnp.float32)
    rng = np.random.default_rng(4)
    edges = _internal_edges(tree)
    for i in rng.permutation(len(edges))[:12]:
        try:
            moves.nni(edges[i], 1, None)
        except Exception:
            pass
    s = TreeSearch(part, tree)
    s.evaluate()
    dev = [0.0]
    orig_spr, orig_nni = (spr_stream.spr_stream_scores,
                          spr_stream.nni_stream_scores)

    def _timed(orig):
        def run(*a, **k):
            t0 = time.perf_counter()
            out = jax.block_until_ready(orig(*a, **k))
            dev[0] += time.perf_counter() - t0
            return out
        return run

    spr_stream.spr_stream_scores = _timed(orig_spr)
    spr_stream.nni_stream_scores = _timed(orig_nni)
    try:
        # same candidate subsets as spr_round_1000 (identical rng walk)
        t0 = time.perf_counter()
        lk1, acc1 = s.spr_round_streamed(radius=5, max_candidates=2,
                                         seed=1)
        dt_first = time.perf_counter() - t0
        dt, best_dev = float("inf"), 0.0
        for _ in range(3):              # warm best-of-3
            dev[0] = 0.0
            t0 = time.perf_counter()
            lk2, acc2 = s.spr_round_streamed(radius=5, max_candidates=2,
                                             seed=2)
            if time.perf_counter() - t0 < dt:
                dt, best_dev = time.perf_counter() - t0, dev[0]
        dev[0] = best_dev
        record("spr_round_1000_streamed_seconds", dt, "s",
               f"same radius-5/2-per-prune candidate set as "
               f"spr_round_1000_seconds, scored from directional CLVs (warm best-of-3); "
               f"device {dev[0]:.2f} s ({dev[0] / dt:.0%}, incl. the "
               f"chained round-start eval); {acc2} "
               f"moves, logL {lk2:.1f}; first round (incl. compiles) "
               f"{dt_first:.1f} s ({acc1} moves, logL {lk1:.1f})")

        # the FULL radius-5 neighborhood — unaffordable by traversal
        # scoring (~26000 candidates), routine for the streamed scorer
        n_full = sum(len(spr_stream.enumerate_targets(pr, 5))
                     for pr in _internal_edges(s.tree))
        t0 = time.perf_counter()
        lkf1, accf1 = s.spr_round_streamed(radius=5, seed=1)
        dtf_first = time.perf_counter() - t0
        dtf, best_dev = float("inf"), 0.0
        for _ in range(3):
            dev[0] = 0.0
            t0 = time.perf_counter()
            lkf2, accf2 = s.spr_round_streamed(radius=5, seed=2)
            if time.perf_counter() - t0 < dtf:
                dtf, best_dev = time.perf_counter() - t0, dev[0]
        dev[0] = best_dev
        record("spr_round_1000_full_neighborhood_seconds", dtf, "s",
               f"FULL radius-5 neighborhood (~{n_full} candidates) per "
               f"pass; device {dev[0]:.2f} s ({dev[0] / dtf:.0%}); "
               f"{accf2} moves, logL {lkf2:.1f}; first round "
               f"{dtf_first:.1f} s ({accf1} moves, logL {lkf1:.1f})")

        t0 = time.perf_counter()
        lkn1, accn1 = s.nni_round_streamed()
        dtn_first = time.perf_counter() - t0
        dtn, best_dev = float("inf"), 0.0
        for _ in range(3):
            dev[0] = 0.0
            t0 = time.perf_counter()
            lkn2, accn2 = s.nni_round_streamed()
            if time.perf_counter() - t0 < dtn:
                dtn, best_dev = time.perf_counter() - t0, dev[0]
        dev[0] = best_dev
        record("nni_round_1000_streamed_seconds", dtn, "s",
               f"all ~2000 NNI alternatives from directional CLVs "
               f"(no corrected pass); device {dev[0]:.2f} s "
               f"({dev[0] / dtn:.0%}); {accn2} moves, logL {lkn2:.1f}; "
               f"first round {dtn_first:.1f} s ({accn1} moves, "
               f"logL {lkn1:.1f})")

        # the RAxML-NG production combo: the SAME
        # streamed round on a SITE-REPEATS partition — pooled storage,
        # dense tip-row base assembled in-program. Conserved alignment
        # so the repeats tables genuinely compress.
        partr, treer, *_ = build(1000, 1024, seed=29, dtype=jnp.float32,
                                 repeats=True, conserved=True)
        rng = np.random.default_rng(4)
        edgesr = _internal_edges(treer)
        for i in rng.permutation(len(edgesr))[:12]:
            try:
                moves.nni(edgesr[i], 1, None)
            except Exception:
                pass
        sr = TreeSearch(partr, treer)
        sr._ensure_engine()
        assert sr._streamed_eligible()
        mem_ratio = partr.clv_bytes() / (
            (partr.nodes + 1) * partr.rate_cats * partr.states
            * partr.sites_padded * 4
            + (partr.scale_buffers + 2) * partr.sites_padded * 4)
        t0 = time.perf_counter()
        lkr1, accr1 = sr.spr_round_streamed(radius=5, seed=2)
        dtr_first = time.perf_counter() - t0
        dtr = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            lkr2, accr2 = sr.spr_round_streamed(radius=5, seed=3)
            dtr = min(dtr, time.perf_counter() - t0)
        record("spr_round_1000_repeats_streamed_seconds", dtr, "s",
               f"FULL radius-5 streamed round on a SITE-REPEATS "
               f"partition (pooled storage at {mem_ratio:.2f}x dense "
               f"bytes; dense tip-row base in-program); {accr2} moves, "
               f"logL {lkr2:.1f}; vs the dense-partition round above "
               f"(target <= 1.5x); first round {dtr_first:.1f} s "
               f"({accr1} moves)")
    finally:
        spr_stream.spr_stream_scores = orig_spr
        spr_stream.nni_stream_scores = orig_nni


def bench_df64():
    """Certified final evaluation (ops/df64.py): wall cost of the
    double-single path per evaluation — final-result money, not search
    money (the fp32 fused kernel stays the production path)."""
    log("[6] df64 certified final evaluation (96 taxa x 2048 sites)")
    from libpll2_jax import loglikelihood_df64
    part, tree, *_ = build(96, 2048, seed=31)
    eng = TreeEngine(part, tree)
    lk32 = eng.loglikelihood()
    t0 = time.perf_counter()
    lk = loglikelihood_df64(part, tree)
    dt_first = time.perf_counter() - t0
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        lk = loglikelihood_df64(part, tree)
        best = min(best, time.perf_counter() - t0)
    record("df64_eval_seconds", best, "s",
           f"double-single certified eval (logL {lk:.4f}; fp32 fused "
           f"gives {lk32:.4f}); END-TO-END wall per call — a one-shot "
           "certification is a single dispatch by nature, so unlike "
           "the k-chained rows this includes the dispatch and the host "
           f"pmatrix split; first call incl. compile "
           f"{dt_first:.1f} s; gate case dna_df64 holds 1e-8 vs the "
           "CPU fp64 reference")


def bench_flagship():
    """At-scale end-to-end flagship rows, read from FLAGSHIP.json —
    regenerate with `python examples/flagship_1000.py` (two full
    pipeline passes + the fp64 CPU cross-check)."""
    path = os.path.join(os.path.dirname(HERE), "FLAGSHIP.json")
    if not os.path.exists(path):
        log("[4g] flagship: FLAGSHIP.json missing — run "
            "examples/flagship_1000.py first")
        return
    f = json.load(open(path))
    cfg = f"{f['taxa']} taxa x {f['sites']} sites -> {f['patterns']} pat"

    def stagestr(stages):
        return "; ".join(f"{n.split(' (')[0]} {s:.1f}s"
                         for n, s in stages)

    record("flagship_1000_cold_seconds", f["cold_total_s"], "s",
           f"end-to-end pipeline ({cfg}), COLD first pass — compiles "
           "not in the persistent cache are paid here, so this varies "
           "with cache state: " + stagestr(f["cold_stages"]))
    sp = f["search_split"][0] if f.get("search_split") else None
    split = (f" [SPR split: device {sp['device']:.2f}s / "
             f"host {sp['host']:.2f}s]" if sp else "")
    record("flagship_1000_warm_seconds", f["warm_total_s"], "s",
           f"same pipeline, WARM (programs reused): "
           + stagestr(f["warm_stages"]) + split)
    cert = (f"; on-device df64 certified eval agrees to "
            f"{f['df64_rel_err']:.1e}" if "df64_rel_err" in f else "")
    record("flagship_1000_fp64_rel_err", f["fp64_rel_err"], "rel",
           f"final logL {f['logl']:.1f} (fp32 device) vs "
           f"{f['fp64_logl']:.1f} (fp64 CPU rebuild of the checkpoint)"
           + cert)


def bench_placement():
    if QUICK:
        return
    log("[4d] EPA-style placement (100-taxon reference, 1024 sites)")
    from libpll2_jax import EdgePlacer
    from libpll2_jax.trees import export_newick, parse_newick

    from libpll2_jax.trees import prune_tip
    full = random_utree([f"t{i}" for i in range(101)], seed=23)
    freqs = [0.3, 0.2, 0.2, 0.3]
    subst = np.array([1, 2, 1, 1, 2, 1.0])
    headers, seqs = simulate_alignment(full, 1024, freqs, subst,
                                       alpha=0.9, seed=23)
    by = dict(zip(headers, seqs))
    victim = "t100"
    ref_tree = parse_newick(export_newick(prune_tip(full, victim)))
    ref_by = {k: v for k, v in by.items() if k != victim}
    placer = EdgePlacer(ref_tree, ref_by)
    placer.set_model(freqs, subst, alpha=0.9)
    rows = placer.place(by[victim])          # compile single path
    n_edges = len(rows)
    rng2 = np.random.default_rng(1)
    Q = 32
    queries = {f"q{i}": "".join(rng2.choice(list("ACGT"), size=1024))
               for i in range(Q)}
    queries["q0"] = by[victim]
    placer.place_batch(queries, chunk=16)    # compile batch path
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        placer.place_batch(queries, chunk=16)
        best = min(best, time.perf_counter() - t0)
    record("placement_queries_per_sec", Q / best, "queries/s",
           f"batched: {Q} queries x {n_edges} edges "
           f"({Q * n_edges} placements) in {best:.2f} s; single-query "
           f"place() is dispatch-bound at ~9/s")

    # EPA-ng-scale streaming: precomputed per-edge attachment tensors,
    # one 16-element contraction + log per (query, edge, site)
    NQ = 1000
    chars = np.array(list("ACGT"))
    stream_q = {}
    for qi in range(NQ):
        src = np.array(list(seqs[int(rng2.integers(0, len(seqs)))]))
        mut = rng2.random(1024) < 0.05
        src[mut] = chars[rng2.integers(0, 4, mut.sum())]
        src[rng2.random(1024) < 0.2] = "-"
        stream_q[f"s{qi}"] = "".join(src)
    placer.prepare_stream()
    placer.place_stream({k: stream_q[k] for k in list(stream_q)[:256]})
    placer.place_stream(stream_q)          # compile the full-Q bucket
    from libpll2_jax.placement import to_jplace
    best = float("inf")
    for _ in range(4):
        t0 = time.perf_counter()
        res = placer.place_stream(stream_q)
        to_jplace(placer, res)             # the EPA deliverable
        best = min(best, time.perf_counter() - t0)
    record("placement_stream_queries_per_sec", NQ / best, "queries/s",
           f"streaming incl. jplace(top7) output: {NQ} queries x "
           f"{n_edges} edges ({NQ * n_edges} placements) in {best:.2f} s "
           "via precomputed attachment tensors (vectorized batch "
           "encode, lazy ranked rows, vectorized jplace blocks)")

    # device+transfer / host split for the streaming row: the timed
    # wrapper covers dispatch + device compute + the D2H pull of the
    # score grid; host is everything else (query encode, ranking, jplace
    # rows)
    import libpll2_jax.placement as _plm
    orig_scores = _plm._stream_scores

    best_t = (float("inf"), 0.0, 0.0)
    for _ in range(4):
        dev = [0.0]

        def timed_scores(*a, **k):
            t0 = time.perf_counter()
            out = np.asarray(jax.block_until_ready(
                orig_scores(*a, **k)))      # include the D2H pull
            dev[0] += time.perf_counter() - t0
            return out

        _plm._stream_scores = timed_scores
        try:
            t0 = time.perf_counter()
            res = placer.place_stream(stream_q)
            to_jplace(placer, res)
            dt_i = time.perf_counter() - t0
        finally:
            _plm._stream_scores = orig_scores
        if dt_i < best_t[0]:
            best_t = (dt_i, dev[0], dt_i - dev[0])
    dt_i, devs, host = best_t
    record("placement_stream_host_share", host / dt_i, "fraction",
           f"instrumented pipeline incl. jplace: host (encode + rank + "
           f"jplace rows) {host:.3f} s ({host / dt_i:.0%}) / "
           f"device+transfer {devs:.3f} s over {dt_i:.3f} s")


def bench_model_opt():
    """Fused-path model-parameter optimization:
    per-Adam-step wall clock vs a single fused eval dispatch. Each step
    batches 2n+1 central-difference trials (n = free params; GTR+freqs
    n = 9 -> 19 trials) into ONE program, `chunk` steps per dispatch."""
    from libpll2_jax.optimize import maximize_fused

    log("[4f] fused model optimization (64 taxa x 4096 sites, GTR+freqs)")
    import jax.numpy as jnp
    part, tree, *_ = build(64, 4096, dtype=jnp.float32)
    # start off-model so the optimizer does real work
    part.set_subst_params(0, [1.0, 1.1, 0.9, 1.05, 0.95, 1.0])
    part.set_frequencies(0, [0.26, 0.24, 0.25, 0.25])
    eng = TreeEngine(part, tree)
    lk0 = eng.loglikelihood()
    t0 = time.perf_counter()
    eng.loglikelihood()
    t_eval = time.perf_counter() - t0           # one dispatch-bound eval
    steps = 50
    maximize_fused(eng, ("subst", "freqs"), steps=2, chunk=2,
                   patience=10**6)              # compile
    t0 = time.perf_counter()
    lk, _, hist = maximize_fused(eng, ("subst", "freqs"), steps=steps,
                                 chunk=25, patience=10**6)
    dt = (time.perf_counter() - t0) / steps
    record("model_opt_steps_per_sec", 1 / dt, "steps/s",
           f"19 fused trials/step (batched central differences), "
           f"{dt / t_eval:.2f}x one eval dispatch ({t_eval * 1e3:.0f} ms)"
           f"; logL {lk0:.1f} -> {lk:.1f} in {steps} steps")
    record("model_opt_step_vs_eval", dt / t_eval, "ratio",
           "per-step wall vs single fused-eval dispatch (target <= 5)")


def bench_stepwise():
    sizes = [(48, 1024)] if QUICK else [(128, 1024), (1000, 1024)]
    for n, sites in sizes:
        log(f"[5] stepwise-addition starting tree ({n} taxa x {sites} "
            "sites)")
        part, tree, headers, seqs = build(n, sites, rate_cats=1, seed=15)
        fp = FastParsimony(part)
        fastparsimony_stepwise([fp], headers, seed=42)       # warm
        dt = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            stree, cost = fastparsimony_stepwise([fp], headers, seed=42)
            dt = min(dt, time.perf_counter() - t0)
        tag = "" if n == 128 or QUICK else f"_{n}"
        record(f"stepwise_seconds{tag}", dt, "s", f"{n} taxa, score {cost}")
        try:
            ref_dt, ref_cost = _reference_stepwise_time(headers, seqs,
                                                        sites)
        except Exception as e:
            log("reference stepwise failed:", repr(e))
            ref_dt = None
        if ref_dt is not None:
            record(f"stepwise_vs_reference{tag}", ref_dt / dt, "x",
                   f"reference {ref_dt*1e3:.1f} ms (score {ref_cost}) vs "
                   f"{dt*1e3:.1f} ms — native host stepwise engine, "
                   "identical tree per seed")


def main():
    dev = jax.devices()[0]
    log(f"device: {dev.platform} ({dev.device_kind})")
    bench_unrooted()
    bench_path_matrix()
    bench_newton()
    bench_protein()
    bench_repeats()
    bench_newton_sweep()
    bench_spr()
    bench_spr_1000()
    bench_search_1000_streamed()
    bench_placement()
    bench_df64()
    bench_flagship()
    bench_stepwise()
    bench_model_opt()

    lines = ["# BENCHMARKS — measured results",
             "",
             f"Device: {dev.platform} ({dev.device_kind}); "
             "device-side timings via k-chained in-dispatch loops "
             "(bench.py method). Regenerate: `python tools/benchmarks.py`.",
             "",
             "| Benchmark | Value | Unit | Notes |",
             "|---|---|---|---|"]
    for r in RESULTS:
        lines.append(f"| {r['name']} | {r['value']:.4g} | {r['unit']} "
                     f"| {r['note']} |")
    open("BENCHMARKS.md", "w").write("\n".join(lines) + "\n")
    print(json.dumps(RESULTS))


if __name__ == "__main__":
    main()
