"""Benchmark: CLV site-update throughput on one device vs reference C library.

Headline metric: CLV site-updates/sec on one device for a GTR+Gamma(4) DNA
full-tree traversal. One site-update = one Felsenstein pruning step for
one alignment site at one inner node (sites x inner-nodes per traversal).

vs_baseline: ratio against the reference libpll-2 compiled with full native
SIMD (-O3 -march=native, AVX2 kernels, OpenMP site loops) running the same
traversal on the host CPU — the reference's fastest configuration.

Prints ONE JSON line on stdout (with the device and, on a GPU, the card's
name and power limit); all diagnostics go to stderr. Everything runs in
this one process, so only one process ever holds the card.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

N_TAXA = int(os.environ.get("BENCH_TAXA", "128"))
N_SITES = int(os.environ.get("BENCH_SITES", "16384"))
RATE_CATS = 4
REPS = int(os.environ.get("BENCH_REPS", "10"))
SEED = 7

REPO = Path(__file__).resolve().parent
CACHE = REPO / ".refbuild" / "bench_baseline.json"


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def build_problem(dtype=None):
    import numpy as np
    from libpll2_jax import Partition, TreeEngine, compute_gamma_cats
    from libpll2_jax.io import maps
    from libpll2_jax.trees import random_alignment, random_utree

    headers, seqs = random_alignment(N_TAXA, N_SITES, seed=SEED)
    tree = random_utree(headers, seed=SEED)
    part = Partition(tree.tip_count, tree.inner_count, 4, N_SITES, 1,
                     tree.edge_count, RATE_CATS, tree.inner_count,
                     dtype=dtype)
    by_label = dict(zip(headers, seqs))
    for tip in tree.tips():
        part.set_tip_states(tip.clv_index, maps.map_nt, by_label[tip.label])
    rng = np.random.default_rng(SEED)
    freqs = rng.dirichlet(np.ones(4) * 10)
    subst = rng.uniform(0.5, 2.0, size=6)
    rates = compute_gamma_cats(0.8, RATE_CATS)
    part.set_frequencies(0, freqs)
    part.set_subst_params(0, subst)
    part.set_category_rates(rates)
    return part, tree, (headers, seqs, freqs, subst, rates)


def bench_device():
    """Fused traversal logL throughput on the default JAX device."""
    import jax
    from libpll2_jax.utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    part, tree, _ = build_problem()
    from libpll2_jax import TreeEngine
    eng = TreeEngine(part, tree)
    dev = jax.devices()[0]
    log(f"device: {dev.platform} ({dev.device_kind}), dtype={part.dtype}")

    lk = eng.loglikelihood()            # standard path, for the record
    log(f"logL = {lk:.4f} (path={eng.execution_path})")

    # Device-side throughput: run K chained traversals in ONE dispatch and
    # difference two trip counts, cancelling the per-dispatch host cost.
    k1, k2 = 5, 65
    eng.loglikelihood_loop(1)           # compile the loop program

    def run(k):
        best = float("inf")
        for _ in range(REPS):
            t0 = time.perf_counter()
            eng.loglikelihood_loop(k)
            best = min(best, time.perf_counter() - t0)
        return best

    dt = max((run(k2) - run(k1)) / (k2 - k1), 1e-9)
    n_ops = tree.inner_count
    site_updates = n_ops * N_SITES
    log(f"traversal: {dt*1e3:.4f} ms device-side "
        f"({site_updates/dt/1e6:.1f} M site-updates/s, "
        f"{1.0/dt:.1f} full-tree logL evals/s)")
    return site_updates / dt, dev, eng.execution_path


def bench_reference():
    """Same traversal through the reference C library at full native speed."""
    sys.path.insert(0, str(REPO / "tests"))
    import oracle
    import numpy as np
    from libpll2_jax.trees import (create_operations, random_alignment,
                                   random_utree, traverse)

    if not oracle.available():
        return None
    if CACHE.exists():
        cached = json.loads(CACHE.read_text())
        if cached.get("config") == [N_TAXA, N_SITES, RATE_CATS]:
            log(f"reference baseline (cached): "
                f"{cached['site_updates_per_sec']/1e6:.1f} M site-updates/s")
            return cached["site_updates_per_sec"]

    # build a native-optimized reference lib (separate from the test oracle)
    fast_lib = REPO / ".refbuild" / "libpll_ref_fast.so"
    if not fast_lib.exists():
        fast_lib.parent.mkdir(exist_ok=True)
        shim = fast_lib.parent / "wraptree_shim.c"
        shim.write_text(oracle._WRAPTREE_SHIM)
        src = sorted(str(p) for p in
                     (oracle.REFERENCE / "src").glob("*.c")) + [str(shim)]
        cmd = ["gcc", "-O3", "-march=native", "-fopenmp", "-D_GNU_SOURCE",
               "-DHAVE_X86INTRIN_H", "-DHAVE_SSE3", "-DHAVE_AVX",
               "-DHAVE_AVX2", "-fPIC", "-shared", "-o", str(fast_lib),
               *src, "-lm", "-Wl,--unresolved-symbols=ignore-all"]
        log("building native reference:", " ".join(cmd[:6]), "...")
        r = subprocess.run(cmd, capture_output=True, text=True)
        if r.returncode != 0:
            log("native reference build failed:", r.stderr[-2000:])
            return None
    oracle.LIB_PATH = fast_lib
    oracle._lib = None

    headers, seqs = random_alignment(N_TAXA, N_SITES, seed=SEED)
    tree = random_utree(headers, seed=SEED)
    rng = np.random.default_rng(SEED)
    freqs = rng.dirichlet(np.ones(4) * 10)
    subst = rng.uniform(0.5, 2.0, size=6)
    import oracle as orc
    from libpll2_jax import compute_gamma_cats
    ref = orc.OraclePartition(tree.tip_count, tree.inner_count, 4, N_SITES,
                              1, tree.edge_count, RATE_CATS,
                              tree.inner_count)
    by_label = dict(zip(headers, seqs))
    for tip in tree.tips():
        ref.set_tip_states(tip.clv_index, "nt", by_label[tip.label])
    ref.set_frequencies(0, freqs)
    ref.set_subst_params(0, subst)
    ref.set_category_rates(compute_gamma_cats(0.8, RATE_CATS))

    trav = traverse(tree.vroot)
    ops, branches, pmat_idx = create_operations(trav)
    op_tuples = [(o.parent_clv_index, o.parent_scaler_index,
                  o.child1_clv_index, o.child1_matrix_index,
                  o.child1_scaler_index, o.child2_clv_index,
                  o.child2_matrix_index, o.child2_scaler_index)
                 for o in ops]
    pidx = [0] * RATE_CATS
    root = tree.vroot

    def once():
        ref.update_prob_matrices(pidx, pmat_idx, branches)
        ref.update_partials(op_tuples)
        return ref.edge_loglikelihood(root.clv_index, root.scaler_index,
                                      root.back.clv_index,
                                      root.back.scaler_index,
                                      root.pmatrix_index, pidx)

    lk = once()    # warm
    log(f"reference logL = {lk:.4f}")
    times = []
    for _ in range(max(3, REPS // 2)):
        t0 = time.perf_counter()
        once()
        times.append(time.perf_counter() - t0)
    dt = min(times)
    rate = tree.inner_count * N_SITES / dt
    log(f"reference traversal: {dt*1e3:.2f} ms "
        f"({rate/1e6:.1f} M site-updates/s)")
    ref.destroy()
    # only cache plausible measurements: a concurrently loaded CPU can
    # crush the reference 10x+ (observed 3.1 M vs the usual ~35 M), and a
    # cached bad baseline silently INFLATES every later vs_baseline ratio
    if rate >= 10e6:
        CACHE.write_text(json.dumps({"config": [N_TAXA, N_SITES,
                                                RATE_CATS],
                                     "site_updates_per_sec": rate}))
    else:
        log("reference rate implausibly low (loaded machine?) — "
            "not caching this baseline")
    return rate


def run_validation():
    """Numerical parity gate (bench_validate.py) in THIS process, after
    the timing: fp32 on the device, fp64 references on the CPU backend.
    Returns 'passed/cases' or None. Every benchmark line doubles as a
    correctness certificate."""
    if os.environ.get("BENCH_VALIDATE", "1") != "1":
        return None
    try:
        import bench_validate
        summary = bench_validate.run_gate()
        return f"{summary['passed']}/{summary['cases']}"
    except Exception as e:
        log("validation gate failed to run:", repr(e))
        return "error"


def main():
    # the gate's fp64 references need the CPU backend beside the device
    plats = os.environ.get("JAX_PLATFORMS")
    if plats and "cpu" not in plats.split(","):
        os.environ["JAX_PLATFORMS"] = plats + ",cpu"
    rate, dev, path = bench_device()
    from libpll2_jax.utils.hardware import card_info
    card = card_info()
    if card:
        log(f"card: {card}")
    try:
        ref_rate = bench_reference()
    except Exception as e:       # baseline failure must not kill the bench
        log("reference baseline failed:", repr(e))
        ref_rate = None
    validated = run_validation()
    vs = (rate / ref_rate) if ref_rate else None
    print(json.dumps({
        "metric": "clv_site_updates_per_sec",
        "value": round(rate, 1),
        "unit": "site-updates/s",
        "device": {"platform": dev.platform, "kind": dev.device_kind},
        "card": card or None,
        "execution_path": path,
        "vs_baseline": round(vs, 3) if vs else None,
        "validated": validated,
    }), flush=True)


if __name__ == "__main__":
    main()
