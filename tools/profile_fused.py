"""Split the flagship eval's device time: Pallas kernel vs XLA epilogue.

Times (a) k chained fused_traversal kernel calls alone and (b) the full
production eval loop (pmatrix + kernel + edge logL), both via the
two-trip-count differencing method bench.py uses, and reports the gap as
the epilogue cost. This methodology found the two epilogue pathologies
fixed in round 2 (the whole-buffer scatter per loop iteration and the
serialized +I gather), so it stays as a diagnostic: run it
whenever eval time and kernel-only time diverge.

Usage: python tools/profile_fused.py   (flagship config; BENCH_* env
overrides apply). Diagnostics only — not part of the test suite.
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp

from libpll2_jax.utils.compile_cache import enable_compile_cache

enable_compile_cache()

import bench
from libpll2_jax import TreeEngine
from libpll2_jax.ops import pallas_fused as ops_fused

part, tree, _ = bench.build_problem()
eng = TreeEngine(part, tree)
print(f"device: {jax.devices()[0].platform}, "
      f"path={eng.execution_path}, slots={eng.fused_slots}",
      file=sys.stderr)
assert eng.use_fused

lk = eng.loglikelihood()
print(f"logL={lk:.4f}", file=sys.stderr)

table, codes, _ = eng.ops
pm = jnp.asarray(part.pmatrix, jnp.float32)
R, S = part.rate_cats, part.states
thr, fac = part.scale_threshold, part.scale_factor
nslots = eng.fused_slots


@jax.jit
def kernel_loop(k, codes, pm, table):
    """k chained kernel-only traversals (dep-threaded against hoisting)."""
    def body(_, carry):
        acc, tbl = carry
        dep = jnp.isnan(acc).astype(jnp.int32)
        cp, cc, sp, sc = ops_fused.fused_traversal(
            codes, pm, tbl + dep, rates=R, states=S, n_slots=nslots,
            threshold=thr, factor=fac)
        return acc + cp[0, 0, 0] + sp[0].astype(jnp.float32), tbl
    acc, _ = jax.lax.fori_loop(0, k, body,
                               (jnp.zeros((), jnp.float32), table))
    return acc


def timeit(fn, k, reps=7):
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(k))
        best = min(best, time.perf_counter() - t0)
    return best


k1, k2 = 5, 65
kernel_loop(1, codes, pm, table).block_until_ready()
kdt = (timeit(lambda k: kernel_loop(k, codes, pm, table), k2)
       - timeit(lambda k: kernel_loop(k, codes, pm, table), k1)) / (k2 - k1)

eng.loglikelihood_loop(1)
fdt = (timeit(eng.loglikelihood_loop, k2)
       - timeit(eng.loglikelihood_loop, k1)) / (k2 - k1)

n_su = tree.inner_count * part.sites
print(f"kernel-only : {kdt*1e3:.3f} ms/eval ({n_su/kdt/1e9:.2f} G su/s)")
print(f"full eval   : {fdt*1e3:.3f} ms/eval ({n_su/fdt/1e9:.2f} G su/s)")
print(f"epilogue    : {(fdt-kdt)*1e3:.3f} ms/eval "
      f"({100*(fdt-kdt)/max(fdt,1e-12):.0f}% of total)")
