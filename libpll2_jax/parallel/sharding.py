"""Site-axis distribution over a device mesh (one or more GPUs).

The reference library is single-process; its consumers (RAxML-NG/ExaML)
scale by giving each MPI rank a slice of alignment columns and reducing
per-rank logL/d1/d2 sums (design affordance visible in
reference: /root/reference/src/pll.c:1112 pattern weights and the per-site
outputs of /root/reference/src/likelihood.c:122). The JAX equivalent
replaces MPI with the JAX collective stack:

  * one `jax.sharding.Mesh` over the devices with a single `'sites'` axis;
  * CLVs/scalers/pattern-weights/invariant flags sharded on their site axis,
    P-matrices/eigensystems/topology replicated (tiny);
  * the only cross-device communication the math needs are three scalar
    reductions — logL sum, d1 sum, d2 sum (see
    reference: /root/reference/src/core_likelihood.c:200-207 and
    /root/reference/src/core_derivatives.c:844-848, plain weighted sums over
    sites) — which XLA lowers to an NCCL `psum` over NVLink when we
    annotate shardings and jit (GSPMD). No halo exchange: every site is
    independent given the shared P-matrices.

Because every kernel in ops/ treats the site axis elementwise until the
final reduction, sharding is purely an annotation exercise: `shard_partition`
re-places the big per-site arrays with NamedShardings and all jitted ops
run SPMD unchanged.
"""
from __future__ import annotations

from functools import partial
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

SITES_AXIS = "sites"


def make_mesh(n_devices: Optional[int] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """1-D mesh over the site axis (the library's data-parallel axis)."""
    if devices is None:
        devices = jax.devices()
        if n_devices is not None:
            devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (SITES_AXIS,))


def clv_sharding(mesh: Mesh) -> NamedSharding:
    """CLV layout is [node, rate, state, site] — shard the site lanes."""
    return NamedSharding(mesh, P(None, None, None, SITES_AXIS))


def scaler_sharding(mesh: Mesh, rate_scalers: bool) -> NamedSharding:
    spec = P(None, None, SITES_AXIS) if rate_scalers else P(None, SITES_AXIS)
    return NamedSharding(mesh, spec)


def site_vector_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P(SITES_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def is_multiprocess(mesh: Mesh) -> bool:
    """True when the mesh spans devices owned by other processes (a real
    multi-process GPU job, or the multi-process CPU test harness)."""
    me = jax.process_index()
    return any(d.process_index != me for d in mesh.devices.flat)


def owned_shards(mesh: Mesh) -> int:
    """How many of the mesh's site-axis shards THIS process feeds: all of
    them single-process, the addressable subset under multi-process."""
    me = jax.process_index()
    n = sum(1 for d in mesh.devices.flat if d.process_index == me)
    return n if n else mesh.devices.size


def put_global(x, mesh: Mesh, spec: P):
    """Place `x` on the mesh with `spec`, working in BOTH execution modes:

    single-process — plain `device_put` (x is the full global array);
    multi-process  — `jax.make_array_from_process_local_data`: x is this
      process's contiguous block for sharded specs (the site-axis column
      slice this rank owns, reference MPI mapping SURVEY §2.3) or the
      full (identical everywhere) array for replicated specs. Device
      order in the mesh is jax.devices() order — process 0's shards
      first — so rank r's block lands at global offset r * local_width.
    """
    sh = NamedSharding(mesh, spec)
    if is_multiprocess(mesh):
        return jax.make_array_from_process_local_data(sh, np.asarray(x))
    return jax.device_put(x, sh)


def shard_partition(partition, mesh: Mesh) -> None:
    """Re-place a Partition's site-major arrays across the mesh, in place.

    Requires `sites_padded % mesh.size == 0`; create the partition with
    `sites_alignment=mesh.size` (or a multiple) to guarantee it. P-matrices
    are replicated — they are [edges, rates, states, states], independent of
    sites, and every shard needs all of them.
    """
    n = owned_shards(mesh)
    if partition.repeats is not None:
        # class identity is a per-shard property (SURVEY §7: repeats are a
        # compute-saving dedup, local to each rank's site slice in the
        # reference's MPI consumers). The pooled class-column layout has
        # no site axis to shard; distribute by splitting the alignment
        # into per-device partitions (each with its own repeats tables)
        # and summing logL/d1/d2 — the PartitionedEngine pattern.
        raise ValueError(
            "site-repeats partitions cannot be sharded in place (the "
            "pooled class-column layout has no global site axis): build "
            "one per-device partition per column slice and run them as "
            "one SPMD program via ShardedRepeatsEngine")
    if partition.sites_padded % n:
        raise ValueError(
            f"sites_padded={partition.sites_padded} not divisible by the "
            f"{n} mesh shards this process owns; create the partition "
            f"with sites_alignment={n}")
    if is_multiprocess(mesh) and partition.asc_extra:
        raise ValueError("asc bias is not supported under multi-process "
                         "site sharding (synthetic columns would be "
                         "duplicated per rank)")
    partition.clv = put_global(partition.clv, mesh,
                               P(None, None, None, SITES_AXIS))
    partition.scale_buffer = put_global(
        partition.scale_buffer, mesh,
        P(None, None, SITES_AXIS) if partition.rate_scalers
        else P(None, SITES_AXIS))
    partition.pmatrix = put_global(partition.pmatrix, mesh, P())
    partition.mesh = mesh


@partial(jax.jit, static_argnames=('mesh', 'scale_threshold',
                                   'scale_factor', 'rate_scalers',
                                   'asc_type', 'n_real'))
def _sharded_repeats_loop(k, clv_flat, sc_flat, eigenvals, inv_eigenvecs,
                          eigenvecs, prop_invar, rates, rate_weights,
                          freqs, params_idx_rates, branches, buckets,
                          root_cols, mat, pattern_weights, invariant, *,
                          mesh, scale_threshold, scale_factor,
                          rate_scalers,
                          asc_type=0, n_real=-1):
    """k chained sharded repeats evaluations in one SPMD dispatch: every
    device runs the pooled bucket traversal on its local class tables,
    then the root-edge logL sums ride one psum over the 'sites' axis.

    asc corrections apply PER SHARD before the psum and sum to the
    global correction exactly: Lewis subtracts sum_w_local * log(1-base)
    where `base` (the synthetic columns' likelihood sum) is identical on
    every shard — local weight sums add to the global one — and the
    Felsenstein/Stamatakis terms are linear in the locally-set asc
    weights (reference core_likelihood.c:24-117 applied rank-wise)."""
    from jax import shard_map

    from ..engine import _repeats_loglikelihood

    def local(k, clv_flat, sc_flat, eigenvals, inv_eigenvecs, eigenvecs,
              prop_invar, rates, rate_weights, freqs, params_idx_rates,
              branches, buckets, root_cols, mat, pw, inv):
        def body(_, carry):
            acc, cf, sf = carry
            total, _per, cf, sf, _pm = _repeats_loglikelihood(
                cf, sf, eigenvals, inv_eigenvecs, eigenvecs, prop_invar,
                rates, rate_weights, freqs, params_idx_rates, branches,
                buckets, root_cols, mat, pw, inv,
                scale_threshold, scale_factor, rate_scalers=rate_scalers,
                asc_type=asc_type, n_real=n_real)
            return acc + total, cf, sf

        zero = jnp.zeros((), clv_flat.dtype)
        acc, cf, sf = jax.lax.fori_loop(0, k, body,
                                        (zero, clv_flat, sc_flat))
        return jax.lax.psum(acc, SITES_AXIS), cf, sf

    rep = P()
    sc_spec = P(None, SITES_AXIS) if rate_scalers else P(SITES_AXIS)
    bucket_specs = tuple((P(SITES_AXIS, None),) * 3 for _ in buckets)
    return shard_map(
        local, mesh=mesh,
        in_specs=(rep, P(None, None, SITES_AXIS), sc_spec, rep, rep, rep,
                  rep, rep, rep, rep, rep, rep, bucket_specs,
                  (P(SITES_AXIS),) * 4, rep, P(SITES_AXIS), P(SITES_AXIS)),
        out_specs=(P(), P(None, None, SITES_AXIS), sc_spec),
        check_vma=False,
    )(k, clv_flat, sc_flat, eigenvals, inv_eigenvecs, eigenvecs,
      prop_invar, rates, rate_weights, freqs, params_idx_rates, branches,
      buckets, root_cols, mat, pattern_weights, invariant)


@partial(jax.jit, static_argnames=('mesh', 'scale_threshold',
                                   'scale_factor', 'rate_scalers',
                                   'asc_type', 'n_real'))
def _sharded_repeats_newton_loop(k, clv_flat, sc_flat, eigenvals,
                                 inv_eigenvecs, eigenvecs, prop_invar,
                                 rates, rate_weights, freqs,
                                 params_idx_rates, branches, buckets,
                                 root_cols, mat, pattern_weights,
                                 invariant, *,
                                 mesh, scale_threshold, scale_factor,
                                 rate_scalers,
                                 asc_type=0, n_real=-1):
    """k chained Newton iterations on the root branch over SHARDED pooled
    repeats storage. Per iteration each device evaluates its local class
    pools, builds its sumtable slice and its d1/d2 partial sums (plain
    weighted site sums, reference core_derivatives.c:844-848), and THREE
    psums (logL, d1, d2) make the Newton update identical on every
    shard — branches stay replicated."""
    from jax import shard_map

    from .. import constants as C
    from ..engine import _repeats_loglikelihood
    from ..ops import derivatives as ops_derivatives

    def local(k, clv_flat, sc_flat, eigenvals, inv_eigenvecs, eigenvecs,
              prop_invar, rates, rate_weights, freqs, params_idx_rates,
              branches, buckets, root_cols, mat, pw, inv):
        p_cols, p_sc_cols, c_cols, c_sc_cols = root_cols

        def body(_, carry):
            cf, sf, branches, total, d1, d2 = carry
            total, _per, cf, sf, _pm = _repeats_loglikelihood(
                cf, sf, eigenvals, inv_eigenvecs, eigenvecs, prop_invar,
                rates, rate_weights, freqs, params_idx_rates, branches,
                buckets, root_cols, mat, pw, inv,
                scale_threshold, scale_factor, rate_scalers=rate_scalers,
                asc_type=asc_type, n_real=n_real)
            sumtable = ops_derivatives.update_sumtable(
                jnp.take(cf, p_cols, axis=2),
                jnp.take(cf, c_cols, axis=2),
                jnp.take(sf, p_sc_cols, axis=-1),
                jnp.take(sf, c_sc_cols, axis=-1),
                inv_eigenvecs, eigenvecs, freqs, params_idx_rates,
                scale_threshold, rate_scalers=rate_scalers,
                has_pscaler=True, has_cscaler=True)
            blen = jnp.take(branches, mat)
            asc_scalers = None
            if asc_type in (1, 2):
                asc_scalers = (jnp.take(sf, p_sc_cols, axis=-1)
                               + jnp.take(sf, c_sc_cols, axis=-1))
            d1, d2 = ops_derivatives.likelihood_derivatives(
                sumtable, eigenvals, prop_invar, freqs, rates,
                rate_weights, params_idx_rates, pw, inv, blen,
                asc_scalers=asc_scalers,
                scale_threshold=scale_threshold,
                asc_type=asc_type, n_real=n_real)
            total = jax.lax.psum(total, SITES_AXIS)
            d1 = jax.lax.psum(d1, SITES_AXIS)
            d2 = jax.lax.psum(d2, SITES_AXIS)
            new_len = ops_derivatives.newton_step(blen, d1, d2,
                                                  C.OPT_MIN_BRANCH_LEN,
                                                  C.OPT_MAX_BRANCH_LEN)
            branches = branches.at[mat].set(new_len)
            return cf, sf, branches, total, d1, d2

        zero = jnp.zeros((), clv_flat.dtype)
        cf, sf, branches, total, d1, d2 = jax.lax.fori_loop(
            0, k, body, (clv_flat, sc_flat, branches, zero, zero, zero))
        return total, d1, d2, branches, cf, sf

    rep = P()
    sc_spec = P(None, SITES_AXIS) if rate_scalers else P(SITES_AXIS)
    bucket_specs = tuple((P(SITES_AXIS, None),) * 3 for _ in buckets)
    return shard_map(
        local, mesh=mesh,
        in_specs=(rep, P(None, None, SITES_AXIS), sc_spec, rep, rep, rep,
                  rep, rep, rep, rep, rep, rep, bucket_specs,
                  (P(SITES_AXIS),) * 4, rep, P(SITES_AXIS), P(SITES_AXIS)),
        out_specs=(P(), P(), P(), P(), P(None, None, SITES_AXIS), sc_spec),
        check_vma=False,
    )(k, clv_flat, sc_flat, eigenvals, inv_eigenvecs, eigenvecs,
      prop_invar, rates, rate_weights, freqs, params_idx_rates, branches,
      buckets, root_cols, mat, pattern_weights, invariant)


@partial(jax.jit, static_argnames=('mesh', 'scale_threshold',
                                   'scale_factor', 'rate_scalers',
                                   'fused_slots', 'root_mat',
                                   'pallas_interpret', 'asc_type',
                                   'n_real', 'newton'))
def _sharded_fused_repeats_loop(k, codes, table, eigenvals, inv_eigenvecs,
                                eigenvecs, prop_invar, rates, rate_weights,
                                freqs, params_idx_rates, branches,
                                pattern_weights, invariant, *,
                                mesh, scale_threshold, scale_factor,
                                rate_scalers, fused_slots, root_mat,
                                pallas_interpret=False, asc_type=0,
                                n_real=-1, newton=False):
    """Dense-fused evaluation of SHARDED site-repeats partitions: the
    pooled class-column storage keeps the memory win, but each device
    EVALUATES its column slice through the single-pass fused kernel on
    dense tip codes (engine.py repeats_dense_fused, extended across the
    mesh). With `newton`, each
    iteration adds the root-edge sumtable + d1/d2 partial sums and THREE
    psums make the Newton branch update identical on every shard
    (reference: /root/reference/src/core_derivatives.c:844-848).
    Returns (total, d1, d2, branches): summed logL of k evals in eval
    mode, the LAST iteration's values in newton mode."""
    from jax import shard_map

    from .. import constants as C
    from ..ops import derivatives as ops_derivatives
    from ..ops import likelihood as ops_likelihood
    from ..ops import pallas_fused as ops_fused
    from ..ops import pmatrix as ops_pmatrix

    R = int(params_idx_rates.shape[0])
    s = int(eigenvals.shape[-1])

    def local(k, codes, table, ev, ievec, evec, pinv, rates, rw, freqs,
              pidx, branches, pw, inv):
        def body(_, carry):
            branches, acc, d1, d2 = carry
            # thread the previous total into the op table (always +0) so
            # eval-mode iterations carry a data dependency — otherwise the
            # body is loop-invariant and XLA hoists the traversal out of
            # the fori_loop (same guard as engine._fused_loglikelihood_loop)
            tbl = table + jnp.isnan(acc).astype(table.dtype)
            pmatrix = ops_pmatrix.update_prob_matrices(
                ev, ievec, evec, pinv, rates, pidx, branches)
            clv_p, clv_c, sc_p, sc_c = ops_fused.fused_traversal(
                codes, pmatrix, tbl, rates=R, states=s,
                n_slots=fused_slots, threshold=scale_threshold,
                factor=scale_factor, interpret=pallas_interpret,
                rate_scalers=rate_scalers)
            total, _ = ops_likelihood.edge_loglikelihood(
                clv_p, clv_c, sc_p, sc_c,
                jnp.take(pmatrix, root_mat, axis=0),
                freqs, pinv, rw, pidx, pw, inv, scale_threshold,
                rate_scalers=rate_scalers, has_pscaler=True,
                has_cscaler=True, asc_type=asc_type, n_real=n_real)
            total = jax.lax.psum(total, SITES_AXIS)
            if not newton:
                return branches, acc + total, d1, d2
            sumtable = ops_derivatives.update_sumtable(
                clv_p, clv_c, sc_p, sc_c, ievec, evec, freqs, pidx,
                scale_threshold, rate_scalers=rate_scalers,
                has_pscaler=True, has_cscaler=True)
            blen = jnp.take(branches, root_mat)
            asc_scalers = (sc_p + sc_c) if asc_type in (1, 2) else None
            d1, d2 = ops_derivatives.likelihood_derivatives(
                sumtable, ev, pinv, freqs, rates, rw, pidx, pw, inv,
                blen, asc_scalers=asc_scalers,
                scale_threshold=scale_threshold,
                asc_type=asc_type, n_real=n_real)
            d1 = jax.lax.psum(d1, SITES_AXIS)
            d2 = jax.lax.psum(d2, SITES_AXIS)
            new_len = ops_derivatives.newton_step(blen, d1, d2,
                                                  C.OPT_MIN_BRANCH_LEN,
                                                  C.OPT_MAX_BRANCH_LEN)
            branches = branches.at[root_mat].set(new_len)
            return branches, total, d1, d2

        zero = jnp.zeros((), branches.dtype)
        return jax.lax.fori_loop(0, k, body, (branches, zero, zero, zero))

    rep = P()
    branches_out, total, d1, d2 = shard_map(
        local, mesh=mesh,
        in_specs=(rep, P(None, SITES_AXIS), rep, rep, rep, rep, rep, rep,
                  rep, rep, rep, rep, P(SITES_AXIS), P(SITES_AXIS)),
        out_specs=(P(), P(), P(), P()),
        check_vma=False,
    )(k, codes, table, eigenvals, inv_eigenvecs, eigenvecs, prop_invar,
      rates, rate_weights, freqs, params_idx_rates, branches,
      pattern_weights, invariant)
    return total, d1, d2, branches_out


@partial(jax.jit, static_argnames=('mesh', 'scale_threshold',
                                   'scale_factor', 'rate_scalers',
                                   'fused_slots', 'pallas_interpret',
                                   'asc_type', 'n_real'))
def _sharded_fused_repeats_candidates(codes, tables_k, blens_k, roots_k,
                                      eigenvals, inv_eigenvecs,
                                      eigenvecs, prop_invar, rates,
                                      rate_weights, freqs,
                                      params_idx_rates, pattern_weights,
                                      invariant, *,
                                      mesh, scale_threshold,
                                      scale_factor, rate_scalers,
                                      fused_slots,
                                      pallas_interpret=False,
                                      asc_type=0, n_real=-1):
    """logL of K candidate topologies over SHARDED site-repeats
    partitions in ONE SPMD dispatch: every device runs the fused kernel
    on its column slice per candidate (tables/branches/roots
    replicated), then one psum reduces the [K] per-candidate sums —
    multi-chip topology search on the repeats production combo
    (TreeSearch drives it through evaluate_packed_arrays exactly like a
    TreeEngine)."""
    from jax import shard_map

    from ..ops import likelihood as ops_likelihood
    from ..ops import pallas_fused as ops_fused
    from ..ops import pmatrix as ops_pmatrix

    R = int(params_idx_rates.shape[0])
    s = int(eigenvals.shape[-1])

    def local(codes, tables_k, blens_k, roots_k, ev, ievec, evec, pinv,
              rates, rw, freqs, pidx, pw, inv):
        def eval_one(branches, table, root_idx):
            pmatrix = ops_pmatrix.update_prob_matrices(
                ev, ievec, evec, pinv, rates, pidx, branches)
            clv_p, clv_c, sc_p, sc_c = ops_fused.fused_traversal(
                codes, pmatrix, table, rates=R, states=s,
                n_slots=fused_slots, threshold=scale_threshold,
                factor=scale_factor, interpret=pallas_interpret,
                rate_scalers=rate_scalers)
            total, _ = ops_likelihood.edge_loglikelihood(
                clv_p, clv_c, sc_p, sc_c,
                jnp.take(pmatrix, root_idx[4], axis=0),
                freqs, pinv, rw, pidx, pw, inv, scale_threshold,
                rate_scalers=rate_scalers, has_pscaler=True,
                has_cscaler=True, asc_type=asc_type, n_real=n_real)
            return total

        # chunked vmap over candidates bounds the [chunk, ...] kernel
        # scratch (engine._fused_multi_topology); padded counts are
        # powers of two, so chunks divide evenly
        chunk = min(tables_k.shape[0], 128)

        def body(carry, xs):
            return carry, jax.vmap(eval_one)(*xs)

        _, totals = jax.lax.scan(
            body, None,
            jax.tree.map(lambda a: a.reshape((-1, chunk) + a.shape[1:]),
                         (blens_k, tables_k, roots_k)))
        return jax.lax.psum(totals.reshape(-1), SITES_AXIS)

    rep = P()
    return shard_map(
        local, mesh=mesh,
        in_specs=(P(None, SITES_AXIS), rep, rep, rep, rep, rep, rep,
                  rep, rep, rep, rep, rep, P(SITES_AXIS),
                  P(SITES_AXIS)),
        out_specs=rep,
        check_vma=False,
    )(codes, tables_k, blens_k, roots_k, eigenvals, inv_eigenvecs,
      eigenvecs, prop_invar, rates, rate_weights, freqs,
      params_idx_rates, pattern_weights, invariant)


class ShardedRepeatsEngine:
    """Site data-parallelism for site-repeats partitions.

    The reference's MPI consumers give each rank a slice of alignment
    columns; a site class is local to a rank (repeats are a pure
    compute-saving dedup, so per-shard class tables are exactly as
    correct as a global one — SURVEY §7). The equivalent built here:
    each device owns a contiguous column slice with its OWN class table
    and pooled class-column storage, and ONE `jax.shard_map` program runs
    the fused bucket traversal per shard and `psum`s the root-edge logL.

    Per-shard table shapes are canonicalized (equal lane widths, op
    counts padded to the max across shards, pools padded to the largest
    shard's total) so a single compiled program serves every shard as
    data — see engine.pack_repeats_canonical.

    parts: one site-repeats Partition per mesh device, each built over
    its column slice (equal widths) with identical model parameters.
    """

    def __init__(self, tree, parts, mesh: Mesh, params_index: int = 0,
                 interpret: bool = False,
                 dense_fused: Optional[bool] = None):
        from ..engine import pack_repeats_canonical
        from ..trees import create_operations, traverse
        from .. import constants as C

        # multi-process: each process supplies one partition per LOCAL
        # device (its column slice of the global alignment, reference MPI
        # mapping); single-process supplies all of them
        n = owned_shards(mesh)
        if len(parts) != n:
            raise ValueError(f"need {n} shard partitions (one per device "
                             f"this process owns), got {len(parts)}")
        p0 = parts[0]
        for p in parts:
            if p.repeats is None:
                raise C.PllError(
                    C.ERROR_PARAM_INVALID,
                    "every shard partition needs site_repeats=True (and "
                    f">= {C.REPEATS_MIN_SITES} sites per shard)")
            if p.sites != p0.sites:
                raise ValueError("shard partitions must have equal widths")
            if p.asc_bias.value != p0.asc_bias.value or \
                    p.asc_extra != p0.asc_extra:
                raise C.PllError(C.ERROR_PARAM_INVALID,
                                 "every shard must carry the same asc "
                                 "configuration")
        self.mesh = mesh
        self.parts = parts
        self.tree = tree
        self.dtype = p0.dtype
        self.rate_scalers = p0.rate_scalers
        # asc corrections compose rank-wise (see _sharded_repeats_loop);
        # Felsenstein/Stamatakis asc weights are per shard — set the
        # global weights once across the shard partitions, not repeated
        self.asc_type = p0.asc_bias.value
        self.n_real = p0.sites if p0.asc_extra else -1
        self.pallas_interpret = interpret

        trav = traverse(tree.vroot)
        operations, branches, pmatrix_indices = create_operations(trav)
        root = tree.vroot
        ri = (root.clv_index, root.scaler_index, root.back.clv_index,
              root.back.scaler_index, root.pmatrix_index)

        # dense-fused evaluation per shard: the POOLED storage stays (the
        # memory win), but each device evaluates its column slice through
        # the fused kernel on dense tip codes (engine.repeats_dense_fused
        # extended across the mesh). Decided FIRST: the dense-fused
        # program touches only tip codes + site vectors, so the pooled
        # arrays are never assembled — which also makes this path
        # multi-process capable (each process feeds its local column
        # blocks via put_global; pool-bucket shapes, by contrast, need
        # global canonicalization and stay single-process).
        from ..ops import pallas_fused as ops_fused
        self.dense_fused = False
        self._fused = None
        # no raw tip-CLV rows on the dense-fused shards (state codes
        # only) — the native candidate builder checks this
        self._packed_ctips = frozenset()
        want_dense = dense_fused is not False
        dense_ok = (p0.dtype == jnp.float32
                    and all(bool(np.all(p._tips_set)) for p in parts)
                    and (interpret
                         or mesh.devices.flat[0].platform == "gpu"))
        if want_dense and dense_ok:
            table, n_slots = ops_fused.pack_fused_schedule(
                operations, p0.tips, (ri[0], ri[2]))
            if table is not None:
                codes = np.concatenate(
                    [ops_fused.tip_code_matrix(p) for p in parts], axis=1)
                self._fused = (
                    self._put(codes, P(None, SITES_AXIS)),
                    self._put(np.asarray(table), P()),
                    max(-(-n_slots // 4) * 4, 4))
                self.dense_fused = True
            elif dense_fused:
                raise C.PllError(
                    C.ERROR_PARAM_INVALID,
                    "dense_fused requested but the traversal cannot be "
                    "packed for the fused kernel")
        elif dense_fused:
            raise C.PllError(
                C.ERROR_PARAM_INVALID,
                "dense_fused requires fp32 shards with every tip set "
                "from state codes on a GPU mesh (or interpret=True)")

        if not self.dense_fused:
            if is_multiprocess(mesh):
                raise C.PllError(
                    C.ERROR_PARAM_INVALID,
                    "the pooled compute path needs globally-canonicalized "
                    "bucket shapes and is single-process only; "
                    "multi-process sharded repeats run dense-fused "
                    "(fp32 shards, tips from state codes)")
            # pass 1: learn per-width op counts; pass 2: repack aligned
            counts = {}
            for p in parts:
                for f, gl, _ in pack_repeats_canonical(p, operations,
                                                       ri)[0]:
                    counts[gl.shape[1]] = max(counts.get(gl.shape[1], 0),
                                              f.shape[0])
            packs = [pack_repeats_canonical(p, operations, ri,
                                            pad_counts=counts)
                     for p in parts]

            # stack tables; shard blocks ride the 'sites' mesh axis
            n_widths = len(packs[0][0])
            self._buckets = tuple(
                (self._put(np.concatenate([pk[0][w][0] for pk in packs]),
                           P(SITES_AXIS, None)),
                 self._put(np.concatenate([pk[0][w][1] for pk in packs]),
                           P(SITES_AXIS, None)),
                 self._put(np.concatenate([pk[0][w][2] for pk in packs]),
                           P(SITES_AXIS, None)))
                for w in range(n_widths))
            self._root_cols = tuple(
                self._put(np.concatenate([pk[1][i] for pk in packs]),
                          P(SITES_AXIS))
                for i in range(4))
            self._mat = self._put(np.asarray(packs[0][2], np.int32), P())

            # pools, padded to the largest shard
            t_max = max(p.clv_flat.shape[-1] for p in parts)
            sc_max = max(p.sc_flat.shape[-1] for p in parts)

            def pad_to(a, width):
                pad = ([(0, 0)] * (a.ndim - 1)
                       + [(0, width - a.shape[-1])])
                return np.pad(np.asarray(a), pad)

            self.clv_flat = self._put(
                np.concatenate([pad_to(p.clv_flat, t_max) for p in parts],
                               axis=-1), P(None, None, SITES_AXIS))
            self.sc_flat = self._put(
                np.concatenate([pad_to(p.sc_flat, sc_max) for p in parts],
                               axis=-1),
                P(None, SITES_AXIS) if self.rate_scalers
                else P(SITES_AXIS))

        self._pw = self._put(
            np.concatenate([np.asarray(p.pattern_weights) for p in parts]),
            P(SITES_AXIS))
        self._inv = self._put(
            np.concatenate([np.asarray(p.invariant) for p in parts]),
            P(SITES_AXIS))

        blen = np.zeros(p0.prob_matrices)
        blen[np.asarray(pmatrix_indices)] = np.asarray(branches)
        self.branches = self._put(np.asarray(blen, self.dtype), P())

        p0._ensure_eigen([params_index])
        d = self.dtype
        self._model = tuple(
            self._put(np.asarray(a, d), P()) for a in (
                p0.eigenvals, p0.inv_eigenvecs, p0.eigenvecs,
                p0.prop_invar, p0.rates, p0.rate_weights, p0.frequencies)
        ) + (self._put(np.asarray([params_index] * p0.rate_cats,
                                  np.int32), P()),)
        self._root_mat_host = int(ri[4])

    def _put(self, a, spec):
        # put_global handles both modes: device_put single-process,
        # make_array_from_process_local_data when the mesh spans processes
        # (each process passes its local column block for sharded specs)
        return put_global(np.asarray(a), self.mesh, spec)

    def _fused_loop(self, k: int, newton: bool):
        codes, table, slots = self._fused
        total, d1, d2, self.branches = _sharded_fused_repeats_loop(
            jnp.asarray(k, jnp.int32), codes, table, *self._model,
            self.branches, self._pw, self._inv,
            mesh=self.mesh,
            scale_threshold=self.parts[0].scale_threshold,
            scale_factor=self.parts[0].scale_factor,
            rate_scalers=self.rate_scalers, fused_slots=slots,
            root_mat=self._root_mat_host,
            pallas_interpret=self.pallas_interpret,
            asc_type=self.asc_type, n_real=self.n_real, newton=newton)
        return float(total), float(d1), float(d2)

    def loglikelihood_loop(self, k: int) -> float:
        """Sum of k chained sharded evaluations, one SPMD dispatch."""
        if self.dense_fused:
            return self._fused_loop(k, newton=False)[0]
        total, self.clv_flat, self.sc_flat = _sharded_repeats_loop(
            jnp.asarray(k, jnp.int32),
            self.clv_flat, self.sc_flat, *self._model, self.branches,
            self._buckets, self._root_cols, self._mat, self._pw, self._inv,
            mesh=self.mesh,
            scale_threshold=self.parts[0].scale_threshold,
            scale_factor=self.parts[0].scale_factor,
            rate_scalers=self.rate_scalers,
            asc_type=self.asc_type, n_real=self.n_real)
        return float(total)

    def loglikelihood(self) -> float:
        return self.loglikelihood_loop(1)

    def newton_loop(self, k: int):
        """k chained Newton iterations on the root branch across the
        shards (the distributed 'training step': eval + d1/d2 psums +
        replicated branch update); returns (logL, d1, d2) of the LAST
        iteration."""
        if self.dense_fused:
            return self._fused_loop(k, newton=True)
        (total, d1, d2, self.branches, self.clv_flat,
         self.sc_flat) = _sharded_repeats_newton_loop(
            jnp.asarray(k, jnp.int32),
            self.clv_flat, self.sc_flat, *self._model, self.branches,
            self._buckets, self._root_cols, self._mat, self._pw,
            self._inv,
            mesh=self.mesh,
            scale_threshold=self.parts[0].scale_threshold,
            scale_factor=self.parts[0].scale_factor,
            rate_scalers=self.rate_scalers,
            asc_type=self.asc_type, n_real=self.n_real)
        return float(total), float(d1), float(d2)

    def newton_step(self):
        return self.newton_loop(1)

    # --- TreeSearch engine protocol (dense-fused shards only): the
    # batched SPR/NNI rounds drive a sharded repeats analysis exactly
    # like a TreeEngine — multi-chip topology search on the repeats
    # production combo. (The streamed rounds' eligibility check returns
    # False for this engine type, so searches take the batched path.)

    @property
    def partition(self):
        """Structural stand-in for the TreeSearch/native-builder hooks
        (prob_matrices, tips, ctip rows): every shard shares them."""
        return self.parts[0]

    @property
    def use_fused(self) -> bool:
        return self.dense_fused

    def _require_fused(self):
        from .. import constants as C
        if not self.dense_fused:
            raise C.PllError(
                C.ERROR_PARAM_INVALID,
                "topology search over a ShardedRepeatsEngine needs the "
                "dense-fused path (fp32 shards, every tip from state "
                "codes)")

    def set_topology(self, tree) -> None:
        """Rebind to a new topology of the same size: repack the fused
        table + branches + root (tip codes are topology-independent)."""
        from ..ops import pallas_fused as ops_fused
        from ..trees import create_operations, traverse
        from .. import constants as C

        self._require_fused()
        trav = traverse(tree.vroot)
        operations, branches, pmatrix_indices = create_operations(trav)
        root = tree.vroot
        ri = (root.clv_index, root.scaler_index, root.back.clv_index,
              root.back.scaler_index, root.pmatrix_index)
        p0 = self.parts[0]
        table, n_slots = ops_fused.pack_fused_schedule(
            operations, p0.tips, (ri[0], ri[2]))
        if table is None:
            raise C.PllError(C.ERROR_PARAM_INVALID,
                             "topology cannot be packed for the fused "
                             "kernel")
        codes, _, old_slots = self._fused
        slots = max(old_slots, -(-n_slots // 4) * 4, 4)
        self._fused = (codes, self._put(np.asarray(table), P()), slots)
        blen = np.zeros(p0.prob_matrices)
        blen[np.asarray(pmatrix_indices)] = np.asarray(branches)
        self.branches = self._put(np.asarray(blen, self.dtype), P())
        self._root_mat_host = int(ri[4])
        self.tree = tree

    def pack_candidate(self, vroot):
        """(table, blens, root_info, n_slots) for the current topology
        rooted at `vroot` (TreeEngine.pack_candidate semantics; no raw
        tip-CLV rows on the dense-fused shards)."""
        if not self.dense_fused:
            return None
        from ..ops import pallas_fused as ops_fused
        p0 = self.parts[0]
        table, blens, ri, n_slots = ops_fused.fused_candidate_from_tree(
            vroot, p0.tips, p0.prob_matrices)
        if table is None:
            return None
        return table, blens, ri, n_slots

    def _cand_slots_for(self, n_slots: int) -> int:
        # monotone grain-8 slot count: static arg, so every new value
        # recompiles the candidate program (engine._stable_slots policy)
        grain = -(-max(int(n_slots), self._fused[2]) // 8) * 8
        self._cand_slots = max(getattr(self, "_cand_slots", 0), grain)
        return self._cand_slots

    def evaluate_packed_arrays(self, tables, blens, roots,
                               n_slots: int) -> np.ndarray:
        """logL for pre-stacked fused candidate arrays — tables
        [K, n_ops+1, 8], blens [K, E], roots [K, 5] — over the sharded
        repeats partitions, one SPMD dispatch + one psum."""
        self._require_fused()
        k = tables.shape[0]
        if k == 0:
            return np.zeros(0)
        from ..ops.spr_stream import _pow2
        w = _pow2(k)
        if w != k:
            tables = np.concatenate(
                [tables, np.repeat(tables[-1:], w - k, axis=0)])
            blens = np.concatenate(
                [blens, np.repeat(blens[-1:], w - k, axis=0)])
            roots = np.concatenate(
                [roots, np.repeat(roots[-1:], w - k, axis=0)])
        codes, _, _ = self._fused
        totals = _sharded_fused_repeats_candidates(
            codes,
            self._put(np.asarray(tables, np.int32), P()),
            self._put(np.asarray(blens, self.dtype), P()),
            self._put(np.asarray(roots, np.int32), P()),
            *self._model, self._pw, self._inv,
            mesh=self.mesh,
            scale_threshold=self.parts[0].scale_threshold,
            scale_factor=self.parts[0].scale_factor,
            rate_scalers=self.rate_scalers,
            fused_slots=self._cand_slots_for(n_slots),
            pallas_interpret=self.pallas_interpret,
            asc_type=self.asc_type, n_real=self.n_real)
        return np.asarray(totals)[:k]

    def evaluate_packed(self, packed) -> np.ndarray:
        """logL for [(table, blens, root_info, n_slots)] candidates from
        pack_candidate."""
        if not packed:
            return np.zeros(0)
        tables = np.stack([pc[0] for pc in packed])
        blens = np.stack([pc[1] for pc in packed])
        roots = np.asarray([list(pc[2]) for pc in packed], np.int32)
        return self.evaluate_packed_arrays(
            tables, blens, roots, max(pc[3] for pc in packed))
