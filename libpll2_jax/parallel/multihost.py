"""Multi-process (multi-host) execution entry point.

The reference library is single-process; its consumers (RAxML-NG / ExaML)
scale across machines by giving each MPI rank a contiguous slice of
alignment columns and all-reducing three scalars — logL, d1, d2 (design
affordance: per-site outputs of reference likelihood.c:122 and the
pattern-weight layout of reference pll.c:1112). The JAX mapping
(SURVEY §2.3): every process owns one column block of the alignment,
`jax.distributed` federates the processes into one device mesh (NVLink
within a host, the network across hosts), and ONE jitted SPMD program
evaluates the whole tree — XLA inserts the psums (NCCL on GPUs).

Recipe (each process runs the same script):

    from libpll2_jax.parallel import multihost
    multihost.initialize("localhost:12355", n_procs, rank)  # one per GPU
    mesh = multihost.global_mesh()
    lo, hi = multihost.process_site_block(total_sites)
    part = Partition(..., sites=hi - lo, sites_alignment=multihost.owned(mesh))
    # feed each tip sequence[lo:hi]; same model params on every process
    shard_partition(part, mesh)                 # assembles the GLOBAL arrays
    engine = TreeEngine(part, tree)             # one SPMD program
    engine.loglikelihood()                      # identical total on every rank

Everything downstream of `shard_partition` is process-count agnostic:
`put_global` (parallel/sharding.py) builds global jax.Arrays from the
process-local blocks via `jax.make_array_from_process_local_data`, and the
jitted tree programs run unchanged. Proof of process-invariance:
tests/test_multihost.py runs 1-process-8-device vs 2-process-4-device CPU
and asserts identical logL/d1/d2.
"""
from __future__ import annotations

from typing import Optional, Tuple

import jax

from .sharding import Mesh, make_mesh, owned_shards


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               local_device_ids=None,
               platform: Optional[str] = None) -> None:
    """Wire this process into the multi-process runtime (idempotent).

    GPUs: run one process per GPU and pass all three of
    `coordinator_address` (`host:port` of process 0, e.g.
    `localhost:<free port>` on one machine), `num_processes` and
    `process_id`, and `local_device_ids=[gpu index]` so that each process
    drives its own card. Nothing in a plain GPU machine describes the
    cluster to JAX, so `jax.distributed.initialize()` called without them
    fails. (One process may instead drive every local GPU itself; then no
    initialize call is needed at all.)

    For the multi-process CPU harness (tests, dry runs without devices),
    pass `platform='cpu'` plus explicit coordinator/count/id: this forces
    the CPU backend through `jax.config` (which also overrides a
    `JAX_PLATFORMS` set for another backend) and selects the gloo
    collectives implementation — without it XLA:CPU silently reduces only
    within each process.
    """
    # idempotency probe that does NOT touch the backend (jax.process_count
    # would initialize XLA, after which distributed.initialize refuses)
    from jax._src import distributed as _dist
    if _dist.global_state.client is not None:
        return                      # already initialized
    if platform == "cpu":
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_cpu_collectives_implementation", "gloo")
    kwargs = {}
    if coordinator_address is not None:
        kwargs["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    if local_device_ids is not None:
        kwargs["local_device_ids"] = local_device_ids
    jax.distributed.initialize(**kwargs)


def global_mesh() -> Mesh:
    """1-D 'sites' mesh over every device of every process."""
    return make_mesh()


def owned(mesh: Mesh) -> int:
    """Shards this process feeds — the `sites_alignment` a process-local
    partition needs so its padded width splits evenly over them."""
    return owned_shards(mesh)


def process_site_block(total_sites: int,
                       n_processes: Optional[int] = None,
                       process_index: Optional[int] = None
                       ) -> Tuple[int, int]:
    """[lo, hi) alignment-column block owned by this process (contiguous
    equal blocks in process order, matching `put_global`'s device order).
    Requires total_sites divisible by the process count — pad or trim the
    alignment first (the reference's MPI consumers do the same split)."""
    n = jax.process_count() if n_processes is None else n_processes
    i = jax.process_index() if process_index is None else process_index
    if total_sites % n:
        raise ValueError(f"{total_sites} sites do not split evenly over "
                         f"{n} processes; pad the alignment to a multiple")
    w = total_sites // n
    return i * w, (i + 1) * w
