"""Fast (Fitch) parsimony on bit-packed state vectors.

Reference: /root/reference/src/fast_parsimony.c. Parsimony-informative
sites (>= 2 state codes occurring >= 2 times among the tips; singletons of
non-informative sites accumulate a constant cost, fast_parsimony.c:128-194)
are weight-expanded and packed into per-state uint32 bitvectors
(fast_parsimony.c:196-367, padding bits set). The Fitch step

    parent_k = (c1_k & c2_k) | (~union & (c1_k | c2_k)),
    union    = OR_k (c1_k & c2_k),   steps += popcount(~union)

runs on the device's vector units via `lax.population_count`, one `lax.scan` over the
operation list. One vector per half-edge (`node_index` addressing,
tips + 3*(tips-1) slots) exactly as the reference, so partial refreshes and
the stepwise machinery carry over. A vmapped edge-score kernel evaluates
many candidate insertion edges in a single launch (the batched replacement for
the reference's per-edge splice/score loop, stepwise.c:266-389).
"""
from __future__ import annotations

from functools import reduce
from typing import Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .sankoff import ParsBuildOp

BITS = 32


def _informative(tip_codes: np.ndarray,
                 pattern_weights: np.ndarray) -> Tuple[np.ndarray, int]:
    """(informative mask [S], const_cost) — fast_parsimony.c:128-194,369.

    Vectorized: one np.unique over (site, code) pairs classifies every
    column at once (the per-column loop was the construction bottleneck
    for long alignments)."""
    tips, sites = tip_codes.shape
    site_ids = np.repeat(np.arange(sites, dtype=np.uint64), tips)
    # (site, code) composite keys; codes fit in < 2^32 after ranking
    _, code_rank = np.unique(tip_codes, return_inverse=True)
    keys = site_ids * np.uint64(len(_)) + \
        code_rank.reshape(tips, sites).T.reshape(-1).astype(np.uint64)
    uniq_keys, counts = np.unique(keys, return_counts=True)
    per_site = (uniq_keys // np.uint64(len(_))).astype(np.int64)
    repeated = np.zeros(sites, dtype=np.int64)
    singles = np.zeros(sites, dtype=np.int64)
    np.add.at(repeated, per_site, (counts > 1).astype(np.int64))
    np.add.at(singles, per_site, (counts == 1).astype(np.int64))
    informative = repeated > 1
    const_cost = int((singles[~informative]
                      * np.asarray(pattern_weights)[~informative]).sum())
    return informative, const_cost


def _pack_tips(tip_codes: np.ndarray,        # [tips, S] uint64 state masks
               informative: np.ndarray,      # [S] bool
               pattern_weights: np.ndarray,  # [S]
               states: int) -> np.ndarray:
    """[tips, states, W] uint32, weight-expanded, padded with ones."""
    idx = np.repeat(np.nonzero(informative)[0],
                    pattern_weights[informative].astype(np.int64))
    bits = idx.size
    words = max(1, -(-bits // BITS))
    out = np.empty((tip_codes.shape[0], states, words), dtype=np.uint32)
    pad = words * BITS - bits
    for i in range(tip_codes.shape[0]):
        codes = tip_codes[i, idx]
        for k in range(states):
            b = ((codes >> np.uint64(k)) & np.uint64(1)).astype(np.uint8)
            b = np.concatenate([b, np.ones(pad, dtype=np.uint8)])
            out[i, k] = np.packbits(b, bitorder="little").view(np.uint32)
    return out


def _union_ands(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """OR over the state axis of (a_k & b_k); a, b: [states, W]."""
    ands = a & b
    return reduce(jnp.bitwise_or, [ands[k] for k in range(ands.shape[0])])


@jax.jit
def _update_kernel(vectors: jnp.ndarray,     # [N, states, W] uint32
                   node_cost: jnp.ndarray,   # [N] int32
                   ops: jnp.ndarray):        # [n, 3] int32
    def body(carry, op):
        vec, cost = carry
        p, c1, c2 = op
        a = jnp.take(vec, c1, axis=0)
        b = jnp.take(vec, c2, axis=0)
        ands = a & b
        ors = a | b
        union = _union_ands(a, b)
        newv = ands | (~union & ors)
        steps = jnp.sum(jax.lax.population_count(~union)).astype(cost.dtype)
        vec = vec.at[p].set(newv)
        cost = cost.at[p].set(steps + cost[c1] + cost[c2])
        return (vec, cost), None

    (vectors, node_cost), _ = jax.lax.scan(body, (vectors, node_cost), ops)
    return vectors, node_cost


@jax.jit
def _edge_score_kernel(vectors: jnp.ndarray, node_cost: jnp.ndarray,
                       i1: jnp.ndarray, i2: jnp.ndarray):
    a = jnp.take(vectors, i1, axis=0)
    b = jnp.take(vectors, i2, axis=0)
    union = _union_ands(a, b)
    return (jnp.sum(jax.lax.population_count(~union)).astype(jnp.int32)
            + node_cost[i1] + node_cost[i2])


@jax.jit
def _batch_insert_scores(vectors: jnp.ndarray,   # [N, states, W]
                         node_cost: jnp.ndarray,
                         tip_vec: jnp.ndarray,   # [states, W]
                         tip_cost: jnp.ndarray,  # scalar
                         e1: jnp.ndarray,        # [E] one edge endpoint
                         e2: jnp.ndarray):       # [E] other endpoint
    """Score of inserting a tip into every edge (e1[i], e2[i]) at once:
    Fitch-join the two edge-side vectors, then edge-score against the tip.
    Equivalent to the reference's splice + 1-op update + edge score
    (stepwise.c:320-361), batched."""
    def one(i1, i2):
        a = jnp.take(vectors, i1, axis=0)
        b = jnp.take(vectors, i2, axis=0)
        ands = a & b
        ors = a | b
        union = _union_ands(a, b)
        joined = ands | (~union & ors)
        steps = jnp.sum(jax.lax.population_count(~union)).astype(jnp.int32)
        cost = steps + node_cost[i1] + node_cost[i2]
        union2 = _union_ands(joined, tip_vec)
        return (jnp.sum(jax.lax.population_count(~union2)).astype(jnp.int32)
                + cost + tip_cost)

    return jax.vmap(one)(e1, e2)


class FastParsimony:
    """pll_fastparsimony_init (fast_parsimony.c:523-560)."""

    def __init__(self, partition):
        if not np.all(partition._tips_set):
            raise ValueError("all tip states must be set before "
                             "fast-parsimony init")
        self.tips = partition.tips
        self.states = partition.states
        self.sites = partition.sites
        self.inner_nodes = self.tips - 1
        # +1 scratch slot absorbing padded no-op writes (see stepwise.py)
        nodes_count = self.tips + 3 * self.inner_nodes + 1
        self.scratch_index = nodes_count - 1

        codes = partition.tip_states[:, :self.sites]
        weights = partition.pattern_weights[:self.sites]
        informative, self.const_cost = _informative(codes, weights)
        self.informative = informative
        self.informative_count = int(informative.sum())

        packed = _pack_tips(codes, informative, weights, self.states)
        words = packed.shape[-1]
        vecs = np.zeros((nodes_count, self.states, words), dtype=np.uint32)
        vecs[:self.tips] = packed
        self.packed_host = packed        # host copy for the native path
        self.vectors = jnp.asarray(vecs)
        self.node_cost = jnp.zeros(nodes_count, dtype=jnp.int32)

    CHUNK = 128   # fixed scan length: one compiled kernel, any op count

    def update_vectors(self, operations: Sequence[ParsBuildOp],
                       chunked: bool = False) -> None:
        """With `chunked`, the list is executed as fixed-size scan chunks
        (padded with no-ops writing the scratch slot) so callers with
        varying op counts — the stepwise loop — reuse one compiled kernel;
        chunks run in order, preserving dependencies."""
        rows = [(o.parent_score_index, o.child1_score_index,
                 o.child2_score_index) for o in operations]
        if not chunked:
            ops = jnp.asarray(rows, dtype=jnp.int32)
            self.vectors, self.node_cost = _update_kernel(
                self.vectors, self.node_cost, ops)
            return
        pad_row = (self.scratch_index, 0, 0)
        for start in range(0, len(rows), self.CHUNK):
            chunk = rows[start:start + self.CHUNK]
            chunk += [pad_row] * (self.CHUNK - len(chunk))
            self.vectors, self.node_cost = _update_kernel(
                self.vectors, self.node_cost,
                jnp.asarray(chunk, dtype=jnp.int32))

    def edge_score(self, index1: int, index2: int) -> int:
        return int(_edge_score_kernel(
            self.vectors, self.node_cost,
            jnp.asarray(index1), jnp.asarray(index2))) + self.const_cost

    def root_score(self, index: int) -> int:
        return int(self.node_cost[index]) + self.const_cost

    def batch_insert_scores(self, tip_index: int,
                            e1: np.ndarray, e2: np.ndarray,
                            chunked: bool = False) -> np.ndarray:
        """const_cost-inclusive scores of inserting tip_index on each edge.
        With `chunked`, candidates run in fixed-size chunks (one compiled
        kernel shape regardless of the candidate count)."""
        tip_vec = self.vectors[tip_index]
        tip_cost = self.node_cost[tip_index]
        if not chunked:
            scores = _batch_insert_scores(
                self.vectors, self.node_cost, tip_vec, tip_cost,
                jnp.asarray(e1, jnp.int32), jnp.asarray(e2, jnp.int32))
            return np.asarray(scores) + self.const_cost
        n = len(e1)
        out = np.empty(n, dtype=np.int64)
        for start in range(0, n, self.CHUNK):
            c1 = np.zeros(self.CHUNK, dtype=np.int32)
            c2 = np.zeros(self.CHUNK, dtype=np.int32)
            m = min(self.CHUNK, n - start)
            c1[:m] = e1[start:start + m]
            c2[:m] = e2[start:start + m]
            c1[m:] = c1[0]
            c2[m:] = c2[0]
            scores = _batch_insert_scores(
                self.vectors, self.node_cost, tip_vec, tip_cost,
                jnp.asarray(c1), jnp.asarray(c2))
            out[start:start + m] = np.asarray(scores)[:m]
        return out + self.const_cost
