"""Weighted (Sankoff) parsimony — min-plus dynamic program over a cost
matrix.

Reference: /root/reference/src/parsimony.c (Sankoff 1975 minimum mutation
trees). Device design: score buffers are one dense [buffers, states, sites]
array; the per-node DP step

    score[p, n, s] = min_k(c1[k, s] + cost[k, n]) + min_k(c2[k, s] + cost[k, n])

is a batched min-plus contraction over the (small) state axis with sites on
the vector lanes, executed as one `lax.scan` over the operation list —
the same topology-as-data design as the likelihood engine.
"""
from __future__ import annotations

from functools import partial
from typing import List, NamedTuple, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .. import constants as C
from ..io import maps as state_maps


class ParsBuildOp(NamedTuple):
    """pll_pars_buildop_t (pll.h): score-buffer indices."""
    parent_score_index: int
    child1_score_index: int
    child2_score_index: int


class ParsRecOp(NamedTuple):
    """pll_pars_recop_t: preorder ancestral-reconstruction indices."""
    node_score_index: int
    node_ancestral_index: int
    parent_score_index: int
    parent_ancestral_index: int


@jax.jit
def _build_kernel(sbuffer: jnp.ndarray,      # [B, states, S]
                  cost: jnp.ndarray,         # [states, states]
                  ops: jnp.ndarray):         # [n, 3] int32
    def body(buf, op):
        parent, c1, c2 = op
        left = jnp.take(buf, c1, axis=0)     # [k, S]
        right = jnp.take(buf, c2, axis=0)
        m1 = jnp.min(left[:, None, :] + cost[:, :, None], axis=0)
        m2 = jnp.min(right[:, None, :] + cost[:, :, None], axis=0)
        return buf.at[parent].set(m1 + m2), None

    sbuffer, _ = jax.lax.scan(body, sbuffer, ops)
    return sbuffer


class Parsimony:
    """pll_parsimony_create (parsimony.c:117-203)."""

    def __init__(self, tips: int, states: int, sites: int,
                 score_matrix, score_buffers: int,
                 ancestral_buffers: int = 0):
        self.tips = tips
        self.states = states
        self.sites = sites
        self.score_matrix = np.asarray(score_matrix,
                                       dtype=np.float64).reshape(states,
                                                                 states)
        self.inf = float(self.score_matrix.max()) + 1.0
        self.sbuffer = jnp.zeros((tips + score_buffers, states, sites))
        self.anc_states = np.zeros((tips + ancestral_buffers, sites),
                                   dtype=np.int64)

    def set_sequence(self, tip_index: int, charmap, sequence: str) -> None:
        """Tip scores: 0 for compatible states, 'infinity' otherwise
        (parsimony.c:24-67)."""
        masks = state_maps.decode_states(
            sequence, np.asarray(charmap, dtype=np.uint64))
        if np.any(masks == 0):
            bad = sequence[int(np.argmax(masks == 0))]
            raise C.PllError(C.ERROR_TIPDATA_ILLEGALSTATE,
                             f"Illegal state code in tip \"{bad}\"")
        ind = state_maps.bits_to_clv(masks, self.states)       # [S, states]
        tipstate = np.where(ind > 0, 0.0, self.inf).T          # [states, S]
        self.sbuffer = self.sbuffer.at[tip_index].set(jnp.asarray(tipstate))

    def build(self, operations: Sequence[ParsBuildOp]) -> float:
        """Postorder DP; returns the score at the last parent
        (parsimony.c:205-284)."""
        ops = jnp.asarray([(o.parent_score_index, o.child1_score_index,
                            o.child2_score_index) for o in operations],
                          dtype=jnp.int32)
        self.sbuffer = _build_kernel(self.sbuffer,
                                     jnp.asarray(self.score_matrix), ops)
        return self.score(operations[-1].parent_score_index)

    def score(self, score_buffer_index: int) -> float:
        """Sum over sites of the per-site state minimum
        (parsimony.c:286-307)."""
        return float(jnp.sum(jnp.min(self.sbuffer[score_buffer_index],
                                     axis=0)))

    def reconstruct(self, charmap, operations: Sequence[ParsRecOp]) -> None:
        """Preorder ancestral states (parsimony.c:309-383): pick the
        minimum-score state unless keeping the parent's state is at least
        as good (min + 1 > parent's value)."""
        cm = np.asarray(charmap, dtype=np.uint64)
        revmap = {}
        for i in range(256):
            m = int(cm[i])
            if m and (m & (m - 1)) == 0:
                revmap[m.bit_length() - 1] = i
        sbuf = np.asarray(self.sbuffer)

        op = operations[0]
        scores = sbuf[op.node_score_index]                   # [states, S]
        minidx = np.argmin(scores, axis=0)
        self.anc_states[op.node_ancestral_index] = [revmap[i] for i in minidx]

        for op in operations[1:]:
            scores = sbuf[op.node_score_index]
            minidx = np.argmin(scores, axis=0)
            minval = scores[minidx, np.arange(self.sites)]
            panc = self.anc_states[op.parent_ancestral_index]
            pstate = np.array([int(cm[a]).bit_length() - 1 for a in panc])
            pval = sbuf[op.parent_score_index][pstate, np.arange(self.sites)]
            keep_parent = minval + 1 > pval
            self.anc_states[op.node_ancestral_index] = np.where(
                keep_parent, panc, [revmap[i] for i in minidx])

    def ancestral(self, index: int) -> str:
        return "".join(chr(c) for c in self.anc_states[index])
