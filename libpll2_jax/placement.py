"""Phylogenetic placement: query sequences onto a fixed reference tree.

The EPA pattern (EPA-ng is a flagship consumer of the reference): for a
query sequence, try attaching it to EVERY edge of the reference tree and
report the per-edge log-likelihoods and likelihood weight ratios (LWR).
Here every candidate attachment of a query is scored in ONE device
dispatch through the engine's batched multi-topology path — the
move->rescore loop EPA builds from the reference collapses into a single
vmapped kernel launch over all 2N-3 edges.

Method: each edge (u, v) of length L is split at its midpoint by a new
inner node carrying the query as a pendant tip (length
`pendant_length`), the standard EPA attachment heuristic. Branch lengths
are not re-optimized per candidate (EPA-ng's fast heuristic mode);
rankings on simulated data recover the true attachment edge.
"""
from __future__ import annotations

from functools import partial
from typing import Dict, List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from . import constants as C
from .engine import TreeEngine, _fused_loglikelihood
from .partition import Partition
from .io import maps
from .ops.gamma import compute_gamma_cats
from .trees import create_operations, traverse
from .trees.utils import utree_clone
from .trees.utree import SCALE_BUFFER_NONE, UNode, UTree, link


from .ops.spr_stream import _pow2


class _RankedRows:
    """Ranked placement rows for ONE query, materialized per access.

    Behaves like the list of {edge, edge_nodes, logL, lwr} dicts that
    place()/place_batch return (indexing, slicing, iteration, len), but
    builds each dict on demand: at EPA-ng scale the eager construction
    of Q x E dicts was most of the streaming placer's host share, while
    the jplace writer reads only the top-k rows per query. Backed by
    rank-ordered arrays (order[i] = edge of rank i, scores/lwr sorted
    the same way) so device-side top-k results feed it directly."""
    __slots__ = ("order", "scores", "lwr", "_names")

    def __init__(self, order, scores, lwr, names):
        self.order, self.scores, self.lwr = order, scores, lwr
        self._names = names

    def __len__(self):
        return len(self.order)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self[j] for j in range(*i.indices(len(self)))]
        e = int(self.order[i])
        return {"edge": e, "edge_nodes": self._names[e],
                "logL": float(self.scores[i]),
                "lwr": float(self.lwr[i])}

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def __eq__(self, other):
        return list(self) == list(other)

    def __repr__(self):
        return repr(self[:min(len(self), 4)]) + ("..." if len(self) > 4
                                                 else "")


def _edge_list(tree: UTree):
    """One representative half-edge per edge (tips included)."""
    out, seen = [], set()
    for node in tree.nodes():
        halves = [node] if node.is_tip() else list(node.ring())
        for h in halves:
            if h.back is not None and id(h) not in seen \
                    and id(h.back) not in seen:
                seen.add(id(h)), seen.add(id(h.back))
                out.append(h)
    return out


def _index_for_placement(tree: UTree, label_row: Dict[str, int]):
    """Assign partition indices on the CLONED reference tree, reserving
    tip row `n` for the query: tips map to their partition rows by
    label; inner clvs start at n+1; pmatrix indices enumerate edges."""
    n = len(label_row)
    inner_clv = n + 1
    scaler = 0
    for node in tree.nodes():
        if node.is_tip():
            node.clv_index = node.node_index = label_row[node.label]
            node.scaler_index = SCALE_BUFFER_NONE
        else:
            for h in node.ring():
                h.clv_index = h.node_index = inner_clv
                h.scaler_index = scaler
            inner_clv += 1
            scaler += 1
    for e, h in enumerate(_edge_list(tree)):
        h.pmatrix_index = h.back.pmatrix_index = e


class EdgePlacer:
    """Placement engine bound to one reference tree + alignment.

    Build once, then `place(query_seq)` per query: one device dispatch
    scores all 2N-3 candidate attachments.
    """

    def __init__(self, tree: UTree, reference_by_label: Dict[str, str],
                 states: int = 4, rate_cats: int = 4, charmap=None,
                 pendant_length: float = 0.05,
                 query_label: str = "QUERY", dtype=None, pallas="auto"):
        if charmap is None:
            charmap = maps.map_nt if states == 4 else maps.map_aa
        self.charmap = charmap
        labels = [t.label for t in tree.tips()]
        if set(labels) != set(reference_by_label):
            raise C.PllError(C.ERROR_PARAM_INVALID,
                             "reference alignment and tree taxa differ")
        n = len(labels)
        sites = len(next(iter(reference_by_label.values())))
        self.n_ref = n
        self.query_row = n
        self.query_label = query_label
        self.pendant_length = pendant_length
        self.tree = utree_clone(tree)
        label_row = {lab: i for i, lab in enumerate(labels)}
        _index_for_placement(self.tree, label_row)
        self.edges = _edge_list(self.tree)
        E = len(self.edges)                       # 2n-3
        # grafted trees have n+1 tips: one extra inner node/scaler and
        # two extra pmatrix slots (the split half + the pendant)
        self.partition = Partition(n + 1, n, states, sites, 1, E + 2,
                                   rate_cats, n, dtype=dtype)
        self._pallas = pallas
        self.partition.set_tip_states_batch(
            charmap, [reference_by_label[lab] for lab in labels],
            tip_indices=[label_row[lab] for lab in labels])
        # placeholder query (all-gap): every tip row must be populated
        # BEFORE the engine builds, or the fused-kernel eligibility check
        # rejects the partition and every placement silently runs the
        # slow XLA fallback
        self.partition.set_tip_states(self.query_row, charmap,
                                      "-" * sites)
        self._candidates = None
        self._edge_names = [
            (h.label or f"node{h.clv_index}",
             h.back.label or f"node{h.back.clv_index}")
            for h in self.edges]

    def set_model(self, freqs, subst, rates=None, alpha: float = 1.0):
        p = self.partition
        p.set_frequencies(0, freqs)
        p.set_subst_params(0, subst)
        if rates is None:
            rates = (compute_gamma_cats(alpha, p.rate_cats)
                     if p.rate_cats > 1 else np.ones(1))
        p.set_category_rates(rates)
        self._engine = None
        self._stream = None

    def _graft_candidates(self):
        """Splice the query onto each edge in turn, snapshot the
        operation list, unsplice. Candidate tuples feed
        TreeEngine.evaluate_topologies; index assignments are shared, so
        every candidate runs in the same compiled program."""
        n = self.n_ref
        E = len(self.edges)
        inner_clv = 2 * n          # rows n+1..2n-1 taken by base inners
        cands = []
        for e, h in enumerate(self.edges):
            u, v = h, h.back
            L = h.length
            r1, r2, r3 = UNode(), UNode(), UNode()
            r1.next, r2.next, r3.next = r2, r3, r1
            for r in (r1, r2, r3):
                r.clv_index = r.node_index = inner_clv
                r.scaler_index = n - 1            # one extra scaler row
            q = UNode(label=self.query_label)
            q.clv_index = q.node_index = self.query_row
            q.scaler_index = SCALE_BUFFER_NONE
            # wire: u -- r1, r2 -- v, r3 -- q; reuse e's pmatrix slot for
            # the u side, slot E for the v side, E+1 for the pendant
            link(r1, u, L / 2)
            link(r2, v, L / 2)
            link(r3, q, self.pendant_length)
            r1.pmatrix_index = u.pmatrix_index = e
            r2.pmatrix_index = v.pmatrix_index = E
            r3.pmatrix_index = q.pmatrix_index = E + 1
            trav = traverse(r3)
            ops, branches, pidx = create_operations(trav)
            root_info = (r3.clv_index, r3.scaler_index, q.clv_index,
                         q.scaler_index, r3.pmatrix_index)
            cands.append((ops, branches, pidx, root_info))
            if e == 0:
                # the engine's base topology roots here; the grafted
                # component keeps its indices after unsplicing
                self._root0 = r3
            # unsplice
            link(u, v, L)
            u.pmatrix_index = v.pmatrix_index = e
        return cands

    def _ensure_engine(self):
        if getattr(self, "_engine", None) is None:
            self._candidates = self._graft_candidates()
            ops, branches, pidx, _ = self._candidates[0]
            self._engine = TreeEngine(self.partition, operations=ops,
                                      branches=branches,
                                      pmatrix_indices=pidx,
                                      root=self._root0,
                                      level_schedule=False,
                                      pallas=self._pallas)
        return self._engine

    def _fused_batch_inputs(self):
        """(tables [E, n_ops+1, 8], branches [E, B], roots [E, 5]) for the
        kernel path, or None when any candidate is unfusable."""
        from .ops import pallas_fused as ops_fused

        if getattr(self, "_batch_inputs", None) is not None:
            return self._batch_inputs
        p = self.partition
        tables, blens, roots, slots = [], [], [], 0
        for ops, branches, pidx, ri in self._candidates:
            table, n_slots = ops_fused.pack_fused_schedule(
                ops, p.tips, (ri[0], ri[2]))
            if table is None:
                return None
            slots = max(slots, n_slots)
            tables.append(table)
            b = np.zeros(p.prob_matrices)
            b[np.asarray(pidx)] = np.asarray(branches)
            blens.append(b)
            roots.append(list(ri))
        self._batch_inputs = (jnp.asarray(np.stack(tables)),
                              jnp.asarray(np.stack(blens), p.dtype),
                              jnp.asarray(np.asarray(roots, np.int32)),
                              max(-(-slots // 4) * 4, 4))
        return self._batch_inputs

    def place_batch(self, query_seqs: Dict[str, str], chunk: int = 8,
                    top_k: Optional[int] = None
                    ) -> Dict[str, Sequence[dict]]:
        """Place MANY queries at once: all (query x edge) attachments in
        one device dispatch per `chunk` queries (vmap over queries x
        vmap over edges through the fused kernel) — per-dispatch latency
        dominates single-query placement, so batching is much faster
        per query. Falls back to per-query
        place() when the fused kernel cannot run (fp64 validation mode).
        Returns {query_label: ranked placement rows}."""
        eng = self._ensure_engine()
        fb = self._fused_batch_inputs() if eng.use_fused else None
        labels = list(query_seqs)
        if not labels:
            return {}
        if fb is None:
            return {lab: self.place(query_seqs[lab], top_k=top_k)
                    for lab in labels}
        tables_k, blens_k, roots_k, n_slots = fb
        p = self.partition

        # per-query tip-code matrices: only the query row differs
        from .ops import pallas_fused as ops_fused
        grain = ops_fused.kernel_grain(p.states)
        pad_to = -(-p.sites_padded // grain) * grain
        codes_list = []
        for lab in labels:
            self.partition.set_tip_states(self.query_row,
                                          self.charmap, query_seqs[lab])
            codes_list.append(ops_fused.tip_code_matrix(p, pad_to=pad_to))
        codes_q = jnp.asarray(np.stack(codes_list))

        margs = eng._model_args()
        sargs = eng._site_args()
        Q = len(labels)
        # pad the query axis to a multiple of `chunk`: a short final
        # chunk would recompile the whole scan+kernel program for one odd
        # shape
        q_pad = -(-Q // chunk) * chunk
        if q_pad != Q:
            codes_q = jnp.concatenate(
                [codes_q, jnp.repeat(codes_q[-1:], q_pad - Q, axis=0)])
        out = np.zeros((q_pad, tables_k.shape[0]))
        for q0 in range(0, q_pad, chunk):
            out[q0:q0 + chunk] = np.asarray(_place_scores(
                codes_q[q0:q0 + chunk], tables_k, blens_k, roots_k,
                *margs, *sargs, p.scale_threshold, p.scale_factor,
                fused_slots=n_slots,
                pallas_interpret=eng.pallas_interpret))
        return dict(zip(labels,
                        self._rank_rows_batch(out[:len(labels)], top_k)))

    def prepare_stream(self):
        """Precompute the query-independent attachment tensors for
        `place_stream` (one device dispatch: postorder + directional-CLV
        edge walk). Call again after changing the model or branch
        lengths; `set_model` invalidates automatically."""
        from .ops import branch_sweep, pmatrix as ops_pmatrix
        from .partition import pack_operations
        from .trees import create_operations as _create_ops

        p = self.partition
        if float(np.max(np.asarray(p.prop_invar))) > 0.0:
            raise C.PllError(
                C.ERROR_PARAM_INVALID,
                "place_stream supports pinv == 0 only (the +I invariant "
                "term depends on the query state pattern); use "
                "place_batch for +I models")
        trav = traverse(self.tree.vroot)
        operations, branches, pidx = _create_ops(trav)
        steps, n_aux = branch_sweep.build_smoothing_schedule(
            self.tree, p.nodes, p.scale_buffers, len(self.edges))
        ops = pack_operations(operations, scratch_clv=p.nodes)
        E = len(self.edges)
        blen_full = np.zeros(E)
        blen_full[np.asarray(pidx)] = np.asarray(branches)
        blen_half = np.concatenate([blen_full / 2.0, [0.0]])
        # a throwaway engine supplies the cached device model operands
        eng = TreeEngine(p, operations=operations, branches=branches,
                         pmatrix_indices=pidx, root=self.tree.vroot,
                         level_schedule=False, pallas=False)
        margs = eng._model_args()
        (ev, inv_evecs, evecs, prop_invar, rates, rate_weights, freqs,
         params_idx_rates) = margs
        a_w, cnt = _edge_attach_tensors(
            p.clv, p.scale_buffer, ev, inv_evecs, evecs, prop_invar,
            rates, rate_weights, freqs, params_idx_rates,
            ops, jnp.asarray(steps),
            jnp.asarray(blen_full, p.dtype),
            jnp.asarray(blen_half, p.dtype),
            p.scale_threshold, p.scale_factor, n_aux=n_aux, n_edges=E)
        pend = ops_pmatrix.update_prob_matrices(
            ev, inv_evecs, evecs, prop_invar, rates, params_idx_rates,
            jnp.asarray([self.pendant_length], p.dtype))[0]
        pw = eng._site_args()[0]
        self._stream = (a_w, cnt, pend, pw,
                        float(np.log(p.scale_threshold)))
        self._stream_version = p._model_version
        self._stream_blens = tuple(h.length for h in self.edges)
        return self

    def _query_codes(self, seq: str) -> np.ndarray:
        return self._query_codes_batch([seq])[0]

    def _query_codes_batch(self, seqs) -> np.ndarray:
        """All query bitmask rows in ONE vectorized pass (one charmap
        gather over the concatenated bytes): the per-query encode loop
        was the dominant host cost of the streaming placer. Returns
        [Q, sites_padded] int32 (int8 for <= 8-state
        alphabets — quarters the host->device transfer)."""
        p = self.partition
        for s in seqs:
            if len(s) != p.sites:
                raise C.PllError(
                    C.ERROR_PARAM_INVALID,
                    f"query length {len(s)} != {p.sites} sites")
        raw = np.frombuffer("".join(seqs).encode("latin-1"),
                            dtype=np.uint8).reshape(len(seqs), p.sites)
        codes = np.asarray(self.charmap, dtype=np.uint64)[raw]
        if np.any(codes == 0):
            qi, si = np.unravel_index(int(np.argmax(codes == 0)),
                                      codes.shape)
            raise C.PllError(
                C.ERROR_TIPDATA_ILLEGALSTATE,
                f"illegal state in query sequence: {seqs[qi][si]!r}")
        dt = np.int8 if p.states <= 8 else np.int32
        out = np.zeros((len(seqs), p.sites_padded), dt)
        out[:, :p.sites] = codes.astype(dt)    # masks fit: < 2^states
        return out

    def place_stream(self, query_seqs: Dict[str, str],
                     chunk: Optional[int] = None,
                     top_k: Optional[int] = None
                     ) -> Dict[str, Sequence[dict]]:
        """EPA-ng-scale streaming placement: queries are scored against
        the PRECOMPUTED per-edge attachment tensors (prepare_stream), so
        each (query, edge, site) costs one R*s-element contraction plus a
        log — independent of tree size — instead of a full traversal.
        Queries are padded to `chunk` (default: the power-of-two bucket
        of the query count, capped at 1024 — the per-dispatch latency
        dominates the contraction, so fewer,
        larger dispatches win) and processed one dispatch per chunk.
        Output rows are identical in format to place()/place_batch (feed
        to_jplace); they materialize lazily on access, so consumers that
        read only the top-k rows (to_jplace) never pay for full ranked
        row construction."""
        p = self.partition
        if getattr(self, "_stream", None) is None \
                or self._stream_version != p._model_version \
                or self._stream_blens != tuple(h.length
                                               for h in self.edges):
            self.prepare_stream()    # model or branch lengths changed
        a_w, cnt, pend, pw, log_thr = self._stream
        labels = list(query_seqs)
        if not labels:
            return {}
        S = p.sites_padded
        tile = next(t for t in (2048, 1024, 512, 128, S) if S % t == 0)
        Q = len(labels)
        if chunk is None:
            chunk = min(_pow2(Q), 1024)
        q_pad = -(-Q // chunk) * chunk
        codes = np.zeros((q_pad, S),
                         np.int8 if p.states <= 8 else np.int32)
        codes[:Q] = self._query_codes_batch(
            [query_seqs[lab] for lab in labels])
        # queue every chunk's transfer + dispatch before blocking on any
        # result: the per-dispatch latency then
        # overlaps the compute instead of serializing behind a blocking
        # np.asarray per chunk
        devs = [_stream_scores(
            jnp.asarray(codes[q0:q0 + chunk]), a_w, cnt, pend, pw,
            log_thr, n_states=p.states, tile=tile)
            for q0 in range(0, q_pad, chunk)]
        out = np.concatenate([np.asarray(d) for d in devs], axis=0)
        return dict(zip(labels,
                        self._rank_rows_batch(out[:Q], top_k)))

    def place(self, query_seq: str, top_k: Optional[int] = None
              ) -> Sequence[dict]:
        """Score every attachment edge for one query sequence (ONE device
        dispatch); returns rows sorted by logL with likelihood weight
        ratios: [{edge, edge_nodes, logL, lwr}, ...]."""
        self.partition.set_tip_states(self.query_row, self.charmap,
                                      query_seq)
        eng = self._ensure_engine()
        scores = np.asarray(eng.evaluate_topologies(self._candidates),
                            dtype=np.float64)
        return self._rank_rows(scores, top_k)

    def _rank_rows(self, scores, top_k=None):
        return self._rank_rows_batch(np.asarray(scores)[None, :],
                                     top_k)[0]

    def _rank_rows_batch(self, scores, top_k=None):
        """Ranked jplace rows for a [Q, E] score matrix: vectorized
        exp/argsort across queries, LAZY per-row dict materialization
        (_RankedRows) — at EPA-ng scale (1000s of queries x 100s of
        edges) eager Q x E dict construction was most of the streaming
        path's host share, while consumers read only the top-k rows."""
        scores = np.asarray(scores, np.float64)
        w = np.exp(scores - scores.max(axis=1, keepdims=True))
        lwr = w / w.sum(axis=1, keepdims=True)
        order = np.argsort(-scores, axis=1)
        if top_k:
            order = order[:, :top_k]
        s_sorted = np.take_along_axis(scores, order, axis=1)
        l_sorted = np.take_along_axis(lwr, order, axis=1)
        names = self._edge_names
        return [_RankedRows(order[qi], s_sorted[qi], l_sorted[qi], names)
                for qi in range(scores.shape[0])]


@partial(jax.jit, static_argnames=('scale_threshold', 'scale_factor',
                                   'n_aux', 'n_edges'))
def _edge_attach_tensors(clv, scaler,
                         eigenvals, inv_eigenvecs, eigenvecs, prop_invar,
                         rates, rate_weights, freqs, params_idx_rates,
                         ops,              # packed postorder Operations
                         steps,            # [n_steps, 13] int32
                         blen_full,        # [E] current edge lengths
                         blen_half,        # [E+1] half lengths (+0 dummy)
                         scale_threshold: float, scale_factor: float,
                         n_aux: int, n_edges: int):
    """Per-edge attachment tensors for the streaming placer, in ONE
    dispatch: a postorder refresh, then the smoothing-schedule edge walk
    (ops/branch_sweep.py) computing directional "up" CLVs in aux rows —
    but instead of Newton steps, each edge step emits

        A[e]   = (P(L_e/2) @ clv_child) * (P(L_e/2) @ clv_parent_side)
                 folded with rate_weights x freqs  ->  [E, R*s, S]
        cnt[e] = summed per-site scaler counts      ->  [E, S]

    — everything about candidate attachment e that does not depend on
    the query. A query's placement logL then reduces to a 16-element
    (R*s) contraction per site against its own pendant-tip part (the
    EPA "partial likelihood" factorization the reference's consumers
    build from pll_update_partials on a 3-node subtree;
    reference: /root/reference/src/pll.c CLV reuse semantics)."""
    from .ops import pmatrix as ops_pmatrix
    from .ops.partials import update_partials

    dtype = clv.dtype
    K = scaler.shape[0] - 2
    R, s, S = clv.shape[1], clv.shape[2], clv.shape[3]

    pmat_full = ops_pmatrix.update_prob_matrices(
        eigenvals, inv_eigenvecs, eigenvecs, prop_invar, rates,
        params_idx_rates, blen_full)
    pmat_half = ops_pmatrix.update_prob_matrices(
        eigenvals, inv_eigenvecs, eigenvecs, prop_invar, rates,
        params_idx_rates, blen_half)

    aux_clv = jnp.zeros((n_aux,) + clv.shape[1:], dtype)
    aux_sc = jnp.zeros((n_aux,) + scaler.shape[1:], scaler.dtype)
    clv_c = jnp.concatenate([clv, aux_clv], axis=0)
    sc_c = jnp.concatenate([scaler[:K], aux_sc, scaler[K:]], axis=0)
    clv_c, sc_c = update_partials(clv_c, sc_c, pmat_full, ops,
                                  scale_threshold, scale_factor)
    thresh = jnp.asarray(scale_threshold, dtype)
    factor = jnp.asarray(scale_factor, dtype)
    HI = jax.lax.Precision.HIGHEST

    # dummy (subtree-exit) steps carry mat == n_edges: they index the
    # appended zero row of pmat_half and scatter into trash row E
    pmat_half_p = jnp.concatenate(
        [pmat_half, jnp.zeros((1,) + pmat_half.shape[1:], dtype)])
    out_a = jnp.zeros((n_edges + 1, R, s, S), dtype)
    out_cnt = jnp.zeros((n_edges + 1, S), sc_c.dtype)

    def step(carry, st):
        clv_c, sc_c, out_a, out_cnt = carry
        (up_clv, up_sc, c1, m1, s1, c2, m2, s2,
         e_c, e_csc, e_p, e_psc, mat) = [st[i] for i in range(13)]
        with jax.named_scope("stream.upclv"):
            left = jnp.take(clv_c, c1, axis=0)
            right = jnp.take(clv_c, c2, axis=0)
            pl = jnp.take(pmat_full, m1, axis=0)
            pr = jnp.take(pmat_full, m2, axis=0)
            x = (jnp.einsum('rij,rjs->ris', pl, left,
                            preferred_element_type=dtype, precision=HI)
                 * jnp.einsum('rij,rjs->ris', pr, right,
                              preferred_element_type=dtype, precision=HI))
            mask = jnp.all(x < thresh, axis=(0, 1))
            x = jnp.where(mask[None, None, :], x * factor, x)
            new_sc = (jnp.take(sc_c, s1, axis=0)
                      + jnp.take(sc_c, s2, axis=0)
                      + mask.astype(sc_c.dtype))
            clv_c = clv_c.at[up_clv].set(x)
            sc_c = sc_c.at[up_sc].set(new_sc)
        with jax.named_scope("stream.attach"):
            ph = jnp.take(pmat_half_p, mat, axis=0)
            a = (jnp.einsum('rij,rjs->ris', ph,
                            jnp.take(clv_c, e_c, axis=0),
                            preferred_element_type=dtype, precision=HI)
                 * jnp.einsum('rij,rjs->ris', ph,
                              jnp.take(clv_c, e_p, axis=0),
                              preferred_element_type=dtype, precision=HI))
            cnt = (jnp.take(sc_c, e_csc, axis=0)
                   + jnp.take(sc_c, e_psc, axis=0))
            e = jnp.minimum(mat, n_edges)
            out_a = out_a.at[e].set(a)
            out_cnt = out_cnt.at[e].set(cnt)
        return (clv_c, sc_c, out_a, out_cnt), None

    (clv_c, sc_c, out_a, out_cnt), _ = jax.lax.scan(
        step, (clv_c, sc_c, out_a, out_cnt), steps)
    fold = (rate_weights[:, None, None].astype(dtype)
            * jnp.take(freqs, params_idx_rates, axis=0)[:, :, None])
    a_w = (out_a[:n_edges] * fold[None]).reshape(n_edges, R * s, S)
    return a_w, out_cnt[:n_edges]


@partial(jax.jit, static_argnames=('n_states', 'tile'))
def _stream_scores(codes_q,           # [Q, S] int query bitmasks
                   a_w,               # [E, R*s, S] weighted edge tensors
                   cnt,               # [E, S] per-site scaler counts
                   pend_pmat,         # [R, s, s] pendant P-matrix
                   pattern_weights,   # [S]
                   log_threshold,     # scalar, log of the scale window
                   n_states: int, tile: int):
    """logL grid [Q, E] from precomputed attachment tensors: one
    16-element contraction + log per (query, edge, site). Site tiles keep
    the [Q, E, tile] intermediate in a lax.scan instead of materializing
    [Q, E, S] in HBM."""
    dtype = a_w.dtype
    HI = jax.lax.Precision.HIGHEST
    Q = codes_q.shape[0]
    E, K, S = a_w.shape
    R = pend_pmat.shape[0]
    bits = ((codes_q[:, None, :] >> jnp.arange(n_states)[None, :, None])
            & 1).astype(dtype)                              # [Q, s, S]
    qp = jnp.einsum('rij,qjs->qris', pend_pmat, bits,
                    preferred_element_type=dtype,
                    precision=HI).reshape(Q, K, S)
    nt = S // tile
    a_t = a_w.reshape(E, K, nt, tile).transpose(2, 0, 1, 3)
    q_t = qp.reshape(Q, K, nt, tile).transpose(2, 0, 1, 3)
    pw_t = pattern_weights.astype(dtype).reshape(nt, tile)
    cnt_t = cnt.astype(dtype).reshape(E, nt, tile).transpose(1, 0, 2)

    def tstep(acc, xs):
        a, q, w, c = xs               # [E,K,T] [Q,K,T] [T] [E,T]
        inner = jax.lax.dot_general(
            q, a, (((1,), (1,)), ((2,), (2,))),
            preferred_element_type=dtype, precision=HI)     # [T, Q, E]
        site = jnp.where(w[:, None, None] > 0,
                         jnp.log(jnp.maximum(inner, 0.0))
                         + c.T[:, None, :] * log_threshold, 0.0)
        return acc + jnp.sum(w[:, None, None] * site, axis=0), None

    acc0 = jnp.zeros((Q, E), dtype)
    logl, _ = jax.lax.scan(tstep, acc0, (a_t, q_t, pw_t, cnt_t))
    return logl


@partial(jax.jit, static_argnames=('scale_threshold', 'scale_factor',
                                   'fused_slots', 'pallas_interpret'))
def _place_scores(codes_q,            # [Q, tips, S_pad] int32
                  tables_k,           # [E, n_ops+1, 8] int32
                  blens_k,            # [E, B]
                  roots_k,            # [E, 5] int32
                  eigenvals, inv_eigenvecs, eigenvecs, prop_invar, rates,
                  rate_weights, freqs, params_idx_rates,
                  pattern_weights, invariant,
                  scale_threshold, scale_factor,
                  fused_slots: int = 4, pallas_interpret: bool = False):
    """logL grid [Q, E]: every query against every attachment edge in one
    dispatch. Pallas folds the two vmaps into grid dimensions."""
    sites = pattern_weights.shape[0]
    clv_stub = jnp.zeros((1, params_idx_rates.shape[0],
                          eigenvals.shape[-1], sites), jnp.float32)
    sc_stub = jnp.zeros((3, sites), jnp.int32)

    def eval_edge(codes, branches, table, root_idx):
        total, _, _, _, _ = _fused_loglikelihood(
            clv_stub, sc_stub, eigenvals, inv_eigenvecs, eigenvecs,
            prop_invar, rates, rate_weights, freqs, params_idx_rates,
            branches, (table, codes), root_idx, pattern_weights,
            invariant, scale_threshold, scale_factor,
            fused_slots=fused_slots, pallas_interpret=pallas_interpret,
            fused_scatter=False)
        return total

    # scan over edges, vmap over queries: the query axis batches the
    # tip-code operand directly (one kernel launch per edge with a
    # query grid dimension); the reverse nesting broadcast-tiled the
    # codes across all edges and was ~25x slower on chip
    def edge_step(_, xs):
        b, t, ri = xs
        return None, jax.vmap(
            lambda codes: eval_edge(codes, b, t, ri))(codes_q)

    _, grid = jax.lax.scan(edge_step, None, (blens_k, tables_k, roots_k))
    return grid.T                                   # [Q, E]


def _jplace_subtree(h) -> str:
    """Newick of the subtree behind half-edge h with {edge} annotations
    (each edge carries its candidate index exactly once)."""
    b = h.back
    e = h.pmatrix_index
    if b.is_tip():
        return f"{b.label}:{b.length:.6f}{{{e}}}"
    parts = ",".join(_jplace_subtree(r) for r in list(b.ring())[1:])
    return f"({parts}){b.label or ''}:{b.length:.6f}{{{e}}}"


def to_jplace(placer: EdgePlacer, results: Dict[str, Sequence[dict]],
              top_k: int = 7) -> dict:
    """Serialize placements into the jplace v3 interchange format (what
    EPA-ng emits; consumed by gappa/iTOL): the reference tree's edges are
    annotated {edge_num} matching the placer's candidate indices, and
    each query carries its top_k placements with logL, LWR, distal
    (midpoint) and pendant lengths. json.dumps the result to write a
    .jplace file."""
    root = placer.tree.vroot
    tree = "(" + ",".join(_jplace_subtree(r) for r in root.ring()) + ");"
    half_len = np.asarray([h.length / 2.0 for h in placer.edges])
    pend = placer.pendant_length
    items = list(results.items())
    placements = []
    lens = [len(r) for _, r in items]
    # vectorized fast path needs a UNIFORM row count per query (all rows
    # >= top_k, or all equal — then the clamp is per-query exact);
    # mixed-length inputs (merged results of different top_k calls) take
    # the dict fallback, which emits min(len(rows), top_k) PER query
    uniform = lens and (min(lens) >= top_k or len(set(lens)) == 1)
    if items and uniform and all(isinstance(r, _RankedRows)
                                 for _, r in items):
        # vectorized across ALL queries: one [Q, k, 4] float block + one
        # [Q, k] edge block -> native lists in two tolist() passes,
        # instead of Q x k dict materializations (the jplace-writer host
        # cost at EPA scale)
        top_k = min(top_k, min(lens))
        o = np.stack([np.asarray(r.order[:top_k], np.int64)
                      for _, r in items])
        vals = np.stack([np.asarray(r.scores[:top_k]) for _, r in items])
        lwrs = np.stack([np.asarray(r.lwr[:top_k]) for _, r in items])
        blocks = np.stack([vals, lwrs, half_len[o],
                           np.full(o.shape, pend)], axis=2).tolist()
        edges_l = o.tolist()
        for (name, _), eq, bq in zip(items, edges_l, blocks):
            placements.append(
                {"p": [[e] + b for e, b in zip(eq, bq)], "n": [name]})
    else:
        for name, rows in items:
            p = [[r["edge"], r["logL"], r["lwr"],
                  placer.edges[r["edge"]].length / 2.0,
                  placer.pendant_length] for r in rows[:top_k]]
            placements.append({"p": p, "n": [name]})
    return {"tree": tree,
            "placements": placements,
            "fields": ["edge_num", "likelihood", "like_weight_ratio",
                       "distal_length", "pendant_length"],
            "version": 3,
            "metadata": {"software": "libpll2_jax"}}
