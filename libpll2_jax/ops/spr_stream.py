"""Streamed SPR scoring from directional CLVs — the reference's
partial-traversal pattern (reference: /root/reference/test/src/
partial-traversal.c, /root/reference/src/utree_moves.c:119-255) done the
batched-device way.

The batched SPR round (engine.evaluate_packed_arrays) re-runs a FULL
postorder per candidate: ~2000 candidates x ~N ops at 1000 taxa, even
though an SPR changes only the few CLVs between the prune and regraft
points. This module scores every candidate of a round from three
precomputed pieces instead:

  1. directional CLVs D[h] for every half-edge h of the CURRENT tree
     (down CLVs = the ordinary postorder; up CLVs = one extra op per
     edge, computed into persistent aux rows);
  2. per prune point, "corrected" CLVs A[t] for each regraft target t
     within the radius: the directional CLV at t's near side in the
     REMAINING tree (prune node excised, its two other edges merged at
     summed length — exactly moves.spr's relink). Each A[t] is ONE
     pruning op: combine the corrected CLV arriving from the prune site
     with the unchanged off-path directional CLV D[sibling];
  3. per candidate (p, t): the regraft splits t's branch in half
     (moves.spr: r.length/2 each side), so

        parent = (P(t.len/2) @ A[t]) * (P(t.len/2) @ D[t.back])
        logL   = edge_loglikelihood(parent, D[p.back], P(p.length))

     with scaler counts summed from the three contributing rows plus the
     parent product's own underflow event.

Per candidate this is ~3 op-equivalents instead of a full traversal —
at 1000 taxa a ~300x device-work reduction for the same scores (parity
asserted against full evaluation in tests/test_spr_stream.py).

All three passes run through ops.partials.update_partials_levels on ONE
extended buffer (partition rows | aux up rows | A rows | scratch), as
wavefront-packed level tables: fixed width W, ops greedily packed into
the earliest non-full wave after their dependencies, so padded work is
O(W * waves) over the op count instead of the rectangle blowup of
strict depth-levels. Wave counts and candidate counts pad to buckets so
a topology change almost never recompiles.

Eligibility (the search falls back to the batched full-traversal round
otherwise): per-site OR per-rate scalers, homogeneous models. Site
repeats stream through a dense tip-row base assembled in-program
(single device, every tip set). Ascertainment bias streams on single
devices (the synthetic all-state-k columns ride every pass; the
per-candidate correction is a vmapped _apply_asc) — under a mesh the
asc column block is global and stays on the batched rounds.
Site-sharded partitions (single- or multi-process) run the scoring body
per shard under `jax.shard_map` with ONE psum of the per-candidate logL
sums — the library's only collective.

Per-edge heterotachy (edge_params) is EXCLUDED by design, not by
omission: an SPR merges the prune node's two flanking branches into one
edge and splits the regraft branch in half, and when those branches
carry different rate matrices the merged/half edges have no
well-defined model (the reference has no heterotachy-under-SPR
semantics either — its consumers re-assign pmatrix indices after the
move). Heterotachy searches take the batched full-traversal rounds,
where every candidate is evaluated with its real per-edge P tables;
cost = the spr_round_1000_seconds row vs the streamed row in
BENCHMARKS.md (~8x).
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import List, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .likelihood import _finalize_site_lk, _mix_rates
from .partials import Operations, update_partials_levels
from . import pmatrix as ops_pmatrix

WAVE_W = 256          # ops per wave (one batched einsum launch)


def _bucket(n: int, m: int) -> int:
    return max(m, -(-n // m) * m)


def _pow2(n: int) -> int:
    k = 1
    while k < n:
        k *= 2
    return k


def pack_waves(rows: Sequence[Sequence[int]], deps: Sequence[int],
               scratch_clv: int, width: int = WAVE_W,
               wave_bucket: int = 4, min_waves: int = 0):
    """Greedy wavefront packing of op rows into [L, W] level tables.

    rows: 8-int op rows (update_partials_levels format); deps[i] lists
    the indices of the ops whose outputs op i consumes (possibly empty).
    An op lands in the earliest non-full wave strictly after ALL of its
    dependencies — op-index order says nothing about wave order (a deep
    child produced early can sit in a later wave than a shallow child
    produced late), so every dependency must be consulted. Returns
    (table [L, W, 8] np.int32, valid [L, W] bool).
    """
    n = len(rows)
    wave_of = np.empty(n, np.int64)
    fills: List[int] = []
    for i in range(n):
        w = 0
        for d in deps[i]:
            if d >= 0:
                w = max(w, wave_of[d] + 1)
        while w < len(fills) and fills[w] >= width:
            w += 1
        while w >= len(fills):
            fills.append(0)
        wave_of[i] = w
        fills[w] += 1
    L = _bucket(max(len(fills), min_waves, 1), wave_bucket)
    table = np.zeros((L, width, 8), np.int32)
    table[:, :, 0] = scratch_clv
    table[:, :, 1] = -1
    valid = np.zeros((L, width), bool)
    cursor = np.zeros(L, np.int64)
    for i in range(n):
        w = wave_of[i]
        k = cursor[w]
        table[w, k] = rows[i]
        valid[w, k] = True
        cursor[w] = k + 1
    return table, valid


class _LazyPairs:
    """(prune, target) UNode pairs materialized on access — a round only
    inspects the few top-ranked candidates of the ~10^4-entry list."""

    def __init__(self, prune_ids, tgt_ids, node_of):
        self._p, self._t, self._nodes = prune_ids, tgt_ids, node_of

    def __len__(self):
        return len(self._p)

    def __getitem__(self, i):
        return self._nodes[self._p[i]], self._nodes[self._t[i]]


def _scatter_table(rows: np.ndarray, wave: np.ndarray, scratch: int,
                   width: int, min_waves_val: int, wave_bucket: int = 4):
    """Vectorized assembly of a [L, W, 8] level table from dense rows +
    native greedy wave assignments (pack_waves' layout: within-wave
    order = creation order)."""
    n = rows.shape[0]
    n_waves = int(wave.max()) + 1 if n else 1
    L = _bucket(max(n_waves, min_waves_val, 1), wave_bucket)
    table = np.zeros((L, width, 8), np.int32)
    table[:, :, 0] = scratch
    table[:, :, 1] = -1
    valid = np.zeros((L, width), bool)
    if n:
        order = np.argsort(wave, kind="stable")
        w = wave[order]
        pos = np.arange(n) - np.searchsorted(w, w)
        table[w, pos] = rows[order]
        valid[w, pos] = True
    return table, valid


def build_spr_stream_native(tree, radius: int, n_nodes: int,
                            n_scalers: int, n_edges: int,
                            max_candidates=None, rng=None,
                            width: int = WAVE_W, min_waves=None):
    """Whole-round schedule via the native builder
    (native/pllnative.cpp pll_nat_spr_stream_{enum,build}): target
    enumeration, directional/postorder/corrected row emission and greedy
    wave assignment run in C++ over flat half-edge arrays; numpy
    scatters the tables and applies the pow2/zero-scaler padding. Rows,
    waves and candidate order are bit-identical to build_spr_stream
    (validated by test_spr_stream); rng subsampling stays host-side for
    stream parity with the batched rounds. Returns None without the
    native lib (callers fall back to the Python builder)."""
    from .. import native
    if native.load() is None:
        return None
    from ..search import _flatten_tree
    back, nxt, clv, scaler, pmat, length, node_of, ids = \
        _flatten_tree(tree)
    T = tree.tip_count
    vr = tree.vroot
    if vr.next is None:
        vr = vr.back
    enum = native.spr_stream_enum(back, nxt, T, radius)
    if enum is None:
        return None
    prune, goff, tgt, tpar, tsib = enum
    sizes = np.diff(goff)
    # the subsampling below consumes `rng`; if the native build fails
    # after that, restore the generator state so the caller's Python
    # fallback re-draws the SAME subsets (stream parity with the batched
    # rounds is a documented invariant)
    rng_state = rng.bit_generator.state if rng is not None else None
    if not max_candidates:
        # full round: kept = every target in order, per group
        kept = (np.arange(goff[-1], dtype=np.int64)
                - np.repeat(goff[:-1], sizes)).astype(np.int32)
        kept_off = goff.copy()
    else:
        kept_chunks = []
        for sz in sizes:
            sz = int(sz)
            if sz > max_candidates:
                kept_chunks.append(np.asarray(
                    rng.permutation(sz)[:max_candidates], np.int32))
            else:
                kept_chunks.append(np.arange(sz, dtype=np.int32))
        kept = (np.concatenate(kept_chunks) if kept_chunks
                else np.zeros(0, np.int32))
        kept_off = np.zeros(len(sizes) + 1, np.int64)
        if kept_chunks:
            np.cumsum([len(c) for c in kept_chunks], out=kept_off[1:])
    res = native.spr_stream_build(
        back, nxt, clv, scaler, pmat, length, T, ids[id(vr)], width,
        prune, goff, tgt, tpar, tsib, kept, kept_off,
        n_nodes, n_scalers, n_edges)
    if res is None:
        if rng_state is not None:
            rng.bit_generator.state = rng_state
        return None

    n_a = res["a_rows"].shape[0]
    n_aux = res["n_aux"]
    n_arows = _pow2(max(n_a, 1))
    scratch = n_nodes + n_aux + n_arows
    zero_sc = n_scalers + n_aux + n_arows + 1
    mw = min_waves or {}

    def fix(rows):
        rows = rows.copy()
        for col in (4, 7):
            rows[:, col] = np.where(rows[:, col] < 0, zero_sc,
                                    rows[:, col])
        return rows

    post_table, post_valid = _scatter_table(
        fix(res["post_rows"]), res["post_wave"], scratch, width,
        mw.get("post", 0))
    up_table, up_valid = _scatter_table(
        fix(res["up_rows"]), res["up_wave"], scratch, width,
        mw.get("up", 0))
    a_table, a_valid = _scatter_table(
        fix(res["a_rows"]), res["a_wave"], scratch, width,
        mw.get("a", 0))

    n_candidates = res["cand"].shape[0]
    C = _pow2(max(n_candidates, 1))
    cand_arr = np.zeros((C, 7), np.int32)
    hl = np.zeros(C)
    if n_candidates:
        cand_arr[:n_candidates] = res["cand"]
        cand_arr[n_candidates:] = res["cand"][-1]
        hl[:n_candidates] = res["half_len"]
        hl[n_candidates:] = res["half_len"][-1]
    cand_arr[:, (1, 3, 5)] = np.where(cand_arr[:, (1, 3, 5)] < 0,
                                      zero_sc, cand_arr[:, (1, 3, 5)])
    nm = res["merged_len"].shape[0]
    ml = np.zeros(_pow2(max(nm, 1)))
    ml[:nm] = res["merged_len"]
    blen_full = np.zeros(n_edges)
    linked = back >= 0
    blen_full[pmat[linked]] = length[linked]
    pairs = _LazyPairs(res["pair_prune"], res["pair_tgt"], node_of)
    return SprStreamSchedule(
        post_table=post_table, post_valid=post_valid,
        up_table=up_table, up_valid=up_valid,
        a_table=a_table, a_valid=a_valid,
        cand_rows=cand_arr, half_len=hl, blen_full=blen_full,
        merged_len=ml, n_candidates=n_candidates, n_aux=n_aux,
        n_arows=n_arows, pairs=pairs,
        rowmap=(ids, res["rowmap_clv"], res["rowmap_sc"]))


def ops_from_table(table: np.ndarray) -> Operations:
    # host-side slicing on purpose: the columns transfer with the jit
    # dispatch that consumes them. Slicing a device array here instead
    # costs 8 eager device ops per table — ~24 device round trips per
    # streamed round, which dominated the warm-round host share.
    t = np.asarray(table)
    col = lambda k: np.ascontiguousarray(t[:, :, k])  # noqa: E731
    return Operations(
        parent_clv=col(0), parent_scaler=col(1),
        child1_clv=col(2), child1_matrix=col(3),
        child1_scaler=col(4), child2_clv=col(5),
        child2_matrix=col(6), child2_scaler=col(7))


def enumerate_targets(p, radius: int):
    """Regraft targets within `radius` of the prune half-edge p, in the
    same DFS order and target set as search._radius_targets. Returns
    [(t, arrival_key, sibling)]: t points AWAY from the prune site;
    arrival_key is id() of the half-edge by which the walk entered t's
    node (p.next / p.next.next at depth 1, else the previous target);
    sibling is the node's third half-edge."""
    out = []
    stack = []
    for h in (p.next, p.next.next):
        if h.back is not None:
            stack.append((h.back, h, 1))
    while stack:
        nd, entry, d = stack.pop()
        if nd.is_tip() or d >= radius:
            continue
        for h, sib in ((nd.next, nd.next.next), (nd.next.next, nd.next)):
            if h.back is None:
                continue
            out.append((h, id(entry), sib))
            stack.append((h.back, h, d + 1))
    return out


@dataclass
class SprStreamSchedule:
    """Host-built tables for one streamed SPR round (all numpy)."""
    post_table: np.ndarray        # [Lp, W, 8] postorder refresh
    post_valid: np.ndarray
    up_table: np.ndarray          # [Lu, W, 8] directional up pass
    up_valid: np.ndarray
    a_table: np.ndarray           # [La, W, 8] corrected-CLV pass
    a_valid: np.ndarray
    cand_rows: np.ndarray         # [C, 7] a_row, a_sc, rb_row, rb_sc,
    #                                      pb_row, pb_sc, score_pm
    half_len: np.ndarray          # [C] regraft half lengths
    blen_full: np.ndarray         # [E] current branch length per pmatrix
    merged_len: np.ndarray        # [P] per-prune merged edge length
    n_candidates: int             # real candidates (<= C, rest padding)
    n_aux: int
    n_arows: int
    # indexable of (prune_halfedge, target_halfedge) pairs: a plain list
    # from the Python builder, a _LazyPairs view from the native one
    pairs: Sequence[Tuple]
    # Python builder: {id(halfedge): (clv_row, sc_row)}; native builder:
    # (ids, rowmap_clv, rowmap_sc) flat arrays — consumers type-sniff
    # (see build_nni_stream's `entry`)
    rowmap: "dict | tuple"


def build_spr_stream(tree, prune_targets, n_nodes: int, n_scalers: int,
                     n_edges: int, width: int = WAVE_W,
                     min_waves=None) -> SprStreamSchedule:
    """Build one round's tables from (prune half-edge, targets[, kept])
    groups.

    `prune_targets`: [(p, [(t, arrival_key, sibling), ...])] as produced
    by enumerate_targets — p's node plus the subtree at p.back is what
    moves.spr(p, t) prunes. An optional third group element lists the
    target indices to emit as candidates (subsampled rounds); corrected
    CLVs are then built only along the ancestor chains of kept targets.
    Row address space: [0, n_nodes) partition CLV rows, then n_aux up
    rows, then n_arows A rows, then one scratch row; scaler rows follow
    the same layout after the partition's n_scalers rows, with the trash
    and guaranteed-zero rows last.
    """
    vroot = tree.vroot
    if vroot.next is None:
        vroot = vroot.back
    vback = vroot.back

    base_aux = n_nodes
    sc_aux = n_scalers
    rowmap = {}          # id(halfedge) -> (clv_row, sc_row or -1)

    def down_entry(h):
        sc = h.scaler_index
        return (h.clv_index, sc if sc is not None and sc >= 0 else -1)

    blen_full = np.zeros(n_edges)
    for node in tree.nodes():
        halves = [node] if node.is_tip() else list(node.ring())
        for h in halves:
            if h.back is not None:
                blen_full[h.pmatrix_index] = h.length or 0.0

    up_rows: List[List[int]] = []
    up_deps: List[int] = []
    n_aux = 0

    def new_aux():
        nonlocal n_aux
        k = n_aux
        n_aux += 1
        return base_aux + k, sc_aux + k

    rowmap[id(vroot)] = down_entry(vroot)
    rowmap[id(vback)] = down_entry(vback)

    def recurse(u, parent_mat, pside_row, pside_sc, pside_op):
        """u: half-edge of the current node toward the parent side;
        (pside_row, pside_sc) hold D[toward-parent direction] seen from
        this node; pside_op is the up-op index producing it (-1 when it
        is a postorder row). Iterative to survive 1000-taxon
        caterpillars (CPython recursion limit)."""
        stack = [(u, parent_mat, pside_row, pside_sc, pside_op)]
        while stack:
            u, parent_mat, pside_row, pside_sc, pside_op = stack.pop()
            rowmap[id(u)] = down_entry(u)
            if u.is_tip():
                continue
            for hc, hsib in ((u.next, u.next.next),
                             (u.next.next, u.next)):
                crow, csc = new_aux()
                rowmap[id(hc)] = (crow, csc)
                sib_row, sib_sc = down_entry(hsib.back)
                up_rows.append([crow, csc,
                                pside_row, parent_mat, pside_sc,
                                sib_row, hsib.pmatrix_index, sib_sc])
                up_deps.append([pside_op])
                stack.append((hc.back, hc.pmatrix_index, crow, csc,
                              len(up_rows) - 1))

    rmat = vroot.pmatrix_index
    recurse(vback, rmat, *down_entry(vroot), -1)
    recurse(vroot, rmat, *down_entry(vback), -1)

    # postorder refresh of the down rows
    from ..trees.utree import traverse
    from ..trees import create_operations
    operations, _, _ = create_operations(traverse(tree.vroot))
    post_rows, post_deps = [], []
    producer = {}
    for op in operations:
        post_rows.append([op.parent_clv_index, op.parent_scaler_index,
                          op.child1_clv_index, op.child1_matrix_index,
                          op.child1_scaler_index, op.child2_clv_index,
                          op.child2_matrix_index, op.child2_scaler_index])
        post_deps.append([producer.get(op.child1_clv_index, -1),
                          producer.get(op.child2_clv_index, -1)])
        producer[op.parent_clv_index] = len(post_rows) - 1

    # corrected-CLV (A) pass + candidate rows, per prune group
    a_rows: List[List[int]] = []
    a_deps: List[int] = []
    cand: List[List[int]] = []
    half_len: List[float] = []
    merged_len: List[float] = []
    pairs: List[Tuple] = []
    base_a = base_aux + n_aux
    sc_a = sc_aux + n_aux

    for group in prune_targets:
        p, targets = group[0], group[1]
        kept = group[2] if len(group) > 2 else None
        if not targets or (kept is not None and len(kept) == 0):
            continue
        if kept is not None:
            # a kept target needs the corrected CLVs of its whole
            # ancestor chain back to the prune site
            tix = {id(t): i for i, (t, _, _) in enumerate(targets)}
            needed = set()
            for i in kept:
                cur = i
                while cur is not None and cur not in needed:
                    needed.add(cur)
                    cur = tix.get(targets[cur][1])
        merged_len.append((p.next.back.length or 0.0)
                          + (p.next.next.back.length or 0.0))
        mi = n_edges + len(merged_len) - 1        # merged pmatrix index
        pb_row, pb_sc = rowmap[id(p.back)]
        # per-node arrival state keyed by the half-edge the walk entered
        # through: (clv_row, sc_row, pmatrix index, producing a-op)
        arrive = {id(p.next): (*rowmap[id(p.next.next.back)], mi, -1),
                  id(p.next.next): (*rowmap[id(p.next.back)], mi, -1)}
        slot_of = {}
        for i, (t, akey, sib) in enumerate(targets):
            if kept is not None and i not in needed:
                continue
            x_row, x_sc, gmat, gop = arrive[akey]
            sib_row, sib_sc = rowmap[id(sib.back)]
            k = len(a_rows)
            arow, asc = base_a + k, sc_a + k
            a_rows.append([arow, asc, x_row, gmat, x_sc,
                           sib_row, sib.pmatrix_index, sib_sc])
            a_deps.append([gop])
            arrive[id(t)] = (arow, asc, t.pmatrix_index, k)
            slot_of[i] = (arow, asc)
        for i in (range(len(targets)) if kept is None else kept):
            t, akey, sib = targets[i]
            arow, asc = slot_of[i]
            rb_row, rb_sc = rowmap[id(t.back)]
            cand.append([arow, asc, rb_row, rb_sc, pb_row, pb_sc,
                         p.pmatrix_index])
            half_len.append((t.length or 0.0) / 2.0)
            pairs.append((p, t))

    n_candidates = len(cand)
    n_arows = _pow2(max(len(a_rows), 1))
    scratch = base_a + n_arows
    zero_sc = sc_a + n_arows + 1                 # trash, zero rows last

    def fix_sc(rows):
        for r in rows:
            for col in (4, 7):
                if r[col] < 0:
                    r[col] = zero_sc
        return rows

    # wave counts follow the tree's depth; `min_waves` floors (callers
    # carry the historical max) keep the compiled shapes monotone so a
    # depth wobble across rounds cannot recompile
    mw = min_waves or {}
    post_table, post_valid = pack_waves(fix_sc(post_rows), post_deps,
                                        scratch, width,
                                        min_waves=mw.get("post", 0))
    up_table, up_valid = pack_waves(fix_sc(up_rows), up_deps, scratch,
                                    width, min_waves=mw.get("up", 0))
    a_table, a_valid = pack_waves(fix_sc(a_rows), a_deps, scratch, width,
                                  min_waves=mw.get("a", 0))

    C = _pow2(max(n_candidates, 1))
    cand_arr = np.zeros((C, 7), np.int32)
    hl = np.zeros(C)
    if n_candidates:
        cand_arr[:n_candidates] = cand
        cand_arr[n_candidates:] = cand[-1]   # pad: harmless recompute
        hl[:n_candidates] = half_len
        hl[n_candidates:] = half_len[-1] if half_len else 0.0
    cand_arr[:, (1, 3, 5)] = np.where(cand_arr[:, (1, 3, 5)] < 0,
                                      zero_sc, cand_arr[:, (1, 3, 5)])
    # merged pmatrix count pads to a power of two: the prune-group count
    # shifts by a few per topology and must not change program shapes
    # (pad entries are computed-but-unreferenced identity-at-0 matrices)
    ml = np.zeros(_pow2(max(len(merged_len), 1)))
    ml[:len(merged_len)] = merged_len
    return SprStreamSchedule(
        post_table=post_table, post_valid=post_valid,
        up_table=up_table, up_valid=up_valid,
        a_table=a_table, a_valid=a_valid,
        cand_rows=cand_arr, half_len=hl, blen_full=blen_full,
        merged_len=ml,
        n_candidates=n_candidates, n_aux=n_aux, n_arows=n_arows,
        pairs=pairs, rowmap=rowmap)


def build_nni_stream(tree, edges, n_nodes: int, n_scalers: int,
                     n_edges: int, width: int = WAVE_W, min_waves=None):
    """NNI analog of build_spr_stream: both alternatives of every
    internal edge scored from BASELINE directional CLVs only (an NNI
    swaps two subtrees across an edge; all four flanking directional
    CLVs are unchanged, and moves._swap keeps each branch with its
    node-side stub). Returns (schedule, moves) where schedule reuses
    SprStreamSchedule with cand_rows [C, 13]:

      [c_row, c_sc, c_pm, b_row, b_sc, b_pm,
       a_row, a_sc, a_pm, d_row, d_sc, d_pm, center_pm]

    scoring parent = (P[c_pm] @ D[C]) * (P[b_pm] @ D[B]) at p's node and
    child = (P[a_pm] @ D[A]) * (P[d_pm] @ D[D]) at q's node, across the
    central edge — exactly what moves.nni + a full evaluation computes.
    `moves` lists (edge, move_type) aligned with cand rows.
    """
    from .. import constants as C

    sched = build_spr_stream_native(tree, 0, n_nodes, n_scalers,
                                    n_edges, width=width,
                                    min_waves=min_waves)
    if sched is None:
        sched = build_spr_stream(tree, [], n_nodes, n_scalers, n_edges,
                                 width=width, min_waves=min_waves)
    rowmap = sched.rowmap
    zero_sc = n_scalers + sched.n_aux + sched.n_arows + 1

    if isinstance(rowmap, dict):
        def entry(h):
            row, sc = rowmap[id(h)]
            return row, (sc if sc >= 0 else zero_sc)
    else:                      # native: (ids, rowmap_clv, rowmap_sc)
        ids, rm_clv, rm_sc = rowmap

        def entry(h):
            hid = ids[id(h)]
            sc = int(rm_sc[hid])
            return int(rm_clv[hid]), (sc if sc >= 0 else zero_sc)

    cand: List[List[int]] = []
    mv: List[Tuple] = []
    for p in edges:
        q = p.back
        a = p.next            # subtree1 stub (swapped in both moves)
        b = p.next.next
        for kind, t2 in ((C.UTREE_MOVE_NNI_LEFT, q.next),
                         (C.UTREE_MOVE_NNI_RIGHT, q.next.next)):
            d = q.next.next if t2 is q.next else q.next
            c_row, c_sc = entry(t2.back)
            b_row, b_sc = entry(b.back)
            a_row, a_sc = entry(a.back)
            d_row, d_sc = entry(d.back)
            cand.append([c_row, c_sc, t2.pmatrix_index,
                         b_row, b_sc, b.pmatrix_index,
                         a_row, a_sc, a.pmatrix_index,
                         d_row, d_sc, d.pmatrix_index,
                         p.pmatrix_index])
            mv.append((p, kind))
    n_candidates = len(cand)
    Cp = _pow2(max(n_candidates, 1))
    cand_arr = np.zeros((Cp, 13), np.int32)
    if n_candidates:
        cand_arr[:n_candidates] = cand
        cand_arr[n_candidates:] = cand[-1]
    sched.cand_rows = cand_arr
    sched.n_candidates = n_candidates
    sched.pairs = mv
    return sched


def _extend_buffers(clv, scaler, n_aux: int, n_arows: int,
                    base=None, rate_cats: int = 0,
                    rate_scalers: bool = False):
    """Per-shard extended buffers: partition rows | aux up rows | A rows
    | scratch (CLV) and partition rows | aux | A | trash | zero
    (scalers).

    With `base=(n_rows, n_scaler_rows)` the `clv` operand is DENSE TIP
    ROWS [tips, states, S] of a pooled site-repeats partition (which has
    no dense per-site buffers) and `scaler` is ignored: the dense base
    is assembled in-program — tips broadcast over `rate_cats`, inner
    rows/scalers zero, which is sufficient because the postorder pass
    rebuilds every inner row and scaler from scratch (only tip rows
    carry information into the streamed scoring)."""
    dtype = clv.dtype
    extra = n_aux + n_arows
    if base is not None:
        n_rows, n_sc = base
        T, s, S = clv.shape
        clv_ext = jnp.zeros((n_rows + extra + 1, rate_cats, s, S), dtype)
        clv_ext = clv_ext.at[:T].set(
            jnp.broadcast_to(clv[:, None], (T, rate_cats, s, S)))
        sc_shape = ((n_sc + extra + 2, rate_cats, S) if rate_scalers
                    else (n_sc + extra + 2, S))
        return clv_ext, jnp.zeros(sc_shape, jnp.int32)
    K = scaler.shape[0] - 2
    clv_ext = jnp.concatenate(
        [clv, jnp.zeros((extra + 1,) + clv.shape[1:], dtype)], axis=0)
    sc_ext = jnp.concatenate(
        [scaler[:K], jnp.zeros((extra + 2,) + scaler.shape[1:],
                               scaler.dtype)], axis=0)
    return clv_ext, sc_ext


def _site_totals(terma_r, site_sc, f, pinv, rate_weights, invariant, pw,
                 scale_threshold: float, dtype,
                 rate_scalers: bool = False,
                 asc_type: int = 0, n_real: int = -1):
    """[c, R, S] per-rate site terms + [c, S] (or [c, R, S] per-rate
    mode) scaler counts -> [c] pattern-weighted logL sums (the
    edge-likelihood epilogue, reference likelihood.c:586 semantics incl.
    the capped per-rate undo of core_likelihood.c:1463, batched over
    candidates). With asc (`n_real` >= 0) the per-candidate correction
    is computed from the synthetic all-state-k columns, which ride the
    directional/corrected passes like ordinary sites (reference
    likelihood.c:24-117 batched over candidates)."""
    if rate_scalers:
        from .likelihood import _site_scalings

        def mix_one_r(tr, sc):
            s, rf = _site_scalings(sc, True, scale_threshold, dtype)
            ta, ti = _mix_rates(tr, rf, f, pinv, rate_weights,
                                invariant, dtype)
            return ta, ti, s

        terma, terminv, site_sc = jax.vmap(mix_one_r)(terma_r, site_sc)
    else:
        def mix_one(tr):
            return _mix_rates(tr, None, f, pinv, rate_weights,
                              invariant, dtype)

        terma, terminv = jax.vmap(mix_one)(terma_r)

    def fin_one(ta, ti, sc):
        return _finalize_site_lk(ta, ti, sc, scale_threshold, dtype)

    site_lk = jax.vmap(fin_one)(terma, terminv, site_sc)
    if asc_type or n_real >= 0:
        from .likelihood import _apply_asc
        states = f.shape[1]

        def asc_one(sl, ta, sc):
            return _apply_asc(sl, ta, sc, pw, asc_type, n_real, states,
                              scale_threshold, dtype)[0]

        return jax.vmap(asc_one)(site_lk, terma, site_sc)
    weighted = jnp.where(pw[None, :] > 0, site_lk * pw[None, :], 0.0)
    return jnp.sum(weighted, axis=1)


def _nni_core(clv, scaler, pm_full, post_ops, post_valid, up_ops,
              up_valid, cand_rows, pattern_weights, invariant,
              f, pinv, rate_weights,
              scale_threshold: float, scale_factor: float,
              n_aux: int, n_arows: int, chunk: int, axis,
              rate_scalers: bool = False, base=None,
              asc_type: int = 0, n_real: int = -1):
    """Per-shard NNI scoring body (everything after the replicated
    pmatrix computation). `axis` is the mesh axis name for the final
    logL psum, or None single-device."""
    dtype = clv.dtype
    clv_ext, sc_ext = _extend_buffers(clv, scaler, n_aux, n_arows,
                                      base=base,
                                      rate_cats=pm_full.shape[1],
                                      rate_scalers=rate_scalers)
    for ops, valid in ((post_ops, post_valid), (up_ops, up_valid)):
        clv_ext, sc_ext = update_partials_levels(
            clv_ext, sc_ext, pm_full, ops, valid,
            scale_threshold, scale_factor, rate_scalers=rate_scalers)

    thresh = jnp.asarray(scale_threshold, dtype)
    factor = jnp.asarray(scale_factor, dtype)
    HI = jax.lax.Precision.HIGHEST
    pw = pattern_weights.astype(dtype)
    C = cand_rows.shape[0]
    n_chunks = max(C // chunk, 1)

    def compose(rows, i0):
        """(P[pm1] @ D[row1]) * (P[pm2] @ D[row2]) with the underflow
        check a real traversal applies at this node."""
        x1 = jnp.take(clv_ext, rows[:, i0], axis=0)
        s1 = jnp.take(sc_ext, rows[:, i0 + 1], axis=0)
        p1 = jnp.take(pm_full, rows[:, i0 + 2], axis=0)
        x2 = jnp.take(clv_ext, rows[:, i0 + 3], axis=0)
        s2 = jnp.take(sc_ext, rows[:, i0 + 4], axis=0)
        p2 = jnp.take(pm_full, rows[:, i0 + 5], axis=0)
        x = (jnp.einsum('crij,crjs->cris', p1, x1,
                        preferred_element_type=dtype, precision=HI)
             * jnp.einsum('crij,crjs->cris', p2, x2,
                          preferred_element_type=dtype, precision=HI))
        if rate_scalers:
            mask = jnp.all(x < thresh, axis=2)           # [c, R, S]
            x = jnp.where(mask[:, :, None, :], x * factor, x)
        else:
            mask = jnp.all(x < thresh, axis=(1, 2))      # [c, S]
            x = jnp.where(mask[:, None, None, :], x * factor, x)
        return x, s1 + s2 + mask.astype(s1.dtype)

    def score_chunk(carry, rows):
        parent, psc = compose(rows, 0)
        child, csc = compose(rows, 6)
        pe = jnp.take(pm_full, rows[:, 12], axis=0)
        termb = jnp.einsum('crjk,crks->crjs', pe, child,
                           preferred_element_type=dtype, precision=HI)
        terma_r = jnp.einsum('crjs,rj->crs', parent * termb, f,
                             preferred_element_type=dtype, precision=HI)
        return carry, _site_totals(terma_r, psc + csc, f, pinv,
                                   rate_weights, invariant, pw,
                                   scale_threshold, dtype,
                                   rate_scalers=rate_scalers,
                                   asc_type=asc_type, n_real=n_real)

    _, totals = jax.lax.scan(score_chunk, 0,
                             cand_rows.reshape(n_chunks, -1, 13))
    totals = totals.reshape(-1)
    if axis is not None:
        totals = jax.lax.psum(totals, axis)
    return totals


def _spr_core(clv, scaler, pm_ext, pm_full, pm_half, post_ops,
              post_valid, up_ops, up_valid, a_ops, a_valid, cand_rows,
              pattern_weights, invariant, f, pinv, rate_weights,
              scale_threshold: float, scale_factor: float,
              n_aux: int, n_arows: int, chunk: int, axis,
              rate_scalers: bool = False, base=None,
              asc_type: int = 0, n_real: int = -1):
    """Per-shard streamed-SPR scoring body (post-pmatrix)."""
    dtype = clv.dtype
    clv_ext, sc_ext = _extend_buffers(clv, scaler, n_aux, n_arows,
                                      base=base,
                                      rate_cats=pm_full.shape[1],
                                      rate_scalers=rate_scalers)
    for ops, valid in ((post_ops, post_valid), (up_ops, up_valid),
                       (a_ops, a_valid)):
        clv_ext, sc_ext = update_partials_levels(
            clv_ext, sc_ext, pm_ext, ops, valid,
            scale_threshold, scale_factor, rate_scalers=rate_scalers)

    thresh = jnp.asarray(scale_threshold, dtype)
    factor = jnp.asarray(scale_factor, dtype)
    HI = jax.lax.Precision.HIGHEST
    pw = pattern_weights.astype(dtype)
    C = cand_rows.shape[0]
    n_chunks = max(C // chunk, 1)

    def score_chunk(carry, xs):
        rows, ph = xs
        A = jnp.take(clv_ext, rows[:, 0], axis=0)        # [c, R, s, S]
        Asc = jnp.take(sc_ext, rows[:, 1], axis=0)       # [c, S]
        Drb = jnp.take(clv_ext, rows[:, 2], axis=0)
        Drbsc = jnp.take(sc_ext, rows[:, 3], axis=0)
        Dpb = jnp.take(clv_ext, rows[:, 4], axis=0)
        Dpbsc = jnp.take(sc_ext, rows[:, 5], axis=0)
        pe = jnp.take(pm_full, rows[:, 6], axis=0)       # [c, R, s, s]
        cm = (jnp.einsum('crij,crjs->cris', ph, A,
                         preferred_element_type=dtype, precision=HI)
              * jnp.einsum('crij,crjs->cris', ph, Drb,
                           preferred_element_type=dtype, precision=HI))
        # the regraft node's own underflow event (a real traversal
        # scales this product exactly like any other op; per-rate mode
        # tracks the event per rate category, core_partials.c:760)
        if rate_scalers:
            mask = jnp.all(cm < thresh, axis=2)          # [c, R, S]
            cm = jnp.where(mask[:, :, None, :], cm * factor, cm)
        else:
            mask = jnp.all(cm < thresh, axis=(1, 2))     # [c, S]
            cm = jnp.where(mask[:, None, None, :], cm * factor, cm)
        termb = jnp.einsum('crjk,crks->crjs', pe, Dpb,
                           preferred_element_type=dtype, precision=HI)
        terma_r = jnp.einsum('crjs,rj->crs', cm * termb, f,
                             preferred_element_type=dtype, precision=HI)
        site_sc = Asc + Drbsc + Dpbsc + mask.astype(Asc.dtype)
        return carry, _site_totals(terma_r, site_sc, f, pinv,
                                   rate_weights, invariant, pw,
                                   scale_threshold, dtype,
                                   rate_scalers=rate_scalers,
                                   asc_type=asc_type, n_real=n_real)

    rows_c = cand_rows.reshape(n_chunks, -1, 7)
    ph_c = pm_half.reshape((n_chunks, -1) + pm_half.shape[1:])
    _, totals = jax.lax.scan(score_chunk, 0, (rows_c, ph_c))
    totals = totals.reshape(-1)
    if axis is not None:
        totals = jax.lax.psum(totals, axis)
    return totals


def _shard_specs(rate_scalers: bool = False):
    """(clv, scaler, site-vector, replicated) PartitionSpecs + axis name
    for the shard-mapped scoring cores; per-rate scaler buffers are
    [K, R, S] so their site axis moves one position right."""
    from jax.sharding import PartitionSpec as P

    from ..parallel.sharding import SITES_AXIS
    sc = (P(None, None, SITES_AXIS) if rate_scalers
          else P(None, SITES_AXIS))
    return P(None, None, None, SITES_AXIS), sc, \
        P(SITES_AXIS), P(), SITES_AXIS


@partial(jax.jit, static_argnames=('scale_threshold', 'scale_factor',
                                   'n_aux', 'n_arows', 'chunk', 'mesh',
                                   'rate_scalers', 'base', 'asc_type',
                                   'n_real'))
def nni_stream_scores(clv, scaler,
                      eigenvals, inv_eigenvecs, eigenvecs, prop_invar,
                      rates, rate_weights, freqs, params_idx_rates,
                      post_ops, post_valid, up_ops, up_valid,
                      blen_full, cand_rows,      # [C, 13] int32
                      pattern_weights, invariant,
                      scale_threshold: float, scale_factor: float,
                      n_aux: int, n_arows: int, chunk: int = 256,
                      mesh=None, rate_scalers: bool = False,
                      base=None, asc_type: int = 0, n_real: int = -1):
    """All NNI candidate logLs of one round in ONE program (directional
    CLVs only — no corrected pass). Returns totals [C]. With `mesh`
    (site-sharded partitions) the body runs per shard via shard_map and
    the logL sums psum over the site axis — the library's only
    collective (SURVEY §2.3). With `base=(n_rows, n_scaler_rows)` the
    clv operand is dense tip rows of a pooled site-repeats partition
    (see _extend_buffers; single-device only)."""
    dtype = clv.dtype
    pm_full = ops_pmatrix.update_prob_matrices(
        eigenvals, inv_eigenvecs, eigenvecs, prop_invar, rates,
        params_idx_rates, blen_full)
    f = jnp.take(freqs, params_idx_rates, axis=0).astype(dtype)
    pinv = jnp.take(prop_invar, params_idx_rates, axis=0)
    if mesh is None:
        return _nni_core(clv, scaler, pm_full, post_ops, post_valid,
                         up_ops, up_valid, cand_rows, pattern_weights,
                         invariant, f, pinv, rate_weights,
                         scale_threshold, scale_factor, n_aux, n_arows,
                         chunk, None, rate_scalers=rate_scalers,
                         base=base, asc_type=asc_type, n_real=n_real)
    from jax import shard_map
    clv_s, sc_s, site_s, rep, axis = _shard_specs(rate_scalers)
    core = partial(_nni_core, scale_threshold=scale_threshold,
                   scale_factor=scale_factor, n_aux=n_aux,
                   n_arows=n_arows, chunk=chunk, axis=axis,
                   rate_scalers=rate_scalers)
    return shard_map(
        core, mesh=mesh,
        in_specs=(clv_s, sc_s, rep, rep, rep, rep, rep, rep,
                  site_s, site_s, rep, rep, rep),
        out_specs=rep,
    )(clv, scaler, pm_full, post_ops, post_valid, up_ops, up_valid,
      cand_rows, pattern_weights, invariant, f, pinv, rate_weights)


@partial(jax.jit, static_argnames=('scale_threshold', 'scale_factor',
                                   'n_aux', 'n_arows', 'chunk', 'mesh',
                                   'rate_scalers', 'base', 'asc_type',
                                   'n_real'))
def spr_stream_scores(clv, scaler,
                      eigenvals, inv_eigenvecs, eigenvecs, prop_invar,
                      rates, rate_weights, freqs, params_idx_rates,
                      post_ops, post_valid, up_ops, up_valid,
                      a_ops, a_valid,
                      blen_full, merged_len, half_len,
                      cand_rows,               # [C, 7] int32
                      pattern_weights, invariant,
                      scale_threshold: float, scale_factor: float,
                      n_aux: int, n_arows: int, chunk: int = 256,
                      mesh=None, rate_scalers: bool = False,
                      base=None, asc_type: int = 0, n_real: int = -1):
    """All candidate logLs of one streamed SPR round in ONE program.

    Returns totals [C] (padded tail repeats the last real candidate).
    With `mesh` (site-sharded partitions) the body runs per shard via
    shard_map — pmatrices are computed once (replicated), the three CLV
    passes and the scoring are site-elementwise per shard, and the
    per-candidate logL sums psum over the site axis. With
    `base=(n_rows, n_scaler_rows)` the clv operand is dense tip rows of
    a pooled site-repeats partition (see _extend_buffers; single-device
    only)."""
    dtype = clv.dtype
    pm_full = ops_pmatrix.update_prob_matrices(
        eigenvals, inv_eigenvecs, eigenvecs, prop_invar, rates,
        params_idx_rates, blen_full)
    pm_merged = ops_pmatrix.update_prob_matrices(
        eigenvals, inv_eigenvecs, eigenvecs, prop_invar, rates,
        params_idx_rates, merged_len)
    pm_ext = jnp.concatenate([pm_full, pm_merged], axis=0)
    pm_half = ops_pmatrix.update_prob_matrices(
        eigenvals, inv_eigenvecs, eigenvecs, prop_invar, rates,
        params_idx_rates, half_len)
    f = jnp.take(freqs, params_idx_rates, axis=0).astype(dtype)
    pinv = jnp.take(prop_invar, params_idx_rates, axis=0)
    if mesh is None:
        return _spr_core(clv, scaler, pm_ext, pm_full, pm_half,
                         post_ops, post_valid, up_ops, up_valid,
                         a_ops, a_valid, cand_rows, pattern_weights,
                         invariant, f, pinv, rate_weights,
                         scale_threshold, scale_factor, n_aux, n_arows,
                         chunk, None, rate_scalers=rate_scalers,
                         base=base, asc_type=asc_type, n_real=n_real)
    from jax import shard_map
    clv_s, sc_s, site_s, rep, axis = _shard_specs(rate_scalers)
    core = partial(_spr_core, scale_threshold=scale_threshold,
                   scale_factor=scale_factor, n_aux=n_aux,
                   n_arows=n_arows, chunk=chunk, axis=axis,
                   rate_scalers=rate_scalers)
    return shard_map(
        core, mesh=mesh,
        in_specs=(clv_s, sc_s, rep, rep, rep, rep, rep, rep, rep,
                  rep, rep, rep, site_s, site_s, rep, rep, rep),
        out_specs=rep,
    )(clv, scaler, pm_ext, pm_full, pm_half, post_ops, post_valid,
      up_ops, up_valid, a_ops, a_valid, cand_rows, pattern_weights,
      invariant, f, pinv, rate_weights)
