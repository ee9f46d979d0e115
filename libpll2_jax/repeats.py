"""Site repeats — compute each distinct subtree site pattern once.

Device-native re-design of the fork's signature optimization (reference:
/root/reference/src/repeats.c). Semantics preserved:

  * a node's site **class** is the identity of the site pattern restricted
    to the node's subtree; tips class sites by their character
    (repeats.c:189-254), inner nodes by the pair (left class, right class)
    (repeats.c:334-347), in first-occurrence order;
  * repeats are disabled per node (class id count = 0, identity mapping)
    when a child has no classes or more than sites/2, or when the pair
    space would overflow (pll_default_enable_repeats, repeats.c:100-110),
    or when compression yields nothing (ids == sites, repeats.c:366-371);
  * parent scalers propagate through the class indirection
    (repeats.c:392-540).

Where the reference reallocates every CLV to its class count
(repeats.c:256-296) — shape-hostile for XLA — we keep dense
[node, rate, state, site] buffers and exploit a structural monotonicity:
a parent has at least as many classes as either child, so scheduling
operations in increasing **capacity buckets** (class count rounded up to a
lane-aligned bucket) preserves postorder dependencies. Each bucket executes
as one compiled scan whose kernels compute only `bucket_width` class
columns, gathered from child class columns — the compute saving the
reference gets from compressed CLVs, without dynamic shapes. Class
identification is a host-side first-occurrence dedup (numpy C speed, the
analog of the reference's O(1) lookup-buffer pass).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

import numpy as np

from .partition import Operation

LOOKUP_BUFFER_SIZE = 2_000_000       # pll.h:128 PLL_REPEATS_LOOKUP_SIZE


def _first_occurrence_classes(codes: np.ndarray
                              ) -> Tuple[np.ndarray, np.ndarray, int]:
    """(site_id, id_site, ids) with classes numbered in first-occurrence
    order over the site axis (the reference's lookup-buffer fill order)."""
    uniq, first_idx, inv = np.unique(codes, return_index=True,
                                     return_inverse=True)
    order = np.argsort(first_idx, kind="stable")
    rank = np.empty_like(order)
    rank[order] = np.arange(order.size)
    site_id = rank[inv.reshape(-1)].astype(np.int32)
    id_site = first_idx[order].astype(np.int32)
    return site_id, id_site, int(uniq.size)


@dataclass
class RepeatsTable:
    """Per-node class structure for one partition."""
    nodes: int
    sites: int
    site_id: np.ndarray = field(init=False)   # [nodes, sites] int32
    id_site: np.ndarray = field(init=False)   # [nodes, sites] int32
    ids: np.ndarray = field(init=False)       # [nodes] int32; 0 = plain

    def __post_init__(self):
        # identity mapping = repeats disabled
        ident = np.tile(np.arange(self.sites, dtype=np.int32),
                        (self.nodes, 1))
        self.site_id = ident.copy()
        self.id_site = ident.copy()
        self.ids = np.zeros(self.nodes, dtype=np.int32)

    def reset_node(self, node: int) -> None:
        """Restore the identity mapping (repeats disabled) for one node —
        used when a tip CLV is overwritten with raw probabilities that have
        no state code to class by."""
        ident = np.arange(self.sites, dtype=np.int32)
        self.site_id[node, :] = ident
        self.id_site[node, :] = ident
        self.ids[node] = 0

    def classes(self, node: int) -> int:
        """Effective class count (sites when repeats are off)."""
        n = int(self.ids[node])
        return n if n else self.sites

    def set_tip(self, tip_index: int, codes: np.ndarray) -> None:
        """Class tips by state code (pll_update_repeats_tips)."""
        from . import native
        nat = native.repeats_tips(np.asarray(codes, dtype=np.uint64))
        if nat is not None:
            site_id, id_site, ids = nat
        else:
            site_id, id_site, ids = _first_occurrence_classes(codes)
        self.site_id[tip_index, :] = site_id
        self.id_site[tip_index, :ids] = id_site
        self.id_site[tip_index, ids:] = 0
        self.ids[tip_index] = ids

    def enable_for(self, left: int, right: int) -> bool:
        """pll_default_enable_repeats (repeats.c:100-110)."""
        li, ri = int(self.ids[left]), int(self.ids[right])
        if not li or not ri:
            return False
        if li * ri >= LOOKUP_BUFFER_SIZE:
            return False
        return li <= self.sites // 2 and ri <= self.sites // 2

    def update_op(self, op: Operation) -> None:
        """Class the parent by (left class, right class) pairs
        (pll_update_repeats, repeats.c:299-383)."""
        p = op.parent_clv_index
        l, r = op.child1_clv_index, op.child2_clv_index
        if not self.enable_for(l, r):
            self.ids[p] = 0
            self.site_id[p, :] = np.arange(self.sites, dtype=np.int32)
            self.id_site[p, :] = np.arange(self.sites, dtype=np.int32)
            return
        from . import native
        nat = native.repeats_update(self.site_id[l], self.site_id[r],
                                    int(self.ids[l]),
                                    int(self.ids[l]) * int(self.ids[r]))
        if nat is not None:
            site_id, id_site, ids = nat
        else:
            codes = (self.site_id[l].astype(np.int64)
                     + self.site_id[r].astype(np.int64) * int(self.ids[l]))
            site_id, id_site, ids = _first_occurrence_classes(codes)
        if ids >= self.sites:         # no compression: force plain
            self.ids[p] = 0
            self.site_id[p, :] = np.arange(self.sites, dtype=np.int32)
            self.id_site[p, :] = np.arange(self.sites, dtype=np.int32)
            return
        self.ids[p] = ids
        self.site_id[p, :] = site_id
        self.id_site[p, :ids] = id_site
        self.id_site[p, ids:] = 0

    def gathers_for(self, op: Operation) -> Tuple[np.ndarray, np.ndarray,
                                                  int]:
        """Child class-column index per parent class (the kernel's gather
        maps): gl[c] = left class feeding parent class c. Width = parent's
        effective class count."""
        p = op.parent_clv_index
        l, r = op.child1_clv_index, op.child2_clv_index
        width = self.classes(p)
        rep = self.id_site[p, :width] if self.ids[p] \
            else np.arange(width, dtype=np.int32)
        gl = self.site_id[l, rep]
        gr = self.site_id[r, rep]
        return gl.astype(np.int32), gr.astype(np.int32), width


@dataclass
class FlatLayout:
    """Pooled class-column storage map: the device analog of the reference's
    per-node CLV reallocation (repeats.c:256-296 reallocate_repeats).

    Instead of dense [node, rate, state, sites] buffers, a repeats
    partition stores one flat column pool [rate, state, total]: node n owns
    columns [off[n], off[n]+cap[n]) where cap[n] is its class count rounded
    to a lane-aligned bucket. Scalers pool likewise, with two extra
    full-width regions: trash (absorbs junk writes) and a guaranteed-zero
    region (serves SCALE_BUFFER_NONE reads). Memory = sum of caps — the
    reference's -30% footprint win, shape-static for XLA."""
    caps: np.ndarray        # [nodes] int64 column capacity per node
    off: np.ndarray         # [nodes] int64 column offset per node
    total: int              # flat column count (incl. scratch tail)
    sc_caps: np.ndarray     # [K] per-scaler capacities
    sc_off: np.ndarray      # [K] scaler offsets
    sc_trash: int           # offset of the trash region (width = sites)
    sc_zero: int            # offset of the guaranteed-zero region
    sc_total: int


def build_flat_layout(table: RepeatsTable, scaler_of: dict,
                      sites: int, scale_buffers: int,
                      lane: int = 128) -> FlatLayout:
    """Column-pool layout from the current class table.

    scaler_of: {scaler_index -> list of nodes writing it} (from the
    schedule); a scaler's capacity is its largest writer's capacity (so a
    reused scaler slot never overruns its region). The pool ends with a
    `sites`-wide scratch tail so fixed-width child windows may read past
    the last node's region without going out of bounds."""
    nodes = table.nodes
    s_pad = -(-sites // lane) * lane        # lane-aligned width ceiling
    caps = np.zeros(nodes, dtype=np.int64)
    off = np.zeros(nodes, dtype=np.int64)
    cur = 0
    for n in range(nodes):
        caps[n] = bucket_width(table.classes(n), sites, lane)
        off[n] = cur
        cur += caps[n]
    total = cur + s_pad                      # scratch tail for window reads

    sc_caps = np.zeros(scale_buffers, dtype=np.int64)
    sc_off = np.zeros(scale_buffers, dtype=np.int64)
    cur = 0
    for k in range(scale_buffers):
        writers = scaler_of.get(k)
        sc_caps[k] = max(caps[n] for n in writers) if writers else 0
        sc_off[k] = cur
        cur += sc_caps[k]
    sc_trash = cur
    cur += s_pad
    sc_zero = cur
    cur += s_pad
    return FlatLayout(caps=caps, off=off, total=int(total),
                      sc_caps=sc_caps, sc_off=sc_off,
                      sc_trash=int(sc_trash), sc_zero=int(sc_zero),
                      sc_total=int(cur))


def bucket_width(classes: int, sites: int, lane: int = 128) -> int:
    """Round a class count up to a power-of-two multiple of the lane width
    (capped at the lane-aligned site count) — static kernel widths that
    bound recompiles, with every pool offset lane-aligned (the Pallas
    pool kernel slices windows at dynamic lane offsets)."""
    cap = -(-sites // lane) * lane
    w = lane
    while w < classes:
        w *= 2
    return min(w, cap)


def schedule_buckets_flat(table: RepeatsTable,
                          operations: Sequence[Operation],
                          sites: int,
                          scale_buffers: int,
                          lane: int = 128):
    """Flat-pool bucket schedule: updates the class table op by op, then
    groups ops by padded kernel width W and emits offset-based index
    arrays for the pooled storage (see FlatLayout).

    Returns (layout, buckets) with buckets =
    [(W, fields [n, 8] int32, gl [n, W], gr [n, W], ident_l, ident_r)]
    in execution order; fields columns are
    (p_off, psc_off, c1_off, m1, s1_off, c2_off, m2, s2_off). Child
    windows are read W wide from the child's offset: gather indices stay
    below the child's true class count, so over-reads select nothing.

    Within one width class, consecutive ops with the same identity
    profile form one bucket: ident_l/r are PYTHON bools marking identity
    gather maps (repeats disabled on both ends of that child edge), so
    kernels skip the permute at trace time — at full width the W x W
    one-hot matmul costs more than the pruning step itself. Run
    splitting preserves the original postorder, so dependencies hold."""
    per_op = []
    scaler_of: Dict[int, List[int]] = {}
    for op in operations:
        table.update_op(op)
        gl, gr, width = table.gathers_for(op)
        per_op.append((bucket_width(width, sites, lane), op, gl, gr))
        if op.parent_scaler_index >= 0:
            scaler_of.setdefault(op.parent_scaler_index, []).append(
                op.parent_clv_index)
    layout = build_flat_layout(table, scaler_of, sites, scale_buffers,
                               lane)

    groups: Dict[int, List] = {}
    for w, op, gl, gr in per_op:
        groups.setdefault(w, []).append((op, gl, gr))

    buckets = []
    for w in sorted(groups):
        rows = groups[w]
        ident = np.arange(w, dtype=np.int32)

        def profile(g1, g2):
            return (bool(g1.size == w and np.array_equal(g1, ident)),
                    bool(g2.size == w and np.array_equal(g2, ident)))

        # split the width class into order-preserving runs of uniform
        # identity profile (the flags become trace-time constants)
        runs = []
        for op, g1, g2 in rows:
            pr = profile(g1, g2)
            if not runs or runs[-1][0] != pr:
                runs.append((pr, []))
            runs[-1][1].append((op, g1, g2))

        for (il, ir), run in runs:
            n = len(run)
            fields = np.zeros((n, 8), dtype=np.int32)
            glm = np.zeros((n, w), dtype=np.int32)
            grm = np.zeros((n, w), dtype=np.int32)
            for i, (op, g1, g2) in enumerate(run):
                psc = op.parent_scaler_index
                s1, s2 = op.child1_scaler_index, op.child2_scaler_index
                fields[i] = [
                    layout.off[op.parent_clv_index],
                    layout.sc_off[psc] if psc >= 0 else layout.sc_trash,
                    layout.off[op.child1_clv_index],
                    op.child1_matrix_index,
                    layout.sc_off[s1] if s1 >= 0 else layout.sc_zero,
                    layout.off[op.child2_clv_index],
                    op.child2_matrix_index,
                    layout.sc_off[s2] if s2 >= 0 else layout.sc_zero,
                ]
                glm[i, :g1.size] = g1
                grm[i, :g2.size] = g2
            buckets.append((w, fields, glm, grm, il, ir))
    return layout, buckets


def schedule_buckets(table: RepeatsTable,
                     operations: Sequence[Operation],
                     sites: int,
                     lane: int = 128
                     ) -> List[Tuple[int, List[Operation],
                                     np.ndarray, np.ndarray]]:
    """Group the postorder operation list into capacity buckets.

    Updates the class table for each operation in order, then groups ops by
    padded kernel width. Because a parent's class count is >= either
    child's, executing groups in increasing width preserves dependencies;
    within a group the original postorder is kept. Returns
    [(width, ops, gl [n, width], gr [n, width])] in execution order.
    """
    per_op = []
    for op in operations:
        table.update_op(op)
        gl, gr, width = table.gathers_for(op)
        per_op.append((bucket_width(width, sites, lane), op, gl, gr))

    groups: Dict[int, List] = {}
    for w, op, gl, gr in per_op:
        groups.setdefault(w, []).append((op, gl, gr))

    out = []
    for w in sorted(groups):
        ops = [g[0] for g in groups[w]]
        gl = np.zeros((len(ops), w), dtype=np.int32)
        gr = np.zeros((len(ops), w), dtype=np.int32)
        for i, (_, g1, g2) in enumerate(groups[w]):
            gl[i, :g1.size] = g1
            gr[i, :g2.size] = g2
            # padding classes re-gather class 0 (harmless, masked by ids)
        out.append((w, ops, gl, gr))
    return out
