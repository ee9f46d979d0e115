"""Fused full-traversal kernel: the whole postorder in ONE GPU kernel.

The XLA `levels` path (ops/partials.py) writes every inner CLV to device
memory and reads it back: at 128 taxa x 16384 sites, GTR+G4 fp32, one CLV
row is 1 MiB and a traversal moves ~380 MiB. This kernel keeps the inner
CLVs out of that round trip:

  * one program per site tile runs the WHOLE packed op table
    (pack_fused_schedule) in an in-kernel loop;
  * tips are read as packed int32 state BITMASKS (4 B/site instead of
    R*s*4 B/site) and bit-decoded into indicator CLVs on the fly (the
    reference's tip-inner specialization, core_partials.c:366-478);
  * inner CLVs live in a small per-tile slot file: a host-side
    linear-scan register allocator maps nodes to slots (max-live is
    O(tree depth) for a postorder, typically < 20), so the working set
    of all tiles fits in the card's L2 cache;
  * only the root edge's two CLVs + scalers are written out — the edge
    log-likelihood, sumtable and derivatives stay in XLA.

Route: Pallas through Triton (`backend="triton"`), which keeps an
interpret mode for CPU tests. The slot file is a per-tile region of a
scratch output (the Triton route has no scratch allocation); a block
barrier orders each op's slot reads before its writes and its writes
before the next op's reads, since a freed child slot may be reused by the
parent in the same op.

State contraction: per rate, sum_j P[:, j] (outer) child[j] as sequential
fp32 FMAs over the real states j, one [sp, T] accumulator per rate (sp =
states padded to a power of two, the Triton route's tensor rule; padded
rows are zero). A 4x4 DNA matrix is far too small for tensor cores, and a
20-state block padded to 32 would run them at TF32 unless split, so every
alphabet takes the exact-fp32 FMA route. Numerical semantics are those of
the XLA scan path (and the reference): per-site (or per-rate) underflow
scaling with threshold/factor, scalers propagated as integer counts (kept
as f32 in the slot file, exact to 2^24), tips contribute scaler 0.

fp32 only (fp64 evaluation stays on the XLA paths).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt


def pack_fused_schedule(operations, n_tips: int, root_pair,
                        clv_tip_rows=None):
    """Linear-scan register allocation of the postorder onto kernel slots.

    Returns (table [n_ops+1, 8] int32, n_slots). Table rows per op:
      [parent_slot, l_is_tip, l_idx, m1, r_is_tip, r_idx, m2, has_scaler]
    where l_idx/r_idx is a tip row (is_tip=1), a row into the raw
    tip-CLV matrix (is_tip=2, pll_set_tip_clv tips), or a slot id
    (is_tip=0). The extra last row holds the root edge:
      [p_is_tip, p_idx, c_is_tip, c_idx, 0, 0, 0, 0].

    `clv_tip_rows`, if given, maps tip clv_index -> row in the kernel's
    tip-CLV value matrix (or -1 for ordinary state-code tips) — the
    reference treats set_tip_clv tips as ordinary CLVs in every kernel
    (reference: /root/reference/src/pll.c:959-1024).

    Returns None when the list is not a plain full/partial postorder the
    kernel supports (an op consumes a CLV that was never produced, or an
    inner op lacks a scaler buffer).
    """
    root_p, root_c = root_pair

    def tip_entry(c):
        if clv_tip_rows is not None and clv_tip_rows[c] >= 0:
            return 2, int(clv_tip_rows[c])
        return 1, c

    last_use = {}
    for k, op in enumerate(operations):
        for c in (op.child1_clv_index, op.child2_clv_index):
            if c >= n_tips:
                last_use[c] = k
    n_ops = len(operations)
    for rn in (root_p, root_c):
        if rn >= n_tips:
            last_use[rn] = n_ops          # alive until the end

    free: list = []
    slot_of: dict = {}
    n_slots = 0
    table = np.zeros((n_ops + 1, 8), dtype=np.int32)
    for k, op in enumerate(operations):
        if op.parent_scaler_index < 0:
            return None, 0                 # kernel assumes scaler per op
        row = [0] * 8
        for pos, (c, m) in enumerate(
                ((op.child1_clv_index, op.child1_matrix_index),
                 (op.child2_clv_index, op.child2_matrix_index))):
            if c < n_tips:
                row[1 + 3 * pos], row[2 + 3 * pos] = tip_entry(c)
            else:
                if c not in slot_of:
                    return None, 0         # consumed before produced
                row[1 + 3 * pos] = 0
                row[2 + 3 * pos] = slot_of[c]
            row[3 + 3 * pos] = m
        # free dying children BEFORE allocating the parent: the kernel
        # fully reads both children into registers before writing, so the
        # parent may safely reuse a dead child's slot
        for c in (op.child1_clv_index, op.child2_clv_index):
            if c >= n_tips and last_use.get(c) == k:
                free.append(slot_of.pop(c))
        if free:
            ps = free.pop()
        else:
            ps = n_slots
            n_slots += 1
        slot_of[op.parent_clv_index] = ps
        row[0] = ps
        row[7] = 1
        table[k] = row

    def root_entry(c):
        if c < n_tips:
            return tip_entry(c)
        if c not in slot_of:
            return None
        return 0, slot_of[c]

    pe, ce = root_entry(root_p), root_entry(root_c)
    if pe is None or ce is None:
        return None, 0
    table[n_ops] = [pe[0], pe[1], ce[0], ce[1], 0, 0, 0, 0]
    return table, max(n_slots, 1)


def fused_candidate_from_tree(vroot, n_tips: int, n_matrices: int,
                              clv_tip_rows=None):
    """One-pass iterative postorder walk producing the fused kernel's
    (table, branch vector, root_info) for the CURRENT topology — the
    exact output of pack_fused_schedule(create_operations(traverse(
    vroot))) without materializing Operation objects. This is the
    per-candidate host cost of batched SPR/NNI scoring (search.py); at
    1000 taxa the object-based pipeline spends ~6 ms/candidate, ~95% of
    a warm round.

    Returns (table [n_ops+1, 8] int32, blens [n_matrices], root_info,
    n_slots) or (None, None, None, 0) when the kernel cannot run this
    topology (an inner op without a scaler row, or a non-binary node)."""
    vback = vroot.back
    blens = np.zeros(n_matrices)
    rows = []
    free: list = []
    slot_of: dict = {}
    n_slots = 0

    def tip_entry(c):
        if clv_tip_rows is not None and clv_tip_rows[c] >= 0:
            return 2, int(clv_tip_rows[c])
        return 1, c

    # emulate trees.utree.traverse: rec(vroot.back) then rec(vroot),
    # children in ring order before the node (postorder)
    stack = [(vroot, False), (vback, False)]
    while stack:
        node, done = stack.pop()
        tip = node.is_tip()
        if not done and not tip:
            stack.append((node, True))
            if node.next.next.next is not node:
                return None, None, None, 0         # non-binary
            stack.append((node.next.next.back, False))
            stack.append((node.next.back, False))
            continue
        # visit: record the branch toward the traversal root (the first
        # subtree's top — vroot.back — would duplicate vroot's entry)
        if node is not vback:
            blens[node.pmatrix_index] = node.length
        if tip:
            continue
        if node.scaler_index < 0:
            return None, None, None, 0             # kernel needs a scaler
        c1, c2 = node.next.back, node.next.next.back
        row = [0] * 8
        freed = []
        for pos, c in ((0, c1), (1, c2)):
            ci = c.clv_index
            if ci < n_tips:
                row[1 + 3 * pos], row[2 + 3 * pos] = tip_entry(ci)
            else:
                # inner CLVs are consumed exactly once in a tree
                # postorder; free the slot for the parent to reuse
                s = slot_of.pop(ci, None)
                if s is None:
                    return None, None, None, 0     # not a valid postorder
                row[1 + 3 * pos] = 0
                row[2 + 3 * pos] = s
                freed.append(s)
            row[3 + 3 * pos] = c.pmatrix_index
        free.extend(freed)
        if free:
            ps = free.pop()
        else:
            ps = n_slots
            n_slots += 1
        slot_of[node.clv_index] = ps
        row[0] = ps
        row[7] = 1
        rows.append(row)

    table = np.zeros((len(rows) + 1, 8), dtype=np.int32)
    table[:len(rows)] = rows

    def root_entry(c):
        if c < n_tips:
            return tip_entry(c)
        return (0, slot_of[c]) if c in slot_of else None

    pe, ce = root_entry(vroot.clv_index), root_entry(vback.clv_index)
    if pe is None or ce is None:
        return None, None, None, 0
    table[len(rows)] = [pe[0], pe[1], ce[0], ce[1], 0, 0, 0, 0]
    root_info = (vroot.clv_index, vroot.scaler_index, vback.clv_index,
                 vback.scaler_index, vroot.pmatrix_index)
    return table, blens, root_info, max(n_slots, 1)


def _pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


def padded_states(states: int) -> int:
    """State axis as the kernel holds it: the next power of two (the
    Triton route's tensors must be power-of-two sized). Padded rows and
    columns of every P-matrix are zero, so they carry zero CLVs."""
    return _pow2(states)


def kernel_grain(states: int) -> int:
    """Sites per program (the site tile). Callers may pre-pad the tip
    matrices to this grain; fused_traversal pads any remainder itself.
    Small tiles keep many programs in flight: the op loop is a chain of
    dependent slot reads, so the card hides its latency across programs
    (tile and warp counts swept on an H100, see PERF.md)."""
    return 32 if padded_states(states) < 16 else 16


def _num_warps(states: int) -> int:
    """Warps per program, swept with the tile on an H100."""
    return 1 if padded_states(states) < 16 else 2


def _fused_kernel(tbl_ref,             # [n_ops+1, 8] int32
                  pmt_ref,             # [E, R, sp, sp] f32, P transposed
                  tips_ref,            # [n_tips, T] int32 bitmasks
                  *refs,               # [ctips], outp, outc, scp, scc,
                                       #  slots, slot_scalers
                  rates: int, states: int, n_ops: int, threshold: float,
                  factor: float, rate_scalers: bool, has_ctips: bool,
                  sync: bool):
    if has_ctips:
        ctips_ref, *refs = refs
    outp_ref, outc_ref, scp_ref, scc_ref, slot_ref, ssc_ref = refs
    sp = pmt_ref.shape[-1]
    tile = tips_ref.shape[-1]
    n_sc = rates if rate_scalers else 1
    f32 = jnp.float32
    thresh = jnp.asarray(float(threshold), f32)
    fact = jnp.asarray(float(factor), f32)
    zero_sc = tuple(jnp.zeros((tile,), f32) for _ in range(n_sc))

    def barrier():
        if sync:                 # interpret mode runs one program serially
            plt.debug_barrier()

    def tip_bit(idx, j):
        return jnp.where((tips_ref[idx] >> j) & 1 == 1, f32(1.0), f32(0.0))

    def matvec(mat, rows):
        """Per rate r: sum_j P[r, :, j] (outer) child[r, j] as sequential
        fp32 FMAs over the real states j — [sp, T] per rate. `rows[r]`
        holds the child's `states` rows ([T] each) for rate r."""
        out = []
        for r in range(rates):
            acc = pmt_ref[mat, r, 0][:, None] * rows[r][0][None, :]
            for j in range(1, states):
                acc = acc + pmt_ref[mat, r, j][:, None] * rows[r][j][None, :]
            out.append(acc)
        return out

    def child(is_tip, idx, mat):
        """(P(mat) @ child) per rate + the child's scalers. The branches
        only fetch rows; the contraction is emitted once per child."""
        def from_slot():
            return (tuple(tuple(slot_ref[0, idx, r, j]
                                for j in range(states))
                          for r in range(rates)),
                    tuple(ssc_ref[0, idx, k] for k in range(n_sc)))

        def from_tip():
            bits = tuple(tip_bit(idx, j) for j in range(states))
            return (bits,) * rates, zero_sc

        if not has_ctips:
            rows, sc = jax.lax.cond(is_tip == 0, from_slot, from_tip)
        else:
            def from_ctip():
                ct = tuple(ctips_ref[idx, j] for j in range(states))
                return (ct,) * rates, zero_sc
            rows, sc = jax.lax.switch(jnp.clip(is_tip, 0, 2),
                                      (from_slot, from_tip, from_ctip))
        return matvec(mat, rows), sc

    def raw(is_tip, idx):
        """Unmultiplied root-edge rows ([sp, T] per rate) + scalers."""
        def from_slot():
            return (tuple(slot_ref[0, idx, r] for r in range(rates)),
                    tuple(ssc_ref[0, idx, k] for k in range(n_sc)))

        def from_tip():
            bit = jnp.arange(sp, dtype=jnp.int32)[:, None]
            hit = ((tips_ref[idx][None, :] >> bit) & 1 == 1) & (bit < states)
            return (jnp.where(hit, f32(1.0), f32(0.0)),) * rates, zero_sc

        if not has_ctips:
            return jax.lax.cond(is_tip == 0, from_slot, from_tip)

        def from_ctip():
            return (ctips_ref[idx],) * rates, zero_sc
        return jax.lax.switch(jnp.clip(is_tip, 0, 2),
                              (from_slot, from_tip, from_ctip))

    def body(i, carry):
        ml, lsc = child(tbl_ref[i, 1], tbl_ref[i, 2], tbl_ref[i, 3])
        mr, rsc = child(tbl_ref[i, 4], tbl_ref[i, 5], tbl_ref[i, 6])
        # every read of this op lands before any write: the parent may
        # reuse a child's slot
        barrier()
        x = [a * b for a, b in zip(ml, mr)]
        has = tbl_ref[i, 7] > 0
        if rate_scalers:
            # each rate block under- flows and rescales independently
            # (reference core_partials.c:760-771)
            cnt = []
            for r in range(rates):
                scale = (jnp.max(x[r], axis=0) < thresh) & has    # [T]
                x[r] = x[r] * jnp.where(scale, fact, f32(1.0))[None, :]
                cnt.append(lsc[r] + rsc[r] + scale.astype(f32))
        else:
            # max(x) < t over every (rate, state) row: x is non-negative
            m = jnp.max(x[0], axis=0)
            for r in range(1, rates):
                m = jnp.maximum(m, jnp.max(x[r], axis=0))
            scale = (m < thresh) & has
            fac = jnp.where(scale, fact, f32(1.0))[None, :]
            x = [v * fac for v in x]
            cnt = [lsc[0] + rsc[0] + scale.astype(f32)]
        pslot = tbl_ref[i, 0]
        for r in range(rates):
            slot_ref[0, pslot, r] = x[r]
        for k in range(n_sc):
            ssc_ref[0, pslot, k] = cnt[k]
        barrier()                # the next op may read this slot
        return carry

    jax.lax.fori_loop(0, n_ops, body, 0)

    for out_ref, sc_ref, col in ((outp_ref, scp_ref, 0),
                                 (outc_ref, scc_ref, 2)):
        xs, scs = raw(tbl_ref[n_ops, col], tbl_ref[n_ops, col + 1])
        for r in range(rates):
            out_ref[r] = xs[r]
        for k in range(n_sc):
            sc_ref[k] = scs[k].astype(jnp.int32)


@partial(jax.jit, static_argnames=('rates', 'states', 'n_slots',
                                   'threshold', 'factor', 'interpret',
                                   'rate_scalers', 'tile'))
def fused_traversal(tip_codes: jnp.ndarray,   # [n_tips, S] int32 bitmasks
                    pmatrix: jnp.ndarray,     # [E, R, s, s]
                    table: jnp.ndarray,       # [n_ops+1, 8] int32
                    rates: int, states: int, n_slots: int,
                    threshold: float, factor: float,
                    interpret: bool = False,
                    rate_scalers: bool = False,
                    tip_clvs=None,            # [n_ctips, s, S] f32
                    tile: int = 0):
    """One full postorder; returns (clv_p, clv_c, scaler_p, scaler_c) for
    the root edge: CLVs [R, s, S] f32; scalers [S] int32 (per-site mode)
    or [R, S] int32 (rate_scalers mode, one count per rate category).
    `tip_clvs` carries raw set_tip_clv probability rows (is_tip == 2 in
    the table), rate-independent by reference semantics (pll.c:1063).
    Any site count is accepted: the site axis is padded to the tile
    (zero codes -> zero CLVs) and sliced back. `tile` (0 = kernel_grain)
    sets the sites per program; the results do not depend on it."""
    n_tips, sites = tip_codes.shape
    n_ops = table.shape[0] - 1
    sp = padded_states(states)
    tile = tile or kernel_grain(states)
    n_sc = rates if rate_scalers else 1
    pad = (-sites) % tile
    width = sites + pad
    n_tiles = width // tile
    codes = jnp.pad(tip_codes.astype(jnp.int32), ((0, 0), (0, pad)))
    # transposed, so that column j of P is one contiguous [sp] load
    pmt = jnp.pad(jnp.swapaxes(pmatrix.astype(jnp.float32), -1, -2),
                  ((0, 0), (0, 0), (0, sp - states), (0, sp - states)))
    has_ctips = tip_clvs is not None and tip_clvs.shape[0] > 0
    in_specs = [pl.BlockSpec(table.shape, lambda j: (0, 0)),
                pl.BlockSpec(pmt.shape, lambda j: (0, 0, 0, 0)),
                pl.BlockSpec((n_tips, tile), lambda j: (0, j))]
    inputs = [table, pmt, codes]
    if has_ctips:
        ct = jnp.pad(tip_clvs.astype(jnp.float32),
                     ((0, 0), (0, sp - states), (0, pad)))
        in_specs.append(pl.BlockSpec((ct.shape[0], sp, tile),
                                     lambda j: (0, 0, j)))
        inputs.append(ct)
    clv_spec = pl.BlockSpec((rates, sp, tile), lambda j: (0, 0, j))
    sc_spec = pl.BlockSpec((n_sc, tile), lambda j: (0, j))
    kernel = partial(_fused_kernel, rates=rates, states=states,
                     n_ops=n_ops, threshold=threshold, factor=factor,
                     rate_scalers=rate_scalers, has_ctips=has_ctips,
                     sync=not interpret)
    outp, outc, scp, scc, _, _ = pl.pallas_call(
        kernel,
        grid=(n_tiles,),
        in_specs=in_specs,
        out_specs=[
            clv_spec, clv_spec, sc_spec, sc_spec,
            pl.BlockSpec((1, n_slots, rates, sp, tile),
                         lambda j: (j, 0, 0, 0, 0)),
            pl.BlockSpec((1, n_slots, n_sc, tile),
                         lambda j: (j, 0, 0, 0)),
        ],
        out_shape=[
            jax.ShapeDtypeStruct((rates, sp, width), jnp.float32),
            jax.ShapeDtypeStruct((rates, sp, width), jnp.float32),
            jax.ShapeDtypeStruct((n_sc, width), jnp.int32),
            jax.ShapeDtypeStruct((n_sc, width), jnp.int32),
            jax.ShapeDtypeStruct((n_tiles, n_slots, rates, sp, tile),
                                 jnp.float32),
            jax.ShapeDtypeStruct((n_tiles, n_slots, n_sc, tile),
                                 jnp.float32),
        ],
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=_num_warps(states),
                                           num_stages=1),
        interpret=interpret,
        name="pll_fused_traversal",
    )(*inputs)
    clv_p = outp[:, :states, :sites]
    clv_c = outc[:, :states, :sites]
    if rate_scalers:
        return clv_p, clv_c, scp[:, :sites], scc[:, :sites]
    return clv_p, clv_c, scp[0, :sites], scc[0, :sites]


def tip_clv_matrix(partition, pad_to: int = 0):
    """f32 raw tip-CLV value matrix [n_ctips, states, width] for tips set
    via set_tip_clv, rows ordered by ascending tip index (the same order
    pack_fused_schedule's clv_tip_rows encodes). None when no such tip
    exists. Values are rate-independent (pll_set_tip_clv replicates one
    state vector over every category, reference pll.c:1063); the kernel
    broadcasts over rates. Asc columns ride along (set_tip_clv fills
    them); pad columns carry 0."""
    p = partition
    idxs = np.flatnonzero(p._tips_clv_set)
    if len(idxs) == 0:
        return None
    mesh = getattr(p, "mesh", None)
    if mesh is not None:
        from ..parallel.sharding import is_multiprocess
        if is_multiprocess(mesh):
            from .. import constants as C
            # the tip rows live in the sharded global CLV array; fetching
            # them host-side would need the full site axis, which spans
            # devices other processes own
            raise C.PllError(
                C.ERROR_PARAM_INVALID,
                "raw tip-CLV tips (set_tip_clv) are not supported under "
                "multi-process site sharding: the tip rows span devices "
                "owned by other processes; encode those tips from state "
                "codes, or run single-process")
    width = max(p.sites_padded, pad_to)
    out = np.zeros((len(idxs), p.states, width), dtype=np.float32)
    for row, t in enumerate(idxs):
        if p.repeats is not None:
            cols = p._tip_cols[t]            # [states, sites + asc]
            out[row, :, :cols.shape[1]] = cols
        else:
            vals = np.asarray(p.clv[t, 0])   # [states, sites_padded]
            out[row, :, :vals.shape[1]] = vals
    return out


def tip_code_matrix(partition, pad_to: int = 0) -> np.ndarray:
    """int32 state-bitmask matrix [tips, max(sites_padded, pad_to)] for
    the kernel: real sites carry the decoded charmap masks, synthetic asc
    columns the single-state masks, padded columns 0 (-> zero CLVs; the
    engine slices kernel outputs back to sites_padded, so pads never
    reach the likelihood). Partitions are NOT required to be 128-aligned
    (real alignments never are) — the kernel pads internally."""
    p = partition
    width = max(p.sites_padded, pad_to)
    codes = np.zeros((p.tips, width), dtype=np.int32)
    codes[:, :p.sites] = p.tip_states[:, :p.sites].astype(np.int64) \
        .astype(np.int32)
    if p.asc_extra:
        for k in range(p.states):
            codes[:, p.sites + k] = 1 << k
    return codes
