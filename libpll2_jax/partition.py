"""Partition: the central state object tying alignments, models and kernels.

Device-native re-design of the reference's pll_partition_t + dispatch layer
(reference: /root/reference/src/pll.c:424-1206, /root/reference/src/
partials.c, likelihood.c, derivatives.c, models.c). Differences by design:

  * All per-index buffer tables (clv[i], pmatrix[i], scale_buffer[i], ...)
    become leading axes of dense device arrays, so topology-dependent work is
    pure gather/scatter over traced integer indices — one compiled program
    serves every topology of a given size.
  * CLV layout is [node, rate, state, site] (sites on the minor axis).
  * Tips are always stored as bit-decoded indicator CLVs (the reference's
    "plain" mode, pll.c:959 set_tipclv); every pruning step is then the
    inner-inner case. The tip-pattern and site-repeat optimizations are
    layered on top separately.
  * Eigendecomposition is host-side numpy (lazy, per rate-matrix, exactly as
    models.c:412-428); everything downstream is jitted JAX.

Precision: float64 by default (bit-consistent with the reference; requires
jax_enable_x64). A float32 fast path uses a 2**-32 rescaling window instead
of 2**-256 (squared, the window must stay above fp32's minimum normal or
deep trees flush to zero between scale checks on flush-to-zero hardware).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from . import constants as C
from .io import maps as state_maps
from .ops import derivatives as ops_derivatives
from .ops import eigen as ops_eigen
from .ops import likelihood as ops_likelihood
from .ops import partials as ops_partials
from .ops import pmatrix as ops_pmatrix
from .ops.partials import Operations


@dataclass
class Operation:
    """One pruning step (pll.h:314-324 pll_operation_t)."""
    parent_clv_index: int
    parent_scaler_index: int
    child1_clv_index: int
    child1_matrix_index: int
    child1_scaler_index: int
    child2_clv_index: int
    child2_matrix_index: int
    child2_scaler_index: int


def pack_operations(operations: Sequence[Operation],
                    pad_to: Optional[int] = None,
                    scratch_clv: int = 0) -> Operations:
    """Convert host operations to the structure-of-arrays device format.

    Padding entries (up to `pad_to`) write into the scratch CLV row and the
    scratch scaler row so jitted programs are reused across op counts.
    """
    n = len(operations)
    m = n if pad_to is None else max(pad_to, n)

    def arr(get, pad_value):
        vals = [get(op) for op in operations] + [pad_value] * (m - n)
        return jnp.asarray(np.array(vals, dtype=np.int32))

    return Operations(
        parent_clv=arr(lambda o: o.parent_clv_index, scratch_clv),
        parent_scaler=arr(lambda o: o.parent_scaler_index, -1),
        child1_clv=arr(lambda o: o.child1_clv_index, 0),
        child1_matrix=arr(lambda o: o.child1_matrix_index, 0),
        child1_scaler=arr(lambda o: o.child1_scaler_index, -1),
        child2_clv=arr(lambda o: o.child2_clv_index, 0),
        child2_matrix=arr(lambda o: o.child2_matrix_index, 0),
        child2_scaler=arr(lambda o: o.child2_scaler_index, -1),
    )


def pack_level_operations(operations: Sequence[Operation],
                          n_tips: int,
                          scratch_clv: int = 0):
    """Group operations into dependency levels and pad to a rectangle.

    Returns (Operations with [L, W] arrays, valid [L, W] bool) for
    `update_partials_levels` — all ops in one level are independent, so each
    level executes as one batched kernel launch (depth-many launches instead
    of ops-many scan steps)."""
    from .trees.utree import compile_levels
    levels = compile_levels(operations, n_tips)
    L = len(levels)
    W = max(len(lv) for lv in levels)

    def arr(get, pad_value):
        out = np.full((L, W), pad_value, dtype=np.int32)
        for i, lv in enumerate(levels):
            out[i, :len(lv)] = [get(op) for op in lv]
        return jnp.asarray(out)

    valid = np.zeros((L, W), dtype=bool)
    for i, lv in enumerate(levels):
        valid[i, :len(lv)] = True
    ops = Operations(
        parent_clv=arr(lambda o: o.parent_clv_index, scratch_clv),
        parent_scaler=arr(lambda o: o.parent_scaler_index, -1),
        child1_clv=arr(lambda o: o.child1_clv_index, 0),
        child1_matrix=arr(lambda o: o.child1_matrix_index, 0),
        child1_scaler=arr(lambda o: o.child1_scaler_index, -1),
        child2_clv=arr(lambda o: o.child2_clv_index, 0),
        child2_matrix=arr(lambda o: o.child2_matrix_index, 0),
        child2_scaler=arr(lambda o: o.child2_scaler_index, -1),
    )
    return ops, jnp.asarray(valid)


class Partition:
    """Likelihood computation state for one alignment partition."""

    def __init__(self,
                 tips: int,
                 clv_buffers: int,
                 states: int,
                 sites: int,
                 rate_matrices: int,
                 prob_matrices: int,
                 rate_cats: int,
                 scale_buffers: int,
                 *,
                 dtype=None,
                 rate_scalers: bool = False,
                 asc_bias: C.AscBias = C.AscBias.NONE,
                 sites_alignment: int = 1,
                 site_repeats: bool = False):
        if dtype is None:
            # float64 when jax_enable_x64 is on, else the float32 fast path
            dtype = jax.dtypes.canonicalize_dtype(np.float64)
        self.dtype = jnp.dtype(dtype)
        if self.dtype == jnp.float64:
            self.scale_threshold = C.SCALE_THRESHOLD
            self.scale_factor = C.SCALE_FACTOR
        else:
            self.scale_threshold = C.SCALE_THRESHOLD_F32
            self.scale_factor = C.SCALE_FACTOR_F32

        self.tips = tips
        self.clv_buffers = clv_buffers
        self.nodes = tips + clv_buffers
        self.states = states
        self.sites = sites
        self.rate_matrices = rate_matrices
        self.prob_matrices = prob_matrices
        self.rate_cats = rate_cats
        self.scale_buffers = scale_buffers
        if asc_bias != C.AscBias.NONE and rate_scalers:
            raise C.PllError(C.ERROR_AB_NOSUPPORT,
                             "Per-rate scalers are not supported with asc "
                             "bias correction")
        self.rate_scalers = rate_scalers
        self.asc_bias = asc_bias
        # ascertainment-bias corrections append `states` synthetic
        # all-state-k columns after the real sites (pll.c:525-531)
        self.asc_extra = states if asc_bias != C.AscBias.NONE else 0

        base = sites + self.asc_extra
        self.sites_padded = -(-base // sites_alignment) * sites_alignment

        self.repeats = None
        self._repeat_schedule = None
        if site_repeats:
            # repeats auto-off below 16 sites, as in pll.c:441-449. The
            # class domain spans the real sites PLUS the synthetic asc
            # columns — the reference's repeats tables are sized
            # sites + states when asc is allocated (repeats.c:69,122,201)
            if sites >= C.REPEATS_MIN_SITES and self.sites_padded == base:
                from .repeats import RepeatsTable
                self.repeats = RepeatsTable(self.nodes, base)

        S, R, s = self.sites_padded, rate_cats, states
        if self.repeats is None:
            # +1 scratch CLV row for padded operations; scalers get +2
            # rows: row K absorbs writes of scaler-less/padded ops
            # (trash), row K+1 is guaranteed zero and serves every
            # SCALE_BUFFER_NONE read
            self.clv = jnp.zeros((self.nodes + 1, R, s, S),
                                 dtype=self.dtype)
            scaler_shape = (scale_buffers + 2, R, S) if rate_scalers \
                else (scale_buffers + 2, S)
            self.scale_buffer = jnp.zeros(scaler_shape, dtype=jnp.int32)
        else:
            # pooled class-column storage (repeats.FlatLayout): node n
            # owns cap[n] columns of one flat [R, s, total] buffer — the
            # reference's per-node CLV reallocation (repeats.c:256-296)
            # made shape-static. Allocated lazily once class counts are
            # known (tips set / first update_partials).
            self.clv = None
            self.scale_buffer = None
            self.clv_flat = None
            self.sc_flat = None
            self._flat = None
            self._tip_cols = {}          # tip -> np [s, n_cols] columns
        self.pmatrix = jnp.zeros((prob_matrices, R, s, s), dtype=self.dtype)

        # model parameters (host mirrors; tiny)
        self.frequencies = np.zeros((rate_matrices, s))
        self.subst_params = np.zeros((rate_matrices, s * (s - 1) // 2))
        self.rates = np.zeros(R)
        self.rate_weights = np.full(R, 1.0 / R)
        self.prop_invar = np.zeros(rate_matrices)
        self.eigenvals = np.zeros((rate_matrices, s))
        self.eigenvecs = np.zeros((rate_matrices, s, s))
        self.inv_eigenvecs = np.zeros((rate_matrices, s, s))
        self.eigen_decomp_valid = np.zeros(rate_matrices, dtype=bool)

        # bumped by every model/site-data setter; lets engines cache
        # device-resident model arguments safely
        self._model_version = 0

        pw = np.zeros(S, dtype=np.int64)
        pw[:sites] = 1
        if self.asc_extra:
            pw[sites:sites + self.asc_extra] = 0  # weights set via asc API
        self.pattern_weights = pw
        self.invariant = np.full(S, -1, dtype=np.int32)
        self._invariant_valid = False
        # per-tip state bitmasks, for invariant-site detection
        self.tip_states = np.zeros((tips, S), dtype=np.uint64)
        self._tips_set = np.zeros(tips, dtype=bool)
        # tips whose CLV came from set_tip_clv (raw probabilities, not
        # reconstructible from tip_states) — checkpointing persists these
        self._tips_clv_set = np.zeros(tips, dtype=bool)
        # bumped by tip setters; engines cache tip-code matrices on it
        self._tip_version = 0

    # ------------------------------------------------------------------ tips
    def set_tip_states(self, tip_index: int, charmap: np.ndarray,
                       sequence: str) -> None:
        """Bit-decode one aligned sequence into the tip's CLV (pll.c:1026)."""
        if len(sequence) != self.sites:
            raise C.PllError(C.ERROR_PARAM_INVALID,
                             f"sequence length {len(sequence)} != sites {self.sites}")
        masks = state_maps.decode_states(sequence, np.asarray(charmap,
                                                              dtype=np.uint64))
        if np.any(masks == 0):
            bad = sequence[int(np.argmax(masks == 0))]
            raise C.PllError(C.ERROR_TIPDATA_ILLEGALSTATE,
                             f"Illegal state code in tip \"{bad}\"")
        self._set_tip_masks(tip_index, masks)

    def set_tip_states_batch(self, charmap, sequences,
                             tip_indices=None,
                             chunk: int = 256) -> None:
        """Install MANY aligned sequences at once: one charmap gather
        decodes every sequence and the dense tip CLVs land in a few
        chunked device updates instead of one eager `.at[].set` per tip
        (~1-3 ms each; at 1000 taxa the per-tip path costs seconds of
        pure dispatch overhead per partition build). Semantically
        identical to calling set_tip_states per tip in order."""
        seqs = list(sequences)
        if tip_indices is None:
            tip_indices = np.arange(len(seqs))
        tip_indices = np.asarray(tip_indices, np.int64)
        if tip_indices.shape[0] != len(seqs):
            raise C.PllError(
                C.ERROR_PARAM_INVALID,
                f"tip_indices ({tip_indices.shape[0]}) and sequences "
                f"({len(seqs)}) must have equal lengths")
        for s in seqs:
            if len(s) != self.sites:
                raise C.PllError(
                    C.ERROR_PARAM_INVALID,
                    f"sequence length {len(s)} != sites {self.sites}")
        cm = np.asarray(charmap, dtype=np.uint64)
        raw = np.frombuffer("".join(seqs).encode("latin-1"),
                            dtype=np.uint8).reshape(len(seqs), self.sites)
        masks = cm[raw]
        if np.any(masks == 0):
            ti, si = np.unravel_index(int(np.argmax(masks == 0)),
                                      masks.shape)
            raise C.PllError(
                C.ERROR_TIPDATA_ILLEGALSTATE,
                f"Illegal state code in tip \"{seqs[ti][si]}\"")
        if self.repeats is not None:
            # pooled partitions do host-side bookkeeping only — the
            # per-tip path is already cheap
            for t, m in zip(tip_indices, masks):
                self._set_tip_masks(int(t), m)
            return
        # host bookkeeping for the whole batch (one version bump)
        self.tip_states[tip_indices, :self.sites] = masks
        self._tips_set[tip_indices] = True
        self._tips_clv_set[tip_indices] = False
        self._tip_version += 1
        self._invariant_valid = False
        s, S = self.states, self.sites_padded
        eye = np.eye(s)
        for c0 in range(0, len(seqs), chunk):
            idx = tip_indices[c0:c0 + chunk]
            m = masks[c0:c0 + chunk]
            ind = state_maps.bits_to_clv(m.reshape(-1), s) \
                .reshape(len(idx), self.sites, s)
            block = np.zeros((len(idx), self.rate_cats, s, S))
            block[:, :, :, :self.sites] = \
                ind.transpose(0, 2, 1)[:, None, :, :]
            if self.asc_extra:
                block[:, :, :, self.sites:self.sites + s] = \
                    eye[None, None, :, :]
            self.clv = self.clv.at[jnp.asarray(idx)].set(
                jnp.asarray(block, dtype=self.dtype))

    def _set_tip_masks(self, tip_index: int, masks: np.ndarray) -> None:
        """Install decoded state bitmasks as a tip CLV (and repeat classes)."""
        self.tip_states[tip_index, :self.sites] = masks
        self._tips_set[tip_index] = True
        self._tips_clv_set[tip_index] = False
        self._tip_version += 1
        self._invariant_valid = False

        if self.repeats is not None:
            # tip CLV columns are class columns (pll_update_repeats_tips);
            # tip classes changed, so any cached schedule and the pooled
            # layout are stale
            self._repeat_key = None
            self._repeat_schedule = None
            self._flat = None
            if self.asc_extra:
                # synthetic asc column k observes state k everywhere —
                # its class code is the single-bit mask (repeats.c:189-254
                # classes tips by character over sites + asc columns)
                masks = np.concatenate([
                    masks, np.uint64(1) << np.arange(self.states,
                                                     dtype=np.uint64)])
            self.repeats.set_tip(tip_index, masks)
            ids = int(self.repeats.ids[tip_index])
            rep = self.repeats.id_site[tip_index, :ids]
            ind = state_maps.bits_to_clv(masks[rep], self.states)
            self._tip_cols[tip_index] = np.ascontiguousarray(ind.T)
            return
        block = np.zeros((self.rate_cats, self.states, self.sites_padded))
        ind = state_maps.bits_to_clv(masks, self.states)     # [sites, s]
        block[:, :, :self.sites] = ind.T[None, :, :]
        if self.asc_extra:
            # synthetic invariant columns: column k observes state k everywhere
            eye = np.eye(self.states)
            block[:, :, self.sites:self.sites + self.states] = eye[None, :, :]
        self.clv = self.clv.at[tip_index].set(
            jnp.asarray(block, dtype=self.dtype))

    def set_tip_clv(self, tip_index: int, clv: np.ndarray,
                    padded: bool = False) -> None:
        """Set a tip CLV from [sites, states] values, replicated across all
        rate categories — exactly pll_set_tip_clv (pll.c:1063): one state
        vector per site in the input, the same for every category. Also
        fills the synthetic asc columns when allocated.

        `padded` is accepted for reference API compatibility; this layout
        has states_padded == states, so padded and unpadded inputs are
        identical."""
        arr = np.asarray(clv, dtype=np.float64)
        arr = arr.reshape(self.sites, self.states)
        if self.repeats is not None:
            # arbitrary probabilities have no state code to class by: reset
            # this tip to the identity mapping (repeats disabled for it) and
            # invalidate any cached schedule built from the old classes
            self.repeats.reset_node(tip_index)
            self._repeat_key = None
            self._repeat_schedule = None
            self._flat = None
            if self.asc_extra:
                arr = np.concatenate([arr, np.eye(self.states)])
            self._tip_cols[tip_index] = np.ascontiguousarray(arr.T)
        else:
            block = np.zeros((self.rate_cats, self.states,
                              self.sites_padded))
            block[:, :, :self.sites] = arr.T[None, :, :]
            if self.asc_extra:
                eye = np.eye(self.states)
                block[:, :, self.sites:self.sites + self.states] = eye[None]
            self.clv = self.clv.at[tip_index].set(
                jnp.asarray(block, dtype=self.dtype))
        # probabilities are not state bitmasks: this tip can no longer
        # participate in bitwise invariant-site detection
        self._tips_set[tip_index] = False
        self._tips_clv_set[tip_index] = True
        self._tip_version += 1
        self._invariant_valid = False

    def dense_tip_rows(self):
        """[tips, states, sites_padded] dense per-site tip CLVs as a
        device array in self.dtype (rate-invariant — callers broadcast
        over categories). The streamed-search base for site-repeats
        partitions, whose pooled class-column storage has no dense rows:
        the scoring program rebuilds every inner CLV from these tips, so
        repeats partitions keep the compressed storage AND ride the
        partial-traversal fast path (reference combo:
        /root/reference/src/repeats.c:299 driven by the op consumer of
        /root/reference/src/partials.c:245, test/src/partial-traversal.c).
        Requires every tip set; cached until a tip setter runs."""
        if getattr(self, "_dense_tip_key", None) == self._tip_version:
            return self._dense_tip_cache
        if not bool(np.all(self._tips_set | self._tips_clv_set)):
            raise C.PllError(C.ERROR_PARAM_INVALID,
                             "dense_tip_rows needs every tip set")
        rows = np.zeros((self.tips, self.states, self.sites_padded))
        for t in range(self.tips):
            if self._tips_set[t]:
                ind = state_maps.bits_to_clv(
                    self.tip_states[t, :self.sites], self.states)
                rows[t, :, :self.sites] = ind.T
            elif self.repeats is not None:
                # raw-probability tip of a repeats partition: repeats are
                # disabled for it (identity mapping), so _tip_cols holds
                # per-site columns (+ asc columns) directly
                cols = self._tip_cols[t]
                rows[t, :, :cols.shape[1]] = cols
                continue
            else:
                rows[t] = np.asarray(self.clv[t, 0])
                continue
            if self.asc_extra:
                rows[t, :, self.sites:self.sites + self.states] = \
                    np.eye(self.states)
        self._dense_tip_cache = jnp.asarray(rows, self.dtype)
        self._dense_tip_key = self._tip_version
        return self._dense_tip_cache

    # ----------------------------------------------------------------- model
    def set_frequencies(self, params_index: int, freqs) -> None:
        f = np.asarray(freqs, dtype=np.float64)
        if abs(f.sum() - 1.0) > C.MISC_EPSILON:
            f = f / f.sum()
        self.frequencies[params_index] = f
        self.eigen_decomp_valid[params_index] = False
        self._model_version += 1

    def set_subst_params(self, params_index: int, params) -> None:
        self.subst_params[params_index] = np.asarray(params, dtype=np.float64)
        self.eigen_decomp_valid[params_index] = False
        self._model_version += 1

    def set_category_rates(self, rates) -> None:
        self.rates = np.asarray(rates, dtype=np.float64).copy()
        self._model_version += 1

    def set_category_weights(self, weights) -> None:
        self.rate_weights = np.asarray(weights, dtype=np.float64).copy()
        self._model_version += 1

    def set_pattern_weights(self, weights) -> None:
        w = np.asarray(weights, dtype=np.int64)
        self.pattern_weights[:self.sites] = w
        self._invariant_valid = False
        self._model_version += 1

    def set_asc_bias_type(self, asc_bias: C.AscBias) -> None:
        """Switch the correction type (pll.c:1126-1172). The partition must
        have been created with asc_bias != NONE so the synthetic all-state-k
        columns are allocated."""
        if not self.asc_extra:
            raise C.PllError(C.ERROR_AB_NOSUPPORT,
                             "Partition was not created with ascertainment "
                             "bias support")
        if asc_bias != C.AscBias.NONE and np.any(self.prop_invar > 0):
            raise C.PllError(C.ERROR_INVAR_INCOMPAT,
                             "Invariant sites are not compatible with asc "
                             "bias correction")
        if asc_bias != C.AscBias.NONE and self.rate_scalers:
            raise C.PllError(C.ERROR_AB_NOSUPPORT,
                             "Per-rate scalers are not supported with asc "
                             "bias correction")
        self.asc_bias = asc_bias

    def set_asc_state_weights(self, state_weights) -> None:
        """Weights of the synthetic per-state columns (pll.c:1174-1181):
        for Stamatakis the per-state invariant-site counts; for Felsenstein
        the total number of invariant sites (on any column)."""
        if not self.asc_extra:
            raise C.PllError(C.ERROR_AB_NOSUPPORT,
                             "Partition was not created with ascertainment "
                             "bias support")
        w = np.asarray(state_weights, dtype=np.int64)
        self.pattern_weights[self.sites:self.sites + self.states] = w
        self._model_version += 1

    def update_invariant_sites_proportion(self, params_index: int,
                                          prop_invar: float) -> None:
        """models.c:495-544."""
        if prop_invar != 0.0 and self.asc_bias != C.AscBias.NONE:
            raise C.PllError(C.ERROR_INVAR_INCOMPAT,
                             "Invariant sites are not compatible with asc bias")
        if prop_invar < 0 or prop_invar >= 1:
            raise C.PllError(C.ERROR_INVAR_PROPORTION,
                             f"Invalid proportion of invariant sites ({prop_invar})")
        if prop_invar > 0.0 and not self._invariant_valid:
            self.update_invariant_sites()
        self.prop_invar[params_index] = prop_invar
        self._model_version += 1

    def update_invariant_sites(self) -> None:
        """Bitwise-AND of observed states per column (models.c:651-752)."""
        gap = np.uint64((1 << self.states) - 1)
        acc = np.full(self.sites, gap, dtype=np.uint64)
        for t in range(self.tips):
            if self._tips_set[t]:
                acc &= self.tip_states[t, :self.sites]
        popcount = np.array([bin(int(x)).count('1') for x in acc])
        inv = np.where(popcount == 1,
                       np.array([int(x).bit_length() - 1 for x in acc]), -1)
        self.invariant[:self.sites] = inv.astype(np.int32)
        self.invariant[self.sites:] = -1
        self._invariant_valid = True
        if not np.any(popcount == 1):
            raise C.PllError(C.ERROR_INVAR_NONEFOUND, "No invariant sites found")

    def count_invariant_sites(self) -> int:
        if not self._invariant_valid:
            self.update_invariant_sites()
        mask = self.invariant[:self.sites] >= 0
        return int(self.pattern_weights[:self.sites][mask].sum())

    # ----------------------------------------------------------------- eigen
    def update_eigen(self, params_index: int) -> None:
        es = ops_eigen.update_eigen(self.subst_params[params_index],
                                    self.frequencies[params_index])
        self.eigenvals[params_index] = es.eigenvals
        self.eigenvecs[params_index] = es.evecs
        self.inv_eigenvecs[params_index] = es.inv_evecs
        self.eigen_decomp_valid[params_index] = True
        self._model_version += 1

    def _ensure_eigen(self, params_indices) -> None:
        for p in set(int(i) for i in params_indices):
            if not self.eigen_decomp_valid[p]:
                self.update_eigen(p)

    # -------------------------------------------------------------- pmatrix
    def update_prob_matrices(self, params_indices, matrix_indices,
                             branch_lengths) -> None:
        """models.c:412-443 — batched over all requested edges at once."""
        params_indices = np.asarray(params_indices, dtype=np.int32)
        self._ensure_eigen(params_indices)
        pmat = ops_pmatrix.update_prob_matrices(
            jnp.asarray(self.eigenvals, self.dtype),
            jnp.asarray(self.inv_eigenvecs, self.dtype),
            jnp.asarray(self.eigenvecs, self.dtype),
            jnp.asarray(self.prop_invar, self.dtype),
            jnp.asarray(self.rates, self.dtype),
            jnp.asarray(params_indices),
            jnp.asarray(np.asarray(branch_lengths), self.dtype))
        self.pmatrix = self.pmatrix.at[jnp.asarray(
            np.asarray(matrix_indices, dtype=np.int32))].set(pmat)

    # -------------------------------------------------------------- partials
    def update_partials(self, operations: Sequence[Operation],
                        pad_to: Optional[int] = None,
                        update_repeats: bool = True) -> None:
        """partials.c:237-291 — one scan over the operation list.

        With site repeats enabled, operations are grouped into capacity
        buckets (see repeats.py) and each bucket runs as one scan computing
        only its class columns."""
        if self.repeats is not None and isinstance(operations, Operations):
            raise C.PllError(C.ERROR_PARAM_INVALID,
                             "site-repeats partitions need the host-side "
                             "Operation list (class columns), not packed "
                             "Operations")
        if self.repeats is not None:
            from .repeats import schedule_buckets_flat
            # rebuild the class schedule only when the operation list or tip
            # data changed — the cached schedule embeds ALL op fields
            # (matrix + scaler indices too), so the key must as well
            key = tuple((o.parent_clv_index, o.parent_scaler_index,
                         o.child1_clv_index, o.child1_matrix_index,
                         o.child1_scaler_index, o.child2_clv_index,
                         o.child2_matrix_index, o.child2_scaler_index)
                        for o in operations)
            if not update_repeats and self._repeat_schedule is not None:
                # reference PLL_ATTRIB semantics: reuse the existing class
                # schedule (pll_update_partials_rep update_repeats=0)
                pass
            elif (self._repeat_schedule is None
                    or getattr(self, "_repeat_key", None) != key):
                self._repeat_key = key
                layout, buckets = schedule_buckets_flat(
                    self.repeats, operations, self.sites + self.asc_extra,
                    self.scale_buffers)
                self._install_flat(layout)
                self._repeat_schedule = tuple(
                    (jnp.asarray(f), jnp.asarray(gl), jnp.asarray(gr))
                    for _, f, gl, gr, _, _ in buckets)
                self._repeat_profiles = tuple(
                    (il, ir) for _, _, _, _, il, ir in buckets)
            self.clv_flat, self.sc_flat = \
                ops_partials.update_partials_repeats_pool(
                    self.clv_flat, self.sc_flat, self.pmatrix,
                    self._repeat_schedule,
                    self.scale_threshold, self.scale_factor,
                    rate_scalers=self.rate_scalers,
                    profiles=self._repeat_profiles)
            return
        ops = operations if isinstance(operations, Operations) else \
            pack_operations(operations, pad_to=pad_to, scratch_clv=self.nodes)
        self.clv, self.scale_buffer = ops_partials.update_partials(
            self.clv, self.scale_buffer, self.pmatrix, ops,
            self.scale_threshold, self.scale_factor,
            rate_scalers=self.rate_scalers)

    # -------------------------------------------------------- flat storage
    def _install_flat(self, layout) -> None:
        """(Re)allocate the pooled class-column buffers for `layout` and
        seed the tip regions from the host-side tip columns."""
        R, s = self.rate_cats, self.states
        arr = np.zeros((R, s, layout.total))
        for tip, cols in self._tip_cols.items():
            o = int(layout.off[tip])
            arr[:, :, o:o + cols.shape[1]] = cols[None]
        self.clv_flat = jnp.asarray(arr, self.dtype)
        shape = (R, layout.sc_total) if self.rate_scalers \
            else (layout.sc_total,)
        self.sc_flat = jnp.zeros(shape, jnp.int32)
        self._flat = layout

    def _ensure_flat(self) -> None:
        if self._flat is None:
            from .repeats import build_flat_layout
            self._install_flat(build_flat_layout(
                self.repeats, {}, self.sites + self.asc_extra,
                self.scale_buffers))

    # ------------------------------------------------------------ likelihood
    def _scaler_row(self, index: int):
        if index == C.SCALE_BUFFER_NONE:
            # the guaranteed-zero row (never written)
            return self.scale_buffer[self.scale_buffers + 1], False
        return self.scale_buffer[index], True

    def _node_view(self, clv_index: int, scaler_index: int):
        """(clv, scaler, has_scaler) in per-site order — with repeats the
        pooled class columns are expanded through site_id."""
        if self.repeats is not None:
            self._ensure_flat()
            lay = self._flat
            sid = self.repeats.site_id[clv_index].astype(np.int64)
            clv_cols = (lay.off[clv_index] + sid).astype(np.int32)
            has = (scaler_index != C.SCALE_BUFFER_NONE
                   and lay.sc_caps[scaler_index] > 0)
            sc_base = lay.sc_off[scaler_index] if has else lay.sc_zero
            sc_cols = (sc_base + sid).astype(np.int32)
            clv_node, scaler = ops_partials.gather_flat_view(
                self.clv_flat, self.sc_flat,
                jnp.asarray(clv_cols), jnp.asarray(sc_cols))
            return clv_node, scaler, has
        scaler, has = self._scaler_row(scaler_index)
        return self.clv[clv_index], scaler, has

    def compute_root_loglikelihood(self, clv_index: int, scaler_index: int,
                                   freqs_indices, persite: bool = False):
        """likelihood.c:122-190."""
        clv_node, scaler, has_scaler = self._node_view(clv_index,
                                                       scaler_index)
        total, per = ops_likelihood.root_loglikelihood(
            clv_node, scaler,
            jnp.asarray(self.frequencies, self.dtype),
            jnp.asarray(self.prop_invar, self.dtype),
            jnp.asarray(self.rate_weights, self.dtype),
            jnp.asarray(np.asarray(freqs_indices, dtype=np.int32)),
            jnp.asarray(self.pattern_weights),
            jnp.asarray(self.invariant),
            self.scale_threshold,
            rate_scalers=self.rate_scalers, has_scaler=has_scaler,
            asc_type=self.asc_bias.value, n_real=self.sites)
        if persite:
            return float(total), np.asarray(per)[:self.sites]
        return float(total)

    def compute_edge_loglikelihood(self, parent_clv_index: int,
                                   parent_scaler_index: int,
                                   child_clv_index: int,
                                   child_scaler_index: int,
                                   matrix_index: int,
                                   freqs_indices,
                                   persite: bool = False):
        """likelihood.c:586-700."""
        pclv, pscaler, has_p = self._node_view(parent_clv_index,
                                               parent_scaler_index)
        cclv, cscaler, has_c = self._node_view(child_clv_index,
                                               child_scaler_index)
        total, per = ops_likelihood.edge_loglikelihood(
            pclv, cclv,
            pscaler, cscaler, self.pmatrix[matrix_index],
            jnp.asarray(self.frequencies, self.dtype),
            jnp.asarray(self.prop_invar, self.dtype),
            jnp.asarray(self.rate_weights, self.dtype),
            jnp.asarray(np.asarray(freqs_indices, dtype=np.int32)),
            jnp.asarray(self.pattern_weights),
            jnp.asarray(self.invariant),
            self.scale_threshold,
            rate_scalers=self.rate_scalers,
            has_pscaler=has_p, has_cscaler=has_c,
            asc_type=self.asc_bias.value, n_real=self.sites)
        if persite:
            return float(total), np.asarray(per)[:self.sites]
        return float(total)

    def compute_node_ancestral(self, node_clv_index: int,
                               node_scaler_index: int,
                               other_clv_index: int,
                               other_scaler_index: int,
                               matrix_index: int,
                               freqs_indices) -> np.ndarray:
        """Marginal ancestral state probabilities [sites, states] at `node`,
        combining its CLV with the neighbor's CLV across the connecting
        edge (reference: /root/reference/src/likelihood.c:758-830,
        pll_compute_node_ancestral).  Unlike the reference, site-repeats
        partitions are supported (class columns are expanded per site)."""
        nclv, nscaler, has_n = self._node_view(node_clv_index,
                                               node_scaler_index)
        oclv, oscaler, has_o = self._node_view(other_clv_index,
                                               other_scaler_index)
        anc = ops_likelihood.node_ancestral(
            nclv, oclv, nscaler, oscaler, self.pmatrix[matrix_index],
            jnp.asarray(self.frequencies, self.dtype),
            jnp.asarray(self.rate_weights, self.dtype),
            jnp.asarray(np.asarray(freqs_indices, dtype=np.int32)),
            self.scale_threshold,
            rate_scalers=self.rate_scalers,
            has_nscaler=has_n, has_oscaler=has_o)
        return np.asarray(anc)[:self.sites]

    # ----------------------------------------------------------- derivatives
    def update_sumtable(self, parent_clv_index: int, child_clv_index: int,
                        parent_scaler_index: int, child_scaler_index: int,
                        params_indices) -> jnp.ndarray:
        """derivatives.c:239-330 (phase 1, once per edge)."""
        pclv, pscaler, has_p = self._node_view(parent_clv_index,
                                               parent_scaler_index)
        cclv, cscaler, has_c = self._node_view(child_clv_index,
                                               child_scaler_index)
        return ops_derivatives.update_sumtable(
            pclv, cclv,
            pscaler, cscaler,
            jnp.asarray(self.inv_eigenvecs, self.dtype),
            jnp.asarray(self.eigenvecs, self.dtype),
            jnp.asarray(self.frequencies, self.dtype),
            jnp.asarray(np.asarray(params_indices, dtype=np.int32)),
            self.scale_threshold,
            rate_scalers=self.rate_scalers,
            has_pscaler=has_p, has_cscaler=has_c)

    def compute_likelihood_derivatives(self, sumtable: jnp.ndarray,
                                       params_indices,
                                       branch_length: float,
                                       parent_scaler_index: int =
                                       C.SCALE_BUFFER_NONE,
                                       child_scaler_index: int =
                                       C.SCALE_BUFFER_NONE):
        """derivatives.c:333-416 (phase 2, per candidate length).

        For Lewis/Felsenstein ascertainment bias the parent/child scaler
        indices of the sumtable's edge must be passed so the synthetic
        columns' absolute likelihoods can be un-scaled."""
        asc_scalers = None
        if self.asc_bias.value in (1, 2):   # Lewis / Felsenstein
            sc = jnp.zeros(self.sites_padded, dtype=jnp.int32)
            for idx in (parent_scaler_index, child_scaler_index):
                row, has = self._scaler_row(idx)
                if has:
                    sc = sc + row
            asc_scalers = sc
        d1, d2 = ops_derivatives.likelihood_derivatives(
            sumtable,
            jnp.asarray(self.eigenvals, self.dtype),
            jnp.asarray(self.prop_invar, self.dtype),
            jnp.asarray(self.frequencies, self.dtype),
            jnp.asarray(self.rates, self.dtype),
            jnp.asarray(self.rate_weights, self.dtype),
            jnp.asarray(np.asarray(params_indices, dtype=np.int32)),
            jnp.asarray(self.pattern_weights),
            jnp.asarray(self.invariant),
            jnp.asarray(branch_length, self.dtype),
            asc_scalers=asc_scalers,
            scale_threshold=self.scale_threshold,
            asc_type=self.asc_bias.value, n_real=self.sites)
        return float(d1), float(d2)

    # ------------------------------------------------------------- debugging
    def get_clv(self, index: int) -> np.ndarray:
        """CLV as [sites, rate_cats, states] (reference memory order);
        with repeats, pooled class columns are expanded to per-site
        order."""
        if self.repeats is not None:
            self._ensure_flat()
            lay = self._flat
            o, c = int(lay.off[index]), int(lay.caps[index])
            block = np.asarray(self.clv_flat[:, :, o:o + c])
            block = block[:, :, self.repeats.site_id[index]]
        else:
            block = np.asarray(self.clv[index])[:, :, :self.sites]
        return np.transpose(block, (2, 0, 1))

    def clv_bytes(self) -> int:
        """Allocated CLV+scaler bytes — the site-repeats memory win is
        directly observable here (reference: EPA-ng -30% footprint,
        /root/reference/README.md:14)."""
        if self.repeats is not None:
            self._ensure_flat()
            return (self.clv_flat.size * self.clv_flat.dtype.itemsize
                    + self.sc_flat.size * self.sc_flat.dtype.itemsize)
        return (self.clv.size * self.clv.dtype.itemsize
                + self.scale_buffer.size * self.scale_buffer.dtype.itemsize)

    def get_pmatrix(self, index: int) -> np.ndarray:
        return np.asarray(self.pmatrix[index])

    def get_scaler(self, index: int) -> np.ndarray:
        """Scaler contents; with repeats this is the raw class-layout
        region of the pooled buffer (width = the writer's capacity)."""
        if self.repeats is not None:
            self._ensure_flat()
            lay = self._flat
            o, c = int(lay.sc_off[index]), int(lay.sc_caps[index])
            return np.asarray(self.sc_flat[..., o:o + c])
        return np.asarray(self.scale_buffer[index])[..., :self.sites]
