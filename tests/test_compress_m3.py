"""M3 validation: site-pattern compression vs the reference
(test/src/compress-patterns.c scenario): identical pattern order, weights,
back-map, and logL equality compressed vs uncompressed."""
import ctypes as ct

import numpy as np
import pytest

import oracle
from libpll2_jax import Partition, TreeEngine, compute_gamma_cats
from libpll2_jax.io import maps
from libpll2_jax.io.compress import compress_site_patterns
from libpll2_jax.trees import random_alignment, random_utree

pytestmark = pytest.mark.skipif(not oracle.available(),
                                reason="reference not available")


def reference_compress(seqs, mapname):
    lib = oracle.load()
    lib.pll_compress_site_patterns.restype = ct.POINTER(ct.c_uint)
    lib.pll_compress_site_patterns.argtypes = [
        ct.POINTER(ct.c_char_p), ct.POINTER(ct.c_ulonglong * 256),
        ct.c_int, ct.POINTER(ct.c_int)]
    bufs = [ct.create_string_buffer(s.encode()) for s in seqs]
    arr = (ct.c_char_p * len(seqs))(*[ct.cast(b, ct.c_char_p) for b in bufs])
    length = ct.c_int(len(seqs[0]))
    w = lib.pll_compress_site_patterns(arr, oracle.charmap(mapname),
                                       len(seqs), ct.byref(length))
    assert w
    n = length.value
    weights = [w[i] for i in range(n)]
    out = [arr[i][:n].decode() for i in range(len(seqs))]
    return out, weights


def test_compression_matches_reference_order_and_weights():
    headers, seqs = random_alignment(8, 500, seed=5, gap_prob=0.05)
    comp, weights, site_map = compress_site_patterns(seqs, maps.map_nt,
                                                     return_map=True)
    ref_seqs, ref_weights = reference_compress(list(seqs), "nt")
    assert list(weights) == list(ref_weights)
    # exact character-level equality with the reference output
    assert comp == ref_seqs
    # back-map reconstructs the original columns
    ours = np.array([maps.decode_states(s, maps.map_nt) for s in comp])
    np.testing.assert_array_equal(
        ours[:, site_map],
        np.array([maps.decode_states(s, maps.map_nt) for s in seqs]))


def test_compression_matches_reference_amino_acid():
    """AA masks exceed a byte: the reference remaps to sequential codes in
    ASCII scan order (compress.c:99-135) — order and decode chars must
    still match exactly."""
    rng = np.random.default_rng(11)
    chars = np.array(list("arNDCQEghilkmfpstwyvX-"))
    seqs = ["".join(chars[rng.integers(0, len(chars), 300)])
            for _ in range(5)]
    comp, weights, _ = compress_site_patterns(seqs, maps.map_aa,
                                              return_map=True)
    ref_seqs, ref_weights = reference_compress(list(seqs), "aa")
    assert list(weights) == list(ref_weights)
    assert comp == ref_seqs


def test_compressed_logl_equals_uncompressed():
    # 4 taxa -> at most 256 distinct columns over 400 sites, so the random
    # alignment is guaranteed to compress
    headers, seqs = random_alignment(4, 400, seed=9)
    tree = random_utree(headers, seed=9)
    by_label = dict(zip(headers, seqs))
    rng = np.random.default_rng(5)
    freqs = rng.dirichlet(np.ones(4) * 10)
    subst = rng.uniform(0.5, 2.0, size=6)
    rates = compute_gamma_cats(0.8, 4)

    def build(seq_list, weights=None):
        part = Partition(tree.tip_count, tree.inner_count, 4,
                         len(seq_list[0]), 1, tree.edge_count, 4,
                         tree.inner_count)
        for tip in tree.tips():
            idx = headers.index(tip.label)
            part.set_tip_states(tip.clv_index, maps.map_nt, seq_list[idx])
        part.set_frequencies(0, freqs)
        part.set_subst_params(0, subst)
        part.set_category_rates(rates)
        if weights is not None:
            part.set_pattern_weights(weights)
        return TreeEngine(part, tree).loglikelihood()

    lk_full = build(list(seqs))
    comp, weights, _ = compress_site_patterns(seqs, maps.map_nt)
    assert len(comp[0]) < len(seqs[0])
    lk_comp = build(comp, weights)
    np.testing.assert_allclose(lk_comp, lk_full, rtol=1e-10)
