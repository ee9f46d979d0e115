"""M5 validation: randomized stepwise-addition starting trees — identical
topology and parsimony cost to the reference for the same seed (the
examples/stepwise scenario)."""
import ctypes as ct

import numpy as np
import pytest

import oracle
from libpll2_jax import Partition
from libpll2_jax.io import maps
from libpll2_jax.parsimony import FastParsimony
from libpll2_jax.parsimony.stepwise import fastparsimony_stepwise
from libpll2_jax.trees import export_newick, random_utree
from libpll2_jax.utils.rng import GlibcRandom, create_shuffled
from libpll2_jax.utils.simulate import simulate_alignment

pytestmark = pytest.mark.skipif(not oracle.available(),
                                reason="reference not available")

N_TAXA = 20
N_SITES = 250


def _data(seed=31):
    tree = random_utree([f"t{i}" for i in range(N_TAXA)], seed=seed)
    headers, seqs = simulate_alignment(
        tree, N_SITES, [0.25] * 4, [1, 2, 1, 1, 2, 1], alpha=1.0, seed=seed)
    return headers, seqs


def test_rng_matches_reference():
    lib = oracle.load()
    lib.pll_random_create.restype = ct.c_void_p
    lib.pll_random_create.argtypes = [ct.c_uint]
    lib.pll_random_getint.restype = ct.c_int
    lib.pll_random_getint.argtypes = [ct.c_void_p, ct.c_int]
    for seed in (1, 42, 0xDEADBEEF):
        st = lib.pll_random_create(seed)
        ours = GlibcRandom(seed)
        assert [lib.pll_random_getint(st, 10 ** 6) for _ in range(64)] == \
            [ours.getint(10 ** 6) for _ in range(64)]


def _oracle_stepwise(headers, seqs, seed):
    lib = oracle.load()
    lib.pll_fastparsimony_stepwise.restype = ct.c_void_p
    lib.pll_fastparsimony_stepwise.argtypes = [
        ct.POINTER(ct.POINTER(oracle.PllParsimony)),
        ct.POINTER(ct.c_char_p), ct.POINTER(ct.c_uint), ct.c_uint,
        ct.c_uint]
    lib.pll_utree_export_newick.restype = ct.c_char_p
    lib.pll_utree_export_newick.argtypes = [ct.c_void_p, ct.c_void_p]

    part = oracle.OraclePartition(len(headers), len(headers) - 2, 4,
                                  N_SITES, 1, 2 * len(headers) - 3, 1,
                                  len(headers) - 2)
    for i, (h, s) in enumerate(zip(headers, seqs)):
        part.set_tip_states(i, "nt", s)
    pars = lib.pll_fastparsimony_init(part.ptr)
    assert pars
    plist = (ct.POINTER(oracle.PllParsimony) * 1)(pars)
    labels = (ct.c_char_p * len(headers))(*[h.encode() for h in headers])
    cost = ct.c_uint()
    tree_ptr = lib.pll_fastparsimony_stepwise(plist, labels,
                                              ct.byref(cost), 1, seed)
    assert tree_ptr

    class Utree(ct.Structure):
        _fields_ = [("tip_count", ct.c_uint), ("inner_count", ct.c_uint),
                    ("edge_count", ct.c_uint), ("binary", ct.c_int),
                    ("nodes", ct.c_void_p), ("vroot", ct.c_void_p)]

    ut = ct.cast(tree_ptr, ct.POINTER(Utree)).contents
    newick = lib.pll_utree_export_newick(ut.vroot, None).decode()
    lib.pll_parsimony_destroy(pars)
    part.destroy()
    return newick, cost.value


@pytest.mark.parametrize("seed", [1, 42, 99991])
def test_stepwise_tree_matches_reference(seed):
    headers, seqs = _data()
    newick_ref, cost_ref = _oracle_stepwise(headers, seqs, seed)

    part = Partition(len(headers), len(headers) - 2, 4, N_SITES, 1,
                     2 * len(headers) - 3, 1, len(headers) - 2)
    for i, s in enumerate(seqs):
        part.set_tip_states(i, maps.map_nt, s)
    fp = FastParsimony(part)
    tree, cost = fastparsimony_stepwise([fp], headers, seed)

    assert cost == cost_ref
    assert export_newick(tree.vroot) == newick_ref


def test_stepwise_seed_zero_identity_order():
    headers, seqs = _data()
    assert create_shuffled(6, 0) == list(range(6))
    part = Partition(len(headers), len(headers) - 2, 4, N_SITES, 1,
                     2 * len(headers) - 3, 1, len(headers) - 2)
    for i, s in enumerate(seqs):
        part.set_tip_states(i, maps.map_nt, s)
    fp = FastParsimony(part)
    tree, cost = fastparsimony_stepwise([fp], headers, 0)
    labels = sorted(t.label for t in tree.tips())
    assert labels == sorted(headers)
    assert cost > 0


def test_stepwise_native_matches_jax_path():
    """The host-native engine (native/pllnative.cpp pll_nat_stepwise) and
    the JAX loop produce bit-identical trees and costs — including a
    multi-partition build (reference stepwise.c:337-346 score summing)."""
    headers, seqs = _data(seed=17)

    def make_fp(sites_slice):
        part = Partition(len(headers), len(headers) - 2, 4,
                         len(sites_slice[0]), 1, 2 * len(headers) - 3, 1,
                         len(headers) - 2)
        for i, s in enumerate(sites_slice):
            part.set_tip_states(i, maps.map_nt, s)
        return FastParsimony(part)

    for plist in ([make_fp(seqs)],
                  [make_fp([s[:120] for s in seqs]),
                   make_fp([s[120:] for s in seqs])]):
        for seed in (3, 77):
            tn, cn = fastparsimony_stepwise(plist, headers, seed)
            tp, cp = fastparsimony_stepwise(plist, headers, seed,
                                            use_native=False)
            assert cn == cp
            assert export_newick(tn.vroot) == export_newick(tp.vroot)
