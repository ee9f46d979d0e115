"""Model selection (ModelTest-NG pattern): nested DNA templates and
empirical AA ranking recover the generating model on simulated data."""
import numpy as np

from libpll2_jax import Partition, TreeEngine, compute_gamma_cats
from libpll2_jax.io import maps
from libpll2_jax.modelselect import select_aa_model, select_dna_model
from libpll2_jax.models import aa_model
from libpll2_jax.trees import random_utree
from libpll2_jax.utils import simulate_alignment


def test_select_dna_model_recovers_hky():
    """Data simulated with a strong transition/transversion ratio and
    skewed frequencies: JC must lose; the winner must be an
    HKY-or-richer model, and nested logL ordering must hold."""
    tree = random_utree([f"t{i}" for i in range(12)], seed=21)
    freqs = [0.4, 0.15, 0.15, 0.3]
    subst = [1.0, 6.0, 1.0, 1.0, 6.0, 1.0]          # kappa = 6
    headers, seqs = simulate_alignment(tree, 1500, freqs, subst,
                                       alpha=0.8, seed=21)
    by = dict(zip(headers, seqs))
    rows = select_dna_model(tree, by, rate_cats=4,
                            models=("JC", "HKY", "GTR"), steps=120)
    by_name = {r["model"]: r for r in rows}
    # nested models: logL(JC) <= logL(HKY) <= logL(GTR)
    assert by_name["JC"]["logL"] <= by_name["HKY"]["logL"] + 1e-3
    assert by_name["HKY"]["logL"] <= by_name["GTR"]["logL"] + 1e-3
    # the ti/tv signal is strong: JC must rank last under BIC
    assert rows[-1]["model"] == "JC"
    assert rows[0]["model"] in ("HKY", "GTR")
    # HKY's fitted kappa is materially above 1
    hky = by_name["HKY"]
    kappa = hky["subst"][1] / hky["subst"][0]
    assert kappa > 2.5, kappa
    # and the fitted frequencies lean the right way
    assert hky["freqs"][0] > hky["freqs"][1]


def test_select_aa_model_recovers_lg():
    tree = random_utree([f"t{i}" for i in range(8)], seed=31)
    rates, freqs = aa_model("lg")
    headers, seqs = simulate_alignment(tree, 600, freqs, rates,
                                       alpha=1.0, seed=31)
    by = dict(zip(headers, seqs))
    rows = select_aa_model(tree, by, rate_cats=4,
                           models=("lg", "wag", "blosum62"), steps=80)
    assert rows[0]["model"] == "lg", [r["model"] for r in rows]
    assert rows[0]["BIC"] < rows[1]["BIC"]
