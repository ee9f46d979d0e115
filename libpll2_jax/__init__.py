"""libpll2_jax — a JAX phylogenetic likelihood engine.

A ground-up JAX/XLA/Pallas re-design with the capabilities of libpll-2
(the site-repeats fork): transition matrices via eigendecomposition,
Felsenstein-pruning CLVs, root/edge log-likelihoods, branch-length
derivatives (Newton engine), parsimony, tree plumbing and alignment I/O —
built for batched, sharded execution on GPU device meshes.
"""
from . import constants
from .constants import AscBias, PllError
from .partition import Operation, Partition, pack_operations
from .ops.gamma import compute_gamma_cats
from .engine import TreeEngine
from . import checkpoint
from .partitioned import PartitionedEngine
from .bootstrap import bootstrap_loglikelihoods
from . import modelselect
from .placement import EdgePlacer
from .ops.df64 import loglikelihood_df64

__all__ = [
    "constants", "AscBias", "PllError",
    "Operation", "Partition", "pack_operations",
    "compute_gamma_cats", "TreeEngine", "checkpoint",
    "PartitionedEngine", "bootstrap_loglikelihoods", "modelselect",
    "EdgePlacer", "loglikelihood_df64",
]
__version__ = "0.1.0"
