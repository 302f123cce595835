"""Core Byzantine-robust aggregation library (counterpart of repro.core)."""
from repro_torch.core.types import (
    ALL_RULES, ATTACKS, COORDINATE_RULES, GRAM_RULES, AggregatorSpec,
)
from repro_torch.core.aggregators import (
    RULES, aggregate, average, cwmed, cwtm, geometric_median, get_rule, krum,
    mda, meamed, multikrum,
)
from repro_torch.core.nnm import nnm, nnm_direct, nnm_matrix_from_stack
from repro_torch.core.attacks import apply_attack, apply_attack_tree
from repro_torch.core.robust import robust_aggregate, tree_combine, tree_gram, tree_mix
from repro_torch.core import theory

__all__ = [
    "AggregatorSpec", "ALL_RULES", "ATTACKS", "COORDINATE_RULES",
    "GRAM_RULES", "RULES", "aggregate", "average", "cwmed", "cwtm",
    "geometric_median", "get_rule", "krum", "mda", "meamed", "multikrum",
    "nnm", "nnm_direct", "nnm_matrix_from_stack", "apply_attack",
    "apply_attack_tree", "robust_aggregate",
    "tree_combine", "tree_gram", "tree_mix", "theory",
]
