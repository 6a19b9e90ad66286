"""Distribution layer: logical-axis partitioning rules, the placement of
tensors on meshes of ranks, and the model's collectives."""
from repro_torch.sharding.partitioning import (
    DEFAULT_RULES,
    Sharding,
    constrain,
    fit_spec,
    fitted,
    current_mesh,
    get_rules,
    is_axes_leaf,
    logical_to_spec,
    place,
    rule_overrides,
    rules_for,
    set_rules,
    sharding_of,
    tree_shardings,
)

__all__ = [
    "DEFAULT_RULES", "Sharding", "constrain", "fit_spec", "fitted", "current_mesh", "get_rules",
    "is_axes_leaf", "logical_to_spec", "place", "rule_overrides", "rules_for",
    "set_rules", "sharding_of", "tree_shardings",
]
