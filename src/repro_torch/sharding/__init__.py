"""Distribution layer: logical-axis partitioning rules."""
from repro_torch.sharding.partitioning import (
    DEFAULT_RULES,
    get_rules,
    logical_to_spec,
    rule_overrides,
    set_rules,
)

__all__ = ["DEFAULT_RULES", "get_rules", "logical_to_spec",
           "rule_overrides", "set_rules"]
