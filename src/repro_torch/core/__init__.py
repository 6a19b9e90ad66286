"""QEdgeProxy core in PyTorch: the MP-MAB bandit (``bandit.py``), KDE
QoS estimation (``kde.py``), SWRR routing (``swrr.py``), oracle regret
(``oracle.py``) and player-indexed randomness that reproduces
``jax.random`` (``prand.py``)."""
from repro_torch.core.bandit import (
    BanditParams,
    BanditState,
    BreakerState,
    breaker_init,
    breaker_is_open,
    breaker_reset_arms,
    breaker_update,
    breaker_veto,
    censored_latency,
    init_state,
    instance_added,
    instance_removed,
    keep_lanes,
    maintenance,
    masked_pick,
    maintenance_subset,
    record,
    record_batch,
    record_feedback,
    record_rings_batch,
    retry_pick,
    select,
    sync_active,
)
from repro_torch.core.kde import (
    empirical_success_prob,
    kde_success_prob,
    masked_quantile,
    normal_cdf,
    silverman_bandwidth,
)
from repro_torch.core.oracle import oracle_weights, step_regret, variation_budget
from repro_torch.core.swrr import swrr_select

__all__ = [
    "BanditParams", "BanditState", "BreakerState", "breaker_init",
    "breaker_is_open", "breaker_reset_arms", "breaker_update",
    "breaker_veto", "censored_latency", "masked_pick", "retry_pick",
    "init_state", "select", "record",
    "record_batch", "record_feedback", "record_rings_batch", "maintenance",
    "maintenance_subset", "instance_added", "instance_removed", "keep_lanes",
    "sync_active", "kde_success_prob", "empirical_success_prob",
    "silverman_bandwidth", "masked_quantile", "normal_cdf",
    "oracle_weights", "step_regret", "variation_budget", "swrr_select",
]
