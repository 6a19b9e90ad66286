"""Computing-Continuum emulation substrate (paper §VII testbed) in
PyTorch: the simulator with its three strategies, single runs and
lane-batched ones, the request lifecycle and the closed-loop control
plane, chunked and checkpointed runs, streaming and trace-mode metrics
with the event and resilience readouts, the scenario compiler and its
library, drivers and the topology."""
from repro_torch.continuum.control import (
    ControlConfig,
    control_stats_stream,
    per_tenant_qos_spread,
)
from repro_torch.continuum.metrics import (
    MetricAccumulator,
    StepSeries,
    StreamOutputs,
    breaker_open_fraction_stream,
    client_qos_satisfaction,
    client_qos_satisfaction_stream,
    cumulative_regret,
    cumulative_regret_series,
    event_recovery,
    event_windows_from_series,
    goodput_offered_series,
    jain_fairness,
    jain_fairness_stream,
    lane,
    p90_proc_latency,
    per_client_success,
    per_client_success_stream,
    per_lb_request_distribution,
    per_lb_request_distribution_stream,
    per_lb_rolling_qos,
    proc_latency_quantile_stream,
    request_rate_per_instance,
    request_rate_per_instance_stream,
    resilience_stats,
    resilience_stats_stream,
    rolling_qos,
    rolling_qos_series,
    variation_budget_emp,
    variation_budget_stream,
)
from repro_torch.continuum.library import get_library
from repro_torch.continuum.scenarios import (
    Autoscale,
    ClientChurn,
    DiurnalWave,
    Drivers,
    InstanceKill,
    InstanceRestore,
    LinkDegrade,
    LoadSurge,
    Partition,
    RttDrift,
    Scenario,
    ServiceSlowdown,
    compile_scenario,
    neutral_drivers,
    slice_drivers,
    stack_drivers,
    with_standby,
)
from repro_torch.continuum.simulator import (SimConfig, SimOutputs,
                                             build_sim_chunks,
                                             build_sim_grid_fn, run_sim,
                                             run_sim_batch, run_sim_grid,
                                             run_sim_stream)
from repro_torch.continuum.topology import Topology, make_topology

__all__ = [
    "ControlConfig", "control_stats_stream", "per_tenant_qos_spread",
    "MetricAccumulator", "StepSeries", "StreamOutputs",
    "breaker_open_fraction_stream", "goodput_offered_series",
    "resilience_stats", "resilience_stats_stream",
    "client_qos_satisfaction", "client_qos_satisfaction_stream",
    "cumulative_regret", "cumulative_regret_series", "event_recovery",
    "event_windows_from_series", "jain_fairness", "jain_fairness_stream",
    "lane", "p90_proc_latency", "per_client_success",
    "per_client_success_stream", "per_lb_request_distribution",
    "per_lb_request_distribution_stream", "per_lb_rolling_qos",
    "proc_latency_quantile_stream", "request_rate_per_instance",
    "request_rate_per_instance_stream", "rolling_qos",
    "rolling_qos_series", "variation_budget_emp", "variation_budget_stream",
    "get_library", "Autoscale", "ClientChurn", "DiurnalWave", "Drivers",
    "InstanceKill", "InstanceRestore", "LinkDegrade", "LoadSurge",
    "Partition", "RttDrift", "Scenario", "ServiceSlowdown",
    "compile_scenario", "neutral_drivers", "slice_drivers",
    "stack_drivers", "with_standby",
    "SimConfig", "SimOutputs", "build_sim_chunks", "build_sim_grid_fn",
    "run_sim",
    "run_sim_batch", "run_sim_grid", "run_sim_stream", "Topology",
    "make_topology",
]
