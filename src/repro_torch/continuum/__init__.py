"""Computing-Continuum emulation substrate (paper §VII testbed) in
PyTorch: the simulator with its three strategies, streaming and
trace-mode metrics, drivers and the topology."""
from repro_torch.continuum.metrics import (
    MetricAccumulator,
    StepSeries,
    StreamOutputs,
    client_qos_satisfaction,
    client_qos_satisfaction_stream,
    cumulative_regret,
    cumulative_regret_series,
    jain_fairness,
    jain_fairness_stream,
    p90_proc_latency,
    per_client_success,
    per_client_success_stream,
    per_lb_request_distribution,
    per_lb_request_distribution_stream,
    per_lb_rolling_qos,
    proc_latency_quantile_stream,
    request_rate_per_instance,
    request_rate_per_instance_stream,
    rolling_qos,
    rolling_qos_series,
    variation_budget_emp,
    variation_budget_stream,
)
from repro_torch.continuum.scenarios import Drivers, neutral_drivers
from repro_torch.continuum.simulator import (SimConfig, SimOutputs, run_sim,
                                             run_sim_stream)
from repro_torch.continuum.topology import Topology, make_topology

__all__ = [
    "MetricAccumulator", "StepSeries", "StreamOutputs",
    "client_qos_satisfaction", "client_qos_satisfaction_stream",
    "cumulative_regret", "cumulative_regret_series", "jain_fairness",
    "jain_fairness_stream", "p90_proc_latency", "per_client_success",
    "per_client_success_stream", "per_lb_request_distribution",
    "per_lb_request_distribution_stream", "per_lb_rolling_qos",
    "proc_latency_quantile_stream", "request_rate_per_instance",
    "request_rate_per_instance_stream", "rolling_qos",
    "rolling_qos_series", "variation_budget_emp", "variation_budget_stream",
    "Drivers", "neutral_drivers", "SimConfig", "SimOutputs", "run_sim",
    "run_sim_stream", "Topology", "make_topology",
]
