"""Computing-Continuum emulation substrate (paper §VII testbed), the
streaming main path in PyTorch."""
from repro_torch.continuum.metrics import (
    MetricAccumulator,
    StepSeries,
    StreamOutputs,
    client_qos_satisfaction_stream,
    jain_fairness_stream,
    proc_latency_quantile_stream,
    request_rate_per_instance_stream,
    rolling_qos_series,
)
from repro_torch.continuum.scenarios import Drivers, neutral_drivers
from repro_torch.continuum.simulator import SimConfig, run_sim_stream
from repro_torch.continuum.topology import Topology, make_topology

__all__ = [
    "MetricAccumulator", "StepSeries", "StreamOutputs",
    "client_qos_satisfaction_stream", "jain_fairness_stream",
    "proc_latency_quantile_stream", "request_rate_per_instance_stream",
    "rolling_qos_series", "Drivers", "neutral_drivers", "SimConfig",
    "run_sim_stream", "Topology", "make_topology",
]
