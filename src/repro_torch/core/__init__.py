"""The paper's contribution, ported to PyTorch: power-proportional dynamic
provisioning through ``provision(ProvisionSpec(...))``.

Ported so far: the cost model (scalar, per-level and typed fleets), the
engine behind ``provision()`` for all seven policies, its streaming twin
``provision_stream()`` for the online ones, and the synthetic traces.  The
brick/fluid numpy oracles, deferral and the multi-device route are still to
come (ROADMAP.md).
"""
from .costs import PAPER_COSTS, CostModel, ServerGroup, schedule_cost
from .provision import (
    PolicySpec,
    PredictionNoise,
    ProvisionResult,
    ProvisionSpec,
    Workload,
    provision,
    provision_stream,
)
from .stepfn import StepFn
from .torch_provision import (
    POLICIES,
    RANDOMIZED as RANDOMIZED_POLICIES,
    on_matrix_cost,
)
from .traces import msr_like_trace, pmr, scale_to_pmr, with_prediction_error

__all__ = [
    "PAPER_COSTS",
    "CostModel",
    "ServerGroup",
    "schedule_cost",
    "POLICIES",
    "RANDOMIZED_POLICIES",
    "PolicySpec",
    "PredictionNoise",
    "ProvisionResult",
    "ProvisionSpec",
    "StepFn",
    "Workload",
    "provision",
    "provision_stream",
    "on_matrix_cost",
    "msr_like_trace",
    "pmr",
    "scale_to_pmr",
    "with_prediction_error",
]
