"""The paper's contribution, ported to PyTorch: power-proportional dynamic
provisioning through ``provision(ProvisionSpec(...))``.

Ported so far: the cost model (scalar, per-level and typed fleets), the
engine behind ``provision()`` for all seven policies, its streaming twin
``provision_stream()`` for the online ones, deferral
(``Workload(deferral=...)``), the ski-rental bounds, the synthetic
traces and the continuous-time brick event model (``events.py``, with
``brick_trace_from_fluid``).  The other numpy oracles (fluid, online,
offline, segments, dp_oracle, analysis) and the multi-device route are still
to come (ROADMAP.md).
"""
from ..deferral import DeferralSpec
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
from .ski_rental import theoretical_ratio
from .events import BrickTrace, Job, generate_brick_trace, trace_from_intervals
from .stepfn import StepFn
from .torch_provision import (
    POLICIES,
    RANDOMIZED as RANDOMIZED_POLICIES,
    on_matrix_cost,
)
from .traces import (
    brick_trace_from_fluid,
    msr_like_trace,
    pmr,
    scale_to_pmr,
    with_prediction_error,
)

__all__ = [
    "PAPER_COSTS",
    "CostModel",
    "DeferralSpec",
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
    "theoretical_ratio",
    "BrickTrace",
    "Job",
    "brick_trace_from_fluid",
    "generate_brick_trace",
    "msr_like_trace",
    "trace_from_intervals",
    "pmr",
    "scale_to_pmr",
    "with_prediction_error",
]
