"""The paper's contribution, ported to PyTorch: power-proportional dynamic
provisioning.

Public API, as ``repro.core`` has it:
  * Declarative provisioning: ``provision(ProvisionSpec(...))`` with
    ``CostModel`` (scalar or per-level), ``Workload``, ``PolicySpec``,
    ``PredictionNoise`` — returns a ``ProvisionResult``; on the card every
    online policy's slot scan is kernel K2 (K1 under ``record_decisions``),
    and ``provision_stream()`` is its twin for production-length traces.
  * Brick (continuous-time) model: ``BrickTrace``, ``simulate`` (online),
    ``a0_schedule``/``a0_cost``/``optimal_schedule_constructed`` (offline),
    ``critical_segments`` — the paper's divide-and-conquer.
  * Fluid (discrete-time) model: ``fluid_cost``, ``fluid_scan``.
  * Policies: ``A1Deterministic``, ``A2Randomized``, ``A3Randomized``.
  * Validation: ``dp_optimal_cost``.

The brick, fluid, offline and DP modules are numpy copies of the
reference's, the oracles the card's results are held to.  The loose-kwargs
``provision_schedule``/``provision_sweep[_costs]``/``provision_cost``
functions are deprecated wrappers around ``provision``, and
``provision_schedule_sharded`` one around its ``mesh=`` route.
"""
from ..deferral import DeferralSpec
from .costs import PAPER_COSTS, CostModel, ServerGroup, schedule_cost
from .dp_oracle import dp_optimal_cost
from .events import BrickTrace, Job, generate_brick_trace, trace_from_intervals
from .fluid import FluidResult, fluid_cost, fluid_scan
from .provision import (
    PolicySpec,
    PredictionNoise,
    ProvisionResult,
    ProvisionSpec,
    Workload,
    provision,
    provision_stream,
)
from .offline import a0_cost, a0_schedule, optimal_cost, optimal_schedule_constructed
from .online import SimResult, simulate
from .segments import CriticalSegment, SegmentType, critical_segments, critical_times
from .ski_rental import (
    A1Deterministic,
    A2Randomized,
    A3Randomized,
    BreakEven,
    DelayedOffPolicy,
    OfflinePolicy,
    theoretical_ratio,
)
from .stepfn import StepFn
from .torch_provision import (
    POLICIES,
    RANDOMIZED as RANDOMIZED_POLICIES,
    on_matrix_cost,
    provision_cost,
    provision_schedule,
    provision_schedule_sharded,
    provision_sweep,
    provision_sweep_costs,
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
    "dp_optimal_cost",
    "BrickTrace",
    "Job",
    "generate_brick_trace",
    "trace_from_intervals",
    "FluidResult",
    "fluid_cost",
    "fluid_scan",
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
    "provision_cost",
    "provision_schedule",
    "provision_schedule_sharded",
    "provision_sweep",
    "provision_sweep_costs",
    "a0_cost",
    "a0_schedule",
    "optimal_cost",
    "optimal_schedule_constructed",
    "SimResult",
    "simulate",
    "CriticalSegment",
    "SegmentType",
    "critical_segments",
    "critical_times",
    "A1Deterministic",
    "A2Randomized",
    "A3Randomized",
    "BreakEven",
    "DelayedOffPolicy",
    "OfflinePolicy",
    "theoretical_ratio",
    "brick_trace_from_fluid",
    "msr_like_trace",
    "pmr",
    "scale_to_pmr",
    "with_prediction_error",
]
