"""Serving: the paper's autoscaler, the fleet planner and its stepper.

The PyTorch port of ``repro.serving``.  ``FleetProvisioner.advance()``
streams: the O(1)-state incremental stepper behind it (engine carry through
kernel K2, slot-indexed draws) lives in :mod:`repro_torch.serving.stepper`
and is exported here for direct use; :class:`PlanMetrics` exports its
health as Prometheus text.

Not ported yet: the cluster simulation (``run_cluster``,
``make_window_max_predictor``, ``ClusterReport``) needs the session traces
of ``data/requests.py`` and the event oracle ``core/events.py`` (ROADMAP.md,
Queue 1 item 10), and the per-replica engines (``InferenceEngine``,
``GenerationResult``) need the LM models (item 11).
"""
from .autoscaler import (
    FleetProvisioner,
    ReplicaAutoscaler,
    ScalerReport,
    replica_cost_model,
)
from .metrics import PlanMetrics
from .stepper import StepperState, pow2_bucket, stepper_chunk, stepper_init

__all__ = [
    "FleetProvisioner",
    "PlanMetrics",
    "ReplicaAutoscaler",
    "ScalerReport",
    "StepperState",
    "pow2_bucket",
    "replica_cost_model",
    "stepper_chunk",
    "stepper_init",
]
