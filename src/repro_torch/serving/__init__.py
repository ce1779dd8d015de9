"""Serving: per-replica engines + the paper's autoscaler + cluster simulation.

The PyTorch port of ``repro.serving``.  ``FleetProvisioner.advance()``
streams: the O(1)-state incremental stepper behind it (engine carry through
kernel K2, slot-indexed draws) lives in :mod:`repro_torch.serving.stepper`
and is exported here for direct use; :class:`PlanMetrics` exports its
health as Prometheus text.  ``run_cluster`` replays a session trace against
the :class:`ReplicaAutoscaler`; with an ``engine_factory`` each arriving
session runs real prefill and decode on its replica's
:class:`InferenceEngine`, through kernels K3 and K4 on the card.
"""
from .autoscaler import (
    FleetProvisioner,
    ReplicaAutoscaler,
    ScalerReport,
    replica_cost_model,
)
from .cluster import ClusterReport, make_window_max_predictor, run_cluster
from .engine import GenerationResult, InferenceEngine
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
    "ClusterReport",
    "make_window_max_predictor",
    "run_cluster",
    "GenerationResult",
    "InferenceEngine",
]
