"""repro_torch — the PyTorch/CUDA port of ``repro``.

A standalone package: it imports torch and numpy, never jax and never
anything of ``repro`` (the JAX reference it is held against).  Its entry
point ``provision(ProvisionSpec(...))`` runs on the card by default, with
the provisioning scan as the hand-written CUDA kernel K1
(:mod:`repro_torch.kernels.provision_scan`); ``ProvisionSpec(device="cpu")``
runs the plain PyTorch version instead.
"""
from .core import (
    PAPER_COSTS,
    POLICIES,
    RANDOMIZED_POLICIES,
    CostModel,
    PolicySpec,
    PredictionNoise,
    ProvisionResult,
    ProvisionSpec,
    ServerGroup,
    StepFn,
    Workload,
    msr_like_trace,
    on_matrix_cost,
    pmr,
    provision,
    scale_to_pmr,
    schedule_cost,
    with_prediction_error,
)

__all__ = [
    "PAPER_COSTS",
    "POLICIES",
    "RANDOMIZED_POLICIES",
    "CostModel",
    "PolicySpec",
    "PredictionNoise",
    "ProvisionResult",
    "ProvisionSpec",
    "ServerGroup",
    "StepFn",
    "Workload",
    "msr_like_trace",
    "on_matrix_cost",
    "pmr",
    "provision",
    "scale_to_pmr",
    "schedule_cost",
    "with_prediction_error",
]
