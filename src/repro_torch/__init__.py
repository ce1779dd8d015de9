"""repro_torch — the PyTorch/CUDA port of ``repro``.

A standalone package: it imports torch and numpy, never jax and never
anything of ``repro`` (the JAX reference it is held against).  Its entry
points ``provision(ProvisionSpec(...))`` and, for production-length traces,
``provision_stream(ProvisionSpec(...))`` run on the card by default, with
the provisioning scans as the hand-written CUDA kernels K1 and K2
(:mod:`repro_torch.kernels.provision_scan`); ``ProvisionSpec(device="cpu")``
runs the plain PyTorch versions instead.
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
    provision_stream,
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
    "provision_stream",
    "scale_to_pmr",
    "schedule_cost",
    "with_prediction_error",
]
