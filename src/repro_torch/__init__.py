"""repro_torch — the PyTorch/CUDA port of ``repro``.

A standalone package: it imports torch and numpy, never jax and never
anything of ``repro`` (the JAX reference it is held against).  Its entry
points ``provision(ProvisionSpec(...))`` and, for production-length traces,
``provision_stream(ProvisionSpec(...))`` run on the card by default, with
the provisioning scans as the hand-written CUDA kernels K1 and K2
(:mod:`repro_torch.kernels.provision_scan`); ``ProvisionSpec(device="cpu")``
runs the plain PyTorch versions instead.  ``Workload(deferral=...)``
defers slack-tolerant work before provisioning it
(:mod:`repro_torch.deferral`), :mod:`repro_torch.scenarios` generates the
workload families, and ``repro_torch.eval.evaluate`` (``python -m
repro_torch.eval``) holds every policy to the paper's bounds over them.
``repro_torch.core`` also holds the paper's numpy oracles (the off-line
optimum, the brick simulator, the fluid model); ``repro_torch.serving``
serves and ``repro_torch.train`` trains the dense LMs on the card.
"""
from .core import (
    PAPER_COSTS,
    POLICIES,
    RANDOMIZED_POLICIES,
    CostModel,
    DeferralSpec,
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
    "DeferralSpec",
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
