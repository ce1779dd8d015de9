"""repro_torch.lint — the runtime sanitizer of the port.

:func:`repro_torch.lint.sanitize.tracer_sanitizer` is the one gated build
check, the counterpart of ``repro.lint.sanitize``.  The reference's static
rules (RPL001–RPL006) are specific to JAX and Pallas; rules aware of
PyTorch and CUDA are still to come (ROADMAP.md, Queue 1 item 13).
"""
from .sanitize import RecompileError, UnobservableCacheError, tracer_sanitizer

__all__ = ["RecompileError", "UnobservableCacheError", "tracer_sanitizer"]
