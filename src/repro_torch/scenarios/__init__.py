"""Scenario library: parametric workload generators behind one registry.

The evaluation counterpart of the provisioning engine: where
:mod:`repro_torch.core.provision` answers "what does policy π cost on trace a",
this package answers "which traces should π be judged on".  Six generator
families ship registered (``msr_diurnal``, ``sinusoidal``, ``flash_crowd``,
``step_outage``, ``heavy_tail_bursts``, ``replay``); each yields
deterministic ``(B, T)`` demand batches at a target peak-to-mean ratio, and
:func:`make_workload` bridges straight into a ``Workload`` with an optional
prediction-noise sweep and/or a deferral spec.  :func:`mix` and
:func:`concat` combine registered families into composite scenarios
(weighted overlay / timeline splice).  ``repro_torch.eval`` runs the full grid.
A copy of ``repro.scenarios`` (numpy only); ``make_workload`` builds the
port's ``Workload``.
"""
from .registry import (
    Scenario,
    concat,
    generate,
    get_generator,
    make_workload,
    mix,
    register_scenario,
    scenario_names,
)
from .generators import SAMPLE_TRACE_PATH  # noqa: F401  (registers the bank)

#: The default evaluation bank: every built-in generator at the paper's
#: scale (PMR 4.63, Section V-A) — ``replay`` keeps its recording's natural
#: peakiness (rescaling a replayed trace would defeat the point).
DEFAULT_SCENARIOS = (
    Scenario("msr_diurnal", target_pmr=4.63),
    Scenario("sinusoidal", target_pmr=4.63),
    Scenario("flash_crowd", target_pmr=4.63),
    Scenario("step_outage", target_pmr=4.63),
    Scenario("heavy_tail_bursts", target_pmr=4.63),
    Scenario("replay"),
)

__all__ = [
    "DEFAULT_SCENARIOS",
    "SAMPLE_TRACE_PATH",
    "Scenario",
    "concat",
    "generate",
    "get_generator",
    "make_workload",
    "mix",
    "register_scenario",
    "scenario_names",
]
