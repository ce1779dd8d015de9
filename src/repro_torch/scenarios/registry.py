"""The scenario registry: parametric workload generators behind one dataclass.

A :class:`Scenario` is a *name* into the registry plus the knobs that make a
concrete workload population from it: generator ``params``, the ``seed`` of
the trace stream, and the two scale knobs every scenario shares —
``target_pmr`` (enforced per trace via :func:`repro_torch.core.traces.scale_to_pmr`,
the paper's Section V-D transform) and ``mean_jobs``.  :func:`generate` turns
one into a ``(n_traces, n_slots)`` integer demand batch; :func:`make_workload`
goes one step further and returns a ready
:class:`~repro_torch.core.provision.Workload` with an optional
:class:`~repro_torch.core.provision.PredictionNoise` attached (``noise_std`` may be
a ``(S,)`` sweep, the spec axis the eval harness consumes).

Trace ``i`` of a batch is drawn from ``default_rng((seed, i))`` — the same
convention as ``TokenPipeline.batch_at`` — so batches are deterministic,
extendable (the first ``B`` traces of a bigger batch are unchanged), and
shared across eval cells (common random numbers).

Register new generators with :func:`register_scenario`; see
:mod:`repro_torch.scenarios.generators` for the built-in bank and
``docs/scenarios.md`` for the how-to.

A copy of ``repro.scenarios.registry`` (numpy only) but for
:func:`make_workload`, which builds the port's ``Workload``.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Callable

import numpy as np

from ..core.traces import scale_to_pmr

GeneratorFn = Callable[..., np.ndarray]

_REGISTRY: dict[str, GeneratorFn] = {}

#: Relative tolerance on the *realized* peak-to-mean ratio of a generated
#: integer trace vs ``Scenario.target_pmr``.  ``scale_to_pmr`` hits the
#: target on the continuous trace, but the subsequent mean rescale +
#: ``rint`` + clip drifts the realized PMR (worst for bursty shapes at low
#: means, e.g. ``heavy_tail_bursts``); :func:`generate` re-fits the
#: pre-rounding target until the rounded trace lands within this tolerance,
#: and warns when it cannot (a trace whose raw shape caps the reachable
#: PMR below the target, e.g. a near-binary ``step_outage``).
PMR_TOL = 0.05

#: Secant-correction attempts before :func:`generate` gives up and warns.
PMR_REFITS = 4


def register_scenario(name: str) -> Callable[[GeneratorFn], GeneratorFn]:
    """Decorator: register ``fn(rng, n_slots, **params) -> (n_slots,) float``
    under ``name``.  Re-registering a taken name raises (rename or remove
    the old generator explicitly)."""

    def deco(fn: GeneratorFn) -> GeneratorFn:
        if name in _REGISTRY:
            raise ValueError(f"scenario {name!r} is already registered")
        _REGISTRY[name] = fn
        return fn

    return deco


def scenario_names() -> tuple[str, ...]:
    """All registered generator names, sorted."""
    return tuple(sorted(_REGISTRY))


def get_generator(name: str) -> GeneratorFn:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown scenario {name!r}: registered scenarios are {scenario_names()}"
        ) from None


@dataclasses.dataclass(frozen=True)
class Scenario:
    """One workload population: a registered generator plus its knobs.

    ``params`` go to the generator verbatim; ``target_pmr``/``mean_jobs``
    are applied afterwards by :func:`generate` (PMR first — the rescale is
    mean-preserving — then the mean), so every scenario hits the same scale
    regardless of its raw shape.  ``target_pmr=None`` keeps the generator's
    natural peakiness.
    """

    name: str
    params: dict = dataclasses.field(default_factory=dict)
    seed: int = 0
    target_pmr: float | None = None
    mean_jobs: float = 32.0

    def describe(self) -> str:
        kv = ", ".join(f"{k}={v}" for k, v in sorted(self.params.items()))
        pmr = "natural" if self.target_pmr is None else f"{self.target_pmr:g}"
        return (
            f"{self.name}(seed={self.seed}, pmr={pmr}, "
            f"mean={self.mean_jobs:g}{', ' + kv if kv else ''})"
        )


def _quantize(a: np.ndarray, mean_jobs: float) -> np.ndarray:
    """Shared tail of the rescale: mean to ``mean_jobs``, rint, clip at 0."""
    mean = a.mean()
    if mean > 0:
        a = a / mean * mean_jobs
    return np.maximum(np.rint(a), 0).astype(np.int64)


def _fit_pmr(a: np.ndarray, target: float, mean_jobs: float,
             label: str) -> np.ndarray:
    """Integer trace whose *realized* PMR is within ``PMR_TOL`` of target.

    ``scale_to_pmr`` only controls the continuous trace; rounding drifts
    the realized ratio.  Measure it post-rounding and secant-correct the
    pre-rounding target (deterministically — no extra randomness) until the
    rounded trace lands inside the tolerance; warn if the trace's shape
    makes the target unreachable.
    """
    goal = target
    best, best_err = None, np.inf
    for _ in range(PMR_REFITS + 1):
        q = _quantize(scale_to_pmr(a, goal), mean_jobs)
        mean = q.mean()
        realized = float(q.max() / mean) if mean > 0 else 0.0
        err = abs(realized - target) / target
        if err < best_err:
            best, best_err = q, err
        if err <= PMR_TOL or realized <= 0:
            break
        goal = max(1.0 + 1e-6, goal * target / realized)
    if best_err > PMR_TOL:
        warnings.warn(
            f"scenario {label}: realized PMR after rounding is off target "
            f"{target:g} by {best_err:.1%} (> {PMR_TOL:.0%}) even after "
            f"{PMR_REFITS} re-fits — the trace shape or mean_jobs "
            f"{mean_jobs:g} caps the reachable peak-to-mean ratio",
            RuntimeWarning,
            stacklevel=3,
        )
    return best


def generate(scenario: Scenario, n_traces: int, n_slots: int) -> np.ndarray:
    """``(n_traces, n_slots)`` int64 demand batch for one scenario.

    Each trace gets its own ``default_rng((seed, i))`` stream, then the
    shared rescale: ``scale_to_pmr`` to ``target_pmr`` (if set, re-fit so
    the rounded trace realizes it within ``PMR_TOL``), mean to
    ``mean_jobs``, round to integer jobs, clip at 0.
    """
    fn = get_generator(scenario.name)
    out = np.empty((n_traces, n_slots), np.int64)
    for i in range(n_traces):
        rng = np.random.default_rng((scenario.seed, i))
        a = np.asarray(fn(rng, n_slots, **scenario.params), np.float64)
        if a.shape != (n_slots,):
            raise ValueError(
                f"scenario {scenario.name!r} generator returned shape "
                f"{a.shape}, expected ({n_slots},)"
            )
        if scenario.target_pmr is not None:
            out[i] = _fit_pmr(a, float(scenario.target_pmr),
                              scenario.mean_jobs, f"{scenario.name!r}[{i}]")
        else:
            out[i] = _quantize(a, scenario.mean_jobs)
    return out


def _component_trace(comp: Scenario, rng: np.random.Generator,
                     n_slots: int) -> np.ndarray:
    """One component's *float* trace for a combinator: the component's own
    generator, ``target_pmr`` and ``mean_jobs`` applied in the continuous
    domain (no rounding — the outer :func:`generate` pipeline quantizes
    once, after combination).  The component draws from a child stream
    seeded off the combinator's ``rng``, so the whole composite stays a
    deterministic function of ``(seed, trace_index)``."""
    fn = get_generator(comp.name)
    child = np.random.default_rng(rng.integers(2**63))
    a = np.asarray(fn(child, n_slots, **comp.params), np.float64)
    if comp.target_pmr is not None:
        a = scale_to_pmr(a, float(comp.target_pmr))
    mean = a.mean()
    if mean > 0:
        a = a / mean * comp.mean_jobs
    return a


def _check_components(components) -> tuple:
    components = tuple(components)
    if not components:
        raise ValueError("need at least one component scenario")
    bad = [c for c in components if not isinstance(c, Scenario)]
    if bad:
        raise ValueError(f"components must be Scenario instances, got {bad}")
    return components


@register_scenario("mix")
def _mix_generator(rng, n_slots, *, components, weights=None) -> np.ndarray:
    """Overlay: the weighted sum of the component traces — e.g. a diurnal
    base carrying heavy-tail burst traffic on top."""
    components = _check_components(components)
    if weights is None:
        weights = (1.0,) * len(components)
    weights = np.asarray(weights, np.float64)
    if weights.shape != (len(components),) or (weights < 0).any() \
            or weights.sum() <= 0:
        raise ValueError(
            f"weights must be {len(components)} non-negative numbers with a "
            f"positive sum, got {weights}"
        )
    out = np.zeros(n_slots, np.float64)
    for w, comp in zip(weights, components):
        out += w * _component_trace(comp, rng, n_slots)
    return out


@register_scenario("concat")
def _concat_generator(rng, n_slots, *, components, fractions=None) -> np.ndarray:
    """Splice: the timeline divided among the components — e.g. a sinusoidal
    week that turns into a flash crowd for its last quarter.  ``fractions``
    are relative segment lengths (default equal); every segment gets at
    least one slot and the last absorbs the rounding remainder."""
    components = _check_components(components)
    if fractions is None:
        fractions = (1.0,) * len(components)
    fractions = np.asarray(fractions, np.float64)
    if fractions.shape != (len(components),) or (fractions <= 0).any():
        raise ValueError(
            f"fractions must be {len(components)} positive numbers, "
            f"got {fractions}"
        )
    if n_slots < len(components):
        raise ValueError(
            f"cannot splice {len(components)} components into {n_slots} slots"
        )
    bounds = np.rint(
        np.cumsum(fractions) / fractions.sum() * n_slots
    ).astype(np.int64)
    bounds[-1] = n_slots
    # every segment gets >= 1 slot even under aggressive rounding
    for i in range(1, len(bounds)):
        bounds[i] = max(bounds[i], bounds[i - 1] + 1)
    starts = np.concatenate([[0], bounds[:-1]])
    return np.concatenate([
        _component_trace(comp, rng, int(hi - lo))
        for comp, lo, hi in zip(components, starts, bounds)
    ])


def mix(
    *components: Scenario,
    weights=None,
    seed: int = 0,
    target_pmr: float | None = None,
    mean_jobs: float = 32.0,
) -> Scenario:
    """Overlay combinator: one :class:`Scenario` whose traces are the
    weighted sum of the component scenarios' (continuous) traces.

    Each component applies its own ``target_pmr``/``mean_jobs`` before the
    weighting, so the weights are in units of the components' means; the
    outer ``target_pmr``/``mean_jobs`` then rescale the composite through
    the standard :func:`generate` pipeline.  The result composes everywhere
    a built-in scenario does — ``generate``, ``make_workload``, eval grids.
    """
    return Scenario(
        "mix",
        params={
            "components": _check_components(components),
            "weights": None if weights is None
            else tuple(float(w) for w in weights),
        },
        seed=seed,
        target_pmr=target_pmr,
        mean_jobs=mean_jobs,
    )


def concat(
    *components: Scenario,
    fractions=None,
    seed: int = 0,
    target_pmr: float | None = None,
    mean_jobs: float = 32.0,
) -> Scenario:
    """Splice combinator: one :class:`Scenario` whose timeline is divided
    among the components in ``fractions`` (default: equal shares).

    Segment ``j`` is the ``j``-th component's trace generated at the
    segment's length (its own ``target_pmr``/``mean_jobs`` applied in the
    continuous domain); the outer knobs rescale the composite afterwards,
    exactly like :func:`mix`.
    """
    return Scenario(
        "concat",
        params={
            "components": _check_components(components),
            "fractions": None if fractions is None
            else tuple(float(f) for f in fractions),
        },
        seed=seed,
        target_pmr=target_pmr,
        mean_jobs=mean_jobs,
    )


def make_workload(
    scenario: Scenario,
    n_traces: int,
    n_slots: int,
    *,
    noise_std=None,
    noise_generator=None,
    noise_normals=None,
    clip_to: int | None = None,
    deferral=None,
):
    """A ready :class:`~repro_torch.core.provision.Workload` for one scenario.

    ``noise_std``: optional ``std_frac`` for a
    :class:`~repro_torch.core.provision.PredictionNoise` — a scalar, or a
    ``(S,)`` array to sweep prediction-error levels as a leading result axis
    (common random numbers: one normal draw per trace, scaled per level).
    The normals come from ``noise_generator`` (a ``torch.Generator``) or are
    injected as ``noise_normals`` of the demand's shape; without either, a
    CPU generator seeded with ``scenario.seed`` draws them.  ``clip_to``: cap
    demand at a fleet capacity (typed fleets pin theirs via
    ``CostModel.n_levels`` — a scenario's peak may exceed it, and
    provisioning requires ``demand <= n_levels``).  ``deferral``: optional
    :class:`~repro_torch.deferral.DeferralSpec` attached to the workload;
    with both ``deferral`` and ``clip_to`` set the demand is *not*
    hard-clipped — the cap becomes the deferral spec's service ceiling, so
    displaced work re-enters the backlog (work conservation) instead of
    being silently dropped.  A single trace (``n_traces=1``) still yields a
    ``(1, n_slots)`` batch — index ``demand[0]`` if you want the unbatched
    convention.  The demand is an int32 CPU tensor; ``ProvisionSpec.device``
    moves it.
    """
    import torch

    from ..core.provision import PredictionNoise, Workload

    raw = generate(scenario, n_traces, n_slots)
    if clip_to is not None:
        if clip_to < 1:
            raise ValueError(f"clip_to={clip_to} must be >= 1")
        if deferral is not None:
            cap = clip_to if deferral.cap is None else min(deferral.cap,
                                                          clip_to)
            deferral = dataclasses.replace(deferral, cap=cap)
        else:
            raw = np.minimum(raw, clip_to)
    demand = torch.as_tensor(raw).to(torch.int32)
    noise = None
    if noise_std is not None:
        if noise_normals is None and noise_generator is None:
            noise_generator = torch.Generator().manual_seed(scenario.seed)
        noise = PredictionNoise(std_frac=noise_std, generator=noise_generator,
                                normals=noise_normals)
    return Workload(demand=demand, noise=noise, deferral=deferral)
