"""Parametric workload-shape generators behind the scenario registry.

Every generator has the same signature::

    fn(rng: np.random.Generator, n_slots: int, **params) -> (n_slots,) float64

and returns an *unnormalized* non-negative demand shape.  The registry
pipeline (:func:`repro_torch.scenarios.generate`) then rescales every trace to the
scenario's ``target_pmr`` via :func:`repro_torch.core.traces.scale_to_pmr` and to
its ``mean_jobs`` before rounding to integer jobs-per-slot, so shape and
scale are orthogonal knobs: a generator only describes *when* load arrives,
never how much.

The bank mirrors how the right-sizing literature evaluates (Albers &
Quedenfeld; Hübotter): a diurnal baseline plus the shapes that stress
ski-rental policies from different directions — smooth periodicity
(``sinusoidal``), sudden onset/decay (``flash_crowd``), level shifts and
dropouts (``step_outage``, the regime where toggling is most tempting and
most dangerous), heavy-tailed burst sizes (``heavy_tail_bursts``), and real
recorded traces (``replay``).

A copy of ``repro.scenarios.generators`` (numpy only), with its own copy of
the ``replay`` sample so that the package stands alone.
"""
from __future__ import annotations

import pathlib

import numpy as np

from ..core.traces import SLOTS_PER_DAY, msr_like_trace

from .registry import register_scenario

#: Two days of an MSR-like trace checked in as the ``replay`` sample.
SAMPLE_TRACE_PATH = pathlib.Path(__file__).parent / "data" / "msr_sample.csv"


@register_scenario("msr_diurnal")
def msr_diurnal(
    rng: np.random.Generator,
    n_slots: int,
    *,
    noise: float = 0.08,
    spike_prob: float = 0.004,
) -> np.ndarray:
    """The paper's synthetic MSR-Cambridge-like week: diurnal + weekly humps,
    occasional flash spikes (wraps :func:`repro_torch.core.traces.msr_like_trace`)."""
    return msr_like_trace(
        rng, n_slots=n_slots, noise=noise, spike_prob=spike_prob
    ).astype(np.float64)


@register_scenario("sinusoidal")
def sinusoidal(
    rng: np.random.Generator,
    n_slots: int,
    *,
    period: int = SLOTS_PER_DAY,
    depth: float = 0.8,
    second_harmonic: float = 0.2,
    noise: float = 0.05,
) -> np.ndarray:
    """Smooth periodic load: 1 + depth·sin(2πt/period) (+ a second harmonic),
    random phase, multiplicative noise.  The gentlest scenario — idle gaps
    change length slowly, so predictions are most informative here."""
    t = np.arange(n_slots)
    phase = rng.uniform(0.0, 2 * np.pi)
    w = 2 * np.pi * t / period
    base = 1.0 + depth * np.sin(w + phase) + second_harmonic * np.sin(2 * w + phase)
    base = base * (1.0 + noise * rng.standard_normal(n_slots))
    return np.clip(base, 0.02, None)


@register_scenario("flash_crowd")
def flash_crowd(
    rng: np.random.Generator,
    n_slots: int,
    *,
    n_events: int = 3,
    spike_mag: float = 8.0,
    rise_slots: int = 2,
    decay_slots: int = 24,
    base_depth: float = 0.3,
) -> np.ndarray:
    """Quiet diurnal baseline plus sudden spikes (the paper's "Lady Gaga"
    events, footnote 2): each event ramps up over ``rise_slots`` and decays
    exponentially with time constant ``decay_slots``.  Stresses the
    turn-*on* path and rewards policies that don't power down too eagerly
    right after a crowd disperses."""
    t = np.arange(n_slots)
    base = 1.0 + base_depth * np.sin(2 * np.pi * t / SLOTS_PER_DAY + rng.uniform(0, 2 * np.pi))
    population = max(n_slots - decay_slots, 1)      # short horizons: fewer events
    n_events = min(n_events, population)
    starts = rng.choice(population, size=n_events, replace=False)
    mags = spike_mag * rng.uniform(0.5, 1.0, n_events)
    for s, m in zip(starts, mags):
        rel = t - s
        ramp = np.clip(rel / max(rise_slots, 1), 0.0, 1.0)
        decay = np.exp(-np.clip(rel - rise_slots, 0, None) / decay_slots)
        base = base + m * np.where(rel >= 0, ramp * decay, 0.0)
    return np.clip(base, 0.02, None)


@register_scenario("step_outage")
def step_outage(
    rng: np.random.Generator,
    n_slots: int,
    *,
    n_steps: int = 6,
    level_lo: float = 0.2,
    level_hi: float = 2.0,
    outage_slots: int = 12,
    noise: float = 0.03,
) -> np.ndarray:
    """Piecewise-constant level shifts plus one hard dropout (demand = 0 for
    ``outage_slots``).  Idle gaps here are exactly the shapes the ski-rental
    lower bound is built from — gaps near Δ — so this is the adversarial
    scenario for A1/A2/A3."""
    edges = np.sort(rng.choice(np.arange(1, n_slots), size=n_steps - 1, replace=False))
    levels = rng.uniform(level_lo, level_hi, n_steps)
    base = levels[np.searchsorted(edges, np.arange(n_slots), side="right")]
    base = base * (1.0 + noise * rng.standard_normal(n_slots))
    out0 = rng.integers(0, max(n_slots - outage_slots, 1))
    base[out0 : out0 + outage_slots] = 0.0
    return np.clip(base, 0.0, None)


@register_scenario("heavy_tail_bursts")
def heavy_tail_bursts(
    rng: np.random.Generator,
    n_slots: int,
    *,
    burst_prob: float = 0.06,
    zipf_s: float = 1.6,
    max_burst: int = 64,
    hold_slots: int = 4,
    base_level: float = 0.5,
) -> np.ndarray:
    """Low baseline plus Zipf-sized job bursts: each arriving burst holds for
    ``hold_slots`` then decays geometrically.  The size distribution's heavy
    tail makes peak-to-mean large and the demand *derivative* bursty — the
    regime where toggle costs dominate energy."""
    sizes = np.minimum(rng.zipf(zipf_s, n_slots), max_burst).astype(np.float64)
    arrivals = (rng.uniform(size=n_slots) < burst_prob) * sizes
    base = np.full(n_slots, base_level)
    active = 0.0
    for t in range(n_slots):
        active = active * (0.5 ** (1.0 / hold_slots)) + arrivals[t]
        base[t] += active
    return base


@register_scenario("replay")
def replay(
    rng: np.random.Generator,
    n_slots: int,
    *,
    path: str | pathlib.Path | None = None,
    key: str = "demand",
) -> np.ndarray:
    """Replay a recorded trace from a ``.csv`` (one demand value per line,
    ``#`` comments allowed) or ``.npz`` (array under ``key``, else the first
    array) file, tiled/cropped to ``n_slots``.  Defaults to the checked-in
    two-day MSR-like sample.  Deterministic: the rng is unused, so every
    trace in a batch replays the same recording."""
    p = pathlib.Path(path) if path is not None else SAMPLE_TRACE_PATH
    if p.suffix == ".npz":
        with np.load(p) as z:
            arr = z[key] if key in z.files else z[z.files[0]]
    else:
        arr = np.loadtxt(p, comments="#", delimiter=",", ndmin=1)
    a = np.asarray(arr, np.float64).reshape(-1)
    if a.size == 0:
        raise ValueError(f"replay trace {p} is empty")
    reps = -(-n_slots // a.size)
    return np.tile(a, reps)[:n_slots]
