"""Workload traces for the discrete-time fluid model (paper Section V).

The MSR Cambridge volume traces used by the paper are not redistributable /
available offline, so :func:`msr_like_trace` synthesizes a one-week trace at
10-minute granularity with diurnal + weekly structure calibrated to the
paper's peak-to-mean ratio (PMR = 4.63).  The PMR sweep transform
``a' = K * a^gamma`` (keeping the mean constant) is the one the paper uses in
Section V-D.

A copy of ``repro.core.traces`` (numpy only).
"""
from __future__ import annotations

import numpy as np

SLOTS_PER_DAY = 144          # 10-minute slots
WEEK_SLOTS = 7 * SLOTS_PER_DAY


def msr_like_trace(
    rng: np.random.Generator | None = None,
    n_slots: int = WEEK_SLOTS,
    mean_jobs: float = 40.0,
    target_pmr: float = 4.63,
    noise: float = 0.08,
    spike_prob: float = 0.004,
) -> np.ndarray:
    """Synthetic one-week fluid workload (jobs per slot, integer >= 0)."""
    rng = rng or np.random.default_rng(0)
    t = np.arange(n_slots)
    day_phase = 2 * np.pi * (t % SLOTS_PER_DAY) / SLOTS_PER_DAY
    # business-hours hump + secondary evening hump
    diurnal = (
        0.25
        + np.clip(np.sin(day_phase - np.pi / 2), 0, None) ** 1.5
        + 0.35 * np.clip(np.sin(2 * day_phase - np.pi / 3), 0, None) ** 2
    )
    dow = (t // SLOTS_PER_DAY) % 7
    weekly = np.where(dow < 5, 1.0, 0.45)     # weekends quieter
    base = diurnal * weekly
    base = base * (1.0 + noise * rng.standard_normal(n_slots))
    # occasional flash crowds ("Lady Gaga" events, footnote 2)
    spikes = (rng.uniform(size=n_slots) < spike_prob) * rng.uniform(2.0, 4.0, n_slots)
    base = np.clip(base + spikes, 0.02, None)
    a = scale_to_pmr(base, target_pmr)
    a = a / a.mean() * mean_jobs
    return np.maximum(np.rint(a).astype(np.int64), 0)


def scale_to_pmr(a: np.ndarray, target_pmr: float, tol: float = 1e-3) -> np.ndarray:
    """Rescale a' = K * a^gamma (mean preserved) to hit a target peak-to-mean
    ratio — the transform used by the paper's Section V-D sweep."""
    a = np.asarray(a, dtype=np.float64)
    a = np.clip(a, 1e-9, None)
    lo, hi = 0.05, 20.0
    for _ in range(200):
        gamma = 0.5 * (lo + hi)
        b = a ** gamma
        b = b / b.mean()
        pmr = b.max()
        if abs(pmr - target_pmr) < tol:
            break
        if pmr < target_pmr:
            lo = gamma
        else:
            hi = gamma
    b = a ** gamma
    return b / b.mean() * a.mean()


def pmr(a: np.ndarray) -> float:
    a = np.asarray(a, dtype=np.float64)
    return float(a.max() / a.mean())


def with_prediction_error(
    a: np.ndarray,
    rng: np.random.Generator,
    std_frac: float,
) -> np.ndarray:
    """Zero-mean Gaussian error, std = std_frac * actual workload (Sec. V-C)."""
    err = rng.standard_normal(a.shape) * std_frac * np.asarray(a, np.float64)
    return np.maximum(np.rint(a + err).astype(np.int64), 0)


def brick_trace_from_fluid(
    a: np.ndarray,
    rng: np.random.Generator | None = None,
    slot_len: float = 1.0,
):
    """Convert a fluid trace (jobs per slot) to a brick trace.

    Whenever a(t) increases by k, k jobs arrive; when it decreases, the most
    recent jobs depart (consistent with LIFO semantics).  Event epochs are
    spread inside the slot so that no two coincide.
    """
    from .events import Job

    rng = rng or np.random.default_rng(0)
    a = np.asarray(a, dtype=np.int64)
    horizon = float(len(a) * slot_len)
    open_jobs: list[float] = []   # arrival times of currently open jobs (stack)
    jobs: list[Job] = []
    prev = 0
    for s, cur in enumerate(a):
        t0 = s * slot_len
        diff = int(cur) - prev
        if diff > 0:
            offs = np.sort(rng.uniform(0.005, 0.49, diff)) * slot_len
            for o in offs:
                open_jobs.append(t0 + float(o))
        elif diff < 0:
            offs = np.sort(rng.uniform(0.51, 0.995, -diff)) * slot_len
            for o in offs:
                arr = open_jobs.pop()
                jobs.append(Job(arr, t0 + float(o)))
        prev = int(cur)
    for arr in open_jobs:
        jobs.append(Job(arr, horizon))
    # ensure distinct epochs
    from .events import _deduplicate

    return _deduplicate(jobs, horizon, rng)
