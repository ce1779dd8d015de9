"""Paper-figure benchmarks on the port: one function per table/figure
(Section V).

The twin of ``benchmarks/paper_figs.py``, with its function names.  Fig. 3
and Fig. 4b run each policy's whole (runs x alpha) grid as ONE
``provision`` call (a ``PolicySpec(windows=...)`` sweep): on the card one
launch of kernel K2 per policy and call.  Fig. 4c's error study rides the
``PredictionNoise`` (S,) sweep axis the same way.  LCP and Fig. 4d keep the
closed-form numpy path of the fluid model.  Traces come from the scenario
registry (``repro_torch.scenarios``).

Randomness: where the reference keys its draws with ``jax.random.key``, the
twin draws from a ``torch.Generator`` seeded alike, so its drawn numbers
differ from the reference's while the draw-free ones are equal; the
injection points (``uniforms=``, ``normals=``) take the reference's draws,
which is how the tests hold the twin to it.  ``kernel=False`` runs the
plain scan on the same device, the kernel route's oracle.
"""
from __future__ import annotations

import functools
import time

import numpy as np
import torch

from ..core import (
    RANDOMIZED_POLICIES,
    CostModel,
    PolicySpec,
    PredictionNoise,
    ProvisionSpec,
    Workload,
    fluid_cost,
    theoretical_ratio,
)
from ..core.traces import WEEK_SLOTS
from ..scenarios import Scenario, generate
from . import TIMED_CALLS, _provision, generator, sync

COSTS = CostModel(P=1.0, beta_on=3.0, beta_off=3.0)   # Delta = 6, paper Sec. V-A

#: Fig. 4c's replicas, noise stds and windows, the reference's
FIG4C_RUNS, FIG4C_STDS, FIG4C_WINDOWS = 10, (0.0, 0.1, 0.25, 0.5), (2, 4)


def _trace(target_pmr: float = 4.63) -> np.ndarray:
    """The paper's MSR-like week, drawn from the scenario registry."""
    sc = Scenario("msr_diurnal", target_pmr=target_pmr, mean_jobs=40.0)
    return generate(sc, 1, WEEK_SLOTS)[0]


def _timed(fn, *args, **kw):
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    return out, (time.perf_counter() - t0) * 1e6


def _sweep_mean_costs(a: np.ndarray, policy: str, windows, runs: int, seed: int = 0, *,
                      device="cuda", kernel: bool = True, uniforms=None):
    """((W,) mean engine cost over ``runs`` replicas, us per call).

    The whole (runs x windows) grid is one ``provision`` call; the first
    call is a warm-up, the time is the mean of the next ``TIMED_CALLS``.
    The randomized policies draw from a generator seeded with ``seed``, a
    fresh one per call so that every call sees the same draws, or take the
    injected ``uniforms=(u0, u)`` ((runs, T, N) tables each).
    """
    n_levels = int(a.max()) + 1
    ab = torch.as_tensor(np.tile(a, (runs, 1)), device=device).to(torch.int32)
    keyed = policy in RANDOMIZED_POLICIES

    def spec():
        gen = generator(device, seed) if keyed and uniforms is None else None
        return ProvisionSpec(
            costs=COSTS,
            workload=Workload(demand=ab),
            policy=PolicySpec(policy, windows=[int(w) for w in windows], generator=gen,
                              uniforms=uniforms if keyed else None),
            n_levels=n_levels,
            device=device,
        )

    specs = [spec() for _ in range(1 + TIMED_CALLS)]

    def once(s):
        cost = _provision(s, record_decisions=False, kernel=kernel).cost
        sync(device)
        return cost

    costs = once(specs[0])
    t0 = time.perf_counter()
    for s in specs[1:]:
        once(s)
    us = (time.perf_counter() - t0) / TIMED_CALLS * 1e6
    return costs.mean(dim=1).cpu().numpy(), us


def fig3_competitive_ratios(rows: list[str], *, device="cuda", kernel: bool = True) -> None:
    """Fig. 3: worst-case vs empirical ratios as alpha grows (batched engine)."""
    a = _trace()
    opt = fluid_cost(a, "offline", COSTS).cost
    windows = np.arange(0, 6)
    for name, runs in (("A1", 1), ("A2", 30), ("A3", 30)):
        means, us = _sweep_mean_costs(a, name, windows, runs, device=device, kernel=kernel)
        for w, mean in zip(windows, means):
            alpha = min(1.0, (w + 1) / COSTS.delta)
            emp = float(mean) / opt
            bound = theoretical_ratio(name, alpha)
            assert emp <= bound + 0.05, (name, alpha, emp, bound)
            rows.append(
                f"fig3_{name}_w{w},{us / (runs * len(windows)):.1f},"
                f"alpha={alpha:.2f};empirical={emp:.4f};bound={bound:.4f}"
            )


def fig4b_cost_reduction_vs_window(rows: list[str], *, device="cuda",
                                   kernel: bool = True) -> None:
    """Fig. 4b: cost reduction vs prediction window, all six policies."""
    a = _trace()
    static = fluid_cost(a, "static", COSTS).cost
    opt = fluid_cost(a, "offline", COSTS).cost
    rows.append(f"fig4b_offline,0.0,reduction={1 - opt / static:.4f}")
    windows = np.arange(0, 11)
    for name, runs in (("A1", 1), ("A2", 20), ("A3", 20)):
        means, us = _sweep_mean_costs(a, name, windows, runs, device=device, kernel=kernel)
        for w, mean in zip(windows, means):
            red = 1 - float(mean) / static
            rows.append(
                f"fig4b_{name}_w{w},{us / (runs * len(windows)):.1f},"
                f"reduction={red:.4f}"
            )
    for w in range(1, 11):
        c, us = _timed(lambda: fluid_cost(a, "lcp", COSTS, window=w).cost)
        rows.append(f"fig4b_LCP_w{w},{us:.1f},reduction={1 - c / static:.4f}")
    means, us = _sweep_mean_costs(a, "delayedoff", [0], 1, device=device, kernel=kernel)
    rows.append(f"fig4b_DELAYEDOFF,{us:.1f},reduction={1 - float(means[0]) / static:.4f}")


def fig4c_costs(a: np.ndarray, *, device="cuda", kernel: bool = True, normals=None):
    """Fig. 4c's (S, W, runs) costs and us per cell: A1 over ``FIG4C_RUNS``
    copies of ``a`` under ``PredictionNoise`` at ``FIG4C_STDS`` (common
    random numbers across stds), windows ``FIG4C_WINDOWS``, one call after
    a warm one.  The normals come from a generator seeded 7, a fresh one
    per call, or are injected as ``normals`` ((runs, T))."""
    ab = torch.as_tensor(np.tile(a, (FIG4C_RUNS, 1)), device=device).to(torch.int32)

    def spec():
        noise = PredictionNoise(
            std_frac=list(FIG4C_STDS), normals=normals,
            generator=generator(device, 7) if normals is None else None,
        )
        return ProvisionSpec(
            costs=COSTS,
            workload=Workload(demand=ab, noise=noise),
            policy=PolicySpec("A1", windows=list(FIG4C_WINDOWS)),
            n_levels=int(a.max()) + 1,
            device=device,
        )

    warm, timed = spec(), spec()
    _provision(warm, record_decisions=False, kernel=kernel)       # the warm-up
    sync(device)
    t0 = time.perf_counter()
    costs = _provision(timed, record_decisions=False, kernel=kernel).cost     # (S, W, B)
    sync(device)
    us = (time.perf_counter() - t0) * 1e6 / (FIG4C_RUNS * len(FIG4C_STDS) * len(FIG4C_WINDOWS))
    return costs, us


def fig4c_prediction_error(rows: list[str], *, device="cuda", kernel: bool = True,
                           normals=None) -> None:
    """Fig. 4c: robustness to zero-mean Gaussian prediction error.

    The whole (error-std x window x replica) study is ONE ``provision``
    call (:func:`fig4c_costs`): ``PredictionNoise.std_frac`` is the (S,)
    sweep axis and the windows ride ``PolicySpec.windows``.
    """
    a = _trace()
    static = fluid_cost(a, "static", COSTS).cost
    costs, us = fig4c_costs(a, device=device, kernel=kernel, normals=normals)
    means = costs.mean(dim=-1).cpu().numpy()                    # (S, W)
    for s, std in enumerate(FIG4C_STDS):
        for w, window in enumerate(FIG4C_WINDOWS):
            red = 1 - float(means[s, w]) / static
            rows.append(
                f"fig4c_A1_w{window}_std{int(std * 100)},{us:.1f},reduction={red:.4f}"
            )


def fig4d_pmr_sweep(rows: list[str]) -> None:
    """Fig. 4d: savings grow with the peak-to-mean ratio.

    The PMR knob is the scenario's ``target_pmr`` field (same seed => same
    base shape, only the Section V-D rescale differs).  The fluid model's
    closed form: no device.
    """
    for pmr in (2, 3, 4, 6, 8, 10):
        a = _trace(target_pmr=float(pmr))
        static = fluid_cost(a, "static", COSTS).cost
        (c, us) = _timed(lambda: fluid_cost(a, "A1", COSTS, window=1).cost)
        rows.append(f"fig4d_pmr{pmr},{us:.1f},reduction={1 - c / static:.4f}")


def sections(*, device="cuda", kernel: bool = True) -> list:
    """``(name, fn(rows))`` of each figure, in the reference's order."""
    return [
        ("fig3_competitive_ratios",
         functools.partial(fig3_competitive_ratios, device=device, kernel=kernel)),
        ("fig4b_cost_reduction_vs_window",
         functools.partial(fig4b_cost_reduction_vs_window, device=device, kernel=kernel)),
        ("fig4c_prediction_error",
         functools.partial(fig4c_prediction_error, device=device, kernel=kernel)),
        ("fig4d_pmr_sweep", fig4d_pmr_sweep),
    ]


def run(rows: list[str], *, device="cuda", kernel: bool = True) -> None:
    for _, fn in sections(device=device, kernel=kernel):
        fn(rows)
