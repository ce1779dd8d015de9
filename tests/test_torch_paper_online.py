"""The twin of ``tests/test_online.py`` on the port: Theorem 7 / Corollary
8 (online competitive ratios) and Lemma 6 (dispatch invariance), through
``repro_torch.core``."""
import math

import numpy as np
import pytest

# The port's tests need torch.  CI's jax-only tier-1 job installs no torch,
# so there these files skip instead of failing at import.
torch = pytest.importorskip("torch")

from repro_torch.core import (  # noqa: E402
    A1Deterministic,
    A2Randomized,
    A3Randomized,
    CostModel,
    OfflinePolicy,
    a0_cost,
    fluid_cost,
    generate_brick_trace,
    msr_like_trace,
    simulate,
    theoretical_ratio,
    trace_from_intervals,
)

COSTS = CostModel(P=1.0, beta_on=3.0, beta_off=3.0)  # Delta = 6
E = math.e


# ---------------------------------------------------------------------------
# A1 (deterministic): ratio must hold on EVERY instance
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("alpha", [0.0, 0.25, 0.5, 0.75, 1.0])
@pytest.mark.parametrize("seed", range(6))
def test_a1_competitive_ratio_random_traces(alpha, seed):
    rng = np.random.default_rng(seed)
    tr = generate_brick_trace(rng, horizon=80.0, rate=0.9, mean_duration=4.0)
    opt = a0_cost(tr, COSTS)
    on = simulate(tr, A1Deterministic(alpha=alpha), COSTS).cost
    # horizon truncation can add up to one idle wait per trailing server; the
    # interior analysis bound is 2 - alpha (Lemma 10).
    slack = 1e-9 + COSTS.P * (1 - alpha) * COSTS.delta * 3 / max(opt, 1e-9)
    assert on / opt <= theoretical_ratio("A1", alpha) + slack


def test_a1_bound_is_tight_adversarial():
    """Repeated (tiny job, gap just over Delta) cycles -> ratio -> 2 - alpha."""
    eps = 1e-4
    cycle = COSTS.delta + 0.01
    jobs = [(1.0 + i * cycle, 1.0 + i * cycle + eps) for i in range(200)]
    tr = trace_from_intervals(jobs, 1.0 + 200 * cycle + 5.0)
    opt = a0_cost(tr, COSTS)
    for alpha in (0.0, 0.5, 1.0):
        on = simulate(tr, A1Deterministic(alpha=alpha), COSTS).cost
        ratio = on / opt
        bound = theoretical_ratio("A1", alpha)
        assert ratio <= bound + 1e-2
        # tight up to boundary-term dilution for alpha < 1
        if alpha < 1.0:
            assert ratio >= bound - 0.05


def test_a1_alpha1_is_optimal():
    """alpha = 1: full critical window knowledge => exactly optimal (Thm 7 rmk)."""
    for seed in range(8):
        rng = np.random.default_rng(seed)
        tr = generate_brick_trace(rng, horizon=60.0, rate=0.8, mean_duration=3.0)
        opt = a0_cost(tr, COSTS)
        on = simulate(tr, A1Deterministic(alpha=1.0), COSTS).cost
        assert on == pytest.approx(opt, rel=1e-9)


# ---------------------------------------------------------------------------
# A2 / A3 (randomized): expected ratio
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,cls", [("A2", A2Randomized), ("A3", A3Randomized)])
@pytest.mark.parametrize("alpha", [0.0, 0.5, 1.0])
def test_randomized_expected_ratio(name, cls, alpha):
    rng = np.random.default_rng(42)
    tr = generate_brick_trace(rng, horizon=120.0, rate=1.2, mean_duration=4.0)
    opt = a0_cost(tr, COSTS)
    runs = 60
    tot = 0.0
    for r in range(runs):
        tot += simulate(tr, cls(alpha=alpha), COSTS, rng=np.random.default_rng(r)).cost
    emp = tot / runs / opt
    bound = theoretical_ratio(name, alpha)
    # expectation estimate + trailing-period slack
    assert emp <= bound + 0.08, f"{name} alpha={alpha}: {emp} > {bound}"


def test_a3_alpha1_is_optimal():
    for seed in range(5):
        rng = np.random.default_rng(seed)
        tr = generate_brick_trace(rng, horizon=60.0, rate=0.8, mean_duration=3.0)
        opt = a0_cost(tr, COSTS)
        on = simulate(tr, A3Randomized(alpha=1.0), COSTS,
                      rng=np.random.default_rng(seed + 99)).cost
        assert on == pytest.approx(opt, rel=1e-9)


def test_a3_beats_a2_bound():
    """e/(e-1+a) <= (e-a)/(e-1) for all alpha in [0,1]."""
    for alpha in np.linspace(0, 1, 21):
        assert theoretical_ratio("A3", alpha) <= theoretical_ratio("A2", alpha) + 1e-12


# ---------------------------------------------------------------------------
# Lemma 6: dispatch is identical across policies (same jobs -> same servers)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(5))
def test_lemma6_assignments_invariant(seed):
    rng = np.random.default_rng(seed)
    tr = generate_brick_trace(rng, horizon=60.0, rate=1.0, mean_duration=3.0)
    base = simulate(tr, OfflinePolicy(), COSTS).assignments
    for pol in (
        A1Deterministic(alpha=0.0),
        A1Deterministic(alpha=0.7),
        A2Randomized(alpha=0.3),
        A3Randomized(alpha=0.9),
    ):
        got = simulate(tr, pol, COSTS, rng=np.random.default_rng(seed + 1)).assignments
        assert got == base, "LIFO dispatch must not depend on the off/idle policy"


# ---------------------------------------------------------------------------
# Fluid-model ratios (Corollary 8)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("window", [0, 1, 2, 3, 5, 6, 8])
def test_fluid_a1_ratio(window):
    a = msr_like_trace(np.random.default_rng(7), n_slots=400, mean_jobs=25.0)
    opt = fluid_cost(a, "offline", COSTS).cost
    on = fluid_cost(a, "A1", COSTS, window=window).cost
    alpha = min(1.0, (window + 1) / COSTS.delta)
    assert on / opt <= 2.0 - alpha + 1e-9


def test_fluid_a1_window_delta_minus_1_is_optimal():
    """Paper Sec. V-B: window Delta-1 slots + current slot => optimal."""
    a = msr_like_trace(np.random.default_rng(3), n_slots=500, mean_jobs=30.0)
    opt = fluid_cost(a, "offline", COSTS).cost
    on = fluid_cost(a, "A1", COSTS, window=int(COSTS.delta) - 1).cost
    assert on == pytest.approx(opt, rel=1e-12)


@pytest.mark.parametrize("name", ["A2", "A3"])
def test_fluid_randomized_ratio(name):
    a = msr_like_trace(np.random.default_rng(11), n_slots=400, mean_jobs=20.0)
    opt = fluid_cost(a, "offline", COSTS).cost
    for window in (0, 2, 4):
        tot = 0.0
        runs = 40
        for r in range(runs):
            tot += fluid_cost(a, name, COSTS, window=window,
                              rng=np.random.default_rng(r)).cost
        alpha = min(1.0, (window + 1) / COSTS.delta)
        assert tot / runs / opt <= theoretical_ratio(name, alpha) + 0.05
