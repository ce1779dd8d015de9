"""The twin of ``tests/test_offline_optimal.py`` on the port: Theorems 4
and 5, the construction and A0 are optimal (against the DP oracle),
through ``repro_torch.core``."""
import numpy as np
import pytest

# The port's tests need torch.  CI's jax-only tier-1 job installs no torch,
# so there these files skip instead of failing at import.
torch = pytest.importorskip("torch")

from repro_torch.core import (  # noqa: E402
    CostModel,
    OfflinePolicy,
    a0_cost,
    a0_schedule,
    dp_optimal_cost,
    fluid_cost,
    generate_brick_trace,
    optimal_schedule_constructed,
    schedule_cost,
    simulate,
    trace_from_intervals,
)

COSTS = CostModel(P=1.0, beta_on=3.0, beta_off=3.0)


@pytest.mark.parametrize("seed", range(12))
def test_a0_equals_constructed_schedule(seed):
    """Theorem 5: the decentralized A0 reproduces the constructed optimum."""
    rng = np.random.default_rng(seed)
    tr = generate_brick_trace(rng, horizon=50.0, rate=0.7, mean_duration=4.0)
    xa = a0_schedule(tr, COSTS)
    xc = optimal_schedule_constructed(tr, COSTS)
    ca = schedule_cost(xa, COSTS, final_level=float(tr.final_count()))
    cc = schedule_cost(xc, COSTS, final_level=float(tr.final_count()))
    assert ca == pytest.approx(cc, rel=1e-9), (
        f"A0 schedule cost {ca} != constructed optimal {cc}"
    )


@pytest.mark.parametrize("seed", range(12))
def test_a0_closed_form_matches_schedule_cost(seed):
    rng = np.random.default_rng(seed)
    tr = generate_brick_trace(rng, horizon=50.0, rate=0.7, mean_duration=4.0)
    x = a0_schedule(tr, COSTS)
    assert a0_cost(tr, COSTS) == pytest.approx(
        schedule_cost(x, COSTS, final_level=float(tr.final_count())), rel=1e-9
    )


@pytest.mark.parametrize("seed", range(12))
def test_offline_simulator_matches_a0_cost(seed):
    rng = np.random.default_rng(seed)
    tr = generate_brick_trace(rng, horizon=40.0, rate=0.8, mean_duration=3.0)
    res = simulate(tr, OfflinePolicy(), COSTS)
    assert res.cost == pytest.approx(a0_cost(tr, COSTS), rel=1e-9)


@pytest.mark.parametrize("seed", range(10))
def test_fluid_offline_equals_dp_oracle(seed):
    """Per-level decomposition == brute-force DP on random fluid traces."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 6, size=40)
    got = fluid_cost(a, "offline", COSTS).cost
    want = dp_optimal_cost(a, COSTS)
    assert got == pytest.approx(want, rel=1e-9), f"level-decomp {got} != DP {want}"


@pytest.mark.parametrize(
    "beta_on,beta_off", [(1.0, 1.0), (3.0, 3.0), (5.0, 1.0), (0.5, 4.5), (10.0, 2.0)]
)
def test_fluid_offline_equals_dp_oracle_cost_sweep(beta_on, beta_off):
    rng = np.random.default_rng(123)
    costs = CostModel(P=1.0, beta_on=beta_on, beta_off=beta_off)
    for _ in range(4):
        a = rng.integers(0, 5, size=30)
        got = fluid_cost(a, "offline", costs).cost
        want = dp_optimal_cost(a, costs)
        assert got == pytest.approx(want, rel=1e-9)


def test_brick_optimal_on_hand_example():
    """Two short jobs with a gap > Delta: server must power-cycle."""
    costs = CostModel(P=1.0, beta_on=3.0, beta_off=3.0)  # Delta = 6
    tr = trace_from_intervals([(1.0, 2.0), (10.0, 11.0)], 20.0)
    # initial turn-on (3) + busy 2.0 + gap 8 > 6 -> beta (6) + trailing off (3)
    assert a0_cost(tr, costs) == pytest.approx(3.0 + 2.0 + 6.0 + 3.0)


def test_brick_optimal_keeps_idle_for_short_gap():
    costs = CostModel(P=1.0, beta_on=3.0, beta_off=3.0)
    tr = trace_from_intervals([(1.0, 2.0), (6.0, 7.0)], 20.0)
    # initial turn-on (3) + busy 2 + gap 4 <= 6 stays idle (4) + trailing off (3)
    assert a0_cost(tr, costs) == pytest.approx(3.0 + 2.0 + 4.0 + 3.0)


def test_brick_vs_fine_grained_dp():
    """Discretize a brick trace finely; DP cost must match a0_cost."""
    costs = CostModel(P=1.0, beta_on=2.0, beta_off=2.0)
    tr = trace_from_intervals([(1.0, 3.0), (2.0, 9.0), (5.0, 6.0), (11.0, 14.0)], 16.0)
    # slot length 1.0 aligned with integer event times: a per slot [t, t+1)
    a = np.array([tr.a_at(t + 1e-9) for t in range(16)])
    got = a0_cost(tr, costs)
    want = dp_optimal_cost(a, costs)
    assert got == pytest.approx(want, rel=1e-9)
