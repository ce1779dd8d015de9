"""The twin of ``tests/test_system.py`` on the port: the paper's headline
claims, through ``repro_torch.core``'s fluid model and through
``provision()`` (the plain route on the CPU; the card runs the same
schedule through K2, ``chip_smoke.py``).

The claims: cost reduction beyond 66% against static provisioning with no
future information, growing with the window to the optimum at window
Δ - 1; the ordering offline < A3 < A2 < A1 in expectation at an
intermediate window; robustness to 50% Gaussian prediction error; savings
growing with the peak-to-mean ratio.
"""
import numpy as np
import pytest

# The port's tests need torch.  CI's jax-only tier-1 job installs no torch,
# so there these files skip instead of failing at import.
torch = pytest.importorskip("torch")

from repro_torch.core import (  # noqa: E402
    CostModel,
    PolicySpec,
    PredictionNoise,
    ProvisionSpec,
    Workload,
    fluid_cost,
    fluid_scan,
    msr_like_trace,
    pmr,
    provision,
    scale_to_pmr,
    with_prediction_error,
)

COSTS = CostModel(P=1.0, beta_on=3.0, beta_off=3.0)  # paper: Delta = 6 slots
RUNS = 30          # fluid draws per randomized policy
PROVISION_RUNS = 8  # provision() draws per randomized policy (one generator each)


@pytest.fixture(scope="module")
def trace():
    return msr_like_trace(np.random.default_rng(0))


def provision_cost(a, policy, window=0, seed=None, noise=None):
    """``provision()``'s cost of one policy on the CPU; ``seed`` seeds the
    randomized policies' generator."""
    gen = None if seed is None else torch.Generator().manual_seed(seed)
    spec = ProvisionSpec(costs=COSTS, workload=Workload(demand=a, noise=noise),
                         policy=PolicySpec(name=policy, window=window, generator=gen),
                         device="cpu")
    return float(provision(spec).cost)


def test_trace_matches_paper_statistics(trace):
    """One week of 10-minute slots, PMR ~ 4.63 (paper Section V-A)."""
    assert len(trace) == 1008
    assert 4.2 <= pmr(trace) <= 5.1


def test_cost_reduction_beyond_66_percent_with_zero_future_info(trace):
    """Paper Sec. V-B: >66% reduction vs static provisioning at window 0."""
    static = fluid_cost(trace, "static", COSTS).cost
    for policy in ("A1", "A2", "A3"):
        c = fluid_cost(trace, policy, COSTS, window=0, rng=np.random.default_rng(1)).cost
        assert 1.0 - c / static > 0.66, f"{policy}: {(1.0 - c / static):.3f}"
        c = provision_cost(trace, policy, window=0, seed=None if policy == "A1" else 1)
        assert 1.0 - c / static > 0.66, f"provision {policy}: {(1.0 - c / static):.3f}"


def test_reduction_grows_with_window_and_reaches_optimal(trace):
    """Fig. 4b: linear growth to the optimum at window Delta - 1, in both
    the fluid model and ``provision()``."""
    static = fluid_cost(trace, "static", COSTS).cost
    opt = fluid_cost(trace, "offline", COSTS).cost
    assert provision_cost(trace, "offline") == pytest.approx(opt, rel=1e-6)
    prev = -1.0
    for w in range(0, 6):
        c = fluid_cost(trace, "A1", COSTS, window=w).cost
        assert provision_cost(trace, "A1", window=w) == pytest.approx(c, rel=1e-6)
        red = 1.0 - c / static
        assert red >= prev - 1e-12
        prev = red
    assert fluid_cost(trace, "A1", COSTS, window=5).cost == pytest.approx(opt)


def test_ordering_offline_best_then_a3_a2_a1(trace):
    """Expected ranking at an intermediate window (2 of Δ - 1 = 5): offline
    < A3 < A2 < A1, over seeded draws, in the fluid model and in
    ``provision()``."""
    opt = fluid_cost(trace, "offline", COSTS).cost
    fluid = {name: np.mean([fluid_cost(trace, name, COSTS, window=2,
                                       rng=np.random.default_rng(r)).cost
                            for r in range(RUNS)])
             for name in ("A1", "A2", "A3")}
    assert opt < fluid["A3"] < fluid["A2"] < fluid["A1"], fluid
    prov = {"A1": provision_cost(trace, "A1", window=2)}
    for name in ("A2", "A3"):
        prov[name] = np.mean([provision_cost(trace, name, window=2, seed=r)
                              for r in range(PROVISION_RUNS)])
    assert provision_cost(trace, "offline") < prov["A3"] < prov["A2"] < prov["A1"], prov


def test_robust_to_prediction_error(trace):
    """Fig. 4c: performance degrades gracefully with 50% Gaussian error."""
    static = fluid_cost(trace, "static", COSTS).cost
    exact = fluid_scan(trace, "A1", COSTS, window=4).cost
    rng = np.random.default_rng(5)
    noisy_costs = []
    for _ in range(10):
        pred = with_prediction_error(trace, rng, 0.5)
        noisy_costs.append(fluid_scan(trace, "A1", COSTS, window=4, predicted=pred).cost)
    noisy = float(np.mean(noisy_costs))
    assert 1.0 - noisy / static > 0.55
    assert noisy >= exact - 1e-9 or abs(noisy - exact) / exact < 0.1
    # the same through provision(): PredictionNoise at 50% of the load
    exact = provision_cost(trace, "A1", window=4)
    noisy = np.mean([provision_cost(trace, "A1", window=4, noise=PredictionNoise(
        0.5, generator=torch.Generator().manual_seed(r))) for r in range(5)])
    assert 1.0 - noisy / static > 0.55
    assert noisy >= exact - 1e-9 or abs(noisy - exact) / exact < 0.1


def test_pmr_sweep_monotone_savings():
    """Fig. 4d: higher PMR -> larger savings from dynamic provisioning."""
    base = msr_like_trace(np.random.default_rng(2), mean_jobs=40.0)
    reductions = []
    for target in (2.0, 4.0, 7.0, 10.0):
        a = scale_to_pmr(base.astype(float), target)
        a = np.maximum(np.rint(a / a.mean() * 40.0), 0).astype(np.int64)
        static = fluid_cost(a, "static", COSTS).cost
        c = fluid_cost(a, "offline", COSTS).cost
        assert provision_cost(a, "offline") == pytest.approx(c, rel=1e-6)
        reductions.append(1.0 - c / static)
    assert all(b >= a - 0.02 for a, b in zip(reductions, reductions[1:])), reductions
    assert reductions[0] > 0.25 and reductions[-1] > 0.7
