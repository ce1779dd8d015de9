"""repro_torch's numpy oracles == repro's, on the CPU.

The paper's divide-and-conquer (``segments``, ``offline``), the brick
simulator (``online``), the fluid model (``fluid``), the DP oracle and the
analysis tables are numpy copies in the port: on the same seeded traces and
the same ``default_rng`` seeds they must give the reference's outputs
exactly (the same numpy operations, so no tolerance).  Then the port's
``provision()`` offline cost against the port's ``dp_optimal_cost`` (float32
against float64: rel 1e-6), the serving cluster held to the port's own
brick oracles, and the deprecated loose-kwargs wrappers against the
reference's, with the reference's draws injected.
"""
import dataclasses
import math

import numpy as np
import pytest

# The port's tests need torch.  CI's jax-only tier-1 job installs no torch,
# so there these files skip instead of failing at import.
torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core as ref  # noqa: E402
import repro_torch.core as port  # noqa: E402
import repro_torch.serving as port_serving  # noqa: E402
from repro.core import analysis as ref_analysis  # noqa: E402
from repro.core import fluid as ref_fluid  # noqa: E402
from repro.core import segments as ref_segments  # noqa: E402
from repro.core.jax_provision import _uniforms as ref_uniforms  # noqa: E402
from repro_torch.convert import uniforms_from_numpy  # noqa: E402
from repro_torch.core import analysis as port_analysis  # noqa: E402
from repro_torch.core import fluid as port_fluid  # noqa: E402
from repro_torch.core import segments as port_segments  # noqa: E402
from repro_torch.data import generate_sessions  # noqa: E402

REF_COSTS = ref.CostModel(P=1.0, beta_on=3.0, beta_off=3.0)
COSTS = port.CostModel(P=1.0, beta_on=3.0, beta_off=3.0)
# (P, beta_on, beta_off): the paper's Δ = 6, an asymmetric Δ = 2.5 and a fractional one
COST_CASES = [(1.0, 3.0, 3.0), (2.0, 3.0, 2.0), (1.5, 0.7, 4.1)]
SEEDS = range(6)


def brick_pair(seed, horizon=50.0, rate=0.8, mean_duration=3.5):
    """One seeded brick trace, generated by each package."""
    kw = dict(horizon=horizon, rate=rate, mean_duration=mean_duration)
    return (ref.generate_brick_trace(np.random.default_rng(seed), **kw),
            port.generate_brick_trace(np.random.default_rng(seed), **kw))


def cost_pair(case):
    return ref.CostModel(*case), port.CostModel(*case)


def segments(segs):
    return [(s.start, s.end, s.start_level, s.end_level, s.seg_type.value) for s in segs]


def stepfn(x):
    return (x.times, x.values, x.horizon)


@pytest.mark.parametrize("seed", SEEDS)
def test_segments_match_reference(seed):
    rt, pt = brick_pair(seed)
    assert port.critical_times(pt) == ref.critical_times(rt)
    assert segments(port.critical_segments(pt)) == segments(ref.critical_segments(rt))
    for s in ref.critical_segments(rt):
        got = port_segments.classify_segment(pt, s.start, s.end)
        assert got.value == ref_segments.classify_segment(rt, s.start, s.end).value


@pytest.mark.parametrize("case", COST_CASES, ids=lambda c: "P{}-on{}-off{}".format(*c))
@pytest.mark.parametrize("seed", SEEDS)
def test_offline_matches_reference(seed, case):
    rt, pt = brick_pair(seed)
    rc, pc = cost_pair(case)
    assert stepfn(port.a0_schedule(pt, pc)) == stepfn(ref.a0_schedule(rt, rc))
    assert (stepfn(port.optimal_schedule_constructed(pt, pc))
            == stepfn(ref.optimal_schedule_constructed(rt, rc)))
    assert port.a0_cost(pt, pc) == ref.a0_cost(rt, rc)
    assert port.optimal_cost(pt, pc) == ref.optimal_cost(rt, rc)


POLICIES = [
    ("offline", lambda m: m.OfflinePolicy()),
    ("A1-0", lambda m: m.A1Deterministic(alpha=0.0)),
    ("A1-0.6", lambda m: m.A1Deterministic(alpha=0.6)),
    ("A2-0.3", lambda m: m.A2Randomized(alpha=0.3)),
    ("A3-0.9", lambda m: m.A3Randomized(alpha=0.9)),
    ("delayedoff", lambda m: m.DelayedOffPolicy(t_wait_factor=0.5)),
    ("breakeven", lambda m: m.BreakEven()),
]


@pytest.mark.parametrize("name,make", POLICIES, ids=[p[0] for p in POLICIES])
@pytest.mark.parametrize("seed", SEEDS[:3])
def test_simulate_matches_reference(seed, name, make):
    """``SimResult`` field for field, the same ``default_rng`` seed driving
    the randomized policies' waits."""
    rt, pt = brick_pair(seed)
    want = ref.simulate(rt, make(ref), REF_COSTS, rng=np.random.default_rng(seed + 40))
    got = port.simulate(pt, make(port), COSTS, rng=np.random.default_rng(seed + 40))
    assert isinstance(got, port.SimResult)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_simulate_with_predicted_pops_matches_reference():
    rt, pt = brick_pair(3)
    rng = np.random.default_rng(9)
    pops = {k: (None if v is None else v + rng.normal(0.0, 1.0))
            for k, v in rt.lifo_matching().items()}
    want = ref.simulate(rt, ref.A1Deterministic(alpha=0.5), REF_COSTS, predicted_pop=pops)
    got = port.simulate(pt, port.A1Deterministic(alpha=0.5), COSTS, predicted_pop=pops)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def fluid_trace(seed, n=240, mean=12.0):
    return ref.msr_like_trace(np.random.default_rng(seed), n_slots=n, mean_jobs=mean)


def fluid_equal(got, want):
    assert isinstance(got, port.FluidResult)
    assert (got.cost, got.energy, got.toggle_cost) == (want.cost, want.energy, want.toggle_cost)
    if want.x is None:
        assert got.x is None
    else:
        np.testing.assert_array_equal(got.x, want.x)


FLUID_POLICIES = ("offline", "A1", "A2", "A3", "delayedoff", "lcp", "static")


@pytest.mark.parametrize("policy", FLUID_POLICIES)
@pytest.mark.parametrize("window", [0, 2, 7])
def test_fluid_cost_matches_reference(policy, window):
    a = fluid_trace(1)
    if policy == "lcp" and window < 1:      # LCP needs a window; both refuse
        for m, c in ((ref, REF_COSTS), (port, COSTS)):
            with pytest.raises(ValueError):
                m.fluid_cost(a, policy, c, window=window)
        return
    for case in COST_CASES:
        rc, pc = cost_pair(case)
        want = ref.fluid_cost(a, policy, rc, window=window, rng=np.random.default_rng(5))
        got = port.fluid_cost(a, policy, pc, window=window, rng=np.random.default_rng(5))
        fluid_equal(got, want)


@pytest.mark.parametrize("policy", ("offline", "A1", "A2", "A3", "delayedoff", "lcp"))
@pytest.mark.parametrize("noisy", [False, True], ids=["exact", "noisy"])
def test_fluid_scan_matches_reference(policy, noisy):
    a = fluid_trace(2, n=160)
    pred = ref.with_prediction_error(a, np.random.default_rng(3), 0.4) if noisy else None
    for case in COST_CASES:
        rc, pc = cost_pair(case)
        for window in (0, 3):
            want = ref.fluid_scan(a, policy, rc, window=window, predicted=pred,
                                  rng=np.random.default_rng(6))
            got = port.fluid_scan(a, policy, pc, window=window, predicted=pred,
                                  rng=np.random.default_rng(6))
            fluid_equal(got, want)


def test_fluid_helpers_match_reference():
    a = fluid_trace(4)
    for level in (0, 3, 9, 40):
        assert port_fluid.level_gaps(a, level) == ref_fluid.level_gaps(a, level)
    for alpha in (0.0, 0.4, 1.0):
        for sampler in ("sample_wait_a2", "sample_wait_a3"):
            want = [getattr(ref_fluid, sampler)(alpha, 6.0, np.random.default_rng(s))
                    for s in range(20)]
            got = [getattr(port_fluid, sampler)(alpha, 6.0, np.random.default_rng(s))
                   for s in range(20)]
            assert got == want
    cost = ref.fluid_cost(a, "A1", REF_COSTS).cost
    assert (port_fluid.cost_reduction_vs_static(cost, a, COSTS)
            == ref_fluid.cost_reduction_vs_static(cost, a, REF_COSTS))


@pytest.mark.parametrize("case", COST_CASES, ids=lambda c: "P{}-on{}-off{}".format(*c))
@pytest.mark.parametrize("seed", SEEDS)
def test_dp_oracle_matches_reference(seed, case):
    a = np.random.default_rng(seed).integers(0, 6, size=30)
    rc, pc = cost_pair(case)
    assert port.dp_optimal_cost(a, pc) == ref.dp_optimal_cost(a, rc)
    assert port.dp_optimal_cost(a, pc, slack=2) == ref.dp_optimal_cost(a, rc, slack=2)


def test_analysis_tables_match_reference():
    rt, pt = brick_pair(7, horizon=60.0)
    a = fluid_trace(5, n=200)
    for name in ("A1", "A2", "A3"):
        for alpha in (0.0, 0.5):
            want = ref_analysis.empirical_ratio_brick(rt, name, alpha, REF_COSTS, n_runs=3)
            got = port_analysis.empirical_ratio_brick(pt, name, alpha, COSTS, n_runs=3)
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
        for window in (0, 3):
            want = ref_analysis.empirical_ratio_fluid(a, name, window, REF_COSTS, n_runs=3)
            got = port_analysis.empirical_ratio_fluid(a, name, window, COSTS, n_runs=3)
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
    want = ref_analysis.cost_reduction_table(a, REF_COSTS, [0, 1, 3, 5], n_runs=2)
    got = port_analysis.cost_reduction_table(a, COSTS, [0, 1, 3, 5], n_runs=2)
    assert list(got) == list(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])


# ---------------------------------------------------------------------------
# The port's provision() against the port's DP oracle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", COST_CASES, ids=lambda c: "P{}-on{}-off{}".format(*c))
@pytest.mark.parametrize("seed", SEEDS)
def test_provision_offline_equals_dp_oracle(seed, case):
    """``provision()``'s closed-form offline cost (float32) is the DP
    optimum (float64) on small traces, batched."""
    a = np.random.default_rng(seed).integers(0, 6, size=(3, 30))
    costs = port.CostModel(*case)
    spec = port.ProvisionSpec(costs=costs, workload=port.Workload(demand=a),
                              policy=port.PolicySpec(name="offline"), device="cpu")
    got = port.provision(spec).cost.numpy()
    want = [port.dp_optimal_cost(row, costs) for row in a]
    np.testing.assert_allclose(got, want, rtol=1e-6)


# ---------------------------------------------------------------------------
# The serving cluster held to the port's own brick oracles
# ---------------------------------------------------------------------------

def test_run_cluster_laws_against_port_simulator():
    """``tests/test_torch_cluster.py``'s laws against the reference's
    simulator, here against the port's ``simulate`` and ``a0_cost`` on the
    port's own brick trace: equal to the simulator (alpha 0; 0.5 and 1
    with a perfect predictor, rel 1e-6), within 2 - alpha of the offline
    optimum up to the horizon slack, and saving over static provisioning."""
    trace = generate_sessions(np.random.default_rng(0), n_slots=120, mean_concurrency=6.0)
    brick = trace.to_brick()
    opt = port.a0_cost(brick, COSTS)
    for alpha in (0.0, 0.5, 1.0):
        want = port.simulate(brick, port.A1Deterministic(alpha=alpha), COSTS).cost
        rep = port_serving.run_cluster(
            trace, COSTS, policy="A1", alpha=alpha,
            predictor=port_serving.make_window_max_predictor(trace) if alpha else None)
        assert rep.total_cost == pytest.approx(want, rel=1e-6), alpha
        assert rep.total_cost <= (2 - alpha) * opt + COSTS.delta * 3
        assert rep.reduction > 0.3


def test_run_cluster_pays_beta_off_for_sessions_cut_at_the_horizon():
    """On the launcher's trace (60 slots, concurrency 4) 17 sessions run
    past the horizon: ``run_cluster`` releases them at T and turns their
    replicas off, while the brick simulator counts them running at T (x(T)
    = a(T)).  So the cluster costs the simulator's cost plus beta_off for
    each of them, at every alpha, in the reference and the port alike (the
    laws above hold on a trace that ends empty)."""
    from repro.data.requests import generate_sessions as ref_sessions

    trace = generate_sessions(np.random.default_rng(0), n_slots=60, mean_concurrency=4.0)
    ref_trace = ref_sessions(np.random.default_rng(0), n_slots=60, mean_concurrency=4.0)
    brick = trace.to_brick()
    cut = brick.final_count()
    assert cut == 17
    for alpha in (0.0, 0.5, 1.0):
        sim = port.simulate(brick, port.A1Deterministic(alpha=alpha), COSTS).cost
        assert sim == ref.simulate(ref_trace.to_brick(), ref.A1Deterministic(alpha=alpha),
                                   REF_COSTS).cost
        predictor = port_serving.make_window_max_predictor(trace) if alpha else None
        rep = port_serving.run_cluster(trace, COSTS, policy="A1", alpha=alpha,
                                       predictor=predictor)
        assert rep.total_cost == pytest.approx(sim + COSTS.beta_off * cut, rel=1e-6), alpha
        assert rep.scaler.energy == pytest.approx(
            port.simulate(brick, port.A1Deterministic(alpha=alpha), COSTS).energy, rel=1e-9)


# ---------------------------------------------------------------------------
# The deprecated loose-kwargs API
# ---------------------------------------------------------------------------

def ref_draws(a, n, seed):
    """The reference's wait uniforms for ``a`` over ``n`` levels under
    ``key(seed)``, split per trace as its ``provision()`` splits them."""
    key = jax.random.key(seed)
    keys = jax.random.split(key, a.shape[0]) if a.ndim == 2 else key[None]
    u0, u1 = jax.vmap(lambda k: ref_uniforms(k, a.shape[-1], n))(keys)
    if a.ndim == 1:
        u0, u1 = u0[0], u1[0]
    return uniforms_from_numpy(np.array(u0), np.array(u1), device="cpu")


@pytest.mark.parametrize("policy", ["A1", "A3", "offline", "delayedoff"])
def test_provision_schedule_wrapper_matches_reference(policy):
    a = np.random.default_rng(20).integers(0, 7, size=80)
    n = int(a.max()) + 1
    keyed = policy == "A3"
    with pytest.warns(DeprecationWarning, match="^deprecated"):
        want = ref.provision_schedule(jnp.asarray(a, jnp.int32), n_levels=n, delta=6,
                                      window=2, policy=policy,
                                      key=jax.random.key(1) if keyed else None)
    with pytest.warns(DeprecationWarning, match="^deprecated"):
        got = port.provision_schedule(a, n_levels=n, delta=6, window=2, policy=policy,
                                      uniforms=ref_draws(a, n, 1) if keyed else None,
                                      device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_provision_sweep_wrappers_match_reference():
    ab = np.random.default_rng(21).integers(0, 6, size=(3, 60))
    kw = dict(n_levels=6, delta=6, policy="A3")
    with pytest.warns(DeprecationWarning, match="^deprecated"):
        want_x = ref.provision_sweep(jnp.asarray(ab, jnp.int32), windows=jnp.arange(4),
                                     key=jax.random.key(2), **kw)
    with pytest.warns(DeprecationWarning, match="^deprecated"):
        want_c = ref.provision_sweep_costs(jnp.asarray(ab, jnp.int32), windows=jnp.arange(4),
                                           key=jax.random.key(2), P=1.0, beta_on=3.0,
                                           beta_off=3.0, **kw)
    u = ref_draws(ab, 6, 2)
    with pytest.warns(DeprecationWarning, match="^deprecated"):
        got_x = port.provision_sweep(ab, windows=list(range(4)), uniforms=u, device="cpu", **kw)
    with pytest.warns(DeprecationWarning, match="^deprecated"):
        got_c = port.provision_sweep_costs(ab, windows=list(range(4)), uniforms=u, P=1.0,
                                           beta_on=3.0, beta_off=3.0, device="cpu", **kw)
    np.testing.assert_array_equal(got_x.numpy(), np.asarray(want_x))
    # integer cost fields: every sum is exact, so the totals are equal
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    with pytest.warns(DeprecationWarning), pytest.raises(ValueError, match="disagrees"):
        port.provision_sweep_costs(ab, windows=[0], delta=5, n_levels=6, device="cpu")


def test_provision_cost_wrapper_matches_reference():
    rng = np.random.default_rng(22)
    a = rng.integers(0, 5, size=(2, 40))
    on = (rng.random((2, 40, 5)) < 0.5) | (a[..., None] > np.arange(5))
    with pytest.warns(DeprecationWarning, match="^deprecated"):
        want = ref.provision_cost(jnp.asarray(a), jnp.asarray(on), 2.0, 3.0, 1.0)
    with pytest.warns(DeprecationWarning, match="^deprecated"):
        got = port.provision_cost(torch.as_tensor(a), torch.as_tensor(on), 2.0, 3.0, 1.0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_provision_schedule_sharded_waits_for_the_multi_device_route(monkeypatch):
    """The multi-device route is ported: the wrapper warns as the
    reference's does and hands ``mesh`` and ``axis`` to the spec it runs
    (``tests/test_torch_mesh.py`` runs it on worlds of gloo ranks and holds
    its x to the reference's)."""
    import importlib
    import types

    seen = {}

    def provision(spec):
        seen["spec"] = spec
        return types.SimpleNamespace(x="x")

    monkeypatch.setattr(importlib.import_module("repro_torch.core.provision"), "provision",
                        provision)
    mesh = object()
    with pytest.warns(DeprecationWarning, match="^deprecated: provision_schedule_sharded"):
        got = port.provision_schedule_sharded(mesh, np.zeros(4, np.int32), n_levels=2,
                                              delta=6, window=1, axis="levels", device="cpu")
    spec = seen["spec"]
    assert got == "x" and spec.mesh is mesh and spec.mesh_axis == "levels"
    assert (spec.n_levels, spec.policy.window, float(spec.costs.delta)) == (2, 1, 6.0)


def test_wrappers_run_on_the_card_unless_given_cpu():
    if torch.cuda.is_available():
        pytest.skip("the refusal needs a machine without CUDA")
    with pytest.warns(DeprecationWarning), pytest.raises(RuntimeError,
                                                         match="CUDA is not available"):
        port.provision_schedule(np.ones(8, np.int32), n_levels=2, delta=6)


def test_oracle_exports_match_reference():
    """``repro_torch.core`` exports every name of ``repro.core``'s API."""
    assert set(ref.__all__) <= set(port.__all__)
    assert math.isclose(port.theoretical_ratio("A2", 0.5), ref.theoretical_ratio("A2", 0.5))
