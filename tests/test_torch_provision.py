"""repro_torch.provision() == repro.core.provision(), end to end, on the CPU.

The same numpy-made demand goes through both packages' ``provision()``;
the port gets the reference's own random draws — the wait uniforms from
``_uniforms`` with the keys split as ``_prepare`` splits them, and the
prediction-noise normals from ``PredictionNoise.apply``'s key use — through
its injection points.  ``x``, the per-level cost terms and the decision
counts must be bit-exact.  The totals (``cost``, ``energy``,
``toggle_cost``, ``group_cost``) are float32 sums over the level axis taken
in another order, so they are held to ``rtol=1e-6``, and to exact equality
where every cost field is an integer.
"""
import dataclasses
import importlib

import numpy as np
import pytest

# The port's tests need torch.  CI's jax-only tier-1 job installs no torch,
# so there these files skip instead of failing at import.
torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core as ref  # noqa: E402
import repro_torch as port  # noqa: E402
from repro.core.jax_provision import KEYED  # noqa: E402
from repro.core.jax_provision import _uniforms as ref_uniforms  # noqa: E402
from repro.deferral import DeferralSpec  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    cost_model_from_numpy,
    normals_from_numpy,
    uniforms_from_numpy,
)
from repro_torch.obs import reconstruct_schedule, telemetry_session  # noqa: E402

# ``repro_torch.core`` re-exports the function ``provision`` over the
# submodule's name, so import the module by its full name
port_provision_module = importlib.import_module("repro_torch.core.provision")

B, T = 3, 48
KEY_SEED = 17


def _demand(seed, batched=True, top=12):
    rng = np.random.default_rng(seed)
    shape = (B, T) if batched else (T,)
    t = np.arange(T)
    phase = rng.uniform(0, 2 * np.pi, shape[:-1] + (1,))
    wave = top / 2 * (1 + 0.8 * np.sin(2 * np.pi * t / 19 + phase))
    return np.clip(np.rint(wave) + rng.integers(-2, 3, shape), 0, top).astype(np.int32)


# integer cost fields give Δ = 2.5 and Δ = 3.0; the per-level and typed
# fleets carry fractional fields
COSTS = {
    "delta_2.5": (2.0, 3.0, 2.0),
    "delta_3.0": (2.0, 3.0, 3.0),
}


def _ref_draws(a, policy, n, noise_std=None):
    """The reference's draws for ``a`` over ``n`` levels, keyed as its
    provision() keys them."""
    key = jax.random.key(KEY_SEED)
    batched = a.ndim == 2
    u = None
    if policy in KEYED:
        keys = jax.random.split(key, a.shape[0]) if batched else key[None]
        u0, u1 = jax.vmap(lambda k: ref_uniforms(k, a.shape[-1], n))(keys)
        u = (np.array(u0), np.array(u1)) if batched else (np.array(u0[0]), np.array(u1[0]))
    z = None
    if noise_std is not None:
        nkey = jax.random.key(KEY_SEED + 1)
        af = jnp.asarray(a, jnp.float32)
        if batched:
            z = jax.vmap(lambda k, ai: jax.random.normal(k, ai.shape))(
                jax.random.split(nkey, a.shape[0]), af)
        else:
            z = jax.random.normal(nkey, af.shape)
        z = np.array(z)
    return u, z


def _both(a, policy, costs, *, windows=None, window=0, noise_std=None, n_levels=None,
          record=False):
    """Run the reference and the port on the same spec and draws."""
    n = n_levels or costs.n_levels or int(a.max()) + 1
    u, z = _ref_draws(a, policy, n, noise_std)
    jnoise = None if noise_std is None else ref.PredictionNoise(
        std_frac=jnp.asarray(noise_std, jnp.float32), key=jax.random.key(KEY_SEED + 1))
    want = ref.provision(ref.ProvisionSpec(
        costs=costs,
        workload=ref.Workload(demand=jnp.asarray(a), noise=jnoise),
        policy=ref.PolicySpec(policy, window=window,
                              windows=None if windows is None else jnp.asarray(windows),
                              key=jax.random.key(KEY_SEED)),
        n_levels=n_levels,
    ), record_decisions=record)
    tcosts = cost_model_from_numpy(np.asarray(costs.P), np.asarray(costs.beta_on),
                                   np.asarray(costs.beta_off), costs.group_sizes,
                                   costs.group_names)
    tnoise = None if noise_std is None else port.PredictionNoise(
        std_frac=noise_std, normals=normals_from_numpy(z))
    got = port.provision(port.ProvisionSpec(
        costs=tcosts,
        workload=port.Workload(demand=a, noise=tnoise),
        policy=port.PolicySpec(policy, window=window, windows=windows,
                               uniforms=None if u is None else uniforms_from_numpy(*u)),
        n_levels=n_levels, device="cpu",
    ), record_decisions=record)
    return want, got


def _integer_fields(costs):
    return all(np.all(np.asarray(f) == np.round(np.asarray(f)))
               for f in (costs.P, costs.beta_on, costs.beta_off))


def _assert_same(want, got, costs, record):
    np.testing.assert_array_equal(got.x.numpy(), np.asarray(want.x))
    assert got.x.dtype == torch.int32
    np.testing.assert_array_equal(got.level_cost.numpy(), np.asarray(want.level_cost))
    totals = ["cost", "energy", "toggle_cost"] + (["group_cost"] if want.group_cost is not None
                                                  else [])
    assert (got.group_cost is None) == (want.group_cost is None)
    for name in totals:
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        if _integer_fields(costs):
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-6, err_msg=name)
    if record:
        assert sorted(got.decision_counts) == sorted(want.decision_counts)
        for k, v in want.decision_counts.items():
            np.testing.assert_array_equal(got.decision_counts[k].numpy(), np.asarray(v))
        np.testing.assert_array_equal(got.decisions.numpy(), np.asarray(want.decisions))
    else:
        assert got.decisions is None and got.decision_counts is None


@pytest.mark.parametrize("cost_case", list(COSTS))
@pytest.mark.parametrize("batched", [True, False], ids=["BT", "T"])
@pytest.mark.parametrize("policy", ref.POLICIES)
def test_provision_matches_reference(policy, batched, cost_case):
    a = _demand(1, batched)
    costs = ref.CostModel(*COSTS[cost_case])
    record = policy != "offline"
    want, got = _both(a, policy, costs, windows=[0, 2, 4], record=record)
    assert tuple(got.x.shape) == ((3, B, T) if batched else (3, T))
    _assert_same(want, got, costs, record)


@pytest.mark.parametrize("policy", ref.POLICIES)
def test_provision_per_level_fields(policy):
    a = _demand(2)
    n = 13
    rng = np.random.default_rng(3)
    costs = ref.CostModel(P=rng.uniform(0.8, 1.6, n).astype(np.float32),
                          beta_on=np.where(np.arange(n) % 2 == 0, 1.25, 1.5).astype(np.float32),
                          beta_off=1.25)
    want, got = _both(a, policy, costs, window=2, record=policy != "offline")
    _assert_same(want, got, costs, policy != "offline")


@pytest.mark.parametrize("policy", ref.POLICIES)
def test_provision_typed_fleet(policy):
    a = _demand(3)
    costs = ref.CostModel.from_groups(
        ref.ServerGroup("legacy", 6, P=1.5, beta_on=2.0, beta_off=1.75),
        ref.ServerGroup("efficient", 7, P=1.0, beta_on=1.25, beta_off=1.25),
    )
    want, got = _both(a, policy, costs, windows=[0, 2], record=policy != "offline")
    assert tuple(got.group_cost.shape) == (2, B, 2)
    _assert_same(want, got, costs, policy != "offline")


@pytest.mark.parametrize("batched", [True, False], ids=["BT", "T"])
@pytest.mark.parametrize("policy", ref.POLICIES)
def test_provision_noise_sweep(policy, batched):
    a = _demand(4, batched)
    costs = ref.CostModel(*COSTS["delta_3.0"])
    stds = [0.0, 0.2, 0.5]
    want, got = _both(a, policy, costs, windows=[1, 3], noise_std=stds, n_levels=16,
                      record=policy != "offline")
    assert tuple(got.x.shape) == ((3, 2, B, T) if batched else (3, 2, T))
    _assert_same(want, got, costs, policy != "offline")


def test_provision_scalar_noise_and_single_window():
    a = _demand(5)
    costs = ref.CostModel(*COSTS["delta_2.5"])
    want, got = _both(a, "A2", costs, window=1, noise_std=0.3, n_levels=16, record=True)
    assert tuple(got.x.shape) == (B, T)
    _assert_same(want, got, costs, True)


# ---------------------------------------------------------------------------
# reduction laws and routes of the port itself
# ---------------------------------------------------------------------------

def _port_spec(a, policy="A1", **kw):
    pol = dict(name=policy, generator=torch.Generator().manual_seed(0))
    pol.update({k: kw.pop(k) for k in ("window", "windows", "uniforms") if k in kw})
    return port.ProvisionSpec(costs=kw.pop("costs", port.PAPER_COSTS),
                              workload=port.Workload(demand=a, **kw.pop("workload", {})),
                              policy=port.PolicySpec(**pol), device="cpu", **kw)


@pytest.mark.parametrize("policy", ["A1", "A3", "offline"])
def test_batched_and_swept_reduce_to_rows(policy):
    a = _demand(6)
    rng = np.random.default_rng(6)
    u = [rng.uniform(size=(B, T, 13)).astype(np.float32) for _ in range(2)]
    full = port.provision(_port_spec(a, policy, windows=[0, 3], uniforms=u, n_levels=13))
    for b in range(B):
        for i, w in enumerate([0, 3]):
            row = port.provision(_port_spec(a[b], policy, window=w, n_levels=13,
                                            uniforms=[x[b] for x in u]))
            assert torch.equal(row.x, full.x[i, b])
            assert torch.equal(row.level_cost, full.level_cost[i, b])


def test_typed_single_group_equals_untyped():
    a = _demand(7)
    typed = port.CostModel.from_groups(port.ServerGroup("only", 13, P=1.0, beta_on=3.0,
                                                        beta_off=3.0))
    plain = port.CostModel(P=np.ones(13, np.float32), beta_on=3.0, beta_off=3.0)
    r_typed = port.provision(_port_spec(a, "A2", costs=typed, windows=[0, 2]))
    r_plain = port.provision(_port_spec(a, "A2", costs=plain, windows=[0, 2]))
    assert torch.equal(r_typed.x, r_plain.x)
    assert torch.equal(r_typed.level_cost, r_plain.level_cost)
    assert torch.equal(r_typed.group_cost[..., 0], r_typed.cost)


def test_decisions_reconstruct_the_schedule():
    a = _demand(8)
    res = port.provision(_port_spec(a, "A3", windows=[0, 2]), record_decisions=True)
    x0 = np.minimum(a[:, 0], int(a.max()) + 1)
    np.testing.assert_array_equal(reconstruct_schedule(res.decisions.numpy(), x0),
                                  res.x.numpy())


def test_generator_draws_are_reproducible():
    a = _demand(9)
    runs = [port.provision(_port_spec(a, "A2", windows=[0, 1], n_levels=13))
            for _ in range(2)]
    assert torch.equal(runs[0].x, runs[1].x)
    offline = port.provision(_port_spec(a, "offline", n_levels=13))
    assert (runs[0].cost >= offline.cost).all()


def test_provision_span_names_the_cpu_route():
    a = _demand(10)
    with telemetry_session() as tel:
        port.provision(_port_spec(a, "A1"), record_decisions=True)
    (event,) = tel.chrome_trace()["traceEvents"]
    assert event["name"] == "provision" and event["args"]["route"] == "cpu"
    assert tel.counter_value("kernels/provision_scan_launches") == 0.0
    assert tel.counter_value("provision/decision_toggle_offs") > 0


# ---------------------------------------------------------------------------
# errors: the port raises where the reference raises
# ---------------------------------------------------------------------------

def _raise_both(exc, ref_fn, port_fn, match=None):
    with pytest.raises(exc, match=match):
        ref_fn()
    with pytest.raises(exc, match=match):
        port_fn()


def _ref_spec(a, policy="A1", key=True, **kw):
    return ref.ProvisionSpec(
        costs=kw.pop("costs", ref.PAPER_COSTS),
        workload=ref.Workload(demand=jnp.asarray(a), **kw.pop("workload", {})),
        policy=ref.PolicySpec(policy, key=jax.random.key(0) if key else None),
        **kw,
    )


def test_unknown_policy_raises():
    a = _demand(11)
    _raise_both(ValueError, lambda: ref.provision(_ref_spec(a, "A4")),
                lambda: port.provision(_port_spec(a, "A4")), match="unknown policy")


@pytest.mark.parametrize("policy", sorted(KEYED))
def test_randomized_policy_without_randomness_raises(policy):
    a = _demand(12)
    spec = _port_spec(a, policy)
    spec = dataclasses.replace(spec, policy=port.PolicySpec(policy))
    _raise_both(ValueError, lambda: ref.provision(_ref_spec(a, policy, key=False)),
                lambda: port.provision(spec), match="randomized")


def test_offline_with_record_raises():
    a = _demand(13)
    _raise_both(ValueError,
                lambda: ref.provision(_ref_spec(a, "offline"), record_decisions=True),
                lambda: port.provision(_port_spec(a, "offline"), record_decisions=True),
                match="record_decisions")


def test_n_levels_that_cannot_be_inferred_raises():
    a = _demand(14)
    # the reference cannot see max(demand) through a jit trace; the port
    # cannot see it in an empty or meta-device demand
    _raise_both(ValueError,
                lambda: jax.jit(lambda d: ref.provision(_ref_spec(d)).x)(jnp.asarray(a)),
                lambda: port.provision(_port_spec(np.zeros((B, 0), np.int32))),
                match="n_levels")
    with pytest.raises(ValueError, match="n_levels"):
        port_provision_module._prepare(
            _port_spec(torch.empty((B, T), dtype=torch.int32, device="meta")),
            port.PolicySpec("A1"), torch.device("meta"),
        )


@pytest.mark.parametrize("bad", ["ndim", "both_predictions", "pred_shape", "std_shape"])
def test_malformed_workloads_raise(bad):
    a = _demand(15)
    z = np.zeros_like(a, np.float32)
    if bad == "ndim":
        ref_kw, port_kw, d_ref, d_port = {}, {}, a[None], a[None]
    elif bad == "both_predictions":
        ref_kw = dict(predicted=jnp.asarray(a),
                      noise=ref.PredictionNoise(0.1, jax.random.key(1)))
        port_kw = dict(predicted=a, noise=port.PredictionNoise(0.1, normals=z))
        d_ref = d_port = a
    elif bad == "pred_shape":
        ref_kw, port_kw = dict(predicted=jnp.asarray(a[:, 1:])), dict(predicted=a[:, 1:])
        d_ref = d_port = a
    else:
        ref_kw = dict(noise=ref.PredictionNoise(jnp.ones((2, 2)), jax.random.key(1)))
        port_kw = dict(noise=port.PredictionNoise(np.ones((2, 2)), normals=z))
        d_ref = d_port = a
    _raise_both(ValueError, lambda: ref.provision(_ref_spec(d_ref, workload=ref_kw)),
                lambda: port.provision(_port_spec(d_port, workload=port_kw)))


def _deferral_pair(policy, batched, slack=2):
    """The reference's and the port's ``provision()`` of one deferred
    workload, on the reference's draws."""
    from repro_torch.deferral import DeferralSpec as PortDeferralSpec

    a = _demand(16, batched)
    n = int(a.max()) + 1
    u, _ = _ref_draws(a, policy, n)
    want = ref.provision(ref.ProvisionSpec(
        costs=ref.CostModel(*COSTS["delta_3.0"]),
        workload=ref.Workload(demand=jnp.asarray(a), deferral=DeferralSpec(slack=slack)),
        policy=ref.PolicySpec(policy, window=1, key=jax.random.key(KEY_SEED)),
        n_levels=n,
    ))
    got = port.provision(port.ProvisionSpec(
        costs=cost_model_from_numpy(*COSTS["delta_3.0"]),
        workload=port.Workload(demand=a, deferral=PortDeferralSpec(slack=slack)),
        policy=port.PolicySpec(policy, window=1,
                               uniforms=None if u is None else uniforms_from_numpy(*u)),
        n_levels=n, device="cpu",
    ))
    return want, got


def test_deferral_is_not_silently_ignored():
    """``Workload(deferral=...)`` is honoured: the engine runs on the deferred
    profile (a schedule unlike the rigid one) and the result carries the
    queue metrics, as the reference's does."""
    want, got = _deferral_pair("A1", True)
    a = _demand(16)
    rigid = port.provision(_port_spec(a, costs=cost_model_from_numpy(*COSTS["delta_3.0"]),
                                      window=1, n_levels=int(a.max()) + 1))
    assert rigid.backlog is None
    assert not torch.equal(got.x, rigid.x)
    np.testing.assert_array_equal(got.x.numpy(), np.asarray(want.x))
    assert int(got.max_delay.max()) > 0 and int(got.deadline_misses.sum()) == 0


@pytest.mark.parametrize("batched", [True, False], ids=["BT", "T"])
@pytest.mark.parametrize("policy", ref.POLICIES)
def test_deferral_matches_reference(policy, batched):
    """Every leaf of a deferred ``provision()``, the five queue fields
    included, equals the reference's."""
    want, got = _deferral_pair(policy, batched)
    _assert_same(want, got, ref.CostModel(*COSTS["delta_3.0"]), False)
    for name in ("backlog", "max_delay", "p99_delay", "deadline_misses", "unserved"):
        g = getattr(got, name)
        assert g is not None and g.dtype == torch.int32, name
        np.testing.assert_array_equal(g.numpy(), np.asarray(getattr(want, name)), err_msg=name)


def test_no_cuda_and_no_device_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = dataclasses.replace(_port_spec(_demand(17)), device="cuda")
    assert port.ProvisionSpec(spec.costs, spec.workload, spec.policy).device == "cuda"
    with pytest.raises(RuntimeError, match='device="cpu"'):
        port.provision(port.ProvisionSpec(spec.costs, spec.workload, spec.policy))


def test_noise_needs_a_source():
    with pytest.raises(ValueError, match="generator or injected normals"):
        port.provision(_port_spec(_demand(18),
                                  workload=dict(noise=port.PredictionNoise(0.2))))
