"""repro_torch.provision_stream() == repro.core.provision_stream(), on the CPU.

The same numpy-made demand goes through both packages' streaming entry
point; the port gets the reference's own random draws — the wait uniforms
from ``_uniforms`` keyed as the reference's ``_prepare`` keys them, and the
prediction-noise normals — through its injection points.  ``x``, the
per-level cost terms and the decision counts must be bit-exact; the totals
too where every cost field is an integer, else to ``rtol=1e-6`` (float32
sums over the level axis taken in another order).

The reference runs once per (policy, demand shape), at a tile of 13 slots;
its own tests (``tests/test_streaming.py``) hold it to the same result at
every tile size, so each of the port's tile sizes is compared with that run.
"""
import dataclasses
import functools

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
from repro_torch.kernels import provision_scan as port_kernels  # noqa: E402
from repro_torch.obs import telemetry_session  # noqa: E402

B, T = 3, 48
KEY_SEED = 23
REF_T_CHUNK = 13
ONLINE = tuple(p for p in ref.POLICIES if p != "offline")
DELTA_3 = (2.0, 3.0, 3.0)            # integer cost fields, Δ = 3


def _demand(seed, batched=True, top=12):
    rng = np.random.default_rng(seed)
    shape = (B, T) if batched else (T,)
    t = np.arange(T)
    phase = rng.uniform(0, 2 * np.pi, shape[:-1] + (1,))
    wave = top / 2 * (1 + 0.8 * np.sin(2 * np.pi * t / 17 + phase))
    return np.clip(np.rint(wave) + rng.integers(-2, 3, shape), 0, top).astype(np.int32)


def _typed_costs(pkg):
    return pkg.CostModel.from_groups(
        pkg.ServerGroup("legacy", 6, P=1.5, beta_on=2.0, beta_off=1.75),
        pkg.ServerGroup("efficient", 7, P=1.0, beta_on=1.25, beta_off=1.25),
    )


def _ref_draws(a, policy, n, noise_std):
    """The reference's draws for ``a`` over ``n`` levels, keyed as its
    ``_prepare`` keys them."""
    batched = a.ndim == 2
    u = z = None
    if policy in KEYED:
        key = jax.random.key(KEY_SEED)
        keys = jax.random.split(key, a.shape[0]) if batched else key[None]
        u0, u1 = jax.vmap(lambda k: ref_uniforms(k, a.shape[-1], n))(keys)
        u = (np.array(u0), np.array(u1)) if batched else (np.array(u0[0]), np.array(u1[0]))
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


def _ref_run(a, policy, costs, windows, noise_std, n_levels):
    jnoise = None if noise_std is None else ref.PredictionNoise(
        std_frac=jnp.asarray(noise_std, jnp.float32), key=jax.random.key(KEY_SEED + 1))
    return ref.provision_stream(ref.ProvisionSpec(
        costs=costs,
        workload=ref.Workload(demand=jnp.asarray(a), noise=jnoise),
        policy=ref.PolicySpec(policy, windows=jnp.asarray(windows),
                              key=jax.random.key(KEY_SEED)),
        n_levels=n_levels,
    ), t_chunk=REF_T_CHUNK, record_decisions=True)


def _port_run(a, policy, costs, windows, noise_std, n_levels, t_chunk):
    n = n_levels or costs.n_levels or int(a.max()) + 1
    u, z = _ref_draws(a, policy, n, noise_std)
    tcosts = cost_model_from_numpy(np.asarray(costs.P), np.asarray(costs.beta_on),
                                   np.asarray(costs.beta_off), costs.group_sizes,
                                   costs.group_names)
    tnoise = None if noise_std is None else port.PredictionNoise(
        std_frac=noise_std, normals=normals_from_numpy(z))
    return port.provision_stream(port.ProvisionSpec(
        costs=tcosts,
        workload=port.Workload(demand=a, noise=tnoise),
        policy=port.PolicySpec(policy, windows=windows,
                               uniforms=None if u is None else uniforms_from_numpy(*u)),
        n_levels=n_levels, device="cpu",
    ), t_chunk=t_chunk, record_decisions=True)


def _assert_same(want, got, exact_totals):
    np.testing.assert_array_equal(got.x.numpy(), np.asarray(want.x))
    assert got.x.dtype == torch.int32
    np.testing.assert_array_equal(got.level_cost.numpy(), np.asarray(want.level_cost))
    assert (got.group_cost is None) == (want.group_cost is None)
    for name in ["cost", "energy", "toggle_cost"] + (
            ["group_cost"] if want.group_cost is not None else []):
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        if exact_totals:
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-6, err_msg=name)
    assert got.decisions is None and want.decisions is None
    assert sorted(got.decision_counts) == sorted(want.decision_counts)
    for k, v in want.decision_counts.items():
        np.testing.assert_array_equal(got.decision_counts[k].numpy(), np.asarray(v), err_msg=k)


@functools.cache
def _reference(policy, batched):
    return _ref_run(_demand(1, batched), policy, ref.CostModel(*DELTA_3), [0, 2, 4],
                    None, None)


@pytest.mark.parametrize("t_chunk", [1, REF_T_CHUNK, T])
@pytest.mark.parametrize("batched", [True, False], ids=["BT", "T"])
@pytest.mark.parametrize("policy", ONLINE)
def test_provision_stream_matches_reference(policy, batched, t_chunk):
    got = _port_run(_demand(1, batched), policy, ref.CostModel(*DELTA_3), [0, 2, 4],
                    None, None, t_chunk)
    assert tuple(got.x.shape) == ((3, B, T) if batched else (3, T))
    _assert_same(_reference(policy, batched), got, exact_totals=True)


@pytest.mark.parametrize("policy", ["A1", "A2"])
def test_provision_stream_noise_sweep(policy):
    a, costs, stds = _demand(4), ref.CostModel(*DELTA_3), [0.0, 0.2, 0.5]
    want = _ref_run(a, policy, costs, [1, 3], stds, 16)
    got = _port_run(a, policy, costs, [1, 3], stds, 16, REF_T_CHUNK)
    assert tuple(got.x.shape) == (3, 2, B, T)
    _assert_same(want, got, exact_totals=True)


def test_provision_stream_typed_aq_rand_with_record():
    a, costs = _demand(3), _typed_costs(ref)
    want = _ref_run(a, "AQ-rand", costs, [0, 2], None, None)
    got = _port_run(a, "AQ-rand", costs, [0, 2], None, None, REF_T_CHUNK)
    assert tuple(got.group_cost.shape) == (2, B, 2)
    _assert_same(want, got, exact_totals=False)


# ---------------------------------------------------------------------------
# the port's two entry points agree, and its errors and telemetry
# ---------------------------------------------------------------------------

def _port_spec(a, policy="A1", costs=None, **workload):
    return port.ProvisionSpec(
        costs=costs or port.PAPER_COSTS, workload=port.Workload(demand=a, **workload),
        policy=port.PolicySpec(policy, windows=[0, 2, 5],
                               generator=torch.Generator().manual_seed(0)),
        device="cpu")


@pytest.mark.parametrize("fleet", ["paper", "typed"])
@pytest.mark.parametrize("policy", ONLINE)
def test_provision_stream_equals_provision(policy, fleet):
    costs = _typed_costs(port) if fleet == "typed" else None
    # each spec has a generator of its own, seeded alike, so both calls draw
    # the same wait uniforms
    want = port.provision(_port_spec(_demand(5), policy, costs), record_decisions=True)
    got = port.provision_stream(_port_spec(_demand(5), policy, costs),
                                t_chunk=REF_T_CHUNK, record_decisions=True)
    for name in ("x", "cost", "energy", "toggle_cost", "level_cost", "group_cost"):
        w, g = getattr(want, name), getattr(got, name)
        assert (w is None) == (g is None) and (w is None or torch.equal(w, g)), name
    assert got.decisions is None
    for k, v in want.decision_counts.items():
        assert torch.equal(got.decision_counts[k], v), k


def test_offline_is_rejected():
    a = _demand(6)
    with pytest.raises(ValueError, match="online-only"):
        ref.provision_stream(ref.ProvisionSpec(
            costs=ref.PAPER_COSTS, workload=ref.Workload(demand=jnp.asarray(a)),
            policy=ref.PolicySpec("offline")))
    with pytest.raises(ValueError, match="online-only"):
        port.provision_stream(_port_spec(a, "offline"))


def test_deferral_is_not_silently_ignored():
    """``Workload(deferral=...)`` is honoured by the streaming entry point:
    its schedule and queue metrics equal the reference's (the wider matrix
    is in ``tests/test_torch_deferral.py``)."""
    from repro_torch.deferral import DeferralSpec as PortDeferralSpec

    a = _demand(7)
    want = ref.provision_stream(ref.ProvisionSpec(
        costs=ref.PAPER_COSTS,
        workload=ref.Workload(demand=jnp.asarray(a), deferral=DeferralSpec(slack=2)),
        policy=ref.PolicySpec("A1", windows=jnp.asarray([0, 2, 5])),
    ), t_chunk=REF_T_CHUNK)
    got = port.provision_stream(_port_spec(a, deferral=PortDeferralSpec(slack=2)), t_chunk=5)
    rigid = port.provision_stream(_port_spec(a), t_chunk=5)
    assert not torch.equal(got.x, rigid.x) and rigid.backlog is None
    for name in ("x", "level_cost", "cost", "backlog", "max_delay", "p99_delay",
                 "deadline_misses", "unserved"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)


def test_no_cuda_and_no_device_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = _port_spec(_demand(8))
    with pytest.raises(RuntimeError, match='device="cpu"'):
        port.provision_stream(dataclasses.replace(spec, device="cuda"))
    with pytest.raises(RuntimeError, match='device="cpu"'):
        port.provision_stream(port.ProvisionSpec(spec.costs, spec.workload, spec.policy))


@pytest.mark.parametrize("t_chunk, seen", [(None, T), (5, 5), (10 * T, T)])
def test_span_names_the_cpu_route_and_no_kernel_runs(t_chunk, seen):
    before = port_kernels.stream_launches
    with telemetry_session() as tel:
        port.provision_stream(_port_spec(_demand(9), "A2"), t_chunk=t_chunk,
                              record_decisions=True)
    (event,) = tel.chrome_trace()["traceEvents"]
    assert event["name"] == "provision_stream"
    assert event["args"]["route"] == "cpu" and event["args"]["t_chunk"] == str(seen)
    assert port_kernels.stream_launches == before
    assert tel.counter_value("kernels/provision_scan_stream_launches") == 0.0
    assert tel.counter_value("provision/decision_toggle_offs") > 0
