"""repro_torch's multi-device provisioning route == the JAX reference, on the CPU.

``ProvisionSpec(mesh=...)`` shards the level axis over the ranks of a
``DeviceMesh``.  Worlds of 1, 2 and 4 gloo ranks run in subprocesses
(``repro_torch.distributed.world.run_world``, a ``FileStore`` under
``tmp_path_factory``), once each for the module; the pytest process never
initialises a process group.  Each world computes every case at once
(:func:`rank_cases`, the ranks' target) and the tests compare the results
case by case.  Every rank's every leaf must equal the reference's
``provision()`` on the same draws — the wait uniforms from ``_uniforms``
with the keys split as its ``_prepare`` splits them, the noise normals as
its ``PredictionNoise`` draws them — as ``tests/test_torch_provision.py``
holds the single-device route: bit for bit, and the totals summed over the
level axis to ``rtol=1e-6`` where a cost field is fractional.  Every leaf
must also equal the port's single-device route exactly.
"""
import concurrent.futures
import dataclasses
import functools
import time
import warnings

import numpy as np
import pytest

# The port's tests need torch.  CI's jax-only tier-1 job installs no torch,
# so there these files skip instead of failing at import.
torch = pytest.importorskip("torch")

import repro_torch as port  # noqa: E402
from repro_torch import (  # noqa: E402
    PAPER_COSTS,
    CostModel,
    PolicySpec,
    PredictionNoise,
    ProvisionSpec,
    ServerGroup,
    Workload,
)
from repro_torch.core import provision_schedule_sharded  # noqa: E402
from repro_torch.core import torch_provision as engine  # noqa: E402
from repro_torch.deferral import DeferralSpec  # noqa: E402
from repro_torch.distributed.world import run_world  # noqa: E402
from repro_torch.eval import EvalGrid, evaluate  # noqa: E402
from repro_torch.obs import telemetry_session  # noqa: E402
from repro_torch.scenarios import Scenario  # noqa: E402
from repro_torch.serving import FleetProvisioner  # noqa: E402

# The ranks import this module (its target), so the reference — and jax —
# are imported where the tests need them, never at the top.

WORLDS = (1, 2, 4)
B, T, N = 2, 40, 13             # 13 levels divide by none of the worlds but 1
KEY_SEED = 29
T_CHUNK = 7
WORLD_TIMEOUT_S = 120
ONLINE = ("A1", "A2", "A3", "delayedoff", "AQ-det", "AQ-rand")
KEYED = ("A2", "A3", "AQ-rand")

# typed fleets: three groups of uneven sizes with Δ 2.5, 3.0, 2.5; and one
# group wider than the layout's 128-lane alignment
TYPED = ((5, 1.0, 1.25, 1.25), (3, 2.0, 3.0, 3.0), (9, 1.5, 2.0, 1.75))
WIDE = ((130, 1.0, 1.25, 1.25), (7, 2.0, 3.0, 3.0))

# name -> (policy, batched, window or windows, noise stds, fleet, record, deferral slack)
SPECS = {f"grid/{p}": (p, True, (0, 1, 2), (0.0, 0.3), None, False, None) for p in ONLINE}
SPECS.update({f"record/{p}": (p, True, (0, 2), None, None, True, None) for p in ("A1", "AQ-rand")})
SPECS.update({f"typed/{p}": (p, True, 2, None, TYPED, False, None) for p in ("A1", "AQ-rand")})
SPECS["wide/A1"] = ("A1", True, 1, None, WIDE, False, None)
SPECS["single/A3"] = ("A3", False, 2, None, None, False, None)
SPECS["deferral/A1"] = ("A1", True, 1, None, None, False, 2)
#: every spec through provision() and through provision_stream() at T_CHUNK
CASES = [f"{name}@{entry}" for name in SPECS for entry in ("provision", "stream")]

#: the reference's SMALL grid (tests/test_eval_harness.py) with a typed and a
#: deferral block, so that every kind of cell takes the mesh
GRID = EvalGrid(
    policies=("A1", "A3"),
    scenarios=(Scenario("sinusoidal", target_pmr=4.0, mean_jobs=16.0),
               Scenario("step_outage", target_pmr=4.0, mean_jobs=16.0)),
    noise_stds=(0.0, 0.2),
    windows=(0, 3),
    n_traces=3,
    n_slots=144,
    typed_groups=(ServerGroup("efficient", 24, P=1.0, beta_on=3.0, beta_off=3.0),
                  ServerGroup("legacy", 24, P=1.5, beta_on=4.5, beta_off=4.5)),
    deferral_slacks=(0, 2),
    device="cpu",
)
PLANNER_DEMAND = np.random.default_rng(25).integers(0, 5, size=(2, 60))
SHARDED_DEMAND = np.random.default_rng(23).integers(0, 6, size=60)


def _fleet(groups):
    if groups is None:
        return PAPER_COSTS, N
    costs = CostModel.from_groups(*[ServerGroup(f"g{i}", n, P=P, beta_on=bon, beta_off=boff)
                                    for i, (n, P, bon, boff) in enumerate(groups)])
    return costs, costs.n_levels


def _demand(name, n, batched):
    """Seeded demand reaching past the fleet's cap ``n``."""
    rng = np.random.default_rng(list(SPECS).index(name))
    shape = (B, T) if batched else (T,)
    return rng.integers(0, n + 4, size=shape).astype(np.int32)


# ---------------------------------------------------------------------------
# The ranks' target
# ---------------------------------------------------------------------------

#: the result fields a rank returns (``decision_counts`` too, when filled)
RESULT_FIELDS = ("x", "cost", "energy", "toggle_cost", "level_cost", "group_cost",
                 "backlog", "max_delay", "p99_delay", "deadline_misses", "unserved")


def run_specs(mesh, cases):
    """Each case's spec once with ``mesh=mesh``, through ``provision`` or
    (``stream``) ``provision_stream`` at ``t_chunk``: ``{name: {field:
    value, ..., "decisions", "decision_counts", "launches": {"K1": n, "K2":
    n}}}``, the launches being this rank's kernel launches in that call."""
    from repro_torch.kernels import provision_scan as kernels

    out = {}
    for case in cases:
        spec = dataclasses.replace(case["spec"], mesh=mesh)
        record = case["record_decisions"]
        k1, k2 = kernels.launches, kernels.stream_launches
        res = (port.provision_stream(spec, t_chunk=case["t_chunk"], record_decisions=record)
               if case["stream"] else port.provision(spec, record_decisions=record))
        row = {f: getattr(res, f) for f in RESULT_FIELDS + ("decisions", "decision_counts")}
        row["launches"] = {"K1": kernels.launches - k1, "K2": kernels.stream_launches - k2}
        out[case["name"]] = row
    return out


def rank_cases(mesh, payload):
    """One rank's results: every spec case through :func:`run_specs`; the eval
    grid with its spans; ``FleetProvisioner(mesh=)``'s three sweeps; the
    deprecated ``provision_schedule_sharded`` with its warnings; and the
    ``provision`` span of one mesh call."""
    out = {"cases": run_specs(mesh, payload["cases"])}
    with telemetry_session() as tel:
        report = evaluate(dataclasses.replace(payload["grid"], mesh=mesh))
    out["eval"] = {
        "cells": report.cells, "mesh": report.grid["mesh"],
        "routes": [e["args"]["route"] for e in tel.chrome_trace()["traceEvents"]
                   if e["name"] == "provision"],
    }
    planner = FleetProvisioner(PAPER_COSTS, policy="A1", max_replicas=8, mesh=mesh,
                               device="cpu")
    windows = np.arange(3)
    out["planner"] = {
        "plan": planner.plan(PLANNER_DEMAND[0]).x,
        "plan_sweep": planner.plan_sweep(PLANNER_DEMAND, windows),
        "sweep_costs": planner.sweep_costs(PLANNER_DEMAND, windows),
    }
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        x = provision_schedule_sharded(mesh, SHARDED_DEMAND, n_levels=6, delta=6,
                                       window=2, device="cpu")
    out["sharded"] = {"x": x, "warnings": [(w.category.__name__, str(w.message))
                                           for w in caught]}
    with telemetry_session() as tel:
        port.provision(dataclasses.replace(payload["cases"][0]["spec"], mesh=mesh))
    out["span"] = [e for e in tel.chrome_trace()["traceEvents"] if e["name"] == "provision"]
    return out


# ---------------------------------------------------------------------------
# The cases, the reference and the worlds
# ---------------------------------------------------------------------------

def _reference_draws(a, policy, n, noise):
    """The reference's uniforms and normals for ``a`` over ``n`` levels, as
    its provision() draws them from ``KEY_SEED`` and ``KEY_SEED + 1``."""
    import jax
    import jax.numpy as jnp

    from repro.core.jax_provision import _uniforms

    u = z = None
    batched = a.ndim == 2
    if policy in KEYED:
        key = jax.random.key(KEY_SEED)
        keys = jax.random.split(key, a.shape[0]) if batched else key[None]
        u0, u1 = jax.vmap(lambda k: _uniforms(k, a.shape[-1], n))(keys)
        u = (np.array(u0), np.array(u1)) if batched else (np.array(u0[0]), np.array(u1[0]))
    if noise is not None:
        nkey = jax.random.key(KEY_SEED + 1)
        af = jnp.asarray(a, jnp.float32)
        if batched:
            z = jax.vmap(lambda k, ai: jax.random.normal(k, ai.shape))(
                jax.random.split(nkey, a.shape[0]), af)
        else:
            z = jax.random.normal(nkey, af.shape)
        z = np.array(z)
    return u, z


@functools.lru_cache(maxsize=None)
def _port_spec(name):
    """The port's spec ``name`` on the reference's draws (one per name: a
    spec with injected draws is not consumed by a call)."""
    policy, batched, windows, noise, groups, _, slack = SPECS[name]
    costs, n = _fleet(groups)
    a = _demand(name, n, batched)
    u, z = _reference_draws(a, policy, n, noise)
    return ProvisionSpec(
        costs=costs,
        workload=Workload(
            demand=a,
            noise=None if noise is None else PredictionNoise(list(noise), normals=z),
            deferral=None if slack is None else DeferralSpec(slack=slack)),
        policy=PolicySpec(policy, **({"windows": list(windows)} if isinstance(windows, tuple)
                                     else {"window": windows}),
                          uniforms=None if u is None else (torch.as_tensor(u[0]),
                                                           torch.as_tensor(u[1]))),
        n_levels=n, device="cpu",
    )


def _reference(name):
    """The reference's provision() of spec ``name`` (record_decisions as the spec asks)."""
    import jax
    import jax.numpy as jnp

    import repro.core as ref
    from repro.deferral import DeferralSpec as RefDeferralSpec

    policy, batched, windows, noise, groups, record, slack = SPECS[name]
    costs, n = _fleet(groups)
    a = _demand(name, n, batched)
    ref_costs = ref.CostModel(P=1.0, beta_on=3.0, beta_off=3.0) if groups is None else \
        ref.CostModel.from_groups(*[ref.ServerGroup(f"g{i}", m, P=P, beta_on=bon, beta_off=boff)
                                    for i, (m, P, bon, boff) in enumerate(groups)])
    return ref.provision(ref.ProvisionSpec(
        costs=ref_costs,
        workload=ref.Workload(
            demand=jnp.asarray(a),
            noise=None if noise is None else ref.PredictionNoise(
                std_frac=jnp.asarray(noise, jnp.float32), key=jax.random.key(KEY_SEED + 1)),
            deferral=None if slack is None else RefDeferralSpec(slack=slack)),
        policy=ref.PolicySpec(policy, key=jax.random.key(KEY_SEED),
                              **({"windows": jnp.asarray(windows)} if isinstance(windows, tuple)
                                 else {"window": windows})),
        n_levels=n,
    ), record_decisions=record)


def _payload():
    cases = []
    for case in CASES:
        name, entry = case.split("@")
        cases.append(dict(name=case, spec=_port_spec(name), stream=entry == "stream",
                          t_chunk=T_CHUNK, record_decisions=SPECS[name][5]))
    return {"cases": cases, "grid": GRID}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The three worlds, run at once in subprocesses while this process
    computes the reference's results: ``(worlds, reference)``, ``worlds``
    mapping a world size to every rank's results."""
    payload = _payload()
    with concurrent.futures.ThreadPoolExecutor(len(WORLDS)) as pool:
        futures = {
            w: pool.submit(run_world, "test_torch_mesh:rank_cases", w, device="cpu",
                           payload=payload, timeout=WORLD_TIMEOUT_S,
                           workdir=tmp_path_factory.mktemp(f"world{w}"))
            for w in WORLDS
        }
        reference = {name: _reference(name) for name in SPECS}
        return {w: f.result() for w, f in futures.items()}, reference


@pytest.fixture(scope="module")
def worlds(runs):
    return runs[0]


@pytest.fixture(scope="module")
def reference(runs):
    return runs[1]


@pytest.fixture(scope="module")
def single():
    """The port's single-device route of every case."""
    out = {}
    for case in CASES:
        name, entry = case.split("@")
        record = SPECS[name][5]
        spec = _port_spec(name)
        out[case] = (port.provision_stream(spec, t_chunk=T_CHUNK, record_decisions=record)
                     if entry == "stream" else port.provision(spec, record_decisions=record))
    return out


def _integer_fields(costs):
    return all(np.all(np.asarray(f) == np.round(np.asarray(f)))
               for f in (costs.P, costs.beta_on, costs.beta_off))


# ---------------------------------------------------------------------------
# The cases
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("world", WORLDS)
def test_mesh_route_equals_the_reference(worlds, reference, world, case):
    name = case.split("@")[0]
    want = reference[name]
    costs, _ = _fleet(SPECS[name][4])
    exact = _integer_fields(costs)
    for rank, out in enumerate(worlds[world]):
        got = out["cases"][case]
        msg = f"world {world} rank {rank} {case}"
        np.testing.assert_array_equal(got["x"].numpy(), np.asarray(want.x), err_msg=msg)
        assert got["x"].dtype == torch.int32
        np.testing.assert_array_equal(got["level_cost"].numpy(), np.asarray(want.level_cost),
                                      err_msg=msg)
        assert (got["group_cost"] is None) == (want.group_cost is None)
        for field in ("cost", "energy", "toggle_cost", "group_cost"):
            w = getattr(want, field)
            if w is None:
                continue
            if exact:
                np.testing.assert_array_equal(got[field].numpy(), np.asarray(w), err_msg=msg)
            else:
                np.testing.assert_allclose(got[field].numpy(), np.asarray(w), rtol=1e-6,
                                           err_msg=f"{msg} {field}")
        for field in ("backlog", "max_delay", "p99_delay", "deadline_misses", "unserved"):
            w = getattr(want, field)
            assert (got[field] is None) == (w is None), field
            if w is not None:
                np.testing.assert_array_equal(got[field].numpy(), np.asarray(w), err_msg=msg)
        # the fleet route records the counters only, as the reference's does
        assert got["decisions"] is None
        if SPECS[name][5]:
            assert sorted(got["decision_counts"]) == sorted(want.decision_counts)
            for k, v in want.decision_counts.items():
                np.testing.assert_array_equal(got["decision_counts"][k].numpy(), np.asarray(v),
                                              err_msg=f"{msg} {k}")
        else:
            assert got["decision_counts"] is None


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("world", WORLDS)
def test_mesh_route_equals_the_single_device_route(worlds, single, world, case):
    want = single[case]
    for rank, out in enumerate(worlds[world]):
        got = out["cases"][case]
        for field in RESULT_FIELDS:
            w = getattr(want, field)
            assert (got[field] is None) == (w is None), field
            if w is not None:
                assert got[field].shape == w.shape and torch.equal(got[field], w), \
                    f"world {world} rank {rank} {case} {field}"
        for k, v in (want.decision_counts or {}).items():
            assert torch.equal(got["decision_counts"][k], v), k
        # the CPU route launches no kernel
        assert got["launches"] == {"K1": 0, "K2": 0}


@pytest.mark.parametrize("world", WORLDS)
def test_every_rank_returns_the_same_result(worlds, world):
    first = worlds[world][0]["cases"]
    for out in worlds[world][1:]:
        for case, got in out["cases"].items():
            for field in RESULT_FIELDS:
                if got[field] is not None:
                    assert torch.equal(got[field], first[case][field]), (case, field)


# ---------------------------------------------------------------------------
# The layout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_levels,group_sizes,size", [
    (13, None, 1), (13, None, 2), (13, None, 4), (4099, None, 4), (8, None, 8),
    (17, (5, 3, 9), 1), (17, (5, 3, 9), 4), (137, (130, 7), 2), (137, (130, 7), 4),
    (300, (200, 100), 3), (4099, (1000, 1500, 1599), 4), (24, (8, 16), 2),
])
def test_group_layout_matches_the_reference(n_levels, group_sizes, size):
    from repro.core import jax_provision as ref_engine

    got = engine._group_layout(n_levels, group_sizes, size)
    want = ref_engine._group_layout(n_levels, group_sizes, size)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2] and got[2] % size == 0
    assert engine.ROUTE_SENTINEL == ref_engine.ROUTE_SENTINEL
    assert (got[0][got[1]] == np.arange(n_levels)).all()


@pytest.mark.parametrize("policy", ["A1", "AQ-rand"])
def test_blocks_of_routes_add_up_to_the_whole_fleet(policy):
    """``_run_stream(routes=)`` over blocks of lanes as the ranks take them,
    some ending in pad lanes: each block's terms and counters are those
    levels' of the whole fleet's run, its pad lanes count nowhere, and the
    blocks' x(t) sum to the fleet's."""
    rng = np.random.default_rng(5)
    n = 9
    ab = torch.as_tensor(rng.integers(0, n + 3, size=(2, 30)), dtype=torch.int32)
    delta = torch.full((n,), 4.0)
    P, bon, boff = (torch.full((n,), v) for v in (1.0, 2.0, 1.5))
    gen = torch.Generator().manual_seed(7)
    uniforms = engine._uniforms(gen, 2, 30, n, torch.device("cpu")) if policy in KEYED else None
    kw = dict(n_levels=n, max_h=4, policy=policy, t_chunk=T_CHUNK, record=True)
    whole = engine._run_stream(ab, ab[None], [0, 2], delta, P, bon, boff, uniforms, **kw)
    x = torch.zeros_like(whole["x"])
    for ids, pads in (([0, 1, 2, 3], 0), ([4, 5, 6, 7], 2), ([8], 3)):
        routes = torch.tensor(ids + [engine.ROUTE_SENTINEL] * pads, dtype=torch.int32)
        pick = torch.tensor(ids + [0] * pads)

        def block(v, fill):
            return torch.cat([v[..., ids], torch.full(v.shape[:-1] + (pads,), fill)], dim=-1)

        part = engine._run_stream(
            ab, ab[None], [0, 2], block(delta, 1.0), *(block(v, 0.0) for v in (P, bon, boff)),
            None if uniforms is None else tuple(u[..., pick] for u in uniforms),
            routes=routes, **kw)
        for k in ("energy", "on_cost", "off_cost", "decision_counts"):
            assert torch.equal(part[k][..., :len(ids)], whole[k][..., ids]), (ids, k)
            assert not part[k][..., len(ids):].any(), (ids, k)
        x += part["x"]
    assert torch.equal(x, whole["x"])


# ---------------------------------------------------------------------------
# The eval, the planner, the wrapper, the span
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def plain_report():
    return evaluate(GRID)


@pytest.mark.parametrize("world", WORLDS)
def test_eval_grid_on_the_mesh_equals_plain_evaluate(worlds, plain_report, world):
    blocks = len(GRID.policies) * len(GRID.scenarios)
    typed = len(GRID.typed_policies) * len(GRID.scenarios)
    deferral = len(GRID.deferral_slacks) * len(GRID.deferral_policies) * len(GRID.scenarios)
    for out in worlds[world]:
        assert out["eval"]["cells"] == plain_report.cells
        assert out["eval"]["mesh"] == {"data": world}
        # every online block, typed cell and deferral cell took the mesh; the
        # offline baselines (one per scenario and block kind) did not
        routes = out["eval"]["routes"]
        assert routes.count("mesh") == blocks + typed + deferral
        assert set(routes) == {"mesh", "cpu"}
    assert plain_report.grid["mesh"] is None


@pytest.mark.parametrize("world", WORLDS)
def test_planner_on_the_mesh_equals_the_planner_without(worlds, world):
    plain = FleetProvisioner(PAPER_COSTS, policy="A1", max_replicas=8, device="cpu")
    windows = np.arange(3)
    for out in worlds[world]:
        got = out["planner"]
        assert torch.equal(got["plan"], plain.plan(PLANNER_DEMAND[0]).x)
        np.testing.assert_array_equal(got["plan_sweep"], plain.plan_sweep(PLANNER_DEMAND, windows))
        np.testing.assert_array_equal(got["sweep_costs"],
                                      plain.sweep_costs(PLANNER_DEMAND, windows))


@pytest.mark.parametrize("world", WORLDS)
def test_provision_schedule_sharded_warns_and_matches(worlds, world):
    import jax
    import jax.numpy as jnp

    import repro.core as ref

    with pytest.warns(DeprecationWarning, match="^deprecated"):
        want = ref.provision_schedule_sharded(
            jax.make_mesh((1,), ("data",)), jnp.asarray(SHARDED_DEMAND, jnp.int32),
            n_levels=6, delta=6, window=2)
    for out in worlds[world]:
        got = out["sharded"]
        assert [c for c, _ in got["warnings"]] == ["DeprecationWarning"]
        assert got["warnings"][0][1].startswith("deprecated: provision_schedule_sharded")
        np.testing.assert_array_equal(got["x"].numpy(), np.asarray(want))


@pytest.mark.parametrize("world", WORLDS)
def test_mesh_span_names_the_mesh_route(worlds, world):
    for out in worlds[world]:
        (event,) = out["span"]
        assert event["args"]["route"] == "mesh" and event["args"]["policy"] == "A1"


# ---------------------------------------------------------------------------
# Refusals: checked before any collective, so a stand-in mesh shows them
# ---------------------------------------------------------------------------

class _StandInMesh:
    """The attributes the route reads before its first collective."""

    def __init__(self, device_type="cpu", names=("data",)):
        self.device_type = device_type
        self.mesh_dim_names = names

    def get_group(self, axis):
        raise AssertionError("the refusal must come before any collective")


def _spec(policy="A1", **kw):
    return ProvisionSpec(costs=PAPER_COSTS, workload=Workload(demand=SHARDED_DEMAND),
                         policy=PolicySpec(policy, window=1), n_levels=6, device="cpu", **kw)


@pytest.mark.parametrize("entry", ["provision", "provision_stream"])
def test_offline_is_rejected_on_the_mesh_route(entry):
    import jax

    import repro.core as ref

    with pytest.raises(ValueError, match="online policies") as want:
        ref.provision(ref.ProvisionSpec(
            costs=ref.CostModel(P=1.0, beta_on=3.0, beta_off=3.0),
            workload=ref.Workload(demand=SHARDED_DEMAND), policy=ref.PolicySpec("offline"),
            n_levels=6, mesh=jax.make_mesh((1,), ("data",))))
    with pytest.raises(ValueError, match="online") as got:
        getattr(port, entry)(_spec("offline", mesh=_StandInMesh()))
    if entry == "provision":
        assert str(got.value) == str(want.value)


def test_eval_grid_rejects_offline_with_a_mesh():
    import jax

    from repro.eval import EvalGrid as RefEvalGrid

    with pytest.raises(ValueError, match="offline") as want:
        RefEvalGrid(policies=("A1", "offline"), mesh=jax.make_mesh((1,), ("data",))).validate()
    with pytest.raises(ValueError, match="offline") as got:
        evaluate(dataclasses.replace(GRID, policies=("A1", "offline"), mesh=_StandInMesh()))
    assert str(got.value) == str(want.value)


def test_a_mesh_on_another_device_type_raises():
    with pytest.raises(ValueError, match="mesh is on 'cuda'"):
        port.provision(_spec(mesh=_StandInMesh("cuda")))
    with pytest.raises(ValueError, match="mesh is on 'cuda'"):
        port.provision_stream(_spec(mesh=_StandInMesh("cuda")))


def test_a_mesh_without_the_axis_raises():
    with pytest.raises(ValueError, match="no axis 'data'"):
        port.provision(_spec(mesh=_StandInMesh(names=("levels",))))
    with pytest.raises(ValueError, match="no axis 'rows'"):
        port.provision(_spec(mesh=_StandInMesh(), mesh_axis="rows"))


def fail_on_rank_one(mesh, payload):
    """A target whose rank 1 fails while rank 0 would run past the timeout."""
    import torch.distributed as dist

    if dist.get_rank() == 1:
        raise RuntimeError("rank 1 fails on purpose")
    time.sleep(WORLD_TIMEOUT_S)


def test_a_failed_rank_stops_the_world(tmp_path):
    """A rank that fails ends the run at once with its traceback, and the
    rank still running is stopped (not left to its timeout)."""
    t0 = time.monotonic()
    with pytest.raises(torch.multiprocessing.ProcessRaisedException,
                       match="rank 1 fails on purpose"):
        run_world("test_torch_mesh:fail_on_rank_one", 2, device="cpu", payload=None,
                  timeout=WORLD_TIMEOUT_S, workdir=tmp_path)
    assert time.monotonic() - t0 < WORLD_TIMEOUT_S / 2
