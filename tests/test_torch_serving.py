"""repro_torch.serving == repro.serving, on the CPU.

The same numpy-made demand goes through the reference's
``FleetProvisioner`` and the port's (``device="cpu"``: the plain version of
kernel K2 behind ``advance()`` and ``provision()``).  The keyed policies get
the reference's own draws: ``advance()`` the stepper's ``fold_in(key,
global_slot)`` uniforms through ``slot_uniforms=``, ``plan_sweep()`` the
per-trace tables of ``_uniforms`` through ``PolicySpec(uniforms=...)``.
Schedules, carries, backlogs and integer totals must be bit-exact; float32
costs summed over the level axis in another order, and the waits drawn
through ``log1p`` (a few ulp apart between PyTorch and XLA on the CPU), are
held to ``rel=1e-6``.  Mirrors ``tests/test_streaming.py`` (the stepper) and
``tests/test_serving.py`` / ``tests/test_obs.py`` (the planner, the
autoscaler and the plan metrics).
"""
import dataclasses
import json
import subprocess
import sys

import numpy as np
import pytest

# The port's tests need torch.  CI's jax-only tier-1 job installs no torch,
# so there these files skip instead of failing at import.
torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.serving as ref  # noqa: E402
import repro_torch.serving as port  # noqa: E402
from repro.core import PolicySpec as RefPolicySpec  # noqa: E402
from repro.core.costs import PAPER_COSTS as REF_COSTS  # noqa: E402
from repro.core.jax_provision import _uniforms as ref_uniforms  # noqa: E402
from repro.deferral import DeferralSpec as RefDeferralSpec  # noqa: E402
from repro.serving.metrics import PlanMetrics as RefPlanMetrics  # noqa: E402
from repro_torch import PAPER_COSTS, PolicySpec  # noqa: E402
from repro_torch.deferral import DeferralSpec  # noqa: E402
from repro_torch.serving.metrics import PlanMetrics  # noqa: E402

T = 96
N = 18
KEY_SEED = 11
RTOL = 1e-6                           # float32 sums over levels in another order
SPLITS = ((1,) * T, (5, 3, 88), (41, 55))
ONLINE = ("A1", "A2", "A3", "delayedoff", "AQ-det", "AQ-rand")
KEYED = ("A2", "A3", "AQ-rand")
ROOT = __import__("pathlib").Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def demand():
    return np.random.default_rng(5).integers(0, N, size=(T,))


def ref_slot_uniforms(key, n_levels):
    """The reference stepper's draws of slots t0 .. t0 + n - 1, as numpy:
    ``split(fold_in(key, t))`` into the atom and the value uniforms."""

    def draw(t0, n):
        def one(tg):
            k0, k1 = jax.random.split(jax.random.fold_in(key, tg))
            return (jax.random.uniform(k0, (n_levels,)),
                    jax.random.uniform(k1, (n_levels,)))

        u0, u = jax.vmap(one)(jnp.int32(t0) + jnp.arange(n, dtype=jnp.int32))
        return np.array(u0), np.array(u)

    return draw


def pair(policy, window=0, n=N, **kw):
    """The reference's planner and the port's on the CPU, the port fed the
    reference's slot draws for a keyed policy."""
    key = jax.random.PRNGKey(KEY_SEED)
    rkw, pkw = dict(kw), dict(kw)
    if "deferral" in kw:
        rkw["deferral"] = RefDeferralSpec(**kw["deferral"])
        pkw["deferral"] = DeferralSpec(**kw["deferral"])
    want = ref.FleetProvisioner(REF_COSTS, policy=policy, window=window, max_replicas=n,
                                key=key if policy in KEYED else None, **rkw)
    got = port.FleetProvisioner(
        PAPER_COSTS, policy=policy, window=window, max_replicas=n, device="cpu",
        slot_uniforms=ref_slot_uniforms(key, n) if policy in KEYED else None, **pkw)
    return want, got


def drive(prov, a, sizes):
    pos, outs = 0, []
    for s in sizes:
        outs.append(prov.advance(a[pos:pos + s]))
        pos += s
    return np.concatenate(outs)


@pytest.mark.parametrize("policy,window", [("A1", 0), ("A1", 3), ("delayedoff", 0),
                                           ("AQ-det", 0)])
def test_advance_one_shot_matches_plan(demand, policy, window):
    want, got = pair(policy, window)
    x = got.advance(demand)
    assert x.dtype == np.int32
    assert (x == want.advance(demand)).all()
    assert (x == np.asarray(want.plan(demand).x)).all()
    assert (x == got.plan(demand).x.numpy()).all()


@pytest.mark.parametrize("sizes", SPLITS, ids=("ones", "5-3-88", "41-55"))
@pytest.mark.parametrize("policy", ["delayedoff", "AQ-rand"])
def test_advance_chunk_invariant_no_peek(demand, policy, sizes):
    """delayedoff holds each idle level for Δ = 6 slots, so slot-by-slot
    advancing splits every pending wait across a chunk boundary; AQ-rand's
    draws are slot-indexed, so they split the same way."""
    want, full = pair(policy)
    ref_full = want.advance(demand)
    assert (full.advance(demand) == ref_full).all()
    _, prov = pair(policy)
    assert (drive(prov, demand, sizes) == ref_full).all()


def test_own_draws_are_chunk_invariant_and_seeded(demand):
    """Without injected draws the port draws each slot from a generator of its
    own, seeded from the planner's generator and the slot: the running state
    of the generator is never read, so any split gives the same schedule and
    the same seed gives the same draws."""
    def planner(seed):
        return port.FleetProvisioner(PAPER_COSTS, policy="AQ-rand", max_replicas=N,
                                     device="cpu",
                                     generator=torch.Generator().manual_seed(seed))

    full = planner(7).advance(demand)
    for sizes in SPLITS:
        assert (drive(planner(7), demand, sizes) == full).all()
    assert not (planner(8).advance(demand) == full).all()
    draw = port.stepper.slot_uniforms(torch.Generator().manual_seed(7), N, "cpu")
    u0, u = draw(40, 3)
    assert u0.shape == u.shape == (3, N) and u.dtype == torch.float32
    assert torch.equal(draw(41, 1)[1][0], u[1]) and not torch.equal(u[0], u[1])


@pytest.mark.parametrize("policy", ONLINE)
@pytest.mark.parametrize("window", [0, 2])
def test_advance_equals_the_reference_bit_for_bit(demand, policy, window):
    """Every policy, keyed ones included, over a split that cuts pending
    waits and peeks: each chunk's x, the carry, and the chunk's level costs
    and totals."""
    want, got = pair(policy, window)
    pos = 0
    for s in (5, 3, 1, 87):
        chunk = demand[pos:pos + s]
        pos += s
        assert (got.advance(chunk) == want.advance(chunk)).all(), (policy, pos)
        for f in ("r", "on"):
            assert (getattr(got.state, f).numpy() == np.asarray(getattr(want.state, f))).all(), f
        # a drawn wait is span * log1p(u * (e - 1)): PyTorch's log1p on the
        # CPU and XLA's differ by a few ulp (ROADMAP.md), the schedule not
        np.testing.assert_allclose(got.state.wait.numpy(), np.asarray(want.state.wait),
                                   rtol=RTOL)
        assert got.state.t == want.state.t == pos
        lp, lw = got.last_plan, want.last_plan
        assert (lp.level_cost.numpy() == np.asarray(lw.level_cost)).all()
        for f in ("cost", "energy", "toggle_cost"):
            assert float(getattr(lp, f)) == pytest.approx(float(getattr(lw, f)), rel=RTOL)
    assert got.metrics.plans == want.metrics.plans == 4
    assert got.metrics.toggles == want.metrics.toggles


def test_advance_chunk_cost_plus_final_off_matches_plan(demand):
    """The stepper's chunk-local cost omits only the forced end-of-trace off
    toggles (the trace has not ended); adding them reproduces plan()'s
    total."""
    want, got = pair("A1")
    got.advance(demand)
    want.advance(demand)
    final_off = int((got.state.on.numpy() & ~(demand[-1] > np.arange(N))).sum())
    assert final_off == int((np.asarray(want.state.on) & ~(demand[-1] > np.arange(N))).sum())
    total = float(got.last_plan.cost) + PAPER_COSTS.beta_off * final_off
    assert total == pytest.approx(float(got.plan(demand).cost), rel=RTOL)
    assert total == pytest.approx(float(want.plan(demand).cost), rel=RTOL)


@pytest.mark.parametrize("sizes", [(31, 2, 63), (1,) * T], ids=("31-2-63", "ones"))
def test_advance_deferral_mid_flight_backlog(sizes):
    """A burst pushes work into the queue and the chunk boundaries cut
    through the live backlog: per chunk, x and the backlog equal the
    reference's one-shot run over the same slots, and at the end so do the
    cumulative queue scalars and the deferral carry."""
    rng = np.random.default_rng(13)
    a = rng.integers(0, 6, size=(T,))
    a[30:34] = 40                                   # burst >> fleet absorbs
    want, got = pair("A1", n=24, deferral=dict(slack=4))
    whole = want.advance(a)
    backlog = np.asarray(want.last_plan.backlog)
    assert backlog.max() > 0
    pos = 0
    for s in sizes:
        x = got.advance(a[pos:pos + s])
        assert (x == whole[pos:pos + s]).all(), pos
        assert (got.last_plan.backlog.numpy() == backlog[pos:pos + s]).all(), pos
        pos += s
    for f in ("max_delay", "p99_delay", "deadline_misses", "unserved"):
        assert int(getattr(got.last_plan, f)) == int(getattr(want.last_plan, f)), f
    assert int(got.last_plan.deadline_misses) == 0
    for k in ("awin", "served"):
        assert (got.state.defer[k].numpy() == np.asarray(want.state.defer[k])).all(), k
    for k in ("w", "miss", "hist"):
        assert (got.state.queue[k].numpy() == np.asarray(want.state.queue[k])).all(), k
    assert got.metrics.backlog_depth == want.metrics.backlog_depth


def test_advance_rejections_and_reset(demand):
    a = demand
    for make in (lambda: ref.FleetProvisioner(REF_COSTS, policy="offline", max_replicas=N),
                 lambda: port.FleetProvisioner(PAPER_COSTS, policy="offline",
                                               max_replicas=N, device="cpu")):
        with pytest.raises(ValueError, match="hindsight"):
            make().advance(a[:8])
    for make, spec in ((ref.FleetProvisioner, RefDeferralSpec),
                       (port.FleetProvisioner, DeferralSpec)):
        kw = {} if make is ref.FleetProvisioner else {"device": "cpu"}
        with pytest.raises(ValueError, match="scalar slack") as e:
            make(REF_COSTS if make is ref.FleetProvisioner else PAPER_COSTS, policy="A1",
                 max_replicas=64, deferral=spec(slack=np.ones(T, np.int32), max_slack=4),
                 **kw).advance(a[:8])
        if make is ref.FleetProvisioner:
            want_msg = str(e.value)
        else:
            assert str(e.value) == want_msg
    _, got = pair("A1")
    for bad, match in ((a[None, :8], "steps one fleet"), (a[:0], "at least one"),
                       (a[:8] + N, "exceeds max_replicas")):
        with pytest.raises(ValueError, match=match):
            got.advance(bad)
    with pytest.raises(ValueError, match="windows= sweep"):
        port.FleetProvisioner(PAPER_COSTS, policy=PolicySpec("A1", windows=[0, 1]),
                              max_replicas=N, device="cpu").advance(a[:8])
    with pytest.raises(ValueError, match="slot by slot"):
        port.FleetProvisioner(PAPER_COSTS, max_replicas=N, device="cpu",
                              policy=PolicySpec("A2", uniforms=(np.zeros((8, N)),) * 2),
                              ).advance(a[:8])
    first = got.advance(a[:16])
    got.reset()
    assert got.state is None and got._history.size == 0 and got.last_plan is None
    assert (got.advance(a[:16]) == first).all()     # fresh trace, same plan


def test_planner_rejections_match_the_reference():
    with pytest.raises(ValueError, match="randomized"):
        ref.FleetProvisioner(REF_COSTS, policy="A2")
    with pytest.raises(ValueError, match="randomized"):
        port.FleetProvisioner(PAPER_COSTS, policy="A2", device="cpu")
    # mesh= is no longer refused: the planner hands it to every spec it plans
    # (tests/test_torch_mesh.py runs such a planner on worlds of gloo ranks)
    mesh = object()
    spec = port.FleetProvisioner(PAPER_COSTS, mesh=mesh, mesh_axis="levels",
                                 device="cpu")._spec(np.zeros(4, np.int32))
    assert spec.mesh is mesh and spec.mesh_axis == "levels"
    with pytest.raises(ValueError, match="inside the PolicySpec"):
        port.FleetProvisioner(PAPER_COSTS, policy=PolicySpec("A1"), window=2, device="cpu")


def test_planner_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        port.FleetProvisioner(PAPER_COSTS, max_replicas=N)


def test_plan_sweep_and_sweep_costs_equal_the_reference():
    traces = np.stack([np.random.default_rng(s).integers(0, 14, size=(100,))
                       for s in range(3)])
    windows = np.arange(4)
    n = int(traces.max()) + 1
    want = ref.FleetProvisioner(REF_COSTS, policy="A1", max_replicas=n)
    got = port.FleetProvisioner(PAPER_COSTS, policy="A1", max_replicas=n, device="cpu")
    xs = got.plan_sweep(traces, windows)
    assert xs.shape == (4, 3, 100) and (xs == want.plan_sweep(traces, windows)).all()
    np.testing.assert_allclose(got.sweep_costs(traces, windows),
                               want.sweep_costs(traces, windows), rtol=RTOL)

    key = jax.random.key(0)
    want = ref.FleetProvisioner(REF_COSTS, policy="A3", max_replicas=n, key=key)
    keys = jax.random.split(key, traces.shape[0])          # as the reference's _prepare
    u0, u = jax.vmap(lambda k: ref_uniforms(k, traces.shape[1], n))(keys)
    got = port.FleetProvisioner(
        PAPER_COSTS, max_replicas=n, device="cpu",
        policy=PolicySpec("A3", uniforms=(np.array(u0), np.array(u))))
    xs = got.plan_sweep(traces, windows)
    assert (xs == want.plan_sweep(traces, windows)).all() and (xs >= traces[None]).all()
    costs = got.sweep_costs(traces, windows)
    assert costs.shape == (4, 3)
    np.testing.assert_allclose(costs, want.sweep_costs(traces, windows), rtol=RTOL)


def test_plan_equals_the_reference_with_deferral_and_predicted(demand):
    rng = np.random.default_rng(3)
    pred = np.clip(demand + rng.integers(-2, 3, size=T), 0, N)
    want, got = pair("A1", window=2)
    w, g = want.plan(demand, pred), got.plan(demand, pred)
    assert (g.x.numpy() == np.asarray(w.x)).all()
    assert float(g.cost) == pytest.approx(float(w.cost), rel=RTOL)
    want, got = pair("A1", n=24, deferral=dict(slack=3))
    a = demand.copy()
    a[40:43] = 30
    w, g = want.plan(a), got.plan(a)
    assert (g.x.numpy() == np.asarray(w.x)).all()
    assert (g.backlog.numpy() == np.asarray(w.backlog)).all()


def _session_events(seed, n_sessions=60, horizon=200.0):
    """One list of (time, kind, session) events: arrivals and departures of
    sessions with exponential lengths, in time order."""
    rng = np.random.default_rng(seed)
    starts = np.sort(rng.uniform(0, horizon, n_sessions))
    ends = starts + rng.exponential(8.0, n_sessions)
    events = [(float(t), 1, i) for i, t in enumerate(starts)]
    events += [(float(t), 0, i) for i, t in enumerate(ends)]
    return sorted(events)


@pytest.mark.parametrize("policy,alpha", [("A1", 0.0), ("A1", 0.5), ("A2", 0.0),
                                          ("A3", 0.5), ("offline", 0.0)])
def test_replica_autoscaler_equals_the_reference(policy, alpha):
    events = _session_events(4)
    ends = {i: t for t, kind, i in events if kind == 0}

    def predictor(t0, t1):                     # sessions alive somewhere in (t0, t1]
        return sum(1 for t, kind, i in events if kind == 1 and t <= t1 and ends[i] > t0)

    reports, rids = [], []
    for module, costs in ((ref, REF_COSTS), (port, PAPER_COSTS)):
        scaler = module.ReplicaAutoscaler(24, costs, policy=policy, alpha=alpha,
                                          predictor=predictor,
                                          rng=np.random.default_rng(0), initial_busy=2)
        held, trail = {}, []
        for t, kind, i in events:
            if kind == 1:
                held[i] = scaler.acquire(t)
                trail.append(held[i])
            else:
                scaler.release(t, held.pop(i))
            trail.append(scaler.n_on())
        reports.append(scaler.finalize(events[-1][0] + 50.0))
        rids.append(trail)
    assert rids[0] == rids[1]
    assert dataclasses.asdict(reports[0]) == dataclasses.asdict(reports[1])
    assert reports[1].total_cost(PAPER_COSTS) == reports[0].total_cost(REF_COSTS)
    assert reports[1].n_turn_off > 0
    assert tuple(port.autoscaler.POLICIES) == tuple(ref.autoscaler.POLICIES)
    with pytest.raises(ValueError, match="unknown policy"):
        port.ReplicaAutoscaler(4, PAPER_COSTS, policy="A9")


def test_replica_cost_model_equals_the_reference_with_every_argument():
    kw = dict(weights_bytes_per_device=8e9, n_chips=16, idle_power_w=110.0,
              peak_power_w=300.0, hbm_bw=819e9, compile_s=25.0, slot_s=300.0)
    want, got = ref.replica_cost_model(**kw), port.replica_cost_model(**kw)
    for f in ("P", "beta_on", "beta_off", "delta"):
        assert getattr(got, f) == getattr(want, f), f
    # every hardware default of the port is the H100's: its 700 W power
    # limit, its measured idle draw and kernel build, its memory rate
    default = port.replica_cost_model(weights_bytes_per_device=8e9, n_chips=16)
    h100 = port.replica_cost_model(weights_bytes_per_device=8e9, n_chips=16,
                                   idle_power_w=131.26, peak_power_w=700.0, hbm_bw=3.35e12,
                                   compile_s=13.26)
    assert (default.beta_on, default.beta_off) == (h100.beta_on, h100.beta_off)
    # the card's 700 W limit outweighs its shorter build: a dearer spin-up
    # than the reference's figures give
    assert default.beta_on > ref.replica_cost_model(weights_bytes_per_device=8e9,
                                                    n_chips=16).beta_on
    assert 0.1 < default.delta < 100


def test_plan_metrics_prometheus_text_is_byte_equal():
    calls = [(12.5, 4, 2), (0.75, 0, 0), (3.125, 9, 7), (1.0, 1, 3)]
    want, got = RefPlanMetrics(), PlanMetrics()
    assert got.prometheus_text() == want.prometheus_text()
    assert got.latency_quantile(0.5) is None
    for c in calls:
        want.observe_plan(*c)
        got.observe_plan(*c)
    assert got.prometheus_text() == want.prometheus_text()
    assert got.prometheus_text("fleet") == want.prometheus_text("fleet")
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_plan_metrics_of_a_serving_loop(demand):
    from repro_torch.obs import telemetry_session

    want, got = pair("delayedoff")
    with telemetry_session() as tel:
        for i in range(3):
            got.advance(demand[8 * i:8 * i + 8])
            want.advance(demand[8 * i:8 * i + 8])
    m = got.metrics
    assert m.plans == 3 and len(m.plan_latencies_ms) == 3 and m.toggles == want.metrics.toggles
    assert tel.counter_value("serving/toggles") == m.toggles
    assert tel.samples("serving/plan_latency_ms") == m.plan_latencies_ms
    assert len(tel.samples("span/serving/advance")) == 3
    txt = m.prometheus_text()
    assert "repro_serving_plans_total 3" in txt and 'quantile="0.99"' in txt


def test_stepper_exports_and_pow2_bucket():
    assert [port.pow2_bucket(n) for n in (1, 7, 8, 9, 64, 65, 1000)] == \
        [ref.pow2_bucket(n) for n in (1, 7, 8, 9, 64, 65, 1000)]
    assert set(port.__all__) == set(ref.__all__)
    st = port.stepper_init(N, PAPER_COSTS.delta, policy="A1", window=2, device="cpu")
    rs = ref.stepper_init(N, REF_COSTS.delta, policy="A1", window=2)
    for f in ("r", "on", "wait"):
        assert (getattr(st, f).numpy() == np.asarray(getattr(rs, f))).all(), f
    with pytest.raises(dataclasses.FrozenInstanceError):
        st.t = 3


def test_stepper_init_needs_cuda_unless_given_cpu():
    """Like every entry point of the port, ``stepper_init`` runs on the card
    unless asked for the CPU: the bare call raises where CUDA is absent."""
    if torch.cuda.is_available():
        pytest.skip("the refusal needs a machine without CUDA")
    with pytest.raises(RuntimeError, match="stepper_init.*CUDA is not available"):
        port.stepper_init(N, PAPER_COSTS.delta, policy="A1")
    assert port.stepper_init(N, PAPER_COSTS.delta, policy="A2", device="cpu").r.device.type == "cpu"


def test_stepper_chunk_kernel_flag_routes_to_the_plain_version(demand, monkeypatch):
    """On CPU tensors both routes are the plain version of K2 and launch
    nothing; ``kernel=False`` calls the plain version by name."""
    from repro_torch.kernels import provision_scan as kernels

    called = []
    real = kernels.provision_scan_stream_ref
    monkeypatch.setattr(port.stepper, "provision_scan_stream_ref",
                        lambda *a, **k: called.append(1) or real(*a, **k))
    st = port.stepper_init(N, PAPER_COSTS.delta, policy="A1", device="cpu")
    before = kernels.stream_launches
    outs = [port.stepper_chunk(torch.as_tensor(demand), 0, st.r, st.on, st.wait,
                               PAPER_COSTS.delta, policy="A1", n_levels=N,
                               max_h=PAPER_COSTS.delta_slots(), window=0, kernel=k)
            for k in (True, False)]
    assert called == [1] and kernels.stream_launches == before
    assert torch.equal(outs[0][0], outs[1][0])
    with pytest.raises(ValueError, match="uniforms"):
        port.stepper_chunk(torch.as_tensor(demand), 0, st.r, st.on, st.wait,
                           PAPER_COSTS.delta, policy="A2", n_levels=N,
                           max_h=PAPER_COSTS.delta_slots(), window=0)


def test_eval_cli_streaming_section_on_the_cpu(tmp_path):
    """``python -m repro_torch.eval --smoke --device cpu`` writes the
    streaming section the reference CLI writes: A1 at t_chunk 1, 64 and 1024
    with the checked-in report's chunk and slot counts and no build in the
    measured loops; the whole run builds no more than the port can."""
    out = tmp_path / "r.json"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.eval", "--smoke", "--device", "cpu",
         "--out", str(out)],
        capture_output=True, text=True, timeout=600, cwd=ROOT,
        env={**__import__("os").environ, "PYTHONPATH": str(ROOT / "src")},
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    got = json.loads(out.read_text())
    want = json.loads((ROOT / "BENCH_provision.json").read_text())
    fields = ("policy", "t_chunk", "chunks", "slots", "compiles")
    assert [{f: r[f] for f in fields} for r in got["streaming"]] == \
        [{f: r[f] for f in fields} for r in want["streaming"]]
    assert all(r["p50_ms"] > 0 and r["p99_ms"] >= r["p50_ms"] for r in got["streaming"])
    assert 0 <= got["jit_entries_added"] <= got["expected_compiles"] == 1
    assert "streaming: t_chunk=1" in proc.stderr
