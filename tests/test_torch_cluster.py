"""repro_torch's session traces, brick events and cluster == repro's, on
the CPU.

``generate_sessions``, ``brick_trace_from_fluid`` and the ``BrickTrace``
queries are numpy copies: equal field for field.  ``run_cluster`` without
engines is numpy over the port's ``ReplicaAutoscaler``: its
``ClusterReport`` must equal the reference's exactly, on the reference
test's trace (``tests/test_serving.py``) for A1 at alpha 0, 0.5 and 1 with
the window-max predictor and for A2/A3 on a seeded rng, and meet its laws
against the reference's brick simulator (``simulate``, ``a0_cost``: the
port's copies of those oracles are still to come).  With engines (the
reduced llama3.2-1b on the CPU) the report and the tokens generated equal
the reference's too.  Then the serving launcher, against the reference's.
"""
import dataclasses

import numpy as np
import pytest

# The port's tests need torch.  CI's jax-only tier-1 job installs no torch,
# so there these files skip instead of failing at import.
torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro.core as ref_core  # noqa: E402
import repro.serving as ref_serving  # noqa: E402
import repro_torch.core as port_core  # noqa: E402
import repro_torch.serving as port_serving  # noqa: E402
from repro.configs import get_config as ref_config  # noqa: E402
from repro.data.requests import generate_sessions as ref_sessions  # noqa: E402
from repro.launch import serve as ref_serve  # noqa: E402
from repro.models import init_params as ref_init_params  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import lm_params_from_numpy  # noqa: E402
from repro_torch.data import generate_sessions  # noqa: E402
from repro_torch.launch import serve as port_serve  # noqa: E402
from repro_torch.serving.engine import serving_params  # noqa: E402

REF_COSTS = ref_core.CostModel(P=1.0, beta_on=3.0, beta_off=3.0)
COSTS = port_core.CostModel(P=1.0, beta_on=3.0, beta_off=3.0)


@pytest.fixture(scope="module")
def traces():
    """The reference test's session trace, made by both packages."""
    return (ref_sessions(np.random.default_rng(0), n_slots=120, mean_concurrency=6.0),
            generate_sessions(np.random.default_rng(0), n_slots=120, mean_concurrency=6.0))


def report_dict(rep):
    return dataclasses.asdict(rep)


@pytest.mark.parametrize("kw", [
    {}, {"n_slots": 60, "mean_concurrency": 4.0},
    {"n_slots": 33, "mean_concurrency": 2.5, "prompt_tokens": 16, "max_new_tokens": 9},
], ids=["default", "launcher", "small"])
@pytest.mark.parametrize("seed", [0, 3])
def test_generate_sessions_matches_reference(seed, kw):
    want = ref_sessions(np.random.default_rng(seed), **kw)
    got = generate_sessions(np.random.default_rng(seed), **kw)
    assert got.horizon == want.horizon
    assert [dataclasses.asdict(s) for s in got.sessions] == \
        [dataclasses.asdict(s) for s in want.sessions]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_brick_trace_from_fluid_matches_reference(seed):
    a = port_core.msr_like_trace(np.random.default_rng(seed), n_slots=50, mean_jobs=5.0)
    want = ref_core.brick_trace_from_fluid(a, np.random.default_rng(seed + 10), slot_len=0.5)
    got = port_core.brick_trace_from_fluid(a, np.random.default_rng(seed + 10), slot_len=0.5)
    assert got.horizon == want.horizon
    assert [(j.arrival, j.departure) for j in got.jobs] == \
        [(j.arrival, j.departure) for j in want.jobs]


def brick_queries(tr):
    times, _ = tr.a_breakpoints()
    probes = sorted(set(times[::3]) | {0.0, tr.horizon / 3, tr.horizon})
    return {
        "events": [(e.time, e.kind, e.job) for e in tr.events],
        "breakpoints": tr.a_breakpoints(),
        "a_at": [tr.a_at(t) for t in probes],
        "a_before": [tr.a_before(t) for t in probes],
        "initial": tr.initial_count(),
        "final": tr.final_count(),
        "lifo": tr.lifo_matching(),
        "empty_periods": tr.empty_periods(),
        "unmatched": tr.unmatched_arrivals(),
        "busy": tr.busy_time(),
        "peak": tr.max_concurrency(),
    }


def test_brick_trace_queries_match_reference(traces):
    ref_trace, port_trace = traces
    assert brick_queries(port_trace.to_brick()) == brick_queries(ref_trace.to_brick())
    for kw in ({}, {"horizon": 60.0, "rate": 2.0, "diurnal": False}):
        want = ref_core.generate_brick_trace(np.random.default_rng(4), **kw)
        got = port_core.generate_brick_trace(np.random.default_rng(4), **kw)
        assert brick_queries(got) == brick_queries(want)
    pairs = [(0.0, 2.0), (0.5, 3.0), (1.0, 1.5), (2.5, 4.0)]
    assert brick_queries(port_core.trace_from_intervals(pairs, 4.0)) == \
        brick_queries(ref_core.trace_from_intervals(pairs, 4.0))
    with pytest.raises(ValueError, match="simultaneous"):
        port_core.trace_from_intervals([(0.0, 1.0), (1.0, 2.0)], 3.0)


def test_window_max_predictor_matches_reference(traces):
    ref_trace, port_trace = traces
    spans = [(t, t + w) for t in np.linspace(0.0, 118.0, 37) for w in (0.1, 1.0, 6.0)]
    for noise in (0.0, 0.3):
        want = ref_serving.make_window_max_predictor(
            ref_trace, noise, np.random.default_rng(9))
        got = port_serving.make_window_max_predictor(
            port_trace, noise, np.random.default_rng(9))
        assert [got(a, b) for a, b in spans] == [want(a, b) for a, b in spans]


CLUSTER_CASES = [("A1", 0.0, False), ("A1", 0.5, True), ("A1", 1.0, True),
                 ("A2", 0.0, False), ("A3", 0.5, True), ("offline", 0.0, False)]


@pytest.mark.parametrize("policy,alpha,predict", CLUSTER_CASES,
                         ids=[f"{p}-{a}-{'pred' if w else 'nopred'}"
                              for p, a, w in CLUSTER_CASES])
def test_run_cluster_matches_reference(traces, policy, alpha, predict):
    ref_trace, port_trace = traces
    want = ref_serving.run_cluster(
        ref_trace, REF_COSTS, policy=policy, alpha=alpha,
        predictor=ref_serving.make_window_max_predictor(ref_trace) if predict else None,
        rng=np.random.default_rng(7))
    got = port_serving.run_cluster(
        port_trace, COSTS, policy=policy, alpha=alpha,
        predictor=port_serving.make_window_max_predictor(port_trace) if predict else None,
        rng=np.random.default_rng(7))
    assert isinstance(got, port_serving.ClusterReport)
    assert report_dict(got) == report_dict(want)


def test_run_cluster_laws_against_reference_simulator(traces):
    """The live autoscaler equals the brick simulator (alpha 0; alpha 0.5
    and 1 with a perfect predictor), meets A1's 2 - alpha bound against the
    offline optimum up to the horizon slack, and saves energy over static
    provisioning (``tests/test_serving.py``'s laws, on the port)."""
    ref_trace, port_trace = traces
    brick = ref_trace.to_brick()
    opt = ref_core.a0_cost(brick, REF_COSTS)
    for alpha in (0.0, 0.5, 1.0):
        want = ref_core.simulate(brick, ref_core.A1Deterministic(alpha=alpha), REF_COSTS).cost
        rep = port_serving.run_cluster(
            port_trace, COSTS, policy="A1", alpha=alpha,
            predictor=port_serving.make_window_max_predictor(port_trace) if alpha else None)
        assert rep.total_cost == pytest.approx(want, rel=1e-6), alpha
        assert rep.total_cost <= (2 - alpha) * opt + COSTS.delta * 3
        assert rep.reduction > 0.3


def test_run_cluster_with_engines_matches_reference():
    """``tests/test_serving.py``'s end-to-end case: real prefill/decode on
    pinned replicas, the reduced llama3.2-1b with the reference's weights,
    the port's engines on the CPU."""
    ref_trace = ref_sessions(np.random.default_rng(3), n_slots=30, mean_concurrency=2.0)
    port_trace = generate_sessions(np.random.default_rng(3), n_slots=30, mean_concurrency=2.0)
    rc = ref_config("llama3.2-1b", reduced=True).replace(remat="none")
    pc = get_config("llama3.2-1b", reduced=True)
    params = ref_init_params(rc, jax.random.key(0))
    # cast once to the compute dtype, as the launcher does, so that every
    # engine shares one set of weights
    port_params = serving_params(
        lm_params_from_numpy(jax.tree.map(np.asarray, params), pc, device="cpu"), pc, "cpu")
    made = []

    def factory():
        made.append(port_serving.InferenceEngine(pc, port_params, max_batch=1, max_seq=64,
                                                 device="cpu"))
        return made[-1]

    want = ref_serving.run_cluster(
        ref_trace, REF_COSTS, policy="A1", alpha=0.0,
        engine_factory=lambda: ref_serving.InferenceEngine(rc, params, max_batch=1,
                                                           max_seq=64))
    got = port_serving.run_cluster(port_trace, COSTS, policy="A1", alpha=0.0,
                                   engine_factory=factory)
    assert got.tokens_generated > 0
    assert got.sessions_served == len(port_trace.sessions)
    assert report_dict(got) == report_dict(want)
    plain = port_serving.run_cluster(port_trace, COSTS, policy="A1", alpha=0.0)
    assert report_dict(got) == dict(report_dict(plain), tokens_generated=got.tokens_generated)
    assert 0 < len(made) <= got.scaler.n_turn_on + 1
    assert made[0].params["blocks"][0]["attn"]["wq"].data_ptr() == \
        made[-1].params["blocks"][0]["attn"]["wq"].data_ptr()


def test_launcher_matches_reference(monkeypatch, capsys):
    args = ["--arch", "llama3.2-1b", "--policy", "A1", "--alpha", "0.5", "--slots", "40"]
    monkeypatch.setattr("sys.argv", ["serve"] + args)
    assert ref_serve.main() == 0
    want = capsys.readouterr().out
    assert port_serve.main(args + ["--device", "cpu"]) == 0
    assert capsys.readouterr().out == want
    assert port_serve.main(["--arch", "llama3.2-1b", "--real-tokens", "--slots", "12",
                            "--concurrency", "1.0", "--device", "cpu"]) == 0
    line = capsys.readouterr().out
    assert "tokens=" in line and line.rstrip().endswith("(cpu)")


def test_launcher_refusals(monkeypatch, capsys):
    # --dry-run traces the cell through repro_torch.launch.dryrun.run_cell, which
    # starts a process group (tests/test_torch_dryrun.py runs it in a subprocess);
    # here a stand-in records the call, and no group is created in this process
    calls = []

    def run_cell(arch, shape, multi_pod, out_dir):
        calls.append((arch, shape, multi_pod))
        return {"hlo_flops_per_device": 1.5e9}

    monkeypatch.setattr("repro_torch.launch.dryrun.run_cell", run_cell)
    assert port_serve.main(["--arch", "llama3.2-1b", "--dry-run", "--multi-pod"]) == 0
    assert calls == [("llama3.2-1b", "decode_32k", True)]
    assert capsys.readouterr().out == "compiled llama3.2-1b x decode_32k: flops/dev=1.500e+09\n"
    if not torch.cuda.is_available():
        assert port_serve.main(["--arch", "llama3.2-1b", "--multi-pod"]) == 2
        assert port_serve.main(["--arch", "llama3.2-1b"]) == 2
        assert "--device cpu" in capsys.readouterr().err
