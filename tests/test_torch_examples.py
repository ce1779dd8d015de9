"""The twins of the four examples (``examples/*_torch.py``) on the CPU,
held to the reference scripts.

Each twin runs in a subprocess with ``--device cpu``; the runs (and the
reference quickstart, which the twin's output must equal line for line)
start together when the module's first test asks for them.  The other
twins' draw-free numbers are held to the reference's API, called here as
the reference scripts call it (the scripts themselves take 20 to 30 s: the
sharded Pallas scan in interpret mode, the token generation).  No process group is created in this process:
the sharded part of ``trace_provisioning_torch.py`` runs its rank in a
process of its own.
"""
from __future__ import annotations

import importlib.util
import os
import re
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

TESTS_DIR = os.path.dirname(os.path.abspath(__file__))
REPO_ROOT = os.path.dirname(TESTS_DIR)
EXAMPLES = os.path.join(REPO_ROOT, "examples")
TWINS = ("quickstart", "trace_provisioning", "serve_autoscale", "train_lm")
TIMEOUT_S = 240
#: train_lm_torch.py checkpoints every 50 steps; the rerun resumes there
TRAIN_ARGS = ("--batch", "2", "--seq", "32")
#: the eval's tolerance on a drawn number's paper bound
BOUND_TOL = 0.05


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO_ROOT, "src") + os.pathsep + env.get("PYTHONPATH", "")
    env["JAX_PLATFORMS"] = "cpu"
    env["OMP_NUM_THREADS"] = "2"        # the runs share the cores
    return env


def _start(script, *args):
    return subprocess.Popen(
        [sys.executable, os.path.join(EXAMPLES, script), *args],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=_env(), cwd=REPO_ROOT,
    )


def _finish(proc):
    out, err = proc.communicate(timeout=TIMEOUT_S)
    return proc.returncode, out, err


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every twin on the CPU and the reference quickstart, started
    together: name -> (exit code, stdout, stderr)."""
    ckpt = str(tmp_path_factory.mktemp("train_lm_ckpt"))
    procs = {
        "quickstart": _start("quickstart_torch.py", "--device", "cpu"),
        "quickstart_ref": _start("quickstart.py"),
        "trace_provisioning": _start("trace_provisioning_torch.py", "--device", "cpu"),
        "serve_autoscale": _start("serve_autoscale_torch.py", "--device", "cpu"),
        "train_lm": _start("train_lm_torch.py", "--device", "cpu", "--steps", "60",
                           "--ckpt-dir", ckpt, *TRAIN_ARGS),
    }
    try:
        out = {name: _finish(proc) for name, proc in procs.items()}
        out["train_lm_resumed"] = _finish(_start(
            "train_lm_torch.py", "--device", "cpu", "--steps", "70", "--ckpt-dir", ckpt,
            *TRAIN_ARGS))
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return out


def _ok(runs, name):
    rc, out, err = runs[name]
    assert rc == 0, f"{name} exited {rc}:\n{err[-3000:]}"
    return out


def _numbers(line):
    return [float(x.replace(",", "")) for x in re.findall(r"-?\d[\d,]*\.?\d*", line)]


def _fields(line):
    """``key=value`` pairs of a line, the values as floats."""
    return {k: float(v.replace(",", "").rstrip("%"))
            for k, v in re.findall(r"([\w()]+)=\s*(-?[\d,]+\.?\d*%?)", line)}


def _section(out, title):
    """The lines of ``out`` from the one starting with ``title`` up to the
    next blank line."""
    lines = out.splitlines()
    start = next(i for i, line in enumerate(lines) if line.startswith(title))
    end = next((i for i in range(start + 1, len(lines)) if not lines[i].strip()), len(lines))
    return lines[start:end]


# ---------------------------------------------------------------------------
# quickstart: line for line
# ---------------------------------------------------------------------------

def test_quickstart_prints_the_reference_line_for_line(runs):
    assert _ok(runs, "quickstart").splitlines() == _ok(runs, "quickstart_ref").splitlines()


# ---------------------------------------------------------------------------
# trace_provisioning: draw-free numbers equal, drawn ones within bounds
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def trace_reference():
    """The reference's draw-free numbers of ``examples/trace_provisioning.py``,
    printed as the script prints them: Fig. 3's A1 column, Fig. 4d, the
    heterogeneous fleet, A1's schedule, and the swept table's std = 0 row
    (A1's costs at windows 0..2 on the undisturbed trace)."""
    import dataclasses

    import jax.numpy as jnp
    import numpy as np

    from repro.core import (
        PAPER_COSTS,
        CostModel,
        PolicySpec,
        ProvisionSpec,
        Workload,
        fluid_cost,
        provision,
        theoretical_ratio,
    )
    from repro.core.traces import WEEK_SLOTS
    from repro.scenarios import Scenario, generate

    costs = PAPER_COSTS
    msr = Scenario("msr_diurnal", target_pmr=4.63, mean_jobs=40.0)
    trace = generate(msr, 1, WEEK_SLOTS)[0]
    n_levels = int(trace.max()) + 1
    demand = Workload(demand=jnp.asarray(trace, jnp.int32))
    opt = fluid_cost(trace, "offline", costs).cost
    a1 = np.asarray(provision(ProvisionSpec(
        costs=costs, workload=demand, n_levels=n_levels,
        policy=PolicySpec("A1", windows=jnp.arange(6, dtype=jnp.int32)))).cost)
    fig3 = []
    for w in range(6):
        alpha = min(1.0, (w + 1) / costs.delta)
        fig3.append([float(f"{alpha:.2f}"), float(f"{theoretical_ratio('A1', alpha):.3f}"),
                     float(f"{a1[w] / opt:.3f}"), float(f"{theoretical_ratio('A3', alpha):.3f}")])
    fig4d = []
    for target in (2, 4, 6, 8, 10):
        a = generate(dataclasses.replace(msr, target_pmr=float(target)), 1, WEEK_SLOTS)[0]
        st = fluid_cost(a, "static", costs).cost
        op = fluid_cost(a, "offline", costs).cost
        fig4d.append(f"  PMR={target:>2}: reduction {1 - op / st:6.1%}")
    n_base = int(n_levels * 0.5)
    beta = np.where(np.arange(n_levels) < n_base, 4.5, 1.5)
    res = provision(ProvisionSpec(costs=CostModel(P=1.0, beta_on=beta, beta_off=beta),
                                  workload=demand, policy=PolicySpec("A1", window=2)))
    lc = np.asarray(res.level_cost)
    het = [f"  total={float(res.cost):,.0f}  energy={float(res.energy):,.0f} "
           f"toggles={float(res.toggle_cost):,.0f}",
           f"  baseload levels (Delta=9): {lc[:n_base].sum():,.0f}; "
           f"spot levels (Delta=3): {lc[n_base:].sum():,.0f}"]
    x = np.asarray(provision(ProvisionSpec(costs=costs, workload=demand, n_levels=n_levels,
                                           policy=PolicySpec("A1", window=2))).x)
    schedule = (f"  A1 x(t): max={int(x.max())}, mean={float(x.mean()):.1f} "
                f"(demand mean {trace.mean():.1f})")
    return {"fig3": fig3, "fig4d": fig4d, "het": het, "schedule": schedule,
            "swept0": [float(c) for c in a1[:3].round(0)]}


def test_trace_provisioning_fig3(runs, trace_reference):
    port = _section(_ok(runs, "trace_provisioning"), "Fig.3")[2:]
    assert len(port) == 6
    for line, want in zip(port, trace_reference["fig3"]):
        alpha, a1_bound, a1_emp, a3_bound, a3_emp = _numbers(line)
        assert [alpha, a1_bound, a1_emp, a3_bound] == want      # draw-free
        assert 1.0 <= a3_emp <= a3_bound + BOUND_TOL            # drawn


@pytest.mark.parametrize("title,key", [("Fig.4d", "fig4d"), ("Heterogeneous fleet", "het")])
def test_trace_provisioning_draw_free_sections(runs, trace_reference, title, key):
    assert _section(_ok(runs, "trace_provisioning"), title)[1:] == trace_reference[key]


def test_trace_provisioning_noise_sweep_within_bounds(runs):
    port = _section(_ok(runs, "trace_provisioning"), "Flash crowd")[1:]
    assert len(port) == 3
    for line, std in zip(port, (0.0, 0.25, 0.5)):
        m = re.fullmatch(r"  std=\s*([\d.]+): mean CR ([\d.]+) \(A1 bound ([\d.]+)\)", line)
        assert m and float(m.group(1)) == std and float(m.group(3)) == 1.5
        assert 1.0 <= float(m.group(2)) <= 1.5 + BOUND_TOL


def test_trace_provisioning_sharded_schedule_is_the_single_device_one(runs, trace_reference):
    port = _ok(runs, "trace_provisioning")
    assert "sharded over 1 device(s): identical schedule ✓" in port
    assert trace_reference["schedule"] in port.splitlines()
    # the swept table's std = 0 row is draw-free
    table = port.split("cost table (rows=std, cols=window):\n")[1].splitlines()
    assert _numbers(table[0]) == trace_reference["swept0"]
    assert len(_numbers(table[1])) == 3


# ---------------------------------------------------------------------------
# serve_autoscale: A1's plans and the cluster's report are the reference's
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def serve_reference():
    """The reference's draw-free serving numbers at the script's defaults:
    A1's window sweep, the deferral table and the cluster's reports."""
    import numpy as np

    from repro.core import CostModel, DeferralSpec, PolicySpec
    from repro.data.requests import generate_sessions
    from repro.serving import FleetProvisioner, make_window_max_predictor, run_cluster

    spec = importlib.util.spec_from_file_location(
        "serve_autoscale_ref", os.path.join(EXAMPLES, "serve_autoscale.py"))
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    costs = CostModel(P=1.0, beta_on=3.0, beta_off=3.0)
    trace = generate_sessions(np.random.default_rng(0), n_slots=40, mean_concurrency=2.5)
    demand = ref.slot_concurrency(trace, 40)
    n = int(demand.max()) + 1
    sweep = FleetProvisioner(costs, policy=PolicySpec("A1"), max_replicas=n).sweep_costs(
        demand, np.arange(int(costs.delta)))
    slack = {}
    for k in (0, 1, 2, 4):
        res = FleetProvisioner(costs, policy="A1", max_replicas=n,
                               deferral=DeferralSpec(slack=k)).plan(demand)
        x = np.asarray(res.x)
        slack[k] = (float(res.cost), int(np.maximum(np.diff(x, prepend=0), 0).sum()),
                    int(res.p99_delay), int(res.deadline_misses))
    pred = make_window_max_predictor(trace)
    cluster = {alpha: run_cluster(trace, costs, policy="A1", alpha=alpha, predictor=pred)
               for alpha in (0.0, 0.5, 1.0)}
    tokens = sum(min(s.max_new_tokens, 16) for s in trace.sessions)
    return {"sweep": np.asarray(sweep), "slack": slack, "cluster": cluster,
            "sessions": len(trace.sessions), "tokens": tokens}


def test_serve_autoscale_a1_plans_equal_the_reference(runs, serve_reference):
    out = _ok(runs, "serve_autoscale")
    assert out.splitlines()[0].startswith(f"sessions: {serve_reference['sessions']},")
    (a1,) = [x for x in out.splitlines() if x.strip().startswith("A1: w=")]
    got = [v for i, v in enumerate(_numbers(a1.split("->")[0])[1:]) if i % 2]
    assert got == [float(f"{c:.0f}") for c in serve_reference["sweep"]]
    (a3,) = [x for x in out.splitlines() if x.strip().startswith("A3: w=")]
    assert len(_numbers(a3.split("->")[0])) == 13
    for k, (cost, toggles, p99, misses) in serve_reference["slack"].items():
        (line,) = [x for x in out.splitlines() if x.strip().startswith(f"slack={k}:")]
        assert _fields(line) == {"slack": k, "cost": float(f"{cost:.0f}"),
                                 "toggles(on)": toggles, "p99_delay": p99, "misses": misses}


def test_serve_autoscale_cluster_reports_equal_the_reference(runs, serve_reference):
    lines = [x for x in _ok(runs, "serve_autoscale").splitlines() if x.startswith("A1(alpha=")]
    assert len(lines) == 4
    for line, alpha in zip(lines, (0.0, 0.5, 1.0, 0.5)):
        rep = serve_reference["cluster"][alpha]
        want = (f"A1(alpha={alpha:.2f}): cost={rep.total_cost:,.1f} "
                f"static={rep.static_cost:,.0f} reduction={rep.reduction:.1%} "
                f"toggles={rep.scaler.n_turn_on}/{rep.scaler.n_turn_off}")
        if "real generation" in line:     # every session served, its tokens generated
            want = want.replace(":", " + real generation:", 1) + (
                f" tokens={serve_reference['tokens']}")
        assert line == want


# ---------------------------------------------------------------------------
# train_lm: the loss falls, and a rerun resumes
# ---------------------------------------------------------------------------

def test_train_lm_loss_falls(runs):
    line = _ok(runs, "train_lm").strip().splitlines()[-1]
    m = re.search(r"to step (\d+): loss ([\d.]+) -> ([\d.]+)", line)
    assert m and int(m.group(1)) == 60
    assert float(m.group(3)) < float(m.group(2))


def test_train_lm_rerun_resumes_from_the_checkpoint(runs):
    out = _ok(runs, "train_lm_resumed")
    assert "resuming from checkpoint step 50" in runs["train_lm_resumed"][2]
    assert re.search(r"to step 70: loss [\d.]+ -> [\d.]+", out)


# ---------------------------------------------------------------------------
# every twin: the card by default, and no fallback to the CPU
# ---------------------------------------------------------------------------

def _twin(name):
    spec = importlib.util.spec_from_file_location(
        f"{name}_torch", os.path.join(EXAMPLES, f"{name}_torch.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("name", TWINS)
def test_twin_exits_2_without_cuda(name, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert _twin(name).main([]) == 2
    assert "--device cpu" in capsys.readouterr().err


@pytest.mark.parametrize("name", TWINS)
def test_twin_imports_neither_jax_nor_repro(name):
    import ast

    with open(os.path.join(EXAMPLES, f"{name}_torch.py"), encoding="utf-8") as fh:
        tree = ast.parse(fh.read())
    roots = {alias.name.split(".")[0] for node in ast.walk(tree)
             if isinstance(node, ast.Import) for alias in node.names}
    roots |= {node.module.split(".")[0] for node in ast.walk(tree)
              if isinstance(node, ast.ImportFrom) and node.level == 0 and node.module}
    assert "repro_torch" in roots and not roots & {"jax", "jaxlib", "repro"}, roots


def test_no_process_group_in_this_process(runs):
    import torch.distributed as dist

    assert runs["trace_provisioning"][0] == 0
    assert not (dist.is_available() and dist.is_initialized())
