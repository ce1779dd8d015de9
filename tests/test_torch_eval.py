"""repro_torch.eval.evaluate == repro.eval.evaluate, cell for cell, on the CPU.

The port's ``evaluate(SMOKE_GRID)`` runs on the CPU with the reference's own
random draws injected (``draws=``): the prediction-noise normals keyed by
``fold_in(key(seed + 1), scenario)`` and split per trace, and the wait
uniforms keyed by ``fold_in(key(seed + stream), policy)`` and split per
trace, exactly as the reference's harness and ``provision()`` key them.
All 144 cells must equal the reference's on every field but the runtime
columns ``wall_ms`` and ``compiles``; ``benchmarks/bench_diff.py`` then
exits 0 on the two reports.  The CLI's gates and device rule are checked
too.
"""
import dataclasses
import json
import pathlib

import numpy as np
import pytest

# The port's tests need torch.  CI's jax-only tier-1 job installs no torch,
# so there these files skip instead of failing at import.
torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro.eval as reval  # noqa: E402
import repro_torch.eval as peval  # noqa: E402
from benchmarks import bench_diff  # noqa: E402
from benchmarks.cr_eval import SMOKE_GRID as REF_SMOKE  # noqa: E402
from repro.core.jax_provision import _uniforms as ref_uniforms  # noqa: E402
from repro_torch.bench import bench_diff as twin_diff  # noqa: E402
from repro_torch.eval import __main__ as cli  # noqa: E402
from repro_torch.eval import harness  # noqa: E402
from repro_torch.obs import telemetry_session  # noqa: E402
from repro_torch.scenarios import Scenario  # noqa: E402

RUNTIME = ("wall_ms", "compiles")
FIXTURES = pathlib.Path(__file__).resolve().parent / "fixtures"
SMOKE_FIXTURE = FIXTURES / "ref_eval_smoke_jax0.9.0.json"
NORMALS = FIXTURES / "ref_eval_normals_jax0.9.0.npz"


class ReferenceDraws:
    """The reference harness's draws for a grid of seed ``seed``."""

    def __init__(self, seed):
        self.seed = seed
        self.calls = []

    def normals(self, scenario_index, shape):
        self.calls.append(("normals", scenario_index, shape))
        key = jax.random.fold_in(jax.random.key(self.seed + 1), scenario_index)
        keys = jax.random.split(key, shape[0])
        return np.array(jax.vmap(lambda k: jax.random.normal(k, (shape[1],)))(keys))

    def uniforms(self, stream, policy_index, shape):
        self.calls.append(("uniforms", stream, policy_index, shape))
        key = jax.random.fold_in(jax.random.key(self.seed + stream), policy_index)
        keys = jax.random.split(key, shape[0])
        u0, u = jax.vmap(lambda k: ref_uniforms(k, shape[1], shape[2]))(keys)
        return np.array(u0), np.array(u)


def _cells(report):
    out = []
    for c in report.cells:
        d = dataclasses.asdict(c)
        for k in RUNTIME:
            d.pop(k)
        out.append(d)
    return out


@pytest.fixture(scope="module")
def smoke_pair():
    want = reval.evaluate(REF_SMOKE)
    draws = ReferenceDraws(REF_SMOKE.seed)
    got = peval.evaluate(dataclasses.replace(cli.SMOKE_GRID, device="cpu"), draws=draws)
    return want, got, draws


def test_smoke_grid_equals_the_reference_cell_for_cell(smoke_pair):
    want, got, _ = smoke_pair
    assert len(got.cells) == len(want.cells) == 144
    for w, g in zip(_cells(want), _cells(got)):
        assert g == w
    assert got.bounds_ok and want.bounds_ok
    # the port's compile step is a kernel-library build, and the CPU builds none
    assert got.backend == "cpu" and got.jit_entries_added == 0
    assert all(c.compiles == 0 and c.wall_ms > 0 for c in got.cells)
    assert got.expected_compiles == 1 and want.expected_compiles > 1
    assert got.streaming is None
    same = {k for k in want.grid if k not in ("mesh", "use_pallas")}
    assert {k: got.grid[k] for k in same} == {k: want.grid[k] for k in same}


def test_draw_free_cells_equal_the_checked_in_report(smoke_pair):
    """``BENCH_provision.json`` holds another JAX version's random streams,
    so only cells no draw can change reproduce it: the 48 that draw nothing
    (A1 at noise 0, AQ-det, deferral A1) and the 6 A2 cells at noise 0 and
    window 4, whose waits span one slot (α = 5/6).  The card holds the 48
    to the file (``chip_smoke.py`` phase 11); this is the CPU's side."""
    _, got, _ = smoke_pair
    stored = json.loads((cli.ROOT / "BENCH_provision.json").read_text())["cells"]
    assert len(stored) == len(got.cells) == 144
    equal = set()
    for i, (c, f) in enumerate(zip(_cells(got), stored)):
        f = {k: v for k, v in f.items() if k not in RUNTIME}
        if c == f:
            equal.add(i)
    cells = got.cells
    draw_free = {i for i, c in enumerate(cells)
                 if (c.policy == "A1" and c.noise_std == 0.0) or c.policy == "AQ-det"}
    a2_w4 = {i for i, c in enumerate(cells)
             if c.policy == "A2" and c.noise_std == 0.0 and c.window == 4}
    assert len(draw_free) == 48 and len(a2_w4) == 6
    assert draw_free | a2_w4 <= equal


def test_bench_diff_passes_between_the_two_reports(smoke_pair, tmp_path, capsys):
    want, got, _ = smoke_pair
    base, new = tmp_path / "ref.json", tmp_path / "port.json"
    want.save(base)
    got.save(new)
    assert json.loads(new.read_text())["schema"] == "repro.eval/v5"
    assert _cells(reval.EvalReport.load(new)) == _cells(got)
    assert bench_diff.main([str(base), str(new)]) == 0
    assert "bench_diff: ok" in capsys.readouterr().err


def test_smoke_fixture_equals_the_reference_report(smoke_pair):
    """``tests/fixtures/ref_eval_smoke_jax0.9.0.json`` is
    ``repro.eval.evaluate(SMOKE_GRID)``'s report: every cell but the runtime
    columns, and the grid."""
    want, _, _ = smoke_pair
    stored = reval.EvalReport.load(SMOKE_FIXTURE)
    assert stored.schema == want.schema
    assert _cells(stored) == _cells(want)
    assert stored.grid == json.loads(json.dumps(want.grid))
    assert stored.streaming is None and want.streaming is None


def test_reference_draws_are_jax_draws_on_every_smoke_call(smoke_pair, tmp_path, capsys):
    """The port's own ``ReferenceDraws`` answers every draw the smoke grid
    asked of jax's with the same bits, so its smoke report is the one above:
    every cell equals the fixture's, and the twin of ``bench_diff.py`` exits
    0 on the two."""
    _, got, draws = smoke_pair
    normals = np.load(NORMALS)["smoke"]
    mine = peval.ReferenceDraws(REF_SMOKE.seed, normals, device="cpu")
    jaxs = ReferenceDraws(REF_SMOKE.seed)
    calls = sorted(set(draws.calls))
    assert len(calls) == 6 + 3
    for call in calls:
        if call[0] == "normals":
            pairs = [(mine.normals(*call[1:]), jaxs.normals(*call[1:]))]
        else:
            pairs = zip(mine.uniforms(*call[1:]), jaxs.uniforms(*call[1:]))
        for m, j in pairs:
            assert m.dtype == torch.float32 and m.device.type == "cpu"
            assert np.array_equal(m.numpy().view(np.uint32),
                                  np.asarray(j, np.float32).view(np.uint32)), call
    fixture = peval.EvalReport.load(SMOKE_FIXTURE)
    assert got.cells == fixture.cells
    new = tmp_path / "port.json"
    got.save(new)
    assert twin_diff.main([str(SMOKE_FIXTURE), str(new)]) == 0
    assert capsys.readouterr().err.splitlines() == ["bench_diff: ok"]


def test_draws_are_asked_once_per_block(smoke_pair):
    """Common random numbers: one normal draw per scenario (shared across the
    noise levels), one uniform pair per keyed (policy, scenario) block, per
    typed AQ-rand cell, and no draw for A1, AQ-det or the deferral A1."""
    _, _, draws = smoke_pair
    kinds = [c[0] for c in draws.calls]
    assert kinds.count("normals") == 6
    by_stream = {}
    for c in draws.calls:
        if c[0] == "uniforms":
            by_stream[c[1]] = by_stream.get(c[1], 0) + 1
    assert by_stream == {harness.POLICY_STREAM: 12, harness.TYPED_STREAM: 6}


def test_the_cli_gates_pass_on_the_smoke_report(smoke_pair):
    cli.check_gates(smoke_pair[1])


def test_the_cli_gates_name_a_violation(smoke_pair):
    report = smoke_pair[1]
    bad = dataclasses.replace(report.cells[0], bound_ok=False)
    broken = dataclasses.replace(report, cells=[bad] + report.cells[1:])
    with pytest.raises(AssertionError, match="paper-bound violations"):
        cli.check_gates(broken)
    dcells = [c for c in report.cells if c.slack is not None]
    pricier = [dataclasses.replace(c, mean_cost=1e9) if c.slack == 12 else c
               for c in report.cells]
    assert dcells
    with pytest.raises(AssertionError, match="deferral bought nothing"):
        cli.check_gates(dataclasses.replace(report, cells=pricier))
    fewer = [c for c in report.cells if c.slack != 12]
    with pytest.raises(AssertionError, match="deferral cells"):
        cli.check_gates(dataclasses.replace(report, cells=fewer))


TINY = peval.EvalGrid(
    policies=("A1", "A2"),
    scenarios=(Scenario("sinusoidal", target_pmr=4.0, mean_jobs=12.0),),
    noise_stds=(0.0, 0.2),
    windows=(0, 2),
    n_traces=3,
    n_slots=96,
    typed_groups=cli.TYPED_GROUPS,
    deferral_slacks=(0, 3),
    device="cpu",
)


def test_own_draws_are_seeded_and_repeatable():
    a, b = peval.evaluate(TINY), peval.evaluate(TINY)
    assert _cells(a) == _cells(b)
    c = peval.evaluate(dataclasses.replace(TINY, seed=1))
    assert _cells(a) != _cells(c)
    assert a.bounds_ok


def test_every_provision_call_lies_in_a_block_span():
    """The eval's spans cover its provision() calls: each lies inside one
    of the four block kinds (the offline baselines of the typed and
    deferral blocks too), and the deferral layer's spans nest inside the
    deferral cells', so their share of one run is at most 1."""
    with telemetry_session() as tel:
        peval.evaluate(TINY)
    events = tel.chrome_trace()["traceEvents"]
    blocks = [e for e in events if e["name"].startswith("eval/")]
    counts = {}
    for e in blocks:
        counts[e["name"]] = counts.get(e["name"], 0) + 1
    assert counts == {"eval/offline_baseline": 1 + 1 + 2, "eval/policy_block": 2,
                      "eval/typed_cell": 2, "eval/deferral_cell": 2}

    def inside(e, kinds):
        return any(b["name"] in kinds and b["ts"] <= e["ts"]
                   and e["ts"] + e["dur"] <= b["ts"] + b["dur"] for b in blocks)

    calls = [e for e in events if e["name"] == "provision"]
    assert len(calls) == 2 + 2 + 2 + 4
    assert all(inside(e, counts) for e in calls)
    layer = [e for e in events if e["name"].startswith("provision/deferral_")]
    assert sorted(e["name"] for e in layer) == ["provision/deferral_apply"] * 2 + [
        "provision/deferral_metrics"] * 2
    assert all(inside(e, {"eval/deferral_cell"}) for e in layer)


def test_spec_builders_rebuild_the_cells_evaluate_ran():
    """``_block_spec``, ``_typed_spec`` and ``_deferral_spec`` are what
    ``evaluate`` runs: rebuilt from the grid's seed, each gives the
    report's mean cost exactly (the card's check of K2 against its plain
    route at the eval's shapes relies on this)."""
    report = peval.evaluate(TINY)
    mean = {(c.policy, c.noise_std, c.window, c.slack): c.mean_cost for c in report.cells}
    dev, n_levels = torch.device("cpu"), report.grid["n_levels"]
    demand_np = harness.generate(TINY.scenarios[0], TINY.n_traces, TINY.n_slots)
    demand = torch.as_tensor(demand_np).to(torch.int32)
    noise = harness._noise(TINY, None, dev, 0, tuple(demand.shape))
    cost = harness._numpy(harness.provision(harness._block_spec(
        TINY, None, dev, 1, demand, noise, n_levels)).cost)          # A2: (S, W, B)
    for s, std in enumerate(TINY.noise_stds):
        for w, window in enumerate(TINY.windows):
            assert float(cost[s, w].mean()) == mean[("A2", std, window, None)]
    group = harness._numpy(harness.provision(harness._typed_spec(
        TINY, None, dev, 1, demand_np)).group_cost)
    assert float(group.sum(axis=-1).mean()) == mean[("AQ-rand", 0.0, 0, None)]
    cost = harness._numpy(harness.provision(harness._deferral_spec(
        TINY, None, dev, 0, demand, 3, n_levels)).cost)
    assert float(cost.mean()) == mean[("A1", 0.0, 0, 3)]


def test_cuda_grid_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert peval.EvalGrid().device == "cuda"
    with pytest.raises(RuntimeError, match='device="cpu"'):
        peval.evaluate(dataclasses.replace(TINY, device="cuda"))


@pytest.mark.parametrize("bad", [
    dict(windows=()), dict(noise_stds=(-0.1,)), dict(policies=()),
    dict(typed_policies=("A1",)), dict(deferral_slacks=(-1,)),
    dict(deferral_rule="LIFO"), dict(deferral_policies=("offline",)),
])
def test_grid_validation_matches_the_reference(bad):
    with pytest.raises(ValueError) as want:
        dataclasses.replace(REF_SMOKE, **bad).validate()
    with pytest.raises(ValueError) as got:
        dataclasses.replace(cli.SMOKE_GRID, **bad).validate()
    assert str(got.value) == str(want.value)


def test_cli_refuses_the_cpu_unless_asked(monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "r.json"
    assert cli.main(["--smoke", "--out", str(out)]) != 0
    assert "--device cpu" in capsys.readouterr().err and not out.exists()
    monkeypatch.setattr(cli, "SMOKE_GRID", TINY)
    assert cli.main(["--smoke", "--device", "cpu", "--out", str(out)]) == 0
    err = capsys.readouterr().err
    assert "device=cpu" in err and "streaming rows: 3" in err and "compiles=0/1" in err
    assert reval.EvalReport.load(out).backend == "cpu"


def test_cli_default_report_is_under_build():
    """The default report lands in the ignored build/ directory, never on the
    checked-in BENCH_provision.json."""
    args = cli.parser().parse_args([])
    assert args.out == cli.ROOT / "build" / "BENCH_torch_provision.json"
    assert (args.device, args.smoke) == ("cuda", False)
    assert "build/" in (cli.ROOT / ".gitignore").read_text().split()
