"""The full-grid fixture == a fresh ``repro.eval.evaluate(FULL_GRID)``.

``tests/fixtures/ref_eval_full_jax0.9.0.json`` is the reference's report of
the CLI's full grid (``benchmarks/cr_eval.py``: 468 cells, a week of
10-minute slots, 16 traces), which ``chip_smoke.py`` holds the port's
card run to.  A fresh reference run must give every cell again on every
field but the runtime columns, and the twin of ``bench_diff.py`` must pass
it.  The reference's grid takes about half a minute on the CPU, so it runs
once, in this file alone.
"""
import dataclasses
import json
import pathlib

import pytest

# The port's tests need torch.  CI's jax-only tier-1 job installs no torch,
# so there these files skip instead of failing at import.
pytest.importorskip("torch")

import repro.eval as reval  # noqa: E402
import repro_torch.eval as peval  # noqa: E402
from benchmarks.cr_eval import FULL_GRID as REF_FULL  # noqa: E402
from repro_torch.bench import bench_diff as twin_diff  # noqa: E402
from repro_torch.eval.__main__ import FULL_GRID  # noqa: E402

FIXTURE = pathlib.Path(__file__).resolve().parent / "fixtures" / "ref_eval_full_jax0.9.0.json"


@pytest.fixture(scope="module")
def fresh():
    return reval.evaluate(REF_FULL)


def test_full_fixture_equals_a_fresh_reference_run(fresh):
    stored = reval.EvalReport.load(FIXTURE)
    assert len(stored.cells) == len(fresh.cells) == 468
    for s, f in zip(stored.cells, fresh.cells):
        assert s == f                                  # wall_ms and compiles compare=False
    assert stored.grid == json.loads(json.dumps(fresh.grid))
    assert stored.bounds_ok and stored.streaming is None


def test_full_fixture_loads_in_the_port_as_the_reference_loads_it(fresh):
    mine, theirs = peval.EvalReport.load(FIXTURE), reval.EvalReport.load(FIXTURE)
    assert [dataclasses.asdict(c) for c in mine.cells] \
        == [dataclasses.asdict(c) for c in theirs.cells]
    assert mine.grid == theirs.grid and mine.schema == theirs.schema == peval.SCHEMA
    # the grid the port's CLI runs is the one the fixture records
    for k in ("noise_stds", "windows", "n_traces", "n_slots", "seed", "tol",
              "noise_slack", "deferral_slacks", "deferral_rule"):
        want = getattr(FULL_GRID, k)
        assert mine.grid[k] == (list(want) if isinstance(want, tuple) else want), k
    assert mine.grid["policies"] == list(FULL_GRID.policies)
    assert mine.grid["typed_policies"] == list(FULL_GRID.typed_policies)


def test_the_twin_passes_a_fresh_reference_run(fresh, tmp_path, capsys):
    new = tmp_path / "fresh.json"
    fresh.save(new)
    assert twin_diff.main([str(FIXTURE), str(new)]) == 0
    out, err = capsys.readouterr()
    assert out.splitlines()[0] == "468 common cells, 0 added, 0 removed"
    assert err.splitlines() == ["bench_diff: ok"]
