"""repro_torch.bench.bench_diff == benchmarks/bench_diff.py, pair for pair.

The twin's ``main`` must give the reference script's exit code and print
its lines, stdout and stderr, on pairs of report files that take every
branch of the diff: identical reports, mean-CR drift within and past
``--tol``, cells removed and added, each verdict flipped either way,
``p99_delay`` and ``wall_ms`` drift, the streaming rows gone, added, with
changed compiles and with drifting latency, and the v1-v4 fixtures against
``BENCH_provision.json``.  The pairs are made from ``BENCH_provision.json``
by the edits below, so no draw is involved.
"""
import ast
import copy
import json
import pathlib

import pytest

# The port's tests need torch.  CI's jax-only tier-1 job installs no torch,
# so there these files skip instead of failing at import.
pytest.importorskip("torch")

from benchmarks import bench_diff as ref  # noqa: E402
from repro_torch.bench import bench_diff as twin  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
BENCH = ROOT / "BENCH_provision.json"
FIXTURES = ROOT / "tests" / "fixtures"


def _cell(d, policy, slack=None, group=False):
    """The first cell of ``policy`` (a deferral cell when ``slack`` is given;
    a typed one when ``group``)."""
    for c in d["cells"]:
        if (c["policy"] == policy and c["slack"] == slack
                and (c["group_bound_ok"] is not None) == group):
            return c
    raise LookupError(policy)


def _raise_cr(by):
    def edit(base, new):
        _cell(new, "A2")["mean_cr"] += by
    return edit


def _flip(field, policy, slack=None, group=False, recover=False):
    """``field`` of the first such cell turned false in the new report, or,
    with ``recover``, false in the baseline and true in the new one."""
    def edit(base, new):
        target = _cell(base if recover else new, policy, slack, group)
        target[field] = [False, True] if group else False
    return edit


def _remove(base, new):
    new["cells"].pop(7)


def _add(base, new):
    extra = copy.deepcopy(_cell(new, "A1"))
    extra["window"] = 9
    new["cells"].append(extra)


def _delay(base, new):
    _cell(new, "A1", slack=12)["p99_delay"] += 3


def _wall(base, new):
    for c in new["cells"][:5]:
        c["wall_ms"] *= 1.6
    new["cells"][5]["wall_ms"] *= 0.5


def _stream_gone(base, new):
    new["streaming"].pop()


def _stream_added(base, new):
    new["streaming"].append(dict(new["streaming"][0], t_chunk=4096))


def _stream_compiles(base, new):
    new["streaming"][1]["compiles"] = 2


def _stream_latency(base, new):
    new["streaming"][0]["p50_ms"] *= 2.0
    new["streaming"][2]["p99_ms"] *= 3.0


def _no_streaming(base, new):
    del new["streaming"]


def _everything(base, new):
    for edit in (_raise_cr(1e-3), _remove, _add, _delay, _wall, _stream_gone,
                 _flip("slo_ok", "A1", slack=6), _flip("bound_ok", "A3", recover=True)):
        edit(base, new)


# (name, edit of (baseline, new) dicts or a v1-v4 fixture as the baseline, extra argv)
PAIRS = [
    ("identical", None, []),
    ("cr_up_within_tol", _raise_cr(5e-7), []),
    ("cr_up_past_tol", _raise_cr(1e-3), []),
    ("cr_up_within_a_wider_tol", _raise_cr(1e-3), ["--tol", "1e-2"]),
    ("cr_down", _raise_cr(-1e-3), []),
    ("cell_removed", _remove, []),
    ("cell_added", _add, []),
    ("bound_ok_flipped", _flip("bound_ok", "A2"), []),
    ("bound_ok_recovered", _flip("bound_ok", "A2", recover=True), []),
    ("group_bound_ok_flipped", _flip("group_bound_ok", "AQ-det", group=True), []),
    ("group_bound_ok_recovered",
     _flip("group_bound_ok", "AQ-rand", group=True, recover=True), []),
    ("slo_ok_flipped", _flip("slo_ok", "A1", slack=2), []),
    ("slo_ok_recovered", _flip("slo_ok", "A1", slack=0, recover=True), []),
    ("p99_delay_drift", _delay, []),
    ("wall_ms_drift", _wall, []),
    ("wall_ms_drift_under_a_wider_wall_tol", _wall, ["--wall-tol", "0.7"]),
    ("streaming_row_gone", _stream_gone, []),
    ("streaming_row_added", _stream_added, []),
    ("streaming_compiles_changed", _stream_compiles, []),
    ("streaming_latency_drift", _stream_latency, []),
    ("streaming_section_gone", _no_streaming, []),
    ("everything_at_once", _everything, []),
] + [(f"report_v{v}_against_the_checked_in_report", f"report_v{v}.json", [])
     for v in (1, 2, 3, 4)]


def _run(main, argv, capsys):
    rc = main(argv)
    out, err = capsys.readouterr()
    return rc, out.splitlines(), err.splitlines()


@pytest.mark.parametrize("name,edit,extra", PAIRS, ids=[p[0] for p in PAIRS])
def test_twin_prints_and_exits_as_the_reference(name, edit, extra, tmp_path, capsys):
    base_path, new_path = tmp_path / "base.json", tmp_path / "new.json"
    if isinstance(edit, str):
        base_path = FIXTURES / edit
        new_path = BENCH
    else:
        base = json.loads(BENCH.read_text())
        new = copy.deepcopy(base)
        if edit is not None:
            edit(base, new)
        base_path.write_text(json.dumps(base))
        new_path.write_text(json.dumps(new))
    argv = [str(base_path), str(new_path)] + extra
    want = _run(ref.main, argv, capsys)
    got = _run(twin.main, argv, capsys)
    assert got == want
    assert want[2] == ["bench_diff: REGRESSION" if want[0] else "bench_diff: ok"]
    if isinstance(edit, str):
        return
    # each edit moves what it names: a regression exactly where one is planted,
    # and a line for every change a tolerance does not hide
    regressed = any(w in name for w in ("past_tol", "removed", "flipped", "everything"))
    assert want[0] == int(regressed), (name, want)
    quiet = name == "identical" or "within" in name or "wider_wall_tol" in name
    assert (len(want[1]) == 1) == quiet, want[1]


def test_twin_keeps_the_reference_names_and_defaults():
    for name in ("cell_key", "_sort_key", "_fmt_key", "_verdict_flipped", "BenchDiff",
                 "diff_reports", "_diff_streaming", "main"):
        assert callable(getattr(twin, name)), name
    assert (twin.DEFAULT_TOL, twin.DEFAULT_WALL_TOL) == (ref.DEFAULT_TOL, ref.DEFAULT_WALL_TOL)


def test_twin_imports_no_jax_and_nothing_of_the_reference():
    tree = ast.parse(pathlib.Path(twin.__file__).read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    assert names <= {"__future__", "argparse", "dataclasses", "pathlib", "sys"}, names


def test_twin_raises_on_duplicate_cells_as_the_reference(tmp_path):
    d = json.loads(BENCH.read_text())
    d["cells"].append(d["cells"][0])
    path = tmp_path / "dup.json"
    path.write_text(json.dumps(d))
    for main in (ref.main, twin.main):
        with pytest.raises(ValueError, match="new report has duplicate cell keys"):
            main([str(BENCH), str(path)])
