"""BENCH-diff: compare two ``BENCH_provision.json`` artifacts cell by cell.

The twin of ``benchmarks/bench_diff.py``: the same names, lines and exit
codes, over the port's :mod:`repro_torch.eval.report` (stdlib only, so it
needs neither JAX nor the reference package).

CI's regression gate for the competitive-ratio trajectory: given the
checked-in baseline and a freshly generated report, key every cell by
``(policy, scenario, noise_std, window, slack, rule)`` (the deferral
coordinates are None on rigid cells, so pre-v3 keys are unchanged) and
flag

- **removed cells** — a grid that silently shrank is a coverage regression;
- **mean-CR increases** beyond ``--tol`` — the empirical ratio drifting up
  means the engine got *worse* at following the offline optimum (common
  random numbers make mean CR deterministic per seed, so any drift is a
  code change, not sampling noise);
- **bound-verdict flips** (``bound_ok``/per-type ``group_bound_ok``/the
  deferral latency ``slo_ok`` true → false) — a paper guarantee or
  latency SLO newly violated.

New cells, CR improvements, verdicts flipping false → true, ``p99_delay``
drift, and per-cell ``wall_ms`` drift beyond ``--wall-tol`` (v4's runtime
column — machine-dependent, so never gated) are informational only.  So is
the whole v5 ``streaming`` section: rows are keyed by ``(policy,
t_chunk)`` and their plan-latency p50/p99 and compile counts are reported
when they move (latency beyond ``--wall-tol``), but wall time on a
benchmark host proves nothing about the engine, so streaming changes never
set the exit status — the zero-steady-state-recompile claim is gated at
generation time by ``python -m repro_torch.eval`` instead.  Exit status 1
on any regression, 0 otherwise::

    PYTHONPATH=src python -m repro_torch.bench.bench_diff baseline.json new.json

Loads via :class:`repro_torch.eval.report.EvalReport`, so a v1/v2/v3 baseline
diffs cleanly against a v4 report (older cells just lack the newer
columns, which the diff treats as absent rather than changed).
"""
from __future__ import annotations

import argparse
import dataclasses
import pathlib
import sys

from ..eval.report import CellResult, EvalReport

#: default tolerance on mean-CR drift before it counts as a regression
DEFAULT_TOL = 1e-6

#: default relative wall_ms drift before a cell is even mentioned (25% —
#: wall clocks are noisy and machine-dependent; this is informational only)
DEFAULT_WALL_TOL = 0.25


def cell_key(c: CellResult) -> tuple:
    return (
        c.policy,
        c.scenario,
        round(float(c.noise_std), 9),
        int(c.window),
        None if c.slack is None else int(c.slack),
        c.rule,
    )


def _sort_key(k: tuple) -> tuple:
    """Total order over cell keys: rigid cells (slack None) sort before
    deferral cells — plain sorted() would choke comparing None with int."""
    policy, scenario, std, window, slack, rule = k
    return (policy, scenario, std, window,
            slack is not None, slack or 0, rule or "")


def _fmt_key(k: tuple) -> str:
    policy, scenario, std, window, slack, rule = k
    base = f"{policy} on {scenario} (std={std:g}, w={window})"
    if slack is not None:
        base += f" defer[{rule} slack={slack}]"
    return base


def _verdict_flipped(old: CellResult, new: CellResult) -> bool:
    """True iff any bound/SLO verdict the baseline passed now fails."""
    if old.bound_ok and not new.bound_ok:
        return True
    if old.group_bound_ok is not None and new.group_bound_ok is not None:
        if any(o and not n for o, n in
               zip(old.group_bound_ok, new.group_bound_ok)):
            return True
    if old.slo_ok is not None and new.slo_ok is not None:
        if old.slo_ok and not new.slo_ok:
            return True
    return False


@dataclasses.dataclass
class BenchDiff:
    """The cell-by-cell comparison of two reports."""

    removed: list[tuple]                               # keys gone from new
    added: list[tuple]                                 # keys new grew
    worse: list[tuple[tuple, float, float]]            # (key, old_cr, new_cr)
    improved: list[tuple[tuple, float, float]]
    flipped: list[tuple]                               # verdict true -> false
    unflipped: list[tuple]                             # verdict false -> true
    latency_drift: list[tuple[tuple, int, int]] = dataclasses.field(
        default_factory=list
    )                                                  # (key, old_p99, new_p99)
    wall_drift: list[tuple[tuple, float, float]] = dataclasses.field(
        default_factory=list
    )                                                  # (key, old_ms, new_ms)
    stream_changed: list[str] = dataclasses.field(
        default_factory=list
    )                                                  # informational lines
    n_common: int = 0

    @property
    def regressed(self) -> bool:
        return bool(self.removed or self.worse or self.flipped)

    def lines(self) -> list[str]:
        out = [f"{self.n_common} common cells, {len(self.added)} added, "
               f"{len(self.removed)} removed"]
        for k in self.removed:
            out.append(f"REGRESSION removed cell: {_fmt_key(k)}")
        for k, old, new in self.worse:
            out.append(
                f"REGRESSION mean CR up: {_fmt_key(k)}: "
                f"{old:.6f} -> {new:.6f} (+{new - old:.2e})"
            )
        for k in self.flipped:
            out.append(f"REGRESSION bound verdict flipped ok->VIOLATED: "
                       f"{_fmt_key(k)}")
        for k in self.added:
            out.append(f"new cell: {_fmt_key(k)}")
        for k, old, new in self.improved:
            out.append(f"improved: {_fmt_key(k)}: {old:.6f} -> {new:.6f}")
        for k in self.unflipped:
            out.append(f"bound verdict recovered: {_fmt_key(k)}")
        for k, old, new in self.latency_drift:
            out.append(f"p99 delay drift: {_fmt_key(k)}: {old} -> {new}")
        for k, old, new in self.wall_drift:
            out.append(
                f"wall_ms drift (informational): {_fmt_key(k)}: "
                f"{old:.1f} -> {new:.1f} ({(new - old) / old:+.0%})"
            )
        out.extend(self.stream_changed)
        return out


def diff_reports(
    baseline: EvalReport,
    new: EvalReport,
    tol: float = DEFAULT_TOL,
    wall_tol: float = DEFAULT_WALL_TOL,
) -> BenchDiff:
    """Compare two reports; ``tol`` is the allowed mean-CR increase and
    ``wall_tol`` the relative wall_ms change worth mentioning."""
    old_cells = {cell_key(c): c for c in baseline.cells}
    new_cells = {cell_key(c): c for c in new.cells}
    if len(old_cells) != len(baseline.cells):
        raise ValueError("baseline report has duplicate cell keys")
    if len(new_cells) != len(new.cells):
        raise ValueError("new report has duplicate cell keys")

    diff = BenchDiff(
        removed=sorted((k for k in old_cells if k not in new_cells),
                       key=_sort_key),
        added=sorted((k for k in new_cells if k not in old_cells),
                     key=_sort_key),
        worse=[], improved=[], flipped=[], unflipped=[],
    )
    for k in sorted(set(old_cells) & set(new_cells), key=_sort_key):
        o, n = old_cells[k], new_cells[k]
        diff.n_common += 1
        if n.mean_cr > o.mean_cr + tol:
            diff.worse.append((k, o.mean_cr, n.mean_cr))
        elif n.mean_cr < o.mean_cr - tol:
            diff.improved.append((k, o.mean_cr, n.mean_cr))
        if _verdict_flipped(o, n):
            diff.flipped.append(k)
        elif _verdict_flipped(n, o):
            diff.unflipped.append(k)
        if (
            o.p99_delay is not None
            and n.p99_delay is not None
            and o.p99_delay != n.p99_delay
        ):
            diff.latency_drift.append((k, o.p99_delay, n.p99_delay))
        if (
            o.wall_ms is not None
            and n.wall_ms is not None
            and o.wall_ms > 0
            and abs(n.wall_ms - o.wall_ms) / o.wall_ms > wall_tol
        ):
            diff.wall_drift.append((k, o.wall_ms, n.wall_ms))
    diff.stream_changed = _diff_streaming(baseline, new, wall_tol)
    return diff


def _diff_streaming(
    baseline: EvalReport, new: EvalReport, wall_tol: float
) -> list[str]:
    """Informational lines for the v5 streaming rows — never a regression.

    Rows are keyed by ``(policy, t_chunk)``; latency drift is mentioned
    past ``wall_tol`` (relative, on p50), compile-count changes always.
    """
    old_rows = {(r.policy, r.t_chunk): r for r in (baseline.streaming or [])}
    new_rows = {(r.policy, r.t_chunk): r for r in (new.streaming or [])}
    lines = []
    for key in sorted(set(old_rows) - set(new_rows)):
        lines.append(
            f"streaming row gone (informational): {key[0]} t_chunk={key[1]}"
        )
    for key in sorted(set(new_rows) - set(old_rows)):
        lines.append(f"new streaming row: {key[0]} t_chunk={key[1]}")
    for key in sorted(set(old_rows) & set(new_rows)):
        o, n = old_rows[key], new_rows[key]
        tag = f"{key[0]} t_chunk={key[1]}"
        if o.compiles != n.compiles:
            lines.append(
                f"streaming compiles changed (informational): {tag}: "
                f"{o.compiles} -> {n.compiles}"
            )
        if (
            o.p50_ms is not None
            and n.p50_ms is not None
            and o.p50_ms > 0
            and abs(n.p50_ms - o.p50_ms) / o.p50_ms > wall_tol
        ):
            lines.append(
                f"streaming latency drift (informational): {tag}: "
                f"p50 {o.p50_ms:.2f} -> {n.p50_ms:.2f} ms, "
                f"p99 {o.p99_ms:.2f} -> {n.p99_ms:.2f} ms"
            )
    return lines


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("baseline", type=pathlib.Path,
                    help="the reference BENCH_provision.json")
    ap.add_argument("new", type=pathlib.Path,
                    help="the freshly generated report to gate")
    ap.add_argument("--tol", type=float, default=DEFAULT_TOL,
                    help="allowed mean-CR increase per cell "
                         f"(default {DEFAULT_TOL:g})")
    ap.add_argument("--wall-tol", type=float, default=DEFAULT_WALL_TOL,
                    help="relative wall_ms drift worth reporting, never gated "
                         f"(default {DEFAULT_WALL_TOL:g})")
    args = ap.parse_args(argv)

    diff = diff_reports(
        EvalReport.load(args.baseline), EvalReport.load(args.new),
        tol=args.tol, wall_tol=args.wall_tol,
    )
    for line in diff.lines():
        print(line)
    if diff.regressed:
        print("bench_diff: REGRESSION", file=sys.stderr)
        return 1
    print("bench_diff: ok", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
