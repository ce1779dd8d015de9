"""The evaluation report schema: one JSON artifact per competitive-ratio run.

``EvalReport`` is the serialized deliverable of
:func:`repro_torch.eval.evaluate` — the same schema as the reference's
``BENCH_provision.json``, so :mod:`repro_torch.bench.bench_diff` (and the
reference's ``benchmarks/bench_diff.py``) reads the port's reports
unchanged.  A copy of ``repro.eval.report`` (stdlib only).  It is plain
dataclasses + ``json`` so the artifact diffs cleanly across PRs and loads
without JAX: every (policy, scenario, noise_std, window) grid cell carries
its empirical competitive-ratio statistics against the offline optimum and
the paper-bound verdict.  ``schema`` is versioned; bump it when a field
changes meaning, not when fields are appended.

v2 adds (all backward-compatible, defaulted on v1 loads): the per-cell CR
distribution (``p50_cr`` plus ``cr_quantiles``, the ratio values at the
fixed :data:`CR_QUANTILES` probabilities) and the typed-fleet columns
(``group_names``/``group_mean_cr``/``group_bound``/``group_bound_ok`` —
per-server-type CR statistics and verdicts, None on untyped cells).

v3 adds the deferral-slack columns (None on rigid cells and on loaded
v1/v2 artifacts): ``slack``/``rule`` identify a deferral cell (slack in
slots, queue dispatch rule), ``max_delay``/``p99_delay`` are the worst
per-trace queueing delays, ``deadline_misses`` the total expired units
over the batch, and ``slo_ok`` the latency-SLO verdict — no deadline
misses and p99 delay within the granted slack.

v4 adds the runtime-health columns ``wall_ms`` (wall-clock of the cell's
provision call, host-side, ms) and ``compiles`` (jitted engine programs
the call added, via ``repro.obs.jaxwatch.CompileWatcher``; -1 when the
cache API is unobservable — the port writes -1 until it has a compile
watcher of its own).  Both are *runtime* facts, not results: they
are excluded from cell equality (``compare=False``) so determinism checks
— same grid, same cells — keep holding across machines, and they are None
on cells loaded from v1–v3 artifacts.  Cells produced by one device
program (a shared (noise × window) sweep) report the program's totals on
each of its cells.

v5 adds the report-level ``streaming`` section: one :class:`StreamingRow`
per serving chunk size, recording the ``FleetProvisioner.advance()``
stepper's plan-latency p50/p99 and the number of jit traces the whole
chunked loop needed (the steady-state-zero-recompiles claim, gated) at
T_chunk ∈ {1, 64, 1024}.  The latency columns are wall-clock facts
(``compare=False``, diffed informationally by ``bench_diff.py`` — never
gated); ``compiles``/``chunks``/``slots`` are results.  ``streaming`` is
None on artifacts loaded from v1–v4.  :meth:`EvalReport.load` still reads
every older version (pinned by ``tests/fixtures/report_v*.json``).
"""
from __future__ import annotations

import dataclasses
import json
import pathlib

SCHEMA = "repro.eval/v5"
SCHEMA_V4 = "repro.eval/v4"
SCHEMA_V3 = "repro.eval/v3"
SCHEMA_V2 = "repro.eval/v2"
SCHEMA_V1 = "repro.eval/v1"

#: the fixed probabilities ``CellResult.cr_quantiles`` reports CR values at
CR_QUANTILES = (0.05, 0.25, 0.5, 0.75, 0.95)


@dataclasses.dataclass(frozen=True)
class CellResult:
    """One grid cell: a (policy, scenario, noise_std, window) combination.

    ``mean_cr``/``p95_cr``/``max_cr`` are statistics of the per-trace ratio
    ``cost / offline_cost`` over the scenario's trace batch.  ``bound`` is
    the paper's worst-case ratio at this cell's α (``None`` when the policy
    has no stated bound), and ``bound_ok`` is the verdict
    ``mean_cr <= bound + tol + noise_slack * noise_std`` (the grid's slack
    for sampling error and prediction noise) — an *expectation* check: the randomized
    A2/A3 guarantee their ratio in expectation only, so the mean (not the
    max) is what the paper promises.

    ``p50_cr``/``cr_quantiles``: the per-trace CR distribution — the median
    plus the values at the fixed :data:`CR_QUANTILES` probabilities (None
    on cells loaded from v1 artifacts).  Typed-fleet cells additionally
    carry per-server-type columns: ``group_names`` (routing-priority
    order), ``group_mean_cr`` (mean of per-type cost over per-type offline
    cost), ``group_bound`` (the per-type ski-rental bound: 2 for AQ-det,
    e/(e−1) for AQ-rand) and ``group_bound_ok`` verdicts; the cell-level
    ``bound`` is the aggregate Albers–Quedenfeld guarantee (2d / d·e/(e−1)).

    Deferral cells (v3) carry ``slack`` (slots of deferral granted),
    ``rule`` (queue dispatch rule), the latency statistics ``max_delay`` /
    ``p99_delay`` (worst per-trace values, in slots) and
    ``deadline_misses`` (total expired units over the batch), plus the
    SLO verdict ``slo_ok``: True iff no unit missed its deadline and the
    p99 queueing delay stayed within the granted slack.  All None on
    rigid cells.

    ``wall_ms``/``compiles`` (v4) are runtime health, not results —
    ``compare=False`` keeps them out of ``==`` so two runs of the same grid
    still produce *equal* cells (the determinism and mesh-vs-plain gates
    compare whole cell lists).  None on cells from pre-v4 artifacts.
    """

    policy: str
    scenario: str
    noise_std: float
    window: int
    alpha: float
    bound: float | None
    mean_cr: float
    p95_cr: float
    max_cr: float
    mean_cost: float
    mean_opt_cost: float
    bound_ok: bool
    p50_cr: float | None = None
    cr_quantiles: list[float] | None = None
    group_names: list[str] | None = None
    group_mean_cr: list[float] | None = None
    group_bound: list[float] | None = None
    group_bound_ok: list[bool] | None = None
    slack: int | None = None
    rule: str | None = None
    max_delay: int | None = None
    p99_delay: int | None = None
    deadline_misses: int | None = None
    slo_ok: bool | None = None
    wall_ms: float | None = dataclasses.field(default=None, compare=False)
    compiles: int | None = dataclasses.field(default=None, compare=False)


@dataclasses.dataclass(frozen=True)
class StreamingRow:
    """One serving-loop measurement: ``FleetProvisioner.advance()`` driven
    at a fixed ``t_chunk`` for ``chunks`` chunks (``slots`` demand slots
    total, after a warmup chunk).  ``p50_ms``/``p99_ms`` are the stepper's
    per-call plan latencies from :class:`repro.serving.metrics.PlanMetrics`
    — wall-clock facts, excluded from equality and never gated.
    ``compiles`` counts jit traces the measured loop added: 0 is the
    steady-state claim (the warmup call owns the bucket's trace)."""

    policy: str
    t_chunk: int
    chunks: int
    slots: int
    compiles: int
    p50_ms: float | None = dataclasses.field(default=None, compare=False)
    p99_ms: float | None = dataclasses.field(default=None, compare=False)


@dataclasses.dataclass
class EvalReport:
    """The full grid's results plus enough metadata to reproduce them."""

    grid: dict
    cells: list[CellResult]
    backend: str
    jit_entries_added: int
    expected_compiles: int
    elapsed_s: float
    schema: str = SCHEMA
    streaming: list[StreamingRow] | None = None

    @property
    def bounds_ok(self) -> bool:
        """True iff every cell's empirical CR respects its paper bound —
        including, on typed cells, every per-server-type verdict, and on
        deferral cells the latency-SLO verdict."""
        return all(
            c.bound_ok
            and (c.group_bound_ok is None or all(c.group_bound_ok))
            and (c.slo_ok is None or c.slo_ok)
            for c in self.cells
        )

    def violations(self) -> list[CellResult]:
        return [
            c for c in self.cells
            if not c.bound_ok
            or (c.group_bound_ok is not None and not all(c.group_bound_ok))
            or (c.slo_ok is not None and not c.slo_ok)
        ]

    def threshold(self, c: CellResult) -> float | None:
        """The value ``bound_ok`` compared ``mean_cr`` against: the paper
        bound plus the grid's sampling tolerance and per-std noise slack."""
        if c.bound is None:
            return None
        return (
            c.bound
            + float(self.grid.get("tol", 0.0))
            + float(self.grid.get("noise_slack", 0.0)) * c.noise_std
        )

    def worst(self, n: int = 5) -> list[CellResult]:
        """The ``n`` cells with the least slack to their *effective*
        threshold (the same one ``bound_ok`` used), tightest first;
        boundless cells sort by raw mean CR."""
        def slack(c: CellResult) -> float:
            t = self.threshold(c)
            return (t - c.mean_cr) if t is not None else -c.mean_cr

        return sorted(self.cells, key=slack)[:n]

    def to_dict(self) -> dict:
        d = {
            "schema": self.schema,
            "grid": self.grid,
            "backend": self.backend,
            "jit_entries_added": self.jit_entries_added,
            "expected_compiles": self.expected_compiles,
            "elapsed_s": self.elapsed_s,
            "bounds_ok": self.bounds_ok,
            "cells": [dataclasses.asdict(c) for c in self.cells],
        }
        if self.streaming is not None:
            d["streaming"] = [dataclasses.asdict(r) for r in self.streaming]
        return d

    def save(self, path: str | pathlib.Path) -> pathlib.Path:
        path = pathlib.Path(path)
        path.write_text(json.dumps(self.to_dict(), indent=2) + "\n")
        return path

    @classmethod
    def from_dict(cls, d: dict) -> "EvalReport":
        # v1-v4 artifacts load as-is: the newer fields are all defaulted,
        # so an older cell dict simply leaves them None (back-compat
        # contract, pinned by tests/fixtures/report_v*.json)
        readable = (SCHEMA, SCHEMA_V4, SCHEMA_V3, SCHEMA_V2, SCHEMA_V1)
        if d.get("schema") not in readable:
            raise ValueError(
                f"report schema {d.get('schema')!r} != expected {SCHEMA!r} "
                f"(or the readable {', '.join(map(repr, readable[1:]))})"
            )
        return cls(
            grid=d["grid"],
            cells=[CellResult(**c) for c in d["cells"]],
            backend=d["backend"],
            jit_entries_added=d["jit_entries_added"],
            expected_compiles=d["expected_compiles"],
            elapsed_s=d["elapsed_s"],
            schema=d["schema"],
            streaming=(
                None if d.get("streaming") is None
                else [StreamingRow(**r) for r in d["streaming"]]
            ),
        )

    @classmethod
    def load(cls, path: str | pathlib.Path) -> "EvalReport":
        return cls.from_dict(json.loads(pathlib.Path(path).read_text()))

    def summary_lines(self) -> list[str]:
        """Human-readable per-cell table (policy-major, CSV-ish)."""
        lines = ["policy,scenario,noise,window,alpha,mean_cr,p50_cr,p95_cr,bound,ok"]
        for c in self.cells:
            b = "-" if c.bound is None else f"{c.bound:.4f}"
            p50 = "-" if c.p50_cr is None else f"{c.p50_cr:.4f}"
            line = (
                f"{c.policy},{c.scenario},{c.noise_std:g},{c.window},"
                f"{c.alpha:.2f},{c.mean_cr:.4f},{p50},{c.p95_cr:.4f},{b},"
                f"{'ok' if c.bound_ok else 'VIOLATED'}"
            )
            if c.group_mean_cr is not None:
                per_type = " ".join(
                    f"{n}={v:.3f}{'' if ok else '!'}" for n, v, ok in
                    zip(c.group_names, c.group_mean_cr, c.group_bound_ok)
                )
                line += f",types[{per_type}]"
            if c.slo_ok is not None:
                line += (
                    f",defer[{c.rule} slack={c.slack} p99={c.p99_delay} "
                    f"miss={c.deadline_misses} "
                    f"{'slo_ok' if c.slo_ok else 'SLO_VIOLATED'}]"
                )
            lines.append(line)
        if self.streaming:
            lines.append(
                "streaming: policy,t_chunk,chunks,slots,p50_ms,p99_ms,compiles"
            )
            for r in self.streaming:
                p50 = "-" if r.p50_ms is None else f"{r.p50_ms:.3f}"
                p99 = "-" if r.p99_ms is None else f"{r.p99_ms:.3f}"
                lines.append(
                    f"streaming: {r.policy},{r.t_chunk},{r.chunks},{r.slots},"
                    f"{p50},{p99},{r.compiles}"
                )
        return lines
