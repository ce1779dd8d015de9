"""Competitive-ratio evaluation CLI: the paper's claims as a JSON artifact.

Runs :func:`repro_torch.eval.evaluate` over the scenario library on the
card and writes the :class:`~repro_torch.eval.report.EvalReport` (the
reference's ``repro.eval/v5`` schema, so ``benchmarks/bench_diff.py`` diffs
it against ``BENCH_provision.json``)::

    PYTHONPATH=src python -m repro_torch.eval --smoke              # the card
    PYTHONPATH=src python -m repro_torch.eval --smoke --device cpu  # the CPU
    PYTHONPATH=src python -m repro_torch.eval --out build/full.json  # full grid
    PYTHONPATH=src python -m repro_torch.eval --smoke --profile build/prof

Without CUDA it exits non-zero unless given ``--device cpu``; it never
falls back to the CPU.  The grids are the reference's (``benchmarks/
cr_eval.py``): both carry ``TYPED_GROUPS`` (AQ-det/AQ-rand on a
two-generation fleet) and sweep ``DEFERRAL_SLACKS``.  The run fails if a
cell violates its paper bound beyond the grid tolerance, if an AQ-det
typed cell lacks the 2d bound, if the deferral block has the wrong cell
count or a latency-SLO violation, or if the widest slack costs more than
rigid; and, as the reference's recompile gates, if the grid builds more
kernel libraries than it needs (one: K1 and K2's) or a warmed re-run of it
builds any.

``--smoke`` first runs the reference CLI's mesh smoke (:func:`mesh_smoke`):
a small grid through ``EvalGrid(mesh=...)`` in a world of one process
(NCCL on ``--device cuda``, gloo on ``--device cpu``) must give the plain
evaluate's cells, with exactly one K2 launch per block on the card.

Both legs also record the v5 ``streaming`` section
(:func:`streaming_latency`): ``FleetProvisioner.advance()`` driven at
T_chunk ∈ {1, 64, 1024} on the CLI's device, its plan-latency p50/p99 from
``PlanMetrics``, and a hard gate that the warmed loop builds nothing (the
stepper's steady-state claim).  ``--profile DIR`` wraps the run in
``torch.profiler`` and writes ``DIR/trace.json``.
"""
from __future__ import annotations

import argparse
import dataclasses
import pathlib
import sys

import numpy as np
import torch

from ..core import PAPER_COSTS, ServerGroup
from ..distributed.world import run_world
from ..kernels._build import load_provision_scan
from ..lint import tracer_sanitizer
from ..obs import profile_to, telemetry_session
from ..scenarios import Scenario
from ..serving import FleetProvisioner, PlanMetrics
from .harness import EvalGrid, evaluate
from .report import EvalReport, StreamingRow

#: the repository root (``src/repro_torch/eval/__main__.py`` is 3 levels in)
ROOT = pathlib.Path(__file__).resolve().parents[3]

#: the benchmark's heterogeneous fleet: two server generations (Albers–
#: Quedenfeld d=2).  "efficient" is the paper's normalized server; "legacy"
#: burns 1.5× the power with proportionally pricier toggles (same Δ).
TYPED_GROUPS = (
    ServerGroup("efficient", 96, P=1.0, beta_on=3.0, beta_off=3.0),
    ServerGroup("legacy", 96, P=1.5, beta_on=4.5, beta_off=4.5),
)

#: the deferral-slack sweep (slots): 0 is the rigid fixed point, the rest
#: trace the cost-vs-slack curve
DEFERRAL_SLACKS = (0, 2, 6, 12)

#: the serving-loop chunk sizes the streaming section measures — one slot
#: at a time (the latency floor), a typical scrape interval, and a bulk
#: backfill chunk
STREAM_CHUNKS = (1, 64, 1024)

SMOKE_GRID = EvalGrid(
    noise_stds=(0.0, 0.2),
    windows=(0, 2, 4),
    n_traces=4,
    n_slots=288,
    typed_groups=TYPED_GROUPS,
    deferral_slacks=DEFERRAL_SLACKS,
)

FULL_GRID = EvalGrid(
    noise_stds=(0.0, 0.1, 0.25, 0.5),
    windows=(0, 1, 2, 3, 4, 5),
    n_traces=16,
    typed_groups=TYPED_GROUPS,
    deferral_slacks=DEFERRAL_SLACKS,
)


#: the reference CLI's mesh smoke grid (``benchmarks/cr_eval.py``'s ``mesh_smoke``)
MESH_SMOKE_GRID = EvalGrid(
    policies=("A1",),
    scenarios=(Scenario("sinusoidal", target_pmr=4.0, mean_jobs=16.0),),
    noise_stds=(0.0, 0.2),
    windows=(0, 2),
    n_traces=2,
    n_slots=144,
)


def mesh_rank(mesh, grid: EvalGrid) -> dict:
    """One rank of the mesh smoke (a :func:`run_world` target): ``grid``
    evaluated on ``mesh``, with this rank's K2 launches (the
    ``kernels/provision_scan_stream_launches`` counter)."""
    with telemetry_session() as tel:
        report = evaluate(dataclasses.replace(grid, mesh=mesh))
    return {"cells": report.cells, "mesh": report.grid["mesh"],
            "launches": int(tel.counter_value("kernels/provision_scan_stream_launches"))}


def mesh_smoke(device: str, grid: EvalGrid = MESH_SMOKE_GRID) -> dict:
    """The reference CLI's mesh smoke on the port: ``grid`` evaluated in a
    world of one process over ``EvalGrid(mesh=...)`` (NCCL on CUDA, gloo on
    the CPU) must reproduce the plain evaluate's cells exactly, and, where
    the reference gates one sharded compile for the block, launch K2 exactly
    once per (policy, scenario) block on the card (none on the CPU, where
    no kernel runs).  Returns the rank's result."""
    grid = dataclasses.replace(grid, device=device)
    plain = evaluate(grid)
    meshed = run_world("repro_torch.eval.__main__:mesh_rank", 1, device=device,
                       payload=grid)[0]
    if meshed["cells"] != plain.cells:
        raise AssertionError(
            "mesh-route eval cells diverge from the single-device route: the "
            "mesh route is supposed to be bit-exact")
    blocks = len(grid.policies) * len(grid.scenarios)
    want = blocks if torch.device(device).type == "cuda" else 0
    if meshed["launches"] != want:
        raise AssertionError(
            f"mesh smoke: {meshed['launches']} K2 launches for {blocks} block(s), "
            f"expected {want}")
    print(f"# mesh smoke: {len(plain.cells)} cells bit-exact through the mesh route "
          f"({meshed['mesh']}), {meshed['launches']} K2 launch(es)", file=sys.stderr)
    return meshed


def check_gates(report: EvalReport) -> None:
    """The reference CLI's result gates (``benchmarks/cr_eval.py``'s
    ``run``), without its recompile gates: raise AssertionError naming the
    cells at fault."""
    if not report.bounds_ok:
        lines = "\n".join(
            f"  {c.policy} on {c.scenario} (std={c.noise_std:g}, w={c.window}"
            f"{'' if c.slack is None else f', slack={c.slack}'}): "
            f"mean CR {c.mean_cr:.4f} vs bound {c.bound}, slo_ok={c.slo_ok}, "
            f"group_bound_ok={c.group_bound_ok}"
            for c in report.violations()
        )
        raise AssertionError(f"paper-bound violations:\n{lines}")
    if report.grid.get("typed_groups"):
        d = len(report.grid["typed_groups"])
        det = [c for c in report.cells
               if c.group_mean_cr is not None and c.policy == "AQ-det"]
        if not det:
            raise AssertionError(
                "grid declares typed_groups but produced no AQ-det multi-type cell"
            )
        off = [c for c in det if c.bound != 2.0 * d]
        if off:
            raise AssertionError(
                f"AQ-det typed cells must carry the 2d = {2.0 * d:g} "
                f"aggregate bound, got {sorted({c.bound for c in off})}"
            )
    if report.grid.get("deferral_slacks"):
        dcells = [c for c in report.cells if c.slack is not None]
        want = (
            len(report.grid["deferral_slacks"])
            * len(report.grid["deferral_policies"])
            * len(report.grid["scenario_labels"])
        )
        if len(dcells) != want:
            raise AssertionError(
                f"grid declares deferral_slacks but produced "
                f"{len(dcells)} deferral cells, expected {want}"
            )
        bad_slo = [c for c in dcells if not c.slo_ok]
        if bad_slo:
            lines = "\n".join(
                f"  {c.policy} on {c.scenario} slack={c.slack}: "
                f"p99={c.p99_delay} misses={c.deadline_misses}"
                for c in bad_slo
            )
            raise AssertionError(f"latency-SLO violations:\n{lines}")
        # the slack axis must actually buy something: per (policy,
        # scenario), the widest-slack cell may not cost more than rigid
        by_ps: dict[tuple, list] = {}
        for c in dcells:
            by_ps.setdefault((c.policy, c.scenario), []).append(c)
        for (policy, scenario), cs in by_ps.items():
            cs = sorted(cs, key=lambda c: c.slack)
            if cs[-1].mean_cost > cs[0].mean_cost:
                raise AssertionError(
                    f"deferral bought nothing: {policy} on {scenario} "
                    f"costs {cs[0].mean_cost:.1f} rigid but "
                    f"{cs[-1].mean_cost:.1f} at slack={cs[-1].slack}"
                )


def streaming_latency(smoke: bool, device: str) -> list[StreamingRow]:
    """The v5 ``streaming`` section, as the reference CLI measures it: drive
    ``FleetProvisioner.advance()`` (A1, 64 replicas, demand in [0, 48) from
    ``default_rng(0)``) at each ``STREAM_CHUNKS`` size on ``device``, record
    the plan-latency p50/p99 through ``PlanMetrics``, and gate the
    zero-steady-state-build claim — after the warmup call has loaded the
    kernel library, the measured loop must build nothing."""
    rows = []
    rng = np.random.default_rng(0)
    for t_chunk in STREAM_CHUNKS:
        chunks = min(32, max(4, (256 if smoke else 8192) // t_chunk))
        demand = rng.integers(0, 48, size=((chunks + 1) * t_chunk,))
        prov = FleetProvisioner(PAPER_COSTS, policy="A1", max_replicas=64, device=device)
        prov.advance(demand[:t_chunk])      # warmup: loads the library on the card
        prov.metrics = PlanMetrics()
        # hard zero-build gate on the warmed steady state (RecompileError on
        # violation), while watch.added still feeds the report row
        with tracer_sanitizer(fns=(load_provision_scan,)) as watch:
            for i in range(1, chunks + 1):
                prov.advance(demand[i * t_chunk:(i + 1) * t_chunk])
        rows.append(StreamingRow(
            policy="A1", t_chunk=t_chunk, chunks=chunks,
            slots=chunks * t_chunk, compiles=watch.added,
            p50_ms=prov.metrics.latency_quantile(0.5),
            p99_ms=prov.metrics.latency_quantile(0.99),
        ))
    print(
        "# streaming: " + "; ".join(
            f"t_chunk={r.t_chunk} p50={r.p50_ms:.2f}ms p99={r.p99_ms:.2f}ms "
            f"compiles={r.compiles}" for r in rows
        ),
        file=sys.stderr,
    )
    return rows


def run(grid: EvalGrid, out: pathlib.Path, streaming: list | None = None) -> EvalReport:
    """Evaluate ``grid`` with the ``streaming`` rows, evaluate it again warmed,
    write the report to ``out`` (also when a gate fails: that is when the
    per-cell diagnostics are needed), then gate it."""
    report = evaluate(grid)
    report.streaming = streaming
    try:
        # the grid again: its kernel library is loaded, so nothing may build
        second = evaluate(grid)
        if second.jit_entries_added > 0:
            raise AssertionError(
                f"warmed re-run built {second.jit_entries_added} kernel library(ies): "
                "a loader lost its cache"
            )
        if report.jit_entries_added > report.expected_compiles:
            raise AssertionError(
                f"the grid built {report.jit_entries_added} kernel libraries, expected "
                f"at most {report.expected_compiles} (K1 and K2's)"
            )
        check_gates(report)
    finally:
        out.parent.mkdir(parents=True, exist_ok=True)
        report.save(out)
    return report


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--smoke", action="store_true",
                    help="the small grid (4 traces of 288 slots, 144 cells)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the grid runs (default: the card)")
    ap.add_argument("--out", type=pathlib.Path,
                    default=ROOT / "build" / "BENCH_torch_provision.json",
                    help="report path (default: build/BENCH_torch_provision.json)")
    ap.add_argument("--profile", type=pathlib.Path, default=None, metavar="DIR",
                    help="wrap the run in torch.profiler; write DIR/trace.json")
    return ap


def main(argv: list[str] | None = None) -> int:
    args = parser().parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("repro_torch.eval: CUDA is not available; pass --device cpu to "
              "evaluate on the CPU", file=sys.stderr)
        return 2
    grid = dataclasses.replace(SMOKE_GRID if args.smoke else FULL_GRID, device=args.device)
    with profile_to(args.profile):
        if args.smoke:
            mesh_smoke(args.device)
        rows = streaming_latency(args.smoke, args.device)
        report = run(grid, args.out, streaming=rows)
    for line in report.summary_lines():
        print(line)
    worst = report.worst(1)[0]
    kind = torch.cuda.get_device_name(0) if args.device == "cuda" else "cpu"
    print(
        f"# {len(report.cells)} cells ({'smoke' if args.smoke else 'full'}), "
        f"device={kind}, {report.elapsed_s:.1f}s, "
        f"compiles={report.jit_entries_added}/{report.expected_compiles}, "
        f"streaming rows: {len(rows)} (t_chunk "
        f"{', '.join(str(r.t_chunk) for r in rows)}, compiles "
        f"{sum(r.compiles for r in rows)}), "
        f"tightest cell: {worst.policy} on {worst.scenario} "
        f"(mean CR {worst.mean_cr:.4f} vs bound {worst.bound:.4f})",
        file=sys.stderr,
    )
    print(f"# wrote {args.out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
