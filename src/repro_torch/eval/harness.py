"""Batched competitive-ratio evaluation: the paper's headline claims as a grid.

The PyTorch port of ``repro.eval.harness``.  ``evaluate(EvalGrid(...))``
measures every (policy × scenario × noise-std × window) cell's empirical
competitive ratio against the offline optimum and checks it against the
paper's worst-case bounds — A1 ≤ 2−α, A2 ≤ (e−α)/(e−1) and A3 ≤ e/(e−1+α)
*in expectation* (Theorems 2–4), delayed-off ≤ 2 — within a statistical
tolerance.

``EvalGrid.typed_groups`` adds a typed-fleet block: per scenario, each
``typed_policies`` entry (the Albers–Quedenfeld ``AQ-det``/``AQ-rand``) runs
on the d-type fleet ``CostModel.from_groups(*groups)`` and is checked
against the aggregate 2d (deterministic) or d·e/(e−1) (randomized)
guarantee, with per-server-type CR columns checked against the per-type
ski-rental bounds.  ``EvalGrid.deferral_slacks`` adds the deferral block:
the defer-then-provision path per (policy × scenario × slack), gated on the
latency-SLO verdict too.

The grid runs on ``EvalGrid.device`` (the card by default): one
``provision(spec)`` call per (policy, scenario) covers the whole
``(S, W, B)`` block through the ``PredictionNoise.std_frac`` sweep axis and
``PolicySpec.windows`` — on CUDA one launch of kernel K2 — and so does
each typed and deferral cell; the offline baselines are the closed form.
Common random numbers throughout: trace ``i`` is identical in every cell,
the noise sweep shares its normal draws across std levels, and the α-sweep
shares its wait uniforms across windows.  The draws come from
``torch.Generator``\\ s on the grid's device, seeded from ``EvalGrid.seed``
with the reference's offsets (+0 policy, +1 noise, +2 typed, +3 deferral)
and the policy or scenario index; ``evaluate(grid, draws=...)`` injects
them instead (:class:`Draws`), which is how the port's cells are held to
the reference's on the same numbers.

The result serializes through :class:`repro_torch.eval.report.EvalReport`
(``python -m repro_torch.eval``).  The port's compile step is building a
kernel library (:mod:`repro_torch.obs.torchwatch`), so ``compiles`` counts
the libraries a cell's call built, ``jit_entries_added`` those the whole
grid built, and ``expected_compiles`` is 1: one library holds K1 and K2, and
the grid needs no other.  A warmed run builds nothing; on the CPU nothing is
ever built.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Protocol

import numpy as np
import torch

from ..core import (
    PAPER_COSTS,
    CostModel,
    PolicySpec,
    PredictionNoise,
    ProvisionSpec,
    ServerGroup,
    Workload,
    provision,
    theoretical_ratio,
)
from ..core.torch_provision import KEYED
from ..core.traces import WEEK_SLOTS
from ..deferral import RULES, DeferralSpec
from ..obs.telemetry import get_telemetry
from ..obs.torchwatch import CompileWatcher, engine_cache_size
from ..scenarios import DEFAULT_SCENARIOS, Scenario, generate
from .report import CR_QUANTILES, CellResult, EvalReport

#: typed-fleet policies the harness knows bounds for (Albers–Quedenfeld)
TYPED_POLICIES = ("AQ-det", "AQ-rand")

#: the reference's seed offsets of each random stream
POLICY_STREAM, NOISE_STREAM, TYPED_STREAM, DEFERRAL_STREAM = 0, 1, 2, 3


@dataclasses.dataclass(frozen=True, eq=False)
class EvalGrid:
    """The declarative input of one evaluation run.

    ``costs`` must be homogeneous (scalar fields): the paper's bounds are
    stated for one Δ.  ``tol`` is the statistical slack on the
    *expectation* bound checks, and a noisy cell must satisfy
    ``mean_cr <= bound + tol + noise_slack * noise_std`` (the paper's bounds
    assume exact predictions).

    ``typed_groups``: optional :class:`~repro_torch.core.ServerGroup` tuple —
    a d-type fleet evaluated per scenario (no noise/window axes: the AQ
    policies never peek), one cell per ``typed_policies`` entry.

    ``deferral_slacks``: optional slack sweep (slots) — one deferral cell per
    (``deferral_policies`` entry × scenario × slack), each running the
    defer-then-provision path (rule ``deferral_rule``) at window 0 with
    exact predictions, its CR measured against the offline optimum on the
    deferred profile and its latency in the ``slo_ok`` verdict.

    ``device``: where every ``provision()`` call and every draw runs —
    ``"cuda"`` (kernel K2) or ``"cpu"`` (the plain scan).
    """

    policies: tuple[str, ...] = ("A1", "A2", "A3")
    scenarios: tuple[Scenario, ...] = DEFAULT_SCENARIOS
    noise_stds: tuple[float, ...] = (0.0,)
    windows: tuple[int, ...] = (0, 1, 2, 3, 4, 5)
    n_traces: int = 16
    n_slots: int = WEEK_SLOTS
    costs: CostModel = PAPER_COSTS
    seed: int = 0
    tol: float = 0.05
    noise_slack: float = 0.5
    typed_groups: tuple[ServerGroup, ...] | None = None
    typed_policies: tuple[str, ...] = TYPED_POLICIES
    deferral_slacks: tuple[int, ...] | None = None
    deferral_rule: str = "EDF"
    deferral_policies: tuple[str, ...] = ("A1",)
    device: str = "cuda"

    def validate(self) -> "EvalGrid":
        if self.costs.is_heterogeneous:
            raise ValueError(
                "EvalGrid needs a homogeneous CostModel: competitive-ratio "
                "bounds are per-Δ, and a per-level model has no single α "
                "(typed fleets go through typed_groups=, which carries the "
                "per-type structure the bounds need)"
            )
        if self.typed_groups is not None:
            if not self.typed_groups:
                raise ValueError("typed_groups needs at least one ServerGroup")
            for g in self.typed_groups:
                g.validate()
            unknown = [p for p in self.typed_policies if p not in TYPED_POLICIES]
            if unknown or not self.typed_policies:
                raise ValueError(
                    f"typed_policies must be drawn from {TYPED_POLICIES}, "
                    f"got {self.typed_policies}"
                )
        if not self.policies or not self.scenarios:
            raise ValueError("EvalGrid needs at least one policy and scenario")
        if any(w < 0 for w in self.windows) or not self.windows:
            raise ValueError(f"windows must be non-negative, got {self.windows}")
        if any(s < 0 for s in self.noise_stds) or not self.noise_stds:
            raise ValueError(
                f"noise_stds must be non-negative, got {self.noise_stds}"
            )
        if self.deferral_slacks is not None:
            if not self.deferral_slacks or any(
                k < 0 for k in self.deferral_slacks
            ):
                raise ValueError(
                    "deferral_slacks must be a non-empty tuple of "
                    f"non-negative slot counts, got {self.deferral_slacks}"
                )
            if self.deferral_rule not in RULES:
                raise ValueError(
                    f"deferral_rule must be one of {RULES}, "
                    f"got {self.deferral_rule!r}"
                )
            bad = [p for p in self.deferral_policies
                   if p == "offline" or _bound(p, 1.0) is None]
            if bad or not self.deferral_policies:
                raise ValueError(
                    "deferral_policies must be online policies with a "
                    f"stated bound, got {self.deferral_policies}"
                )
        return self


class Draws(Protocol):
    """The random numbers of one evaluation, injected.

    ``normals(scenario_index, (B, T))``: the prediction-noise normals of one
    scenario, shared across its noise levels.  ``uniforms(stream,
    policy_index, (B, T, N))``: the two wait-uniform tables ``(u0, u)`` of
    one block of a keyed policy, ``stream`` being ``POLICY_STREAM`` (one
    per policy, shared across windows and scenarios), ``TYPED_STREAM`` or
    ``DEFERRAL_STREAM``.  Arrays or tensors; they are moved to the grid's
    device.
    """

    def normals(self, scenario_index: int, shape: tuple[int, int]): ...

    def uniforms(self, stream: int, policy_index: int,
                 shape: tuple[int, int, int]): ...


def _generator(device: torch.device, seed: int, stream: int, index: int) -> torch.Generator:
    """A fresh generator for one (stream, index) of the grid's seed: every
    block draws from its own, so a block's draws do not depend on which
    blocks ran before it.  The triple is hashed into 32 bits, all that the
    CPU generator keeps of a seed."""
    entropy = [(seed + stream) % 2**64, index]
    state = np.random.SeedSequence(entropy).generate_state(1, np.uint32)[0]
    return torch.Generator(device=device).manual_seed(int(state))


def _policy(grid: EvalGrid, draws, device, stream: int, index: int, name: str,
            shape: tuple[int, int, int], **kw) -> PolicySpec:
    """``PolicySpec(name)`` with its wait uniforms, when the policy draws."""
    if name not in KEYED:
        return PolicySpec(name, **kw)
    if draws is None:
        return PolicySpec(name, generator=_generator(device, grid.seed, stream, index), **kw)
    u0, u = draws.uniforms(stream, index, shape)
    return PolicySpec(name, uniforms=(_float32(u0, device), _float32(u, device)), **kw)


def _float32(v, device: torch.device) -> torch.Tensor:
    """An injected draw (array or tensor) as a float32 tensor on ``device``."""
    if not isinstance(v, torch.Tensor):
        v = torch.as_tensor(np.asarray(v, np.float32))
    return v.to(device=device, dtype=torch.float32)


def _timed(label: str, fn, device: torch.device, **span_labels):
    """Run ``fn`` under a telemetry span, waiting for the card on CUDA.

    Returns ``(result, wall_ms, compiles)`` — the per-cell runtime-health
    pair the v4 report schema serializes; ``compiles`` is the number of
    kernel libraries the call built (:class:`CompileWatcher`).
    """
    with get_telemetry().span(label, **span_labels), CompileWatcher() as watch:
        t0 = time.perf_counter()
        out = fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        wall_ms = (time.perf_counter() - t0) * 1e3
    return out, wall_ms, watch.added


def _numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().astype(np.float64)


def _bound(policy: str, alpha: float) -> float | None:
    """Paper worst-case ratio for a policy at prediction fraction α
    (dispatching on the policy name; None when the policy has no bound)."""
    if policy == "offline":
        return 1.0              # hindsight optimum IS the denominator
    if policy == "delayedoff":
        return 2.0              # break-even timer Δ, classic ski-rental bound
    if policy in ("A1", "A2", "A3"):
        return theoretical_ratio(policy, alpha)
    if policy == "AQ-det":
        return 2.0              # per-type break-even timer (d = 1 view)
    if policy == "AQ-rand":
        return math.e / (math.e - 1.0)
    return None


def _typed_bounds(policy: str, d: int) -> tuple[float, float]:
    """(aggregate, per-type) competitive-ratio bounds on a d-type fleet: the
    Albers–Quedenfeld 2d / d·e/(e−1), and the per-type ski-rental bound."""
    per_type = _bound(policy, 0.0)
    if per_type is None or policy not in TYPED_POLICIES:
        raise ValueError(f"no typed bound for policy {policy!r}")
    return d * per_type, per_type


def _scenario_labels(scenarios: tuple[Scenario, ...]) -> list[str]:
    """Unique per-scenario labels (name, suffixed on collision)."""
    seen: dict[str, int] = {}
    labels = []
    for sc in scenarios:
        k = seen.get(sc.name, 0)
        seen[sc.name] = k + 1
        labels.append(sc.name if k == 0 else f"{sc.name}#{k}")
    return labels


def _cr_stats(cr: np.ndarray) -> dict:
    """The per-trace CR distribution's statistics of one cell."""
    quantiles = [float(q) for q in np.quantile(cr, CR_QUANTILES)]
    return dict(
        mean_cr=float(cr.mean()),
        p95_cr=float(np.percentile(cr, 95)),
        max_cr=float(cr.max()),
        p50_cr=quantiles[CR_QUANTILES.index(0.5)],
        cr_quantiles=quantiles,
    )


def _noise(grid: EvalGrid, draws, device: torch.device, si: int,
           shape: tuple[int, int]) -> PredictionNoise:
    """Scenario ``si``'s noise sweep: one normal draw, shared by its noise
    levels and its policies (a generator would be consumed by each
    policy's call)."""
    if draws is None:
        g = _generator(device, grid.seed, NOISE_STREAM, si)
        normals = torch.randn(shape, generator=g, device=device)
    else:
        normals = _float32(draws.normals(si, shape), device)
    return PredictionNoise(std_frac=list(grid.noise_stds), normals=normals)


def _block_spec(grid: EvalGrid, draws, device: torch.device, pi: int,
                demand: torch.Tensor, noise: PredictionNoise, n_levels: int) -> ProvisionSpec:
    """The one ``provision()`` spec of online block (policy ``pi``, a
    scenario's ``demand`` and ``noise``): its (S, W, B) cells."""
    return ProvisionSpec(
        costs=grid.costs,
        workload=Workload(demand=demand, noise=noise),
        policy=_policy(grid, draws, device, POLICY_STREAM, pi, grid.policies[pi],
                       tuple(demand.shape) + (n_levels,), windows=list(grid.windows)),
        n_levels=n_levels,
        device=device,
    )


def _typed_spec(grid: EvalGrid, draws, device: torch.device, pi: int,
                demand_np: np.ndarray) -> ProvisionSpec:
    """The spec of typed cell (typed policy ``pi``, a scenario's demand) on
    the fleet ``CostModel.from_groups(*grid.typed_groups)``."""
    costs = CostModel.from_groups(*grid.typed_groups)
    # typed fleets pin their capacity; cap demand at it (same semantic as
    # make_workload(clip_to=...)) so every scenario fits the fleet
    demand = torch.as_tensor(np.minimum(demand_np, costs.n_levels), device=device).to(
        torch.int32)
    return ProvisionSpec(
        costs=costs,
        workload=Workload(demand=demand),
        policy=_policy(grid, draws, device, TYPED_STREAM, pi, grid.typed_policies[pi],
                       tuple(demand.shape) + (costs.n_levels,)),
        device=device,
    )


def _deferral_spec(grid: EvalGrid, draws, device: torch.device, pi: int,
                   demand: torch.Tensor, slack: int, n_levels: int) -> ProvisionSpec:
    """The spec of deferral cell (deferral policy ``pi``, a scenario's
    ``demand``, ``slack``) at window 0 with exact predictions."""
    dspec = DeferralSpec(slack=slack, rule=grid.deferral_rule,
                         max_slack=max(grid.deferral_slacks))
    return ProvisionSpec(
        costs=grid.costs,
        workload=Workload(demand=demand, deferral=dspec),
        policy=_policy(grid, draws, device, DEFERRAL_STREAM, pi, grid.deferral_policies[pi],
                       tuple(demand.shape) + (n_levels,)),
        n_levels=n_levels,
        device=device,
    )


def _evaluate_typed(grid: EvalGrid, labels: list[str], demands: list, draws,
                    device: torch.device) -> list[CellResult]:
    """Typed-fleet cells for every (typed policy, scenario) pair.

    One ``provision`` per pair plus one typed offline baseline per scenario
    — no noise/window axes (the AQ policies never peek).
    """
    if grid.typed_groups is None:
        return []
    costs = CostModel.from_groups(*grid.typed_groups)
    d = costs.n_groups
    cells: list[CellResult] = []
    for label, demand_np in zip(labels, demands):
        specs = [_typed_spec(grid, draws, device, pi, demand_np)
                 for pi in range(len(grid.typed_policies))]
        opt_group, _, _ = _timed(
            "eval/offline_baseline",
            lambda: provision(dataclasses.replace(
                specs[0], policy=PolicySpec("offline"))).group_cost,   # (B, d)
            device, scenario=label, block="typed",
        )
        opt_group = _numpy(opt_group)
        opt = opt_group.sum(axis=-1)
        for policy, spec in zip(grid.typed_policies, specs):
            cost_group, wall_ms, compiles = _timed(
                "eval/typed_cell", lambda: provision(spec).group_cost,  # (B, d)
                device, policy=policy, scenario=label,
            )
            cost_group = _numpy(cost_group)
            cost = cost_group.sum(axis=-1)
            cr = cost / opt
            bound, per_type_bound = _typed_bounds(policy, d)
            # a type the offline optimum never powers is never powered
            # online either (same dispatcher condition), so 0/0 cells are
            # vacuously ratio 1
            group_cr = np.where(
                opt_group > 0,
                cost_group / np.where(opt_group > 0, opt_group, 1.0),
                1.0,
            ).mean(axis=0)                              # (d,)
            stats = _cr_stats(cr)
            cells.append(CellResult(
                policy=policy,
                scenario=label,
                noise_std=0.0,
                window=0,
                alpha=0.0,                              # no peek
                bound=bound,
                mean_cost=float(cost.mean()),
                mean_opt_cost=float(opt.mean()),
                bound_ok=stats["mean_cr"] <= bound + grid.tol,
                group_names=list(costs.group_names),
                group_mean_cr=[float(v) for v in group_cr],
                group_bound=[per_type_bound] * d,
                group_bound_ok=[
                    bool(v <= per_type_bound + grid.tol) for v in group_cr
                ],
                wall_ms=wall_ms,
                compiles=compiles,
                **stats,
            ))
    return cells


def _evaluate_deferral(grid: EvalGrid, labels: list[str], demands: list, n_levels: int,
                       draws, device: torch.device) -> list[CellResult]:
    """Deferral cells: (deferral policy × scenario × slack) at window 0.

    One ``provision`` per (scenario, slack, policy) through
    ``Workload(deferral=...)`` — deferral, then K2 on CUDA, then the queue
    metrics — plus one offline baseline per (scenario, slack) on the same
    deferred profile.  The baseline runs the closed form on
    ``DeferralSpec.apply``'s profile directly: that is the profile
    ``provision()`` would feed it, and its queue metrics are not read (so
    each (scenario, slack) computes its deferred profile twice).
    """
    if grid.deferral_slacks is None:
        return []
    alpha = min(1.0, 1.0 / float(grid.costs.delta))         # window = 0
    cells: list[CellResult] = []
    for label, demand_np in zip(labels, demands):
        demand = torch.as_tensor(demand_np, device=device).to(torch.int32)
        for slack in grid.deferral_slacks:
            specs = [_deferral_spec(grid, draws, device, pi, demand, slack, n_levels)
                     for pi in range(len(grid.deferral_policies))]
            opt, _, _ = _timed(
                "eval/offline_baseline",
                lambda: provision(ProvisionSpec(
                    costs=grid.costs,
                    workload=Workload(demand=specs[0].workload.deferral.apply(demand)),
                    policy=PolicySpec("offline"),
                    n_levels=n_levels,
                    device=device,
                )).cost,                                    # (B,)
                device, scenario=label, block="deferral", slack=slack,
            )
            opt = _numpy(opt)
            for policy, spec in zip(grid.deferral_policies, specs):
                res, wall_ms, compiles = _timed(
                    "eval/deferral_cell", lambda: provision(spec),
                    device, policy=policy, scenario=label, slack=slack,
                )
                cost = _numpy(res.cost)                     # (B,)
                cr = cost / opt
                misses = int(res.deadline_misses.sum())
                unserved = int(res.unserved.sum())
                p99 = int(res.p99_delay.max())
                max_delay = int(res.max_delay.max())
                bound = _bound(policy, alpha)
                stats = _cr_stats(cr)
                cells.append(CellResult(
                    policy=policy,
                    scenario=label,
                    noise_std=0.0,
                    window=0,
                    alpha=alpha,
                    bound=bound,
                    mean_cost=float(cost.mean()),
                    mean_opt_cost=float(opt.mean()),
                    bound_ok=stats["mean_cr"] <= bound + grid.tol,
                    slack=int(slack),
                    rule=grid.deferral_rule,
                    max_delay=max_delay,
                    p99_delay=p99,
                    deadline_misses=misses,
                    slo_ok=(
                        misses == 0 and unserved == 0 and p99 <= int(slack)
                    ),
                    wall_ms=wall_ms,
                    compiles=compiles,
                    **stats,
                ))
    return cells


def evaluate(grid: EvalGrid, *, draws: Draws | None = None) -> EvalReport:
    """Run the full grid on ``grid.device`` and return the scored
    :class:`EvalReport`.

    One ``provision()`` call per (policy, scenario) pair — the noise and
    window axes live inside it, one K2 launch on CUDA — and one closed-form
    offline baseline per scenario; then the typed and deferral blocks,
    one ``provision()`` per cell.  ``draws``: inject the random numbers
    (:class:`Draws`) instead of drawing them from the grid's seed.
    """
    grid.validate()
    device = torch.device(grid.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"EvalGrid(device={grid.device!r}) but CUDA is not available: "
            "pass device=\"cpu\" to evaluate on the CPU"
        )
    t0 = time.perf_counter()
    builds0 = engine_cache_size()
    labels = _scenario_labels(grid.scenarios)
    demands = [generate(sc, grid.n_traces, grid.n_slots) for sc in grid.scenarios]
    # one fleet size for every scenario => one shape per policy
    n_levels = int(max(d.max() for d in demands)) + 1
    delta = float(grid.costs.delta)
    shape = (grid.n_traces, grid.n_slots)

    cells: list[CellResult] = []
    for si, (label, demand_np) in enumerate(zip(labels, demands)):
        demand = torch.as_tensor(demand_np, device=device).to(torch.int32)
        opt, _, _ = _timed(
            "eval/offline_baseline",
            lambda: provision(ProvisionSpec(
                costs=grid.costs,
                workload=Workload(demand=demand),
                policy=PolicySpec("offline"),
                n_levels=n_levels,
                device=device,
            )).cost,                                        # (B,)
            device, scenario=label,
        )
        opt = _numpy(opt)
        noise = _noise(grid, draws, device, si, shape)
        for pi, policy in enumerate(grid.policies):
            spec = _block_spec(grid, draws, device, pi, demand, noise, n_levels)
            # the whole (S, W, B) block is one provision() call, so its cells
            # share the block's runtime-health pair (block totals)
            cost, wall_ms, compiles = _timed(
                "eval/policy_block", lambda: provision(spec).cost,
                device, policy=policy, scenario=label,
            )                                               # (S, W, B)
            cost = _numpy(cost)
            cr = cost / opt[None, None, :]
            for s, std in enumerate(grid.noise_stds):
                for w, window in enumerate(grid.windows):
                    alpha = min(1.0, (window + 1) / delta)
                    bound = _bound(policy, alpha)
                    stats = _cr_stats(cr[s, w])
                    cells.append(CellResult(
                        policy=policy,
                        scenario=label,
                        noise_std=float(std),
                        window=int(window),
                        alpha=alpha,
                        bound=bound,
                        mean_cost=float(cost[s, w].mean()),
                        mean_opt_cost=float(opt.mean()),
                        bound_ok=(
                            bound is None
                            or stats["mean_cr"]
                            <= bound + grid.tol + grid.noise_slack * float(std)
                        ),
                        wall_ms=wall_ms,
                        compiles=compiles,
                        **stats,
                    ))

    cells.extend(_evaluate_typed(grid, labels, demands, draws, device))
    cells.extend(_evaluate_deferral(grid, labels, demands, n_levels, draws, device))

    return EvalReport(
        grid={
            "policies": list(grid.policies),
            "scenarios": [sc.describe() for sc in grid.scenarios],
            "scenario_labels": labels,
            "noise_stds": list(grid.noise_stds),
            "windows": list(grid.windows),
            "n_traces": grid.n_traces,
            "n_slots": grid.n_slots,
            "n_levels": n_levels,
            "delta": delta,
            "seed": grid.seed,
            "tol": grid.tol,
            "noise_slack": grid.noise_slack,
            "mesh": None,
            "device": device.type,
            "cr_quantiles": list(CR_QUANTILES),
            "typed_groups": (
                None if grid.typed_groups is None
                else [dataclasses.asdict(g) for g in
                      CostModel.from_groups(*grid.typed_groups).groups]
            ),
            "typed_policies": (
                None if grid.typed_groups is None else list(grid.typed_policies)
            ),
            "deferral_slacks": (
                None if grid.deferral_slacks is None
                else list(grid.deferral_slacks)
            ),
            "deferral_rule": (
                None if grid.deferral_slacks is None else grid.deferral_rule
            ),
            "deferral_policies": (
                None if grid.deferral_slacks is None
                else list(grid.deferral_policies)
            ),
        },
        cells=cells,
        backend=device.type,
        jit_entries_added=engine_cache_size() - builds0,
        expected_compiles=1,                # K1 and K2's library
        elapsed_s=time.perf_counter() - t0,
    )
