"""Provisioning-engine benchmarks on the port: throughput of the declarative
fleet provisioner (traces x alpha-sweep x levels as one ``provision(spec)``
call), the fused scan kernel K1, heterogeneous per-level cost models, the
mesh route, deferral, and the event-driven brick simulator.

The twin of ``benchmarks/provision_bench.py``, with its function names,
sizes and row names, but for the route word in a row's name
(:data:`ROUTE_WORDS`).  On the card every online ``provision()`` call is one
launch of kernel K2 and :func:`pallas_scan_throughput` launches K1; on the
CPU both are their plain versions.  The reference's compile gates are build
gates here (:func:`repro_torch.lint.tracer_sanitizer` over the kernel
library): re-pricing a fleet builds nothing, and neither does a warmed
re-run of the mesh route.  :func:`telemetry_overhead` keeps both of its
checks: a live telemetry registry changes nothing and builds nothing, and
``record_decisions=True`` leaves ``x`` bit for bit.  A failed check raises.
"""
from __future__ import annotations

import functools
import time

import numpy as np
import torch

from ..core import (
    RANDOMIZED_POLICIES,
    CostModel,
    PolicySpec,
    PredictionNoise,
    ProvisionSpec,
    ServerGroup,
    Workload,
    generate_brick_trace,
    msr_like_trace,
    provision,
    simulate,
)
from ..core.ski_rental import A1Deterministic
from ..kernels import provision_scan as _scans
from ..kernels._build import load_provision_scan
from ..lint import tracer_sanitizer
from ..obs import telemetry_session
from . import TIMED_CALLS, _provision, generator, mean_us, sync

COSTS = CostModel(P=1.0, beta_on=3.0, beta_off=3.0)
DELTA = int(COSTS.delta)
N_SLOTS = 1008

#: the reference's route words in its row names, and the port's for each
#: device: (on the card, on the CPU).  The reference's Pallas rows are the
#: kernels here, or their plain versions on the CPU; its lax.scan rows the
#: plain scan on the same cells.
ROUTE_WORDS = {
    "pallas_tpu": ("cuda", "plain"),
    "pallas_interpret": ("cuda", "plain"),
    "tpu": ("cuda", "plain"),
    "interpret": ("cuda", "plain"),
    "jax_provision": ("torch_provision", "torch_provision"),
    "lax_scan": ("plain_scan", "plain_scan"),
}
#: rows of the reference renamed whole: its interpret-mode attention check
#: is K3 against its plain version here
RENAMED = {"flash_interpret_256": "flash_256"}


def route_word(word: str, device) -> str:
    """The port's route word for the reference's ``word`` on ``device``."""
    return ROUTE_WORDS[word][torch.device(device).type != "cuda"]


def route_name(name: str, device) -> str:
    """A row name of the reference as the port names the row on ``device``:
    each route word of :data:`ROUTE_WORDS` between underscores replaced, or
    its entry in :data:`RENAMED`."""
    if name in RENAMED:
        return RENAMED[name]
    parts = name.split("_")
    out, i = [], 0
    while i < len(parts):
        pair = "_".join(parts[i:i + 2])
        if pair in ROUTE_WORDS:
            out.append(route_word(pair, device))
            i += 2
        elif parts[i] in ROUTE_WORDS:
            out.append(route_word(parts[i], device))
            i += 1
        else:
            out.append(parts[i])
            i += 1
    return "_".join(out)


def _trace(n_levels: int, seed: int = 0, n_slots: int = N_SLOTS) -> np.ndarray:
    return msr_like_trace(
        np.random.default_rng(seed), mean_jobs=n_levels / 4.0, n_slots=n_slots
    )


def _spec(a, n_levels, policy="A1", windows=None, costs=COSTS, *, device):
    return ProvisionSpec(
        costs=costs,
        workload=Workload(demand=torch.as_tensor(a, device=device).to(torch.int32)),
        policy=PolicySpec(
            policy, window=2, windows=windows,
            generator=generator(device, 0) if policy in RANDOMIZED_POLICIES else None,
        ),
        n_levels=n_levels,
        device=device,
    )


def jax_provisioner_throughput(rows: list[str], sizes=(64, 512, 4096), *,
                               device="cuda") -> None:
    """Single-trace A1 path (the serving autoscaler's hot loop)."""
    for n_levels in sizes:
        a = _trace(n_levels)
        spec = _spec(a, n_levels, device=device)
        us = mean_us(lambda: provision(spec).x, 5, device)
        rows.append(
            f"{route_word('jax_provision', device)}_levels{n_levels},{us:.1f},"
            f"slots={len(a)};decisions_per_s={n_levels * len(a) / (us / 1e6):.3e}"
        )


def batched_sweep_throughput(rows: list[str], n_levels=256, n_traces=32, *,
                             device="cuda") -> None:
    """The batched engine: (traces x alpha values x levels) per second."""
    n_windows = DELTA
    windows = list(range(n_windows))
    for policy in ("A1", "A3"):
        a = np.stack([_trace(n_levels, seed=s) for s in range(n_traces)])
        spec = _spec(a, n_levels, policy, windows=windows, device=device)
        us = mean_us(lambda: provision(spec).cost, 3, device)
        cells = n_traces * n_windows * n_levels * a.shape[1]
        rows.append(
            f"batched_sweep_{policy}_b{n_traces}_w{n_windows}_n{n_levels},{us:.1f},"
            f"decisions_per_s={cells / (us / 1e6):.3e}"
        )


def heterogeneous_throughput(rows: list[str], n_levels=256, *, device="cuda") -> None:
    """Per-level cost arrays (two server classes) vs the scalar model."""
    a = _trace(n_levels)
    beta = np.where(np.arange(n_levels) < n_levels // 2, 4.5, 1.5)
    het = CostModel(P=1.0, beta_on=beta, beta_off=beta)
    for tag, costs in (("homog", COSTS), ("hetero", het)):
        spec = _spec(a, n_levels, costs=costs, device=device)
        us = mean_us(lambda: provision(spec).cost, 5, device)
        rows.append(
            f"provision_{tag}_n{n_levels},{us:.1f},"
            f"decisions_per_s={n_levels * len(a) / (us / 1e6):.3e}"
        )


def typed_fleet_throughput(rows: list[str], n_total=256, *, device="cuda") -> None:
    """Typed d=2 fleet (CostModel.from_groups) under AQ-det vs the untyped
    scalar model under delayedoff on the same demand — same per-level timer
    mechanics, so the delta is the cost of the group axis (group_cost
    reduction + routing-priority concatenation)."""
    half = n_total // 2
    typed = CostModel.from_groups(
        ServerGroup("efficient", half, P=1.0, beta_on=3.0, beta_off=3.0),
        ServerGroup("legacy", n_total - half, P=1.5, beta_on=4.5, beta_off=4.5),
    )
    a = torch.as_tensor(_trace(n_total), device=device).to(torch.int32)
    for tag, costs, policy in (
        ("untyped_delayedoff", COSTS, "delayedoff"),
        ("typed2_AQ-det", typed, "AQ-det"),
    ):
        spec = ProvisionSpec(
            costs=costs,
            workload=Workload(demand=a),
            policy=PolicySpec(policy),
            n_levels=n_total,
            device=device,
        )
        us = mean_us(lambda: provision(spec).cost, 5, device)
        rows.append(
            f"provision_{tag}_n{n_total},{us:.1f},"
            f"decisions_per_s={n_total * a.shape[0] / (us / 1e6):.3e}"
        )


def pallas_scan_throughput(rows: list[str], sizes=(512, 4096), *, device="cuda") -> None:
    """The fused per-level scan through the G = 1 wrapper
    ``kernels.provision_scan``: K1 on the card, its plain version on the CPU."""
    for n_levels in sizes:
        a = torch.as_tensor(_trace(n_levels), device=device).to(torch.int32)
        thresholds = torch.full((n_levels,), float(DELTA - 3), dtype=torch.float32,
                                device=device)
        us = mean_us(lambda: _scans.provision_scan(a, thresholds, delta=DELTA, horizon=3), 3,
                    device)
        rows.append(
            f"pallas_scan_{route_word('tpu', device)}_levels{n_levels},{us:.1f},"
            f"decisions_per_s={n_levels * a.shape[0] / (us / 1e6):.3e}"
        )


def _mesh_grid_demand(n_levels, n_traces, n_slots, device) -> torch.Tensor:
    ab = np.stack([_trace(n_levels, seed=s, n_slots=n_slots) for s in range(n_traces)])
    return torch.as_tensor(ab, device=device).to(torch.int32)


def _mesh_grid_spec(ab, n_levels, n_windows, n_stds, device, mesh=None):
    """A3 over the (S, W, B) grid of ``ab`` with a noise sweep: the wait
    uniforms from a generator seeded 0 and the normals from one seeded 5,
    fresh for every spec, so that every spec of these sizes sees the same
    draws."""
    noise = PredictionNoise(
        std_frac=np.linspace(0.0, 0.4, n_stds).tolist(), generator=generator(device, 5)
    )
    return ProvisionSpec(
        costs=COSTS,
        workload=Workload(demand=ab, noise=noise),
        policy=PolicySpec("A3", windows=list(range(n_windows)),
                          generator=generator(device, 0)),
        n_levels=n_levels,
        device=device,
        mesh=mesh,
    )


def _mesh_rank(mesh, payload) -> dict:
    """One rank of the mesh rows (a :func:`repro_torch.distributed.world.
    run_world` target): the grid of ``payload["sizes"]`` on ``mesh``, a warm
    call then ``TIMED_CALLS`` timed ones (``"gate"``: a cold call and a
    warmed re-run, each under a build gate), with the rank's K2 launches."""
    device = mesh.device_type
    n_levels, n_traces, n_windows, n_stds, n_slots = payload["sizes"]
    ab = _mesh_grid_demand(n_levels, n_traces, n_slots, device)
    before = _scans.stream_launches

    def once():
        res = provision(_mesh_grid_spec(ab, n_levels, n_windows, n_stds, device, mesh=mesh))
        sync(device)
        return res

    out = {}
    if payload["gate"]:
        with tracer_sanitizer(fns=(load_provision_scan,), max_compiles=None) as cold:
            res = once()
        with tracer_sanitizer(fns=(load_provision_scan,), max_compiles=0) as warm:
            once()
        out.update(cold=cold.added, warm=warm.added)
    else:
        res = once()
        t0 = time.perf_counter()
        for _ in range(TIMED_CALLS):
            once()
        out["us"] = (time.perf_counter() - t0) / TIMED_CALLS * 1e6
    out.update(x=res.x.cpu(), cost=res.cost.cpu(), level_cost=res.level_cost.cpu(),
               launches=_scans.stream_launches - before)
    return out


def _mesh_world(sizes, device, gate: bool) -> dict:
    """:func:`_mesh_rank` in a world of one process (NCCL on the card, gloo on
    the CPU); its K2 launches checked: one per call on the card, none on
    the CPU."""
    from ..distributed.world import run_world

    got = run_world("repro_torch.bench.provision_bench:_mesh_rank", 1, device=str(device),
                    payload={"sizes": sizes, "gate": gate})[0]
    calls = 2 if gate else 1 + TIMED_CALLS
    want = calls if torch.device(device).type == "cuda" else 0
    if got["launches"] != want:
        raise AssertionError(f"mesh rank: {got['launches']} K2 launches for {calls} "
                             f"calls, expected {want}")
    return got


def mesh_grid_throughput(rows: list[str], n_levels=256, n_traces=8,
                         n_windows=4, n_stds=2, n_slots=N_SLOTS, *, device="cuda") -> None:
    """The mesh route on the full (S, W, B) grid, in a world of one process
    (K2 on the rank's block of levels), against the plain scan on identical
    cells (A3, so the wait draws ride along too): the two must be equal, bit
    for bit."""
    sizes = (n_levels, n_traces, n_windows, n_stds, n_slots)
    meshed = _mesh_world(sizes, device, gate=False)
    ab = _mesh_grid_demand(n_levels, n_traces, n_slots, device)

    def plain():
        return _provision(_mesh_grid_spec(ab, n_levels, n_windows, n_stds, device),
                          record_decisions=False, kernel=False)

    want = plain()
    for leaf in ("x", "level_cost", "cost"):
        if not torch.equal(meshed[leaf], getattr(want, leaf).cpu()):
            raise AssertionError(f"mesh route's {leaf} differs from the plain scan's")
    us_plain = mean_us(lambda: plain().cost, 3, device)
    cells = n_stds * n_windows * n_traces * n_levels * n_slots
    for word, us in (("pallas_tpu", meshed["us"]), ("lax_scan", us_plain)):
        rows.append(
            f"mesh_grid_{route_word(word, device)}_s{n_stds}_w{n_windows}_b{n_traces}"
            f"_n{n_levels},{us:.1f},decisions_per_s={cells / (us / 1e6):.3e}"
        )


def mesh_grid_compile_gate(rows: list[str], n_levels=48, n_slots=168, *,
                           device="cuda") -> None:
    """One mesh-route grid cell as a build gate, in a fresh world of one: the
    cold call loads the kernel library (one build on the card, none on the
    CPU) and a warmed re-run builds nothing."""
    got = _mesh_world((n_levels, 2, 2, 2, n_slots), device, gate=True)
    want = 1 if torch.device(device).type == "cuda" else 0
    if got["cold"] != want:
        raise AssertionError(f"mesh route: the cold call built {got['cold']} libraries, "
                             f"expected {want}")
    rows.append(f"mesh_grid_compiles,0.0,cold={got['cold']};warm_added={got['warm']}")


def deferral_cost_vs_slack(rows: list[str], n_levels=256, slacks=(0, 2, 6, 12), *,
                           device="cuda") -> None:
    """The defer-then-provision path: provisioning cost as a function of the
    granted queueing slack, one row per slack.  The specs share
    ``max_slack``, so the queue's shapes stay fixed across the curve; the
    widest-slack schedule must not cost more than rigid."""
    from ..deferral import DeferralSpec

    a = torch.as_tensor(_trace(n_levels), device=device).to(torch.int32)
    max_slack = max(slacks)
    curve = []
    for slack in slacks:
        spec = ProvisionSpec(
            costs=COSTS,
            workload=Workload(
                demand=a,
                deferral=DeferralSpec(slack=slack, max_slack=max_slack),
            ),
            policy=PolicySpec("A1", window=2),
            n_levels=n_levels,
            device=device,
        )
        res = provision(spec)
        sync(device)
        t0 = time.perf_counter()
        for _ in range(3):
            provision(spec).cost
            sync(device)
        us = (time.perf_counter() - t0) / 3 * 1e6
        curve.append(float(res.cost))
        rows.append(
            f"deferral_slack{slack}_n{n_levels},{us:.1f},"
            f"cost={curve[-1]:.1f};p99={int(res.p99_delay)};"
            f"miss={int(res.deadline_misses)}"
        )
    assert curve[-1] <= curve[0], (
        f"deferral bought nothing: rigid costs {curve[0]:.1f}, "
        f"slack={slacks[-1]} costs {curve[-1]:.1f}"
    )


def brick_simulator_throughput(rows: list[str]) -> None:
    """The event-driven brick simulator (numpy; no device)."""
    rng = np.random.default_rng(1)
    tr = generate_brick_trace(rng, horizon=2000.0, rate=3.0, mean_duration=4.0)
    t0 = time.perf_counter()
    simulate(tr, A1Deterministic(alpha=0.5), COSTS)
    us = (time.perf_counter() - t0) * 1e6
    rows.append(
        f"brick_sim_{len(tr.jobs)}jobs,{us:.1f},"
        f"events_per_s={2 * len(tr.jobs) / (us / 1e6):.3e}"
    )


def jit_cache_reuse(rows: list[str], *, device="cuda") -> None:
    """Re-pricing the fleet must reuse the kernel library, not rebuild it.

    The spec's cost fields are data: after one call has loaded the library,
    four price points (the same ceil(max Delta)) build nothing.
    """
    a = _trace(32, n_slots=160)
    provision(_spec(a, 32, device=device)).cost           # loads the library on the card
    sync(device)
    with tracer_sanitizer(fns=(load_provision_scan,), max_compiles=0) as watch:
        for beta in (2.6, 2.75, 2.9, 3.0):
            spec = _spec(a, 32, costs=CostModel(P=1.0, beta_on=beta, beta_off=beta),
                         device=device)
            provision(spec).cost
            sync(device)
    rows.append(f"jit_cache_repricing,0.0,entries_added={watch.added}")


def telemetry_overhead(rows: list[str], *, device="cuda") -> None:
    """The observability layer's zero-overhead contract, as a smoke gate.

    With a live telemetry registry installed, re-running the warmed default
    path must build nothing and give the same schedule, and
    ``record_decisions=True`` (K1 on the card) must leave the schedule
    bit for bit (provenance is extra outputs, never a decision input).
    """
    a = _trace(32, n_slots=160)
    spec = _spec(a, 32, device=device)
    base = provision(spec).x.clone()                   # warm
    with telemetry_session():
        with tracer_sanitizer(fns=(load_provision_scan,)) as watch:
            lit = provision(spec).x
    assert torch.equal(lit, base), "telemetry changed the schedule"
    rec = provision(spec, record_decisions=True)
    assert torch.equal(rec.x, base), "record_decisions=True changed the schedule"
    assert rec.decisions is not None
    rows.append(
        f"telemetry_overhead,0.0,extra_compiles={max(watch.added, 0)};"
        "record_bitexact=1"
    )


#: the functions of :func:`run`, in the reference's order
RUN = ("jax_provisioner_throughput", "batched_sweep_throughput", "heterogeneous_throughput",
       "typed_fleet_throughput", "pallas_scan_throughput", "mesh_grid_throughput",
       "deferral_cost_vs_slack", "brick_simulator_throughput", "jit_cache_reuse",
       "mesh_grid_compile_gate", "telemetry_overhead")
#: the functions of :func:`run_smoke`, in the reference's order, at its sizes
SMOKE_SIZES = {
    "jax_provisioner_throughput": {"sizes": (64,)},
    "batched_sweep_throughput": {"n_levels": 32, "n_traces": 4},
    "heterogeneous_throughput": {"n_levels": 32},
    "typed_fleet_throughput": {"n_total": 32},
    "pallas_scan_throughput": {"sizes": (128,)},
    "mesh_grid_throughput": {"n_levels": 32, "n_traces": 2, "n_windows": 2, "n_stds": 2,
                             "n_slots": 160},
    "deferral_cost_vs_slack": {"n_levels": 32, "slacks": (0, 4)},
    "jit_cache_reuse": {},
    "mesh_grid_compile_gate": {},
    "telemetry_overhead": {},
}


def sections(*, device="cuda", smoke: bool = False) -> list:
    """``(name, fn(rows))`` of each benchmark of :func:`run` (``smoke``: of
    :func:`run_smoke`, at its sizes), in the reference's order."""
    out = []
    for name in SMOKE_SIZES if smoke else RUN:
        kw = dict(SMOKE_SIZES[name]) if smoke else {}
        if name != "brick_simulator_throughput":         # numpy only
            kw["device"] = device
        out.append((name, functools.partial(globals()[name], **kw)))
    return out


def run(rows: list[str], *, device="cuda") -> None:
    for _, fn in sections(device=device):
        fn(rows)


def run_smoke(rows: list[str], *, device="cuda") -> None:
    """CI leg: small shapes, every code path, plus the build gates
    (re-pricing builds nothing; a warmed mesh re-run builds nothing;
    telemetry builds nothing and changes nothing)."""
    for _, fn in sections(device=device, smoke=True):
        fn(rows)
