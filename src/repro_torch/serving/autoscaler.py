"""Replica autoscaler — the paper's technique as a first-class serving feature.

The PyTorch port of ``repro.serving.autoscaler``.  It maps the paper's
algorithms onto model-serving replicas:

  * last-empty-server-first  ->  last-empty-REPLICA-first (LIFO stack);
    a session is pinned to its replica for its whole lifetime, so the
    no-job-migration property becomes a no-KV-cache-migration property.
  * per-server ski-rental    ->  each idle replica independently decides
    off-vs-idle after (1-alpha)*Delta (A1) or a randomized wait (A2/A3),
    peeking an alpha*Delta prediction window.
  * the peek uses only the LIFO structure: a replica at stack depth p is
    popped iff predicted concurrency exceeds busy_now + p (paper Sec. IV-B).

Two front-ends share the math:

  * :class:`ReplicaAutoscaler` — event-driven, reacts live to session
    arrivals/departures (numpy, a copy of the reference's);
  * :class:`FleetProvisioner` — slot-based capacity planning on the port's
    engine: ``plan``/``plan_sweep``/``sweep_costs`` run ``provision()``,
    and ``advance`` steps the serving stepper
    (:mod:`repro_torch.serving.stepper`), both through kernel K2 on the
    card.

Delta = (beta_on + beta_off)/P with beta_on the replica spin-up cost
(weight load + compile, amortized) — see ``replica_cost_model``.
"""
from __future__ import annotations

import dataclasses
import heapq
import time
from typing import Callable

import numpy as np
import torch

from ..core import torch_provision as _engine
from ..core.costs import CostModel
from ..core.provision import (
    PolicySpec,
    ProvisionResult,
    ProvisionSpec,
    Workload,
    _resolve_device,
    provision,
)
from ..core.ski_rental import (
    A1Deterministic,
    A2Randomized,
    A3Randomized,
    OfflinePolicy,
)
from ..deferral import defer_stream, queue_stream, queue_stream_finalize
from ..obs.telemetry import get_telemetry
from .metrics import PlanMetrics
from .stepper import slot_uniforms, stepper_chunk, stepper_init

POLICIES = {
    "A1": A1Deterministic,
    "A2": A2Randomized,
    "A3": A3Randomized,
    "offline": OfflinePolicy,
}


def _policy_class(policy: str):
    if policy not in POLICIES:
        raise ValueError(
            f"unknown policy {policy!r}: valid policies are {tuple(POLICIES)}"
        )
    return POLICIES[policy]


@dataclasses.dataclass
class ReplicaState:
    replica_id: int
    state: str = "off"            # off | idle | busy
    since: float = 0.0            # time of last state change
    session: int | None = None


@dataclasses.dataclass
class ScalerReport:
    energy: float = 0.0
    n_turn_on: int = 0
    n_turn_off: int = 0
    busy_time: float = 0.0
    idle_time: float = 0.0

    def total_cost(self, costs: CostModel) -> float:
        return (
            self.energy
            + costs.beta_on * self.n_turn_on
            + costs.beta_off * self.n_turn_off
        )


class ReplicaAutoscaler:
    """Event-driven live autoscaler (no future knowledge beyond the window)."""

    def __init__(
        self,
        n_replicas: int,
        costs: CostModel,
        policy: str = "A1",
        alpha: float = 0.0,
        predictor: Callable[[float, float], float] | None = None,
        rng: np.random.Generator | None = None,
        initial_busy: int = 0,
    ):
        self.costs = costs
        self.policy = _policy_class(policy)(alpha=alpha)
        self.alpha = alpha
        self.predictor = predictor            # (t0, t1) -> max predicted load
        self.rng = rng or np.random.default_rng(0)
        self.replicas = [ReplicaState(i) for i in range(n_replicas)]
        # stack of replica ids (idle or off); bottom..top
        self.stack: list[int] = list(range(n_replicas - 1, initial_busy - 1, -1))
        for i in range(initial_busy):
            self.replicas[i].state = "busy"
        self.busy: set[int] = set(range(initial_busy))
        self.report = ScalerReport()
        self._timers: list[tuple[float, int, int]] = []   # (deadline, seq, rid)
        self._seq = 0
        self._timer_valid: dict[int, float] = {}

    # ------------------------------------------------------------------ events
    def acquire(self, t: float) -> int:
        """Session start: pop the last-empty replica (LIFO)."""
        self.advance(t)
        rid = self.stack.pop()
        r = self.replicas[rid]
        if r.state == "idle":
            self.report.energy += self.costs.P * (t - r.since)
            self.report.idle_time += t - r.since
        else:  # off -> on
            self.report.n_turn_on += 1
        r.state = "busy"
        r.since = t
        self.busy.add(rid)
        self._timer_valid.pop(rid, None)
        return rid

    def release(self, t: float, rid: int) -> None:
        """Session end: push the replica; start its ski-rental clock."""
        self.advance(t)
        r = self.replicas[rid]
        self.report.energy += self.costs.P * (t - r.since)
        self.report.busy_time += t - r.since
        self.busy.discard(rid)
        r.state = "idle"
        r.since = t
        self.stack.append(rid)
        wait = self.policy.wait_time(self.costs.delta, self.rng)
        if isinstance(self.policy, OfflinePolicy):
            wait = 0.0
        deadline = t + wait
        self._seq += 1
        self._timer_valid[rid] = deadline
        heapq.heappush(self._timers, (deadline, self._seq, rid))

    def advance(self, t: float) -> None:
        """Fire all ski-rental decisions due at or before time t."""
        while self._timers and self._timers[0][0] <= t:
            deadline, _, rid = heapq.heappop(self._timers)
            if self._timer_valid.get(rid) != deadline:
                continue
            del self._timer_valid[rid]
            r = self.replicas[rid]
            if r.state != "idle":
                continue
            if not self._predicted_pop(rid, deadline):
                # turn off
                self.report.energy += self.costs.P * (deadline - r.since)
                self.report.idle_time += deadline - r.since
                r.state = "off"
                r.since = deadline
                self.report.n_turn_off += 1
            # else: stay idle until popped

    def finalize(self, t_end: float) -> ScalerReport:
        """Horizon end: x(T) = a(T) — force idle replicas off."""
        self.advance(t_end)
        for r in self.replicas:
            if r.state == "idle":
                self.report.energy += self.costs.P * (t_end - r.since)
                self.report.idle_time += t_end - r.since
                r.state = "off"
                self.report.n_turn_off += 1
            elif r.state == "busy":
                self.report.energy += self.costs.P * (t_end - r.since)
                self.report.busy_time += t_end - r.since
                r.since = t_end
        return self.report

    # ------------------------------------------------------------------ peek
    def _stack_depth(self, rid: int) -> int:
        """0 = top of stack."""
        return len(self.stack) - 1 - self.stack.index(rid)

    def _predicted_pop(self, rid: int, t: float) -> bool:
        """Will this replica be popped within (t, t + alpha*Delta]?

        Under LIFO the replica at depth p is popped iff concurrency exceeds
        busy_now + p within the window.
        """
        if self.predictor is None or self.alpha <= 0.0:
            return False
        if rid not in self.stack:
            return False
        window_end = t + self.alpha * self.costs.delta
        predicted_max = self.predictor(t, window_end)
        threshold = len(self.busy) + self._stack_depth(rid) + 1
        return predicted_max >= threshold

    def n_on(self) -> int:
        return sum(1 for r in self.replicas if r.state != "off")


class FleetProvisioner:
    """Slot-based capacity planner on the port's provisioning engine.

    Where :class:`ReplicaAutoscaler` reacts to one fleet's live events, this
    planner takes per-slot (predicted) session concurrency for B fleets at
    once — shape ``(T,)`` or ``(B, T)`` — and runs a
    :class:`repro_torch.core.ProvisionSpec` over it on ``device`` (the card
    by default: one launch of kernel K2 per online call; ``"cpu"`` runs the
    plain scans).  The ``policy`` argument is a
    :class:`repro_torch.core.PolicySpec` (or a policy name, sugar for
    ``PolicySpec(name, window=window, generator=generator)``); heterogeneous
    per-replica cost models are plain ``(max_replicas,)`` arrays on
    ``costs``.  ``plan_sweep``/``sweep_costs`` evaluate every prediction
    window in one call, which is how an operator picks α for a fleet (paper
    Fig. 4b as a planning tool).  Randomized policies need an explicit
    ``torch.Generator`` (or injected uniforms); a generator is consumed by a
    ``plan`` call, as by ``provision()``.

    Typed fleets plug straight in: build ``costs`` with
    ``CostModel.from_groups(ServerGroup(...), ...)`` and the fleet size
    defaults to the model's pinned capacity, ``plan(...).group_cost`` breaks
    the spend down per replica type, and ``AQ-det``/``AQ-rand`` become
    available alongside the paper's A1/A2/A3.

    ``deferral=`` (a :class:`repro_torch.deferral.DeferralSpec`) marks the
    sessions as deferrable, as in the reference; the spec's service cap
    defaults to the fleet size.

    ``slot_uniforms``: the per-slot draws of ``advance()`` for a keyed
    policy, a callable ``(t0, n) -> (u0, u)`` of two (n, max_replicas)
    float32 tables for global slots ``t0 .. t0 + n - 1``; by default they are
    drawn from ``generator`` slot by slot (:func:`repro_torch.serving.
    stepper.slot_uniforms`).

    ``mesh=`` (a ``DeviceMesh`` on ``device``'s type) shards the replica
    axis over its axis ``mesh_axis``: ``plan``, ``plan_sweep`` and
    ``sweep_costs`` run the mesh route of ``provision()``, one K2 launch
    per rank on the card, bit-exact against the planner without a mesh;
    every rank builds the same planner and gets the whole plan.
    ``advance()`` stays on the single-device stepper, as in the reference.
    """

    def __init__(
        self,
        costs: CostModel,
        policy="A1",
        window: int = 0,
        max_replicas: int | None = None,
        generator: torch.Generator | None = None,
        mesh=None,
        mesh_axis: str = "data",
        deferral=None,
        device="cuda",
        slot_uniforms=None,
    ):
        self.costs = costs
        if isinstance(policy, PolicySpec):
            if window != 0 or generator is not None:
                raise ValueError(
                    "pass window/generator inside the PolicySpec, not alongside it"
                )
            self.policy = policy
        else:
            self.policy = PolicySpec(name=policy, window=int(window), generator=generator)
        if slot_uniforms is None:
            self.policy.validate()
        else:                           # advance() has its draws; plan() checks its own
            _engine._check_policy(self.policy.name)
        self.slot_uniforms = slot_uniforms
        costs.validate_groups()
        pinned = costs.n_levels
        if max_replicas is None:
            # a level-pinned model (per-replica arrays or typed groups) IS
            # the fleet size; scalar models fall back to a planning cap
            max_replicas = 1024 if pinned is None else pinned
        elif pinned is not None and int(max_replicas) != pinned:
            raise ValueError(
                f"max_replicas={max_replicas} conflicts with the cost "
                f"model's pinned fleet size {pinned}; drop max_replicas "
                "(it defaults to the pinned size)"
            )
        self.max_replicas = int(max_replicas)
        self.device = _resolve_device(device)
        self.mesh = mesh
        self.mesh_axis = mesh_axis
        if deferral is not None:
            if deferral.cap is None:
                deferral = dataclasses.replace(deferral, cap=self.max_replicas)
            deferral.validate()
        self.deferral = deferral
        self._history = np.zeros(0, np.int64)
        self.last_plan = None
        #: the advance() stepper's carry (:class:`repro_torch.serving.
        #: stepper.StepperState`); None until the first advance() call
        self.state = None
        self._prev_x = None
        #: rolling advance() health: plan-latency p50/p99, toggle churn,
        #: backlog depth — export with ``self.metrics.prometheus_text()``
        self.metrics = PlanMetrics()

    def _spec(self, demand, predicted=None, windows=None):
        policy = self.policy
        if windows is not None:
            policy = dataclasses.replace(policy, windows=np.asarray(windows, np.int32))
        return ProvisionSpec(
            costs=self.costs,
            workload=Workload(
                demand=self._as_i32(demand),
                predicted=None if predicted is None else self._as_i32(predicted),
                deferral=self.deferral,
            ),
            policy=policy,
            n_levels=self.max_replicas,
            device=self.device,
            mesh=self.mesh,
            mesh_axis=self.mesh_axis,
        )

    def plan(self, demand, predicted=None) -> ProvisionResult:
        """Full ProvisionResult on the planner's device; ``.x`` is (T,) ->
        (T,) or (B, T) -> (B, T)."""
        if self.policy.windows is not None:
            raise ValueError(
                "the planner's PolicySpec carries a windows= sweep; "
                "plan() returns per-window-free shapes — use plan_sweep()/"
                "sweep_costs(), or drop windows from the PolicySpec"
            )
        return provision(self._spec(demand, predicted))

    def plan_sweep(self, demand, windows) -> np.ndarray:
        """x over an α-sweep: (W, T) or (W, B, T) for windows (W,)."""
        return provision(self._spec(demand, windows=windows)).x.cpu().numpy()

    def sweep_costs(self, demand, windows) -> np.ndarray:
        """Schedule costs over an α-sweep: (W,) or (W, B)."""
        return provision(self._spec(demand, windows=windows)).cost.cpu().numpy()

    def advance(self, demand_chunk) -> np.ndarray:
        """Commit the next chunk of per-slot demand; return its replica plan.

        A *true incremental stepper*: the per-level engine state (ski-rental
        clocks, on bits, residual waits), the causal deferral window and the
        queue's age buckets persist on ``self.state``
        (:class:`~repro_torch.serving.stepper.StepperState`), so each call
        costs O(chunk · replicas) regardless of how long the fleet has been
        running — no history is re-planned, and every returned slot is final
        (*commit-as-returned*; the no-peek policies are exactly chunk-size
        invariant, the peeking ones read the window within the chunk only).
        On the card a call is one launch of kernel K2 and builds nothing once
        the kernel library is loaded.

        Deferral follows the causal :func:`repro_torch.deferral.defer_stream`
        rule and requires scalar slack.  Randomized policies draw the waits of
        each slot from that slot's own stream (``slot_uniforms``) —
        reproducible and chunk-size invariant, but a different stream than
        ``plan()``'s per-trace tables.

        ``self.last_plan`` carries the chunk's view as a
        :class:`~repro_torch.core.ProvisionResult` on the planner's device:
        ``x``/``backlog`` cover the chunk, the cost fields are chunk-local
        (toggle edges against the carried state; no forced final off — the
        trace has not ended), and the queue scalars (``deadline_misses``/
        ``unserved``/delay quantiles) are *cumulative since the first call*.
        Every step records plan latency (until the plan is on the host),
        toggles (including the seam from the previous chunk) and backlog
        depth into ``self.metrics``.
        """
        return self._advance(demand_chunk, kernel=True)

    def _advance(self, demand_chunk, *, kernel: bool) -> np.ndarray:
        """:meth:`advance` with the scan route chosen by the caller: K2
        (``kernel=True``; the plain version on the CPU) or the plain version
        on the planner's device, which is how the kernel route is checked
        on the card."""
        chunk = np.asarray(demand_chunk, np.int64)
        if chunk.ndim != 1:
            raise ValueError(
                f"advance() steps one fleet: demand_chunk must be (T,), "
                f"got shape {chunk.shape}"
            )
        if chunk.size == 0:
            raise ValueError("advance() needs at least one demand slot")
        if self.policy.name == "offline":
            raise ValueError(
                "advance() steps online policies; 'offline' needs the whole "
                "trace in hindsight — use plan()"
            )
        if self.policy.windows is not None:
            raise ValueError(
                "the planner's PolicySpec carries a windows= sweep; advance() "
                "steps a single window — use plan_sweep()/sweep_costs(), or "
                "drop windows from the PolicySpec"
            )
        if self.deferral is not None and np.ndim(self.deferral.slack) != 0:
            raise ValueError(
                "advance() streams with scalar slack only (a per-slot slack "
                "vector is tied to one fixed horizon) — use plan()"
            )
        keyed = self.policy.name in _engine.KEYED
        draw = self.slot_uniforms
        if keyed and draw is None:
            if self.policy.generator is None:
                raise ValueError(
                    f"advance() draws {self.policy.name!r}'s waits slot by slot: pass "
                    "generator= or slot_uniforms= (injected tables are plan()'s)"
                )
            draw = slot_uniforms(self.policy.generator, self.max_replicas, self.device)
        arrivals = self._as_i32(chunk)
        n = chunk.size
        dev = self.device
        if self.state is None:
            self.state = stepper_init(
                self.max_replicas, self.costs.delta, policy=self.policy.name,
                window=self.policy.window, deferral=self.deferral, device=dev,
            )
        st = self.state

        with get_telemetry().span("serving/advance", chunk=n, t0=st.t):
            t_wall = time.perf_counter()
            if self.deferral is None:
                served, defer_c = arrivals, None
            else:
                served, defer_c = defer_stream(
                    arrivals, st.defer, slack=self.deferral.bound(), cap=self.deferral.cap,
                )
            x_dev, (r, on, wait), totals = stepper_chunk(
                served, st.t, st.r, st.on, st.wait, self.costs.delta,
                policy=self.policy.name, n_levels=self.max_replicas,
                max_h=self.costs.delta_slots(), window=self.policy.window,
                uniforms=draw(st.t, n) if keyed else None, kernel=kernel,
            )
            x = x_dev.cpu().numpy()
            queue_c, backlog, qsnap = None, None, {}
            if self.deferral is not None:
                backlog, queue_c = queue_stream(
                    arrivals, x_dev, st.queue, rule=self.deferral.rule,
                    max_slack=self.deferral.bound(),
                )
                qsnap = queue_stream_finalize(queue_c, max_slack=self.deferral.bound())
            latency_ms = (time.perf_counter() - t_wall) * 1e3

        self.state = dataclasses.replace(
            st, t=st.t + n, r=r, on=on, wait=wait, defer=defer_c, queue=queue_c,
        )
        self._history = np.concatenate([self._history, chunk])
        P_lv, bon_lv, boff_lv = self.costs.per_level(self.max_replicas, dev)
        level_cost = (
            P_lv * totals["run"] + bon_lv * totals["up"] + boff_lv * totals["down"]
        )
        self.last_plan = ProvisionResult(
            x=x_dev,
            cost=level_cost.sum(),
            energy=(P_lv * totals["run"]).sum(),
            toggle_cost=(bon_lv * totals["up"] + boff_lv * totals["down"]).sum(),
            level_cost=level_cost,
            group_cost=(
                None if self.costs.group_sizes is None
                else self.costs.group_reduce(level_cost)
            ),
            backlog=backlog,
            max_delay=qsnap.get("max_delay"),
            p99_delay=qsnap.get("p99_delay"),
            deadline_misses=qsnap.get("deadline_misses"),
            unserved=qsnap.get("unserved"),
        )
        toggles = int(np.abs(np.diff(x)).sum())
        if self._prev_x is not None:
            toggles += abs(int(x[0]) - self._prev_x)    # seam between chunks
        self._prev_x = int(x[-1])
        self.metrics.observe_plan(
            latency_ms, toggles, 0 if backlog is None else int(backlog[-1]),
        )
        return x

    def reset(self) -> None:
        """Drop the advance() carry and history — the next call starts a
        fresh trace (the kernel library stays loaded; state is data)."""
        self.state = None
        self._prev_x = None
        self._history = np.zeros(0, np.int64)
        self.last_plan = None

    def _as_i32(self, demand) -> torch.Tensor:
        a = demand if isinstance(demand, torch.Tensor) else torch.as_tensor(np.asarray(demand))
        peak = int(a.max())
        if peak > self.max_replicas and self.deferral is None:
            # with a deferral spec the service cap (== the fleet size by
            # default) absorbs the excess into the backlog instead
            raise ValueError(f"demand peak {peak} exceeds max_replicas {self.max_replicas}")
        return a.to(device=self.device, dtype=torch.int32)


#: the hardware defaults of :func:`replica_cost_model`, all from one NVIDIA
#: H100 80GB HBM3 at a 700.00 W power limit (``nvidia-smi
#: --query-gpu=name,power.limit --format=csv,noheader``): its power limit;
#: its median ``power.draw`` while idle, 131.26 W (``chip_smoke.py`` phase 14
#: (f), ten samples after a sync and 2 s of rest, a context and 14 GB held);
#: its memory rate, 3.35e12 B/s (NVIDIA's data sheet); and a cold build of
#: the attention kernels K3 and K4, the replica's compile step, 13.26 s
#: (``kernels/build_ms``, phase 2 of the same run)
H100_PEAK_POWER_W = 700.0
H100_IDLE_POWER_W = 131.26
H100_HBM_BW = 3.35e12
ATTENTION_BUILD_S = 13.26


def replica_cost_model(
    weights_bytes_per_device: float,
    n_chips: int,
    idle_power_w: float = H100_IDLE_POWER_W,
    peak_power_w: float = H100_PEAK_POWER_W,
    hbm_bw: float = H100_HBM_BW,
    compile_s: float = ATTENTION_BUILD_S,
    slot_s: float = 600.0,
) -> CostModel:
    """Derive the paper's (P, beta) constants for one model replica.

    beta_on ~ energy of the spin-up: weight load (HBM-bandwidth bound) +
    compile/warmup at peak power; beta_off ~ drain at idle power.  P = idle
    power per slot (serving energy is charged to sessions either way).
    Units: energy per slot (slot_s seconds).  The hardware defaults are the
    H100's (:data:`H100_PEAK_POWER_W` and the constants beside it), where
    the reference's are a TPU v5e's memory rate with other power and
    compile figures; with every argument given both compute the same.
    """
    load_s = weights_bytes_per_device / hbm_bw + compile_s
    beta_on = n_chips * peak_power_w * load_s / (idle_power_w * slot_s)
    beta_off = n_chips * idle_power_w * 0.25 * compile_s / (idle_power_w * slot_s)
    # normalize so P = 1 per slot per replica
    return CostModel(P=1.0, beta_on=beta_on / n_chips, beta_off=max(beta_off / n_chips, 0.1))
