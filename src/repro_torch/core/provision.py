"""One declarative provisioning API: ``provision(ProvisionSpec(...))``.

The PyTorch port of ``repro.core.provision``: ``provision()``,
``provision_stream()`` and their spec (the multi-device ``mesh=`` route
comes in a later slice).  The spec is three frozen dataclasses plus
options:

  * :class:`~repro_torch.core.costs.CostModel` — ``P``/``beta_on``/
    ``beta_off`` as scalars or ``(n_levels,)`` arrays; Δ is derived per
    level (paper eq. 12); typed fleets come from ``CostModel.from_groups``;
  * :class:`Workload` — demand ``(T,)`` or ``(B, T)``, an optional
    ``predicted`` trace, or a :class:`PredictionNoise` model that
    synthesizes one (paper Sec. V-C), and an optional
    :class:`~repro_torch.deferral.DeferralSpec` (defer-then-provision);
  * :class:`PolicySpec` — policy name, a single ``window`` or a ``windows``
    sweep axis (α = (w+1)/Δ), and the ``torch.Generator`` (or injected
    uniform tables) for A2/A3/AQ-rand.

:func:`provision` runs the whole (noise-stds × windows × traces × levels)
grid and returns a :class:`ProvisionResult`.  It runs on the card
(``ProvisionSpec.device`` defaults to ``"cuda"``), where every online
policy's slot scan is one launch of kernel K2 (of K1 under
``record_decisions``); ``device="cpu"`` runs the plain PyTorch scan.
:func:`provision_stream` returns the same result through K2 at any tile
size, for production-length traces.  Without CUDA and without
``device="cpu"`` both raise — they never fall back.

Shape convention: the result keeps a leading windows axis iff the spec used
``windows=``, a batch axis iff demand was ``(B, T)``, and an outermost
noise axis iff ``PredictionNoise.std_frac`` was a ``(S,)`` sweep — so
``result.x`` is ``(T,)``, ``(B, T)``, ``(W, T)``, ``(W, B, T)`` … up to
``(S, W, B, T)``.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any

import torch

from ..deferral import DeferralSpec
from ..obs import provenance as _prov
from ..obs.telemetry import get_telemetry
from . import torch_provision as _engine
from .costs import CostModel

#: demand, predicted traces and injected draws: a tensor, or anything
#: ``torch.as_tensor`` takes (numpy arrays, lists)
TensorLike = Any


@dataclasses.dataclass(frozen=True, eq=False)
class PredictionNoise:
    """Zero-mean Gaussian prediction error, std = ``std_frac`` × actual load.

    The peek step reads ``max(round(a + std * z * a), 0)`` with standard
    normals ``z`` (paper Sec. V-C), rounded half to even as the reference's
    ``jnp.rint``.  ``z`` is drawn from ``generator``, or injected as
    ``normals`` of the demand's shape ((T,) or (B, T)).

    ``std_frac`` is a float, or a ``(S,)`` sequence to sweep error levels as
    a leading axis of the result: the normal draw is shared across the sweep
    (common random numbers), only its scale varies.
    """

    std_frac: float | TensorLike
    generator: torch.Generator | None = None
    normals: TensorLike | None = None

    def apply(self, demand: torch.Tensor) -> torch.Tensor:
        """Predicted trace(s) for ``demand`` (int32, same device); a ``(S,)``
        ``std_frac`` prepends an S axis."""
        a = demand.to(torch.float32)
        if self.normals is not None:
            z = torch.as_tensor(self.normals, device=a.device).to(torch.float32)
            if z.shape != a.shape:
                raise ValueError(
                    f"normals shape {tuple(z.shape)} must match demand shape "
                    f"{tuple(a.shape)}"
                )
        elif self.generator is not None:
            g = self.generator
            z = torch.randn(a.shape, generator=g, device=g.device).to(a.device)
        else:
            raise ValueError("PredictionNoise needs a generator or injected normals=")
        std = torch.as_tensor(self.std_frac, dtype=torch.float32, device=a.device)
        if std.ndim == 1:
            std = std.reshape((std.shape[0],) + (1,) * a.ndim)
        elif std.ndim > 1:
            raise ValueError(
                f"std_frac must be a scalar or a (S,) sweep, got shape {tuple(std.shape)}"
            )
        return torch.clamp(torch.round(a + std * z * a), min=0.0).to(torch.int32)


@dataclasses.dataclass(frozen=True, eq=False)
class Workload:
    """Demand trace(s) plus what the peek step is allowed to see.

    ``demand``: (T,) or (B, T) integer concurrency per slot.  ``predicted``:
    optional trace(s) of the same shape the prediction window reads (the
    dispatcher always sees the true current slot).  ``noise``: optional
    :class:`PredictionNoise` that synthesizes ``predicted`` from ``demand``;
    mutually exclusive with an explicit ``predicted``.  ``deferral``:
    optional :class:`~repro_torch.deferral.DeferralSpec` marking the demand
    as *arrivals with slack*: ``provision()`` water-fills the arrivals into
    the deferred service profile before the engine sees them
    (defer-then-provision) and reports queue metrics on the result.
    """

    demand: TensorLike
    predicted: TensorLike | None = None
    noise: PredictionNoise | None = None
    deferral: DeferralSpec | None = None

    def resolve_predicted(self, demand_i32: torch.Tensor) -> torch.Tensor | None:
        if self.predicted is not None and self.noise is not None:
            raise ValueError("pass either predicted= or noise=, not both")
        if self.noise is not None:
            return self.noise.apply(demand_i32)
        if self.predicted is not None:
            return torch.as_tensor(self.predicted, device=demand_i32.device).to(torch.int32)
        return None


@dataclasses.dataclass(frozen=True, eq=False)
class PolicySpec:
    """Which algorithm runs, with how much future, under which randomness.

    ``name``: one of ``repro_torch.core.torch_provision.POLICIES``.
    ``window``: the number of future slots the peek sees (α = (window+1)/Δ
    per level).  ``windows``: optional (W,) sweep axis — evaluates every
    window in one run and puts a leading W axis on the result; overrides
    ``window``.  ``generator``: the ``torch.Generator`` the randomized A2/A3
    and AQ-rand draw their wait uniforms from; or ``uniforms=(u0, u)``,
    two injected (B, T, N) tables ((T, N) for unbatched demand).  The
    Albers–Quedenfeld pair ``AQ-det``/``AQ-rand`` never peeks, so both
    ignore ``window``/``windows`` (the sweep axis broadcasts).
    """

    name: str = "A1"
    window: int = 0
    windows: TensorLike | None = None
    generator: torch.Generator | None = None
    uniforms: tuple[TensorLike, TensorLike] | None = None

    def validate(self) -> "PolicySpec":
        """Raise ValueError for unknown policy names or missing randomness on
        the randomized policies; returns self (chainable)."""
        _engine._check_policy(self.name)
        if self.name in _engine.KEYED:
            _engine._require_randomness(self.name, self.generator, self.uniforms)
        return self


@dataclasses.dataclass(frozen=True, eq=False)
class ProvisionSpec:
    """The complete declarative input of one provisioning computation.

    ``n_levels``: fleet size; defaults to the cost model's per-level length,
    else ``max(demand) + 1``.  ``device``: where the engine runs —
    ``"cuda"`` (the default: kernels K1 and K2) or ``"cpu"`` (the plain
    scans).
    """

    costs: CostModel
    workload: Workload
    policy: PolicySpec
    n_levels: int | None = None
    device: str | torch.device = "cuda"


@dataclasses.dataclass(frozen=True, eq=False)
class ProvisionResult:
    """What one :func:`provision` call produced (tensors on the spec's device).

    ``x``: powered-on servers per slot, (..., T) int32.  ``cost`` =
    ``energy`` + ``toggle_cost`` (paper eq. 5, forced x(T)=a(T) boundary).
    ``level_cost``: (..., N) per-level totals.  ``group_cost``: (..., d)
    per-type totals for typed fleets (``CostModel.from_groups``); None for
    ungrouped models.

    ``provision(spec, record_decisions=True)`` fills the provenance pair on
    both devices: ``decisions``, the (..., T, N) uint8 per-slot reason
    bitmask (written by K1 on CUDA), and ``decision_counts``, a dict of the
    four aggregate per-level counters (..., N) int32 keyed by
    ``repro_torch.obs.provenance.COUNT_ORDER`` names (K1's counters on
    CUDA, the codes' sums on the CPU).
    :func:`provision_stream` fills ``decision_counts`` only.

    Deferral-enabled workloads (``Workload(deferral=...)``) additionally
    fill the queue metrics, measured on the true arrivals (int32):
    ``backlog`` (..., T) work still queued after each slot; ``max_delay`` /
    ``p99_delay`` (...) worst and 99th-percentile queueing delay in slots
    over served units; ``deadline_misses`` (...) units that expired while
    queued; ``unserved`` (...) units left at the horizon (0 whenever the
    schedule covers the deferred profile).  All None without deferral.
    """

    x: torch.Tensor
    cost: torch.Tensor
    energy: torch.Tensor
    toggle_cost: torch.Tensor
    level_cost: torch.Tensor
    group_cost: torch.Tensor | None = None
    decisions: torch.Tensor | None = None
    decision_counts: dict | None = None
    backlog: torch.Tensor | None = None
    max_delay: torch.Tensor | None = None
    p99_delay: torch.Tensor | None = None
    deadline_misses: torch.Tensor | None = None
    unserved: torch.Tensor | None = None


def _resolve_device(device, owner: str = "ProvisionSpec") -> torch.device:
    """``device`` as a ``torch.device``: cuda or cpu, and cuda only where
    CUDA is available (``RuntimeError`` naming ``owner``, the entry point
    that was given it)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{owner}(device={str(device)!r}) but CUDA is not available: "
            "pass device=\"cpu\" to run the plain PyTorch route on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be cuda or cpu, got {device!r}")
    return dev


@contextlib.contextmanager
def _device_span(name: str, device: torch.device):
    """A telemetry span over work launched on ``device``.  With telemetry
    on and a CUDA device it waits for the card on entry and on exit, so that
    it times that work alone (two synchronizations per span); with
    telemetry off it does nothing."""
    tel = get_telemetry()
    sync = tel.enabled and device.type == "cuda"
    if sync:
        torch.cuda.synchronize(device)
    with tel.span(name):
        yield
        if sync:
            torch.cuda.synchronize(device)


def _prepare(spec: ProvisionSpec, pol: PolicySpec, device: torch.device) -> dict:
    """Normalize a validated spec into engine-shaped inputs on ``device``:
    applies deferral water-filling, resolves the predicted trace / noise
    sweep, infers ``n_levels``, broadcasts the cost fields per level, takes
    or draws the wait uniforms, and derives the squeeze conventions.  Also
    returns the true ``arrivals`` (queue metrics are measured on those, not
    on the deferred profile)."""
    a = torch.as_tensor(spec.workload.demand, device=device).to(torch.int32)
    if a.ndim not in (1, 2):
        raise ValueError(f"demand must be (T,) or (B, T), got shape {tuple(a.shape)}")
    defer = spec.workload.deferral
    arrivals = a
    if defer is not None:
        # defer-then-provision: the engine (predictions, noise, n_levels
        # inference, the offline baseline) runs on the water-filled service
        # profile; queue metrics are measured on the true arrivals
        with _device_span("provision/deferral_apply", device):
            a = defer.validate().apply(a)
    squeeze_b = a.ndim == 1
    ab = a[None] if squeeze_b else a
    noise = spec.workload.noise
    squeeze_s = noise is None or torch.as_tensor(noise.std_frac).ndim == 0
    pred = spec.workload.resolve_predicted(a)
    if pred is None:
        predb = ab[None]
    else:
        want = (
            tuple(a.shape)
            if squeeze_s
            else (torch.as_tensor(noise.std_frac).shape[0],) + tuple(a.shape)
        )
        if tuple(pred.shape) != want:
            raise ValueError(
                f"predicted shape {tuple(pred.shape)} must match demand shape "
                f"{tuple(a.shape)}"
                + ("" if squeeze_s else
                   f" with a leading noise-sweep axis (expected {want})")
            )
        predb = pred.unsqueeze(-2) if squeeze_b else pred
        if squeeze_s:
            predb = predb[None]                              # (S=1, B, T)

    spec.costs.validate_groups()
    n_levels = spec.n_levels
    if n_levels is None:
        n_levels = spec.costs.n_levels
    if n_levels is None:
        if ab.numel() == 0 or ab.device.type == "meta":
            raise ValueError(
                "n_levels cannot be derived from demand without concrete "
                "values (max(demand) is undefined): pass "
                "ProvisionSpec(n_levels=...) explicitly or use a CostModel "
                "with (n_levels,) per-level fields"
            )
        n_levels = int(ab.max()) + 1
    P_lv, bon_lv, boff_lv = spec.costs.per_level(n_levels, device)
    delta_lv = torch.as_tensor(
        spec.costs.delta, dtype=torch.float32, device=device
    ).broadcast_to((n_levels,))

    squeeze_w = pol.windows is None
    windows = [int(pol.window)] if squeeze_w else [
        int(w) for w in torch.as_tensor(pol.windows).reshape(-1).tolist()
    ]

    uniforms = None
    if pol.name in _engine.KEYED:
        B, T = ab.shape
        if pol.uniforms is not None:
            uniforms = tuple(
                torch.as_tensor(u, device=device).to(torch.float32) for u in pol.uniforms
            )
            uniforms = tuple(u[None] if squeeze_b and u.ndim == 2 else u for u in uniforms)
            if any(tuple(u.shape) != (B, T, n_levels) for u in uniforms):
                raise ValueError(
                    f"uniforms must be two (B, T, N) = {(B, T, n_levels)} tables, "
                    f"got {[tuple(u.shape) for u in uniforms]}"
                )
        else:
            uniforms = _engine._uniforms(pol.generator, B, T, n_levels, device)
    return dict(
        arrivals=arrivals, defer=defer, ab=ab, predb=predb, squeeze_b=squeeze_b,
        squeeze_w=squeeze_w, squeeze_s=squeeze_s, windows=windows, uniforms=uniforms,
        n_levels=n_levels, P_lv=P_lv, bon_lv=bon_lv, boff_lv=boff_lv,
        delta_lv=delta_lv, max_h=spec.costs.delta_slots(),
    )


def provision(spec: ProvisionSpec, *, record_decisions: bool = False) -> ProvisionResult:
    """Run a :class:`ProvisionSpec` end to end on ``spec.device``.

    On CUDA every online policy's whole (S, W, B) grid is one launch of
    kernel K2, which returns x(t) and the per-level totals without a (T, N)
    on-matrix (A2/A3/AQ-rand draw their waits from the uniforms inside it);
    on the CPU it is the plain PyTorch slot loop.  ``offline`` is the
    closed-form hindsight optimum on both.

    ``record_decisions=True`` fills ``ProvisionResult.decisions`` and
    ``decision_counts`` with the per-slot reason codes of
    :mod:`repro_torch.obs.provenance` and their per-level counts; on CUDA
    the grid is then one launch of K1, which writes the on-matrix and the
    codes.  Rejected for ``offline``, which is a closed form with no slot
    scan to record.
    """
    device = _resolve_device(spec.device)
    return _provision(spec, record_decisions=record_decisions,
                      kernel=device.type == "cuda")


def _provision(spec: ProvisionSpec, *, record_decisions: bool, kernel: bool) -> ProvisionResult:
    """:func:`provision` with the scan route chosen by the caller: the
    kernels (``kernel=True``, CUDA only: K2, or K1 under record) or the plain
    scan on ``spec.device`` — the latter on a CUDA spec is how the kernel
    route is checked on the card."""
    pol = spec.policy.validate()
    if record_decisions and pol.name == "offline":
        raise ValueError(
            "record_decisions=True: 'offline' is the closed-form hindsight "
            "optimum — it has no slot scan, so there are no per-slot "
            "decisions to record"
        )
    device = _resolve_device(spec.device)
    pr = _prepare(spec, pol, device)
    tel = get_telemetry()
    with tel.span("provision", policy=pol.name, route=device.type,
                  n_levels=pr["n_levels"], record=record_decisions):
        out = _engine._run(
            pr["ab"], pr["predb"], pr["windows"], pr["delta_lv"], pr["P_lv"],
            pr["bon_lv"], pr["boff_lv"], pr["uniforms"],
            n_levels=pr["n_levels"], max_h=pr["max_h"], policy=pol.name,
            record=record_decisions, kernel=kernel,
        )
        out = _squeeze(out, pr)
    return _result(spec, out, record_decisions, tel, pr)


def provision_stream(spec: ProvisionSpec, *, t_chunk: int | None = None,
                     record_decisions: bool = False) -> ProvisionResult:
    """:func:`provision` for production-length traces: the same spec and the
    same result, bit for bit, without the (T, N) on-matrix.

    Every online policy's whole (S, W, B) grid is one call of the streaming
    scan — one launch of kernel K2 on CUDA, its plain tiled loop on the CPU
    — which returns x(t) and per-level totals, so the memory of a call is
    O(cells · (T + levels)) plus the two (B, T, N) uniform tables of the
    randomized policies, which the common-random-numbers contract pins to
    absolute slots (on the CPU, plus their (W·B, T, N) wait tables; on CUDA
    K2 draws each wait from the uniforms itself).  ``t_chunk`` (default
    :data:`repro_torch.kernels.provision_scan.DEFAULT_T_CHUNK`, clamped to
    the trace length) is the tile size; it never changes a result.

    As in the reference: ``offline`` is rejected (a closed form over the
    whole trace, nothing to stream), and ``record_decisions=True`` fills
    ``decision_counts`` only — per-slot ``decisions`` are the O(T · N)
    buffer streaming exists to avoid.  ``Workload(deferral=...)`` fills the
    same queue metrics as :func:`provision` does.
    """
    from ..kernels.provision_scan import DEFAULT_T_CHUNK

    pol = spec.policy.validate()
    if pol.name == "offline":
        raise ValueError(
            "provision_stream is online-only: 'offline' is the closed-form "
            "hindsight optimum over the whole trace — use provision()"
        )
    device = _resolve_device(spec.device)
    pr = _prepare(spec, pol, device)
    T = pr["ab"].shape[-1]
    t_chunk = int(min(max(int(DEFAULT_T_CHUNK if t_chunk is None else t_chunk), 1),
                      max(T, 1)))
    tel = get_telemetry()
    with tel.span("provision_stream", policy=pol.name, route=device.type,
                  n_levels=pr["n_levels"], t_chunk=t_chunk, record=record_decisions):
        out = _engine._run_stream(
            pr["ab"], pr["predb"], pr["windows"], pr["delta_lv"], pr["P_lv"],
            pr["bon_lv"], pr["boff_lv"], pr["uniforms"],
            n_levels=pr["n_levels"], max_h=pr["max_h"], policy=pol.name,
            t_chunk=t_chunk, record=record_decisions,
        )
        out = _squeeze(out, pr)
    return _result(spec, out, record_decisions, tel, pr)


def _squeeze(out: dict, pr: dict) -> dict:
    """Drop the engine's (S, W, B) leading axes that the spec did not ask for."""

    def one(o):
        if pr["squeeze_b"]:
            o = o.squeeze(2)
        if pr["squeeze_w"]:
            o = o.squeeze(1)
        if pr["squeeze_s"]:
            o = o.squeeze(0)
        return o

    return {k: one(v) for k, v in out.items()}


def _result(spec: ProvisionSpec, out: dict, record_decisions: bool, tel,
            pr: dict) -> ProvisionResult:
    """A :class:`ProvisionResult` from the engine's squeezed per-level terms:
    the totals, the per-type reduction, under ``record_decisions`` the
    decision counters (the kernel's where a kernel counted them, else
    summed from the per-slot codes), and under deferral the queue metrics
    of the true arrivals against the schedule."""
    decisions = out.pop("decisions", None)
    rows = out.pop("decision_counts", None)             # (..., 4, N) int32
    counts = None
    if record_decisions:
        if rows is not None:
            counts = {name: rows[..., i, :] for i, name in enumerate(_prov.COUNT_ORDER)}
        else:
            counts = {
                name: ((decisions & bit) != 0).sum(dim=-2, dtype=torch.int32)
                for name, bit in zip(_prov.COUNT_ORDER, _prov.COUNT_BITS)
            }
        if tel.enabled:
            tel.count("provision/decision_toggle_offs", float(counts["toggle_off"].sum()))

    level_cost = out["energy"] + out["on_cost"] + out["off_cost"]
    defer = pr["defer"]
    queue = {}
    if defer is not None:
        with _device_span("provision/deferral_metrics", out["x"].device):
            queue = defer.metrics(pr["arrivals"], out["x"])
    return ProvisionResult(
        x=out["x"],
        cost=level_cost.sum(dim=-1),
        energy=out["energy"].sum(dim=-1),
        toggle_cost=(out["on_cost"] + out["off_cost"]).sum(dim=-1),
        level_cost=level_cost,
        group_cost=(
            None if spec.costs.group_sizes is None
            else spec.costs.group_reduce(level_cost)
        ),
        decisions=decisions,
        decision_counts=counts,
        backlog=queue.get("backlog"),
        max_delay=queue.get("max_delay"),
        p99_delay=queue.get("p99_delay"),
        deadline_misses=queue.get("deadline_misses"),
        unserved=queue.get("unserved"),
    )
