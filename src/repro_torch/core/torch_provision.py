"""The paper's provisioning algorithms as a batched PyTorch engine.

The PyTorch port of ``repro.core.jax_provision``.
The fluid-model level decomposition makes every algorithm an independent
per-level computation, so the whole fleet is one scan over slots with a
``(cells, levels)`` state.  A *cell* is one (noise-std, window, trace)
combination of a :class:`~repro_torch.core.provision.ProvisionSpec`'s
sweep; the engine lays the whole ``(S, W, B)`` grid out as cells, the way
the reference's sharded grid does, and runs it in one scan:

  * on a CUDA device through kernel K2
    (:func:`repro_torch.kernels.provision_scan.provision_scan_stream`, via
    :func:`_run_stream`), one thread per (cell, level) looping over the
    slots on the card and returning x(t) and per-level totals; under
    ``record`` through K1 (:func:`repro_torch.kernels.provision_scan.
    provision_scan_grid`), which also writes the (T, N) on-matrix and the
    per-slot reason codes;
  * on the CPU through :func:`_on_matrix_scan`, a Python loop over slots of
    plain tensor ops — the CPU route and K1's oracle.

:func:`_run_stream` is also the engine of ``provision_stream()``: the same
grid through K2 or its plain version :func:`_stream_scan`.
:func:`_sharded_run` is the multi-device route of both: the level axis
sharded over the ranks of a ``DeviceMesh`` axis, each rank scanning its
block of levels through :func:`_run_stream` (K2 on the card), x(t) summed
and the per-level terms gathered across the ranks.

Policies: ``A1`` (deterministic, ratio ``2 - α``), ``A2`` (randomized,
``(e-α)/(e-1)``), ``A3`` (randomized, ``e/(e-1+α)``), ``offline``
(hindsight optimum, closed form), ``delayedoff``, and the typed-fleet pair
``AQ-det`` / ``AQ-rand`` (Albers–Quedenfeld, arXiv 2107.14672).

Randomness contract: the keyed policies consume two ``(B, T, N)`` uniform
tables (:func:`_uniforms`); the draw at ``[b, t, l]`` is consumed iff level
``l`` of trace ``b`` becomes newly idle in slot ``t``.  The same tables
serve every window and every noise level (common random numbers).  The
tables can be injected, which is how the tests hold the port to the
reference's draws bit for bit.
"""
from __future__ import annotations

import math
import warnings
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from ..obs import provenance as _prov

E = math.e

POLICIES = ("A1", "A2", "A3", "offline", "delayedoff", "AQ-det", "AQ-rand")
RANDOMIZED = ("A2", "A3")
#: policies that consume random wait tables (RANDOMIZED plus the typed AQ-rand)
KEYED = RANDOMIZED + ("AQ-rand",)
#: policies with no prediction peek (ski-rental timers only)
NO_PEEK = ("delayedoff", "AQ-det", "AQ-rand")
#: policies whose schedule ignores the window sweep entirely
WINDOW_FREE = ("offline",) + NO_PEEK


def _check_policy(policy: str) -> None:
    if policy not in POLICIES:
        raise ValueError(
            f"unknown policy {policy!r}: valid policies are {POLICIES}"
        )


def _require_randomness(policy: str, generator, uniforms) -> None:
    if generator is None and uniforms is None:
        raise ValueError(
            f"policy {policy!r} is randomized: pass an explicit generator "
            "(or injected uniforms=)"
        )


# ---------------------------------------------------------------------------
# Randomized-wait sampling (ski-rental thresholds)
# ---------------------------------------------------------------------------

def _uniforms(generator: torch.Generator, B: int, T: int, n_levels: int,
              device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """Two (B, T, n_levels) U(0,1) tables: atom draw (A3) and value draw.

    Drawn on the generator's own device and moved to ``device``, so a CPU
    generator serves a CUDA run (and gives the same numbers on both).
    """
    shape = (B, T, n_levels)
    u0 = torch.rand(shape, generator=generator, device=generator.device)
    u = torch.rand(shape, generator=generator, device=generator.device)
    return u0.to(device), u.to(device)


def _wait_rows(policy, windows, delta):
    """Per-window rows of A2/A3's inverse CDF: ``span`` (W, N) and, for A3,
    the atom probability ``p0`` (W, N) (else None).

    A2: Z ~ e^{z/((1-α)Δ)} / ((e-1)(1-α)Δ) on [0, (1-α)Δ], so span =
    (1-α)Δ.  A3: an atom at 0 w.p. α/(e-1+α), else A2's density.  AQ-rand:
    the no-peek α = 0 case.  ``delta`` is a float32 ``(N,)`` tensor;
    ``windows`` python ints.  The op order is the reference's.
    """
    b = delta
    wf = torch.tensor([float(w) for w in windows], dtype=torch.float32, device=b.device)
    alpha = torch.clamp((wf[:, None] + 1.0) / b, 0.0, 1.0)
    if policy == "AQ-rand":             # no peek: the window never enters
        alpha = torch.zeros_like(alpha)
    span = (1.0 - alpha) * b
    p0 = alpha / (E - 1.0 + alpha) if policy == "A3" else None
    return span, p0


def _waits(u0, u, span, p0):
    """Wait thresholds from uniform tables: ``span * log1p(u * (e-1))``, and 0
    where ``u0 < p0`` when there is an atom (``p0`` not None).  ``span`` and
    ``p0`` broadcast over the tables' last (level) axis.  The same uniforms
    give the same waits up to the device's ``log1p``."""
    waits = span * torch.log1p(u * (E - 1.0))
    if p0 is not None:
        waits = torch.where(u0 < p0, 0.0, waits)
    return waits


def _waits_from_uniforms(policy, u0, u, window, delta):
    """Transform uniform tables into wait thresholds for a given window
    (:func:`_wait_rows` for that window, then :func:`_waits`)."""
    span, p0 = _wait_rows(policy, [window], delta)
    return _waits(u0, u, span[0], None if p0 is None else p0[0])


class UniformWaits(NamedTuple):
    """The waits of a keyed policy as the uniforms they are drawn from: K2's
    uniforms route, which applies :func:`_waits` to the entries a lane
    consumes instead of reading a built (K·Bu, T, N) table.

    Cell ``g`` draws from ``u[cell[g]]`` (and ``u0[cell[g]]``) with span row
    ``span[cell_thr[g]]`` (and ``p0[cell_thr[g]]``); ``u0`` and ``p0`` are
    None for policies without A3's atom.
    """

    u0: torch.Tensor | None     # (Bu, T, N) float32
    u: torch.Tensor             # (Bu, T, N) float32
    span: torch.Tensor          # (K, N) float32
    p0: torch.Tensor | None     # (K, N) float32
    cell: torch.Tensor          # (G,) int32

    def table(self, cell_thr):
        """The same waits as a (K·Bu, T, N) table and the cells' rows of it:
        row ``k·Bu + b`` holds span row ``k`` over uniforms ``b``.  This is
        the table route, and the uniforms route's plain version."""
        Bu = self.u.shape[0]
        table = torch.stack([
            _waits(self.u0, self.u, self.span[k], None if self.p0 is None else self.p0[k])
            for k in range(self.span.shape[0])
        ]).reshape(-1, *self.u.shape[1:])
        cell_thr = torch.as_tensor(cell_thr)                 # the rows stay where the map is
        return table, (cell_thr.long() * Bu
                       + self.cell.to(cell_thr.device, torch.long)).to(torch.int32)


# ---------------------------------------------------------------------------
# The per-level slot scan (all online policies): K1's plain version
# ---------------------------------------------------------------------------

def _slot_update(r, on, wait, busy, seen, wait_draw):
    """One slot of the per-level ski-rental engine, in the reference's op
    order.

    ``r``/``on``/``wait``: idle run length (f32), on bit, wait threshold
    (f32); ``busy``: dispatcher compare for this slot; ``seen``: peek
    verdict; ``wait_draw``: this slot's sampled thresholds (None for the
    deterministic policies, whose ``wait`` is the constant row).  Returns the
    updated state plus the ``expired``/``off_now`` decision bits.
    """
    on = on | busy                                 # dispatcher turn-on
    r = torch.where(busy, 0.0, r)
    idle = on & ~busy
    if wait_draw is not None:
        wait = torch.where(idle & (r == 0.0), wait_draw, wait)
    r = torch.where(idle, r + 1.0, r)
    expired = idle & (r - 1.0 >= wait)
    off_now = expired & ~seen
    on = on & ~off_now
    r = torch.where(off_now, 0.0, r)
    return (r, on, wait), expired, off_now


def _on_matrix_scan(traces, predicted, thresholds, cell_trace, cell_pred,
                    cell_thr, cell_hor, *, level_horizon, routes, horizon,
                    record=False):
    """(G, T, N) bool on-matrix over G cells, one Python loop over slots.

    The arguments are K1's (:func:`repro_torch.kernels.provision_scan.
    provision_scan_grid`): cell ``g`` runs demand row
    ``traces[cell_trace[g]]``, peeks into ``predicted[cell_pred[g]]``,
    waits on ``thresholds[cell_thr[g]]`` — a constant ``(1, N)`` row or a
    ``(T, N)`` table whose entry ``[t, l]`` is consumed iff level ``l``
    becomes newly idle in slot ``t`` — and masks its peek per level to
    ``h < level_horizon[cell_hor[g]]``; ``horizon`` slots are examined.
    Lane ``j`` dispatches against level id ``routes[j]``.

    Returns ``(ons, codes)``: ``codes`` is None, or with ``record=True`` the
    (G, T, N) uint8 :mod:`repro_torch.obs.provenance` reason bitmask.
    """
    dev = traces.device
    cell_trace, cell_pred, cell_thr, cell_hor = (
        c.to(dev, torch.long) for c in (cell_trace, cell_pred, cell_thr, cell_hor))
    a = traces[cell_trace]                                   # (G, T)
    G, T = a.shape
    n = routes.shape[0]
    p = predicted[cell_pred]
    pad = torch.cat([p, p.new_zeros((G, horizon))], dim=1)   # peek past T reads 0
    hor = level_horizon[cell_hor]                            # (G, N)
    time_varying = thresholds.shape[1] != 1
    ons = torch.empty((G, T, n), dtype=torch.bool, device=dev)
    codes = torch.empty((G, T, n), dtype=torch.uint8, device=dev) if record else None
    r = torch.zeros((G, n), dtype=torch.float32, device=dev)
    on = a[:, 0, None] > routes                              # x(0) = a(0)
    wait = (torch.zeros((G, n), dtype=torch.float32, device=dev) if time_varying
            else thresholds[cell_thr, 0])
    for t in range(T):
        busy = a[:, t, None] > routes
        if record:
            rise = busy & ~on                                # dispatcher turn-on edge
        seen = torch.zeros_like(busy)
        for h in range(horizon):
            seen = seen | ((pad[:, t + 1 + h, None] > routes) & (hor > float(h)))
        draw = thresholds[cell_thr, t] if time_varying else None
        (r, on, wait), expired, off_now = _slot_update(r, on, wait, busy, seen, draw)
        ons[:, t] = on
        if record:
            codes[:, t] = (
                rise.to(torch.uint8) * _prov.DEMAND_RISE
                + expired.to(torch.uint8) * _prov.WAIT_EXPIRED
                + (expired & seen).to(torch.uint8) * _prov.PEEK_FIRED
                + off_now.to(torch.uint8) * _prov.TOGGLE_OFF
            )
    return ons, codes


# ---------------------------------------------------------------------------
# The streaming slot scan (all online policies): K2's plain version
# ---------------------------------------------------------------------------

#: the streaming scan's per-lane totals, in K2's row order (the four
#: :data:`repro_torch.obs.provenance.COUNT_ORDER` counters follow under
#: ``record``)
STREAM_ACCS = ("run", "up", "down")


def _stream_scan(traces, predicted, thresholds, cell_trace, cell_pred, cell_thr,
                 cell_hor, *, level_horizon, routes, horizon, t_chunk, n_levels,
                 carry=None, record=False):
    """x(t), per-lane totals and the end carry over G cells, in tiles.

    The arguments are K2's (:func:`repro_torch.kernels.provision_scan.
    provision_scan_stream`) and mean what they mean for
    :func:`_on_matrix_scan`; ``thresholds`` may also be a
    :class:`UniformWaits`, whose table is built first.  The slots run in ``t_chunk``-slot tiles, each
    tile's predicted rows reaching ``horizon`` slots past it (0 past T), so
    the tile size never changes a result.  Instead of the on-matrix it
    returns ``(x, accs, carry)``:

      * ``x`` (G, T) int32, the on lanes per slot with lane ``j`` counted
        iff ``routes[j] < n_levels``;
      * ``accs``, a dict of (G, N) int32 totals under the same lane mask:
        :data:`STREAM_ACCS` (on-slots and toggle edges against the virtual
        x(0) = a(0) boundary, without the forced final off, which only the
        caller can add) plus the four decision counters under ``record``;
      * ``carry``, the ``{"r", "on", "wait"}`` (G, N) state after the last
        slot.

    ``carry=None`` starts a fresh trace: at its first slot the previous
    state is the busy pattern itself, so nothing turns on or off there.  A
    carry from an earlier call continues that trace instead.  With a
    constant threshold row the wait is the row and the carry's is ignored;
    with a time-varying table it starts from the carry.
    """
    dev = traces.device
    # a table of one slot is time-varying too: the uniforms route's waits are
    # drawn per slot, also when a chunk of one slot continues a carry
    time_varying = isinstance(thresholds, UniformWaits) or thresholds.shape[1] != 1
    if isinstance(thresholds, UniformWaits):     # the uniforms route: its waits as a table
        thresholds, cell_thr = thresholds.table(cell_thr)
    cell_trace, cell_pred, cell_thr, cell_hor = (
        c.to(dev, torch.long) for c in (cell_trace, cell_pred, cell_thr, cell_hor))
    G, T, n = cell_trace.shape[0], traces.shape[1], routes.shape[0]
    hor = level_horizon[cell_hor]                            # (G, N)
    lane_ok = routes < n_levels
    fresh = carry is None
    if fresh:
        r = torch.zeros((G, n), dtype=torch.float32, device=dev)
        on = torch.zeros((G, n), dtype=torch.bool, device=dev)
        wait = torch.zeros_like(r)
    else:
        r, on, wait = carry["r"], carry["on"], carry["wait"]
    if not time_varying:
        wait = thresholds[cell_thr, 0]
    names = STREAM_ACCS + (_prov.COUNT_ORDER if record else ())
    accs = torch.zeros((len(names), G, n), dtype=torch.int32, device=dev)
    x = torch.empty((G, T), dtype=torch.int32, device=dev)
    for t0 in range(0, T, t_chunk):
        # a tile stops at T: the reference's pad tail past T freezes the
        # state and the totals, which is what not running it does
        a = traces[cell_trace, t0:t0 + t_chunk]
        size = a.shape[1]
        p = predicted[cell_pred, t0 + 1:t0 + 1 + size + horizon]   # slots t0 + 1 ...
        p = torch.cat([p, p.new_zeros((G, size + horizon - p.shape[1]))], dim=1)
        thr = thresholds[cell_thr, t0:t0 + size] if time_varying else None
        for k in range(size):
            busy = a[:, k, None] > routes
            prev = busy if fresh and t0 + k == 0 else on     # virtual x(0) = a(0)
            seen = torch.zeros_like(busy)
            for h in range(horizon):
                seen = seen | ((p[:, k + h, None] > routes) & (hor > float(h)))
            (r, on, wait), expired, off_now = _slot_update(
                r, on, wait, busy, seen, None if thr is None else thr[:, k])
            x[:, t0 + k] = (on & lane_ok).sum(dim=-1, dtype=torch.int32)
            inc = [on, on & ~prev, prev & ~on]
            if record:
                inc += [busy & ~prev, expired, expired & seen, off_now]
            accs += (torch.stack(inc) & lane_ok).to(torch.int32)
    return x, dict(zip(names, accs)), {"r": r, "on": on, "wait": wait}


def _offline_levels(a, n_levels, delta):
    """Hindsight-optimal per-level schedule, closed form (no scan).

    ``a`` (..., T) demand; returns (..., T, N) bool.  Level on at slot t iff
    busy, or inside an interior idle gap of length <= Delta_l (prev and next
    busy exist and next - prev - 1 <= b_l).  ``torch.cummax`` and a flipped
    ``torch.cummin`` stand in for the reference's associative scans; the
    next-busy index is float32 (``T + b + 1``), as there.
    """
    T = a.shape[-1]
    b = delta.broadcast_to((n_levels,))
    levels = torch.arange(n_levels, device=a.device)
    busy = a[..., :, None] > levels                          # (..., T, N)
    idx = torch.arange(T, device=a.device)[:, None]
    prev_busy = torch.cummax(
        torch.where(busy, idx, -1), dim=-2
    ).values                                                 # last busy <= t
    next_busy = torch.flip(torch.cummin(
        torch.flip(torch.where(busy, idx.to(torch.float32), T + b + 1), [-2]),
        dim=-2,
    ).values, [-2])                                          # first busy >= t
    gap = next_busy - prev_busy - 1
    keep_idle = (prev_busy >= 0) & (next_busy <= T - 1) & (gap * 1.0 <= b)
    return busy | (~busy & keep_idle)


# ---------------------------------------------------------------------------
# Per-level cost reduction (heterogeneous-ready)
# ---------------------------------------------------------------------------

def _cost_terms(a, on_matrix, P_lv, beta_on_lv, beta_off_lv):
    """Per-level cost components of a schedule, each ``(..., N)``.

    ``a`` (..., T) demand, ``on_matrix`` (..., T, N); the cost fields are
    ``(N,)`` float32 tensors.  Initial state x(0)=a(0) is free; the final
    slot is forced to x(T)=a(T) (paper eq. 5).
    """
    ob = on_matrix.to(torch.bool)
    on = ob.to(torch.int32)
    levels = torch.arange(on_matrix.shape[-1], device=on_matrix.device)
    run_slots = on.sum(dim=-2, dtype=torch.int32)                 # (..., N)
    up = torch.clamp(on[..., 1:, :] - on[..., :-1, :], min=0).sum(dim=-2, dtype=torch.int32)
    down = torch.clamp(on[..., :-1, :] - on[..., 1:, :], min=0).sum(dim=-2, dtype=torch.int32)
    first_on = (ob[..., 0, :] & ~(a[..., 0, None] > levels)).to(torch.int32)
    final_off = (ob[..., -1, :] & ~(a[..., -1, None] > levels)).to(torch.int32)
    return {
        "energy": P_lv * run_slots,
        "on_cost": beta_on_lv * (up + first_on),
        "off_cost": beta_off_lv * (down + final_off),
    }


def on_matrix_cost(a, on_matrix, costs):
    """Total cost of a per-level schedule under a (possibly per-level) model.

    ``costs`` is a :class:`repro_torch.core.costs.CostModel`; supports
    leading batch axes: ``a`` (..., T), ``on_matrix`` (..., T, N).
    """
    on_matrix = torch.as_tensor(on_matrix)
    a = torch.as_tensor(a, device=on_matrix.device)
    P_lv, bon_lv, boff_lv = costs.per_level(on_matrix.shape[-1], on_matrix.device)
    terms = _cost_terms(a, on_matrix, P_lv, bon_lv, boff_lv)
    return (terms["energy"] + terms["on_cost"] + terms["off_cost"]).sum(dim=-1)


# ---------------------------------------------------------------------------
# The one engine body: the (S, W, B) grid as cells
# ---------------------------------------------------------------------------

def _grid_inputs(ab, predb, windows, delta, uniforms, *, n_levels, max_h, policy,
                 uniform_waits=False):
    """K1's inputs for one online policy over the (S, W', B) cell grid.

    ``ab`` (B, T) int32 demand; ``predb`` (S, B, T) int32 predicted rows;
    ``windows``: python ints; ``delta`` (N,) float32; ``uniforms``: the
    (B, T, N) pair for the keyed policies, else None.  Window-free policies
    run one window column (W' = 1), the others W' = len(windows).  Cell
    ``g = (s, w, b)`` in row-major order, as in the reference's sharded
    grid: A2/A3 read wait table ``w*B + b``, AQ-rand table ``b``, the
    deterministic policies the constant row ``w``.  With ``uniform_waits``
    the keyed policies' ``thresholds`` are a :class:`UniformWaits` instead
    (K2's uniforms route: span row ``w``, uniforms ``b``), which builds no
    table.  Returns the keyword arguments of
    :func:`repro_torch.kernels.provision_scan.provision_scan_grid` plus the
    cell-grid shape ``(S, W', B)``.
    """
    S, B, T = predb.shape
    dev = ab.device
    b = delta
    if policy in WINDOW_FREE:
        windows = [0]
    W = len(windows)
    wf = torch.tensor(windows, dtype=torch.float32, device=dev)
    s_ix, w_ix, b_ix = torch.meshgrid(     # on the host: K1's wrapper checks them there
        # repro-torch-lint: disable=RPT005 (host cell maps; moved to the card after the check)
        torch.arange(S), torch.arange(W), torch.arange(B), indexing="ij",
    )
    i32 = torch.int32
    cell_thr = w_ix.reshape(-1).to(i32)   # span or A1's row per window; the timers' one row
    if policy in KEYED:
        u0, u = uniforms
        span, p0 = _wait_rows(policy, windows, b)
        thresholds = UniformWaits(u0 if p0 is not None else None, u, span, p0,
                                  b_ix.reshape(-1).to(i32))
        if not uniform_waits:           # (W'·B, T, N) waits, row w·B + b
            thresholds, cell_thr = thresholds.table(cell_thr)
    elif policy in NO_PEEK:                                  # timer Δ_l
        thresholds = b[None, None, :].contiguous()           # (1, 1, N)
    else:                                                    # A1 per window
        thresholds = torch.clamp(b[None, :] - wf[:, None] - 1.0, min=0.0)[:, None, :]
    if policy in NO_PEEK:
        horizon = 0
        level_horizon = torch.zeros((1, n_levels), dtype=torch.float32, device=dev)
    else:
        horizon = int(min(max(windows) + 1, max_h))
        level_horizon = torch.minimum(wf[:, None] + 1.0, b[None, :])   # (W, N)
    kwargs = dict(
        traces=ab, predicted=predb.reshape(S * B, T),
        thresholds=thresholds if isinstance(thresholds, UniformWaits)
        else thresholds.contiguous(),
        cell_trace=b_ix.reshape(-1).to(i32), cell_pred=(s_ix * B + b_ix).reshape(-1).to(i32),
        cell_thr=cell_thr, cell_hor=w_ix.reshape(-1).to(i32),
        delta=max_h, horizon=horizon,
        routes=torch.arange(n_levels, dtype=i32, device=dev),
        level_horizon=level_horizon.contiguous(),
    )
    return kwargs, (S, W, B)


def _run(ab, predb, windows, delta, P_lv, beta_on_lv, beta_off_lv, uniforms, *,
         n_levels, max_h, policy, record=False, kernel=False):
    """Shared engine body behind :func:`repro_torch.core.provision.provision`.

    ``ab`` (B, T) int32 demand; ``predb`` (S, B, T) int32 predicted rows;
    ``windows``: python ints (W,); ``delta``/cost fields: (N,) float32;
    ``uniforms``: the injected or drawn (B, T, N) pair for the keyed
    policies, else None.  Returns a dict of ``x`` (S, W, B, T) int32 and
    per-level cost terms (S, W, B, N) float32; window-free policies run once
    and are broadcast over the W axis (expanded views).  ``record=True``
    adds the per-slot ``decisions`` (S, W, B, T, N) uint8, and on the K1
    route K1's ``decision_counts`` (S, W, B, 4, N) int32 beside them.

    The online policies' slot scan, by route:

      * ``kernel=False``: :func:`_on_matrix_scan` (the CPU route, and the
        kernels' oracle on the card), reduced by :func:`_cost_terms`;
      * ``kernel=True`` (CUDA tensors only), without ``record``:
        :func:`_run_stream`, one launch of K2, which returns x and the
        per-level totals itself — no (T, N) on-matrix is built;
      * ``kernel=True`` with ``record``: K1, which writes the on-matrix and
        the reason codes, reduced by :func:`_cost_terms`.
    """
    if record and policy == "offline":
        raise ValueError("record=True: offline has no slot scan to record")
    B, T = ab.shape
    S = predb.shape[0]
    W = len(windows)
    if policy == "offline":
        ons = _offline_levels(ab, n_levels, delta)           # (B, T, N)
        out = _cost_terms(ab, ons, P_lv, beta_on_lv, beta_off_lv)
        out["x"] = ons.sum(dim=-1, dtype=torch.int32)
        return {k: v.expand((S, W) + v.shape) for k, v in out.items()}
    if kernel and not record:
        from ..kernels.provision_scan import DEFAULT_T_CHUNK

        return _run_stream(ab, predb, windows, delta, P_lv, beta_on_lv, beta_off_lv,
                           uniforms, n_levels=n_levels, max_h=max_h, policy=policy,
                           t_chunk=DEFAULT_T_CHUNK)

    inputs, (S, Wc, B) = _grid_inputs(
        ab, predb, windows, delta, uniforms,
        n_levels=n_levels, max_h=max_h, policy=policy,
    )
    counts = None
    if kernel:
        from ..kernels.provision_scan import provision_scan_grid

        ons, counts, codes = provision_scan_grid(**inputs, record=True, codes=True)
    else:
        ons, codes = _on_matrix_scan(
            **{k: v for k, v in inputs.items() if k != "delta"}, record=record,
        )
    ons = ons.reshape(S, Wc, B, T, n_levels)
    out = _cost_terms(ab, ons, P_lv, beta_on_lv, beta_off_lv)
    out["x"] = ons.sum(dim=-1, dtype=torch.int32)
    if codes is not None:
        out["decisions"] = codes.reshape(S, Wc, B, T, n_levels)
    if counts is not None:
        out["decision_counts"] = counts.reshape(S, Wc, B, 4, n_levels)
    if Wc != W:                                              # window-free
        out = {k: v.expand((S, W) + v.shape[2:]) for k, v in out.items()}
    return out


def _run_stream(ab, predb, windows, delta, P_lv, beta_on_lv, beta_off_lv, uniforms, *,
                n_levels, max_h, policy, t_chunk, record=False, routes=None):
    """Streaming twin of :func:`_run`, behind
    :func:`repro_torch.core.provision.provision_stream`.

    The same (S, W', B) cell grid, waits and common random numbers as
    :func:`_run`, as one call of :func:`repro_torch.kernels.provision_scan.
    provision_scan_stream` — K2 on CUDA tensors, its plain version on the
    CPU — which returns x(t) and per-level totals instead of the (T, N)
    on-matrix.  The keyed policies take K2's uniforms route: on CUDA the
    kernel draws each wait from the (B, T, N) uniforms where it is consumed,
    and no (W·B, T, N) wait table is built; on the CPU the plain version
    builds that table first.  The forced x(T) = a(T) final off is added
    here from the end carry.  Returns what :func:`_run` returns, bit for bit, with
    ``decision_counts`` (S, W, B, 4, N) under ``record`` on both devices.
    ``offline`` is rejected: it is a closed form over the whole trace.

    ``routes``: the lanes' routing ids, one per entry of ``delta`` and the
    cost fields (default 0..n_levels-1).  A lane dispatches against its id,
    and a lane whose id is not below ``n_levels`` is a pad lane that counts
    nowhere; :func:`_sharded_run` passes a rank's block this way.
    """
    if policy == "offline":
        raise ValueError(
            "offline is closed-form over the full trace; the streaming engine "
            "is online-only — use provision() for offline"
        )
    from ..kernels.provision_scan import provision_scan_stream

    T = ab.shape[1]
    W = len(windows)
    lanes = n_levels if routes is None else routes.shape[0]
    inputs, (S, Wc, B) = _grid_inputs(
        ab, predb, windows, delta, uniforms,
        n_levels=lanes, max_h=max_h, policy=policy, uniform_waits=True,
    )
    del inputs["delta"]
    if routes is not None:
        inputs["routes"] = routes
    x, accs, carry = provision_scan_stream(
        **inputs, t_chunk=t_chunk, n_levels=n_levels, record=record)
    lead = (S, Wc, B, lanes)
    # close the trace: a real level still on at T that the last slot's
    # demand does not need turns off
    routes = inputs["routes"]
    busy_end = ab[:, T - 1, None] > routes                       # (B, N)
    final_off = (carry["on"].reshape(lead) & (routes < n_levels) & ~busy_end).to(torch.int32)
    out = {
        "energy": P_lv * accs["run"].reshape(lead),
        "on_cost": beta_on_lv * accs["up"].reshape(lead),
        "off_cost": beta_off_lv * (accs["down"].reshape(lead) + final_off),
        "x": x.reshape(S, Wc, B, T),
    }
    if record:
        out["decision_counts"] = torch.stack(
            [accs[name].reshape(lead) for name in _prov.COUNT_ORDER], dim=-2)
    if Wc != W:                                              # window-free
        out = {k: v.expand((S, W) + v.shape[2:]) for k, v in out.items()}
    return out


# ---------------------------------------------------------------------------
# Fleet-scale engine body: shard the level axis over a device mesh
# ---------------------------------------------------------------------------

#: routing id for pad lanes in the sharded level layout: compares false
#: against any int32 demand, so a pad lane can never turn on
ROUTE_SENTINEL = 2**30


def _group_layout(n_levels, group_sizes, size):
    """Static (route, sel, n_layout) storage layout for the sharded level axis.

    ``route[j]`` is the *routing id* of storage lane ``j`` — the global
    level the busy compare ``a(t) > route[j]`` dispatches against — or
    ``ROUTE_SENTINEL`` for pad lanes.  ``sel[l]`` is the storage lane of
    real level ``l`` (compacts gathered per-lane outputs back to level
    order).  Ungrouped fleets lay levels out contiguously.  Typed fleets pad
    each group to an 8-lane multiple — capped at 128 lanes — as the
    reference does for its kernel's blocks.  The tail is padded to a
    multiple of ``size`` (the number of ranks) either way.
    """
    if group_sizes is None:
        sizes = padded = [int(n_levels)]
    else:
        sizes = [int(s) for s in group_sizes]
        align = min(128, -(-max(sizes) // 8) * 8)
        padded = [-(-s // align) * align for s in sizes]
    n_layout = -(-sum(padded) // size) * size
    route = np.full(n_layout, ROUTE_SENTINEL, np.int32)
    sel = np.empty(n_levels, np.int64)
    off_route = off_lane = 0
    for s, p in zip(sizes, padded):
        route[off_lane:off_lane + s] = np.arange(off_route, off_route + s)
        sel[off_route:off_route + s] = np.arange(off_lane, off_lane + s)
        off_route += s
        off_lane += p
    return route, sel, n_layout


def _mesh_axis(mesh, axis, device):
    """The process group, size and rank of ``mesh``'s axis ``axis``.  The
    mesh must live on ``device``'s type: the route never moves a spec to
    another device."""
    names = mesh.mesh_dim_names or ()
    if axis not in names:
        raise ValueError(f"mesh has no axis {axis!r}; its axes are {tuple(names)}")
    if mesh.device_type != device.type:
        raise ValueError(
            f"the mesh is on {mesh.device_type!r} but the spec runs on "
            f"{device.type!r}: build the mesh on the spec's device type"
        )
    group = mesh.get_group(axis)
    return group, dist.get_world_size(group), dist.get_rank(group)


def _on_wire(t, group):
    """``t`` where ``group``'s backend takes it: gloo moves CUDA tensors
    through the host, NCCL takes them where they are."""
    return t.cpu() if t.is_cuda and dist.get_backend(group) == "gloo" else t


def _sum_ranks(t, group):
    """``t`` summed over the ranks of ``group`` (``all_reduce``), on t's device."""
    wire = _on_wire(t.contiguous(), group)
    dist.all_reduce(wire, op=dist.ReduceOp.SUM, group=group)
    return wire.to(t.device)


def _gather_levels(t, group, size):
    """The ranks' level blocks of ``t`` (last axis), gathered in rank order."""
    wire = _on_wire(t.contiguous(), group)
    parts = [torch.empty_like(wire) for _ in range(size)]
    dist.all_gather(parts, wire, group=group)
    return torch.cat(parts, dim=-1).to(t.device)


def _sharded_run(mesh, axis, ab, predb, windows, delta, P_lv, beta_on_lv, beta_off_lv,
                 uniforms, *, n_levels, max_h, policy, t_chunk, group_sizes=None, record=False):
    """Level-sharded engine over the full (S, W, B) grid, behind
    ``provision(ProvisionSpec(mesh=...))`` and ``provision_stream``'s.

    The arguments are :func:`_run_stream`'s, plus ``mesh``, a
    ``torch.distributed.device_mesh.DeviceMesh`` whose axis ``axis``
    shards the levels, and the typed fleet's ``group_sizes``.  Every rank
    calls it with the same arguments and gets the same dict back: ``x``
    (S, W, B, T) int32 and the per-level terms (S, W, B, N) float32, equal
    to :func:`_run`'s bit for bit.

    The grid, its waits and its common random numbers are :func:`_run`'s;
    the level axis is laid out by :func:`_group_layout` and this rank takes
    its block of lanes, each dispatching against its routing id.  The
    uniforms were drawn at ``n_levels`` (never at the layout's width), so a
    (trace, draws) pair gives one schedule at every world size; a rank
    takes its lanes' columns of them.  The block runs through
    :func:`_run_stream` in ``t_chunk``-slot tiles — one launch of K2 on
    CUDA, its plain version on the CPU.  Then x(t) is summed over the
    ranks, and the per-level terms are gathered in rank order and compacted
    back to level order.

    ``record=True`` adds ``decision_counts`` (S, W, B, 4, N) only: the
    fleet route records aggregate counters, as the reference's does, and
    leaves the per-slot ``decisions`` out.  K1, which writes those (and
    which the reference runs on this route), is not on the port's: K2
    counts the decisions itself, as on the single-device streaming route.
    ``offline`` is rejected: it has no slot scan.
    """
    _check_policy(policy)
    if policy == "offline":
        raise ValueError(
            "sharded path supports online policies (offline has no slot scan); "
            f"valid policies are {tuple(p for p in POLICIES if p != 'offline')}"
        )
    dev = ab.device
    group, size, rank = _mesh_axis(mesh, axis, dev)
    route_np, sel_np, n_layout = _group_layout(n_levels, group_sizes, size)
    per = n_layout // size
    route = torch.from_numpy(route_np[rank * per:(rank + 1) * per]).to(dev)
    real = route < n_levels
    src = torch.where(real, route, 0).long()

    def lanes(v, fill):
        """This rank's lanes of a (..., N) row; pad lanes take ``fill``."""
        return torch.where(real, v[..., src], fill)

    if uniforms is not None:
        uniforms = tuple(u[..., src] for u in uniforms)
    out = _run_stream(
        ab, predb, windows, lanes(delta, 1.0),  # a pad lane never turns on: its Δ is moot
        *(lanes(v, 0.0) for v in (P_lv, beta_on_lv, beta_off_lv)), uniforms,
        n_levels=n_levels, max_h=max_h, policy=policy, t_chunk=t_chunk, record=record,
        routes=route,
    )
    sel = torch.from_numpy(sel_np).to(dev)
    terms = torch.stack([out["energy"], out["on_cost"], out["off_cost"]])
    energy, on_cost, off_cost = _gather_levels(terms, group, size)[..., sel]
    done = {"energy": energy, "on_cost": on_cost, "off_cost": off_cost,
            "x": _sum_ranks(out["x"], group)}
    if record:
        done["decision_counts"] = _gather_levels(out["decision_counts"], group, size)[..., sel]
    return done


# ---------------------------------------------------------------------------
# Deprecated loose-kwargs API (forwards to the spec engine)
# ---------------------------------------------------------------------------
#
# The reference's wrappers take a ``key=`` for A2/A3; these take what
# ``PolicySpec`` takes in its place, a ``generator=`` or injected
# ``uniforms=(u0, u)``, and the spec's ``device`` ("cuda" unless given
# "cpu").  ``provision_schedule_sharded`` takes a ``DeviceMesh``.

def _warn_deprecated(old: str, new: str) -> None:
    warnings.warn(
        f"deprecated: {old} — build a ProvisionSpec and call "
        f"repro_torch.core.provision ({new})",
        DeprecationWarning,
        stacklevel=3,
    )


def _dynamics_costs(delta):
    """A CostModel whose derived Δ equals the wrapper's free-floating delta."""
    from .costs import CostModel

    d = np.asarray(delta, np.float32)
    half = d / 2.0 if d.ndim else float(delta) / 2.0
    return CostModel(P=1.0, beta_on=half, beta_off=half)


def provision_schedule(a, *, n_levels: int, delta: int, window: int = 0, policy: str = "A1",
                       predicted=None, generator=None, uniforms=None, device="cuda"):
    """Deprecated: use ``provision(ProvisionSpec(...))``.

    Returns x: (T,) or (B, T) int32 — number of powered-on servers per slot.
    """
    from .provision import PolicySpec, ProvisionSpec, Workload, provision

    _warn_deprecated("provision_schedule(...)", "result.x")
    spec = ProvisionSpec(
        costs=_dynamics_costs(delta),
        workload=Workload(demand=a, predicted=predicted),
        policy=PolicySpec(name=policy, window=window, generator=generator, uniforms=uniforms),
        n_levels=n_levels, device=device,
    )
    return provision(spec).x


def provision_sweep(a, *, n_levels: int, delta: int, windows, policy: str = "A1",
                    generator=None, uniforms=None, predicted=None, device="cuda"):
    """Deprecated: use ``provision(ProvisionSpec(...))`` with ``windows=``.

    x over the whole sweep: (W, T) for a (T,) trace, (W, B, T) batched.
    """
    from .provision import PolicySpec, ProvisionSpec, Workload, provision

    _warn_deprecated("provision_sweep(...)", "result.x with a windows axis")
    spec = ProvisionSpec(
        costs=_dynamics_costs(delta),
        workload=Workload(demand=a, predicted=predicted),
        policy=PolicySpec(name=policy, windows=windows, generator=generator,
                          uniforms=uniforms),
        n_levels=n_levels, device=device,
    )
    return provision(spec).x


def provision_sweep_costs(a, *, n_levels: int, delta: int, windows, policy: str = "A1",
                          generator=None, uniforms=None, predicted=None, P: float = 1.0,
                          beta_on: float = 3.0, beta_off: float = 3.0, device="cuda"):
    """Deprecated: use ``provision(ProvisionSpec(...))`` and ``result.cost``.

    Schedule costs over the sweep: (W,) or (W, B).  The redundant ``delta``
    kwarg must equal the derived ``(beta_on + beta_off) / P`` (the spec API
    removes it entirely).
    """
    from .costs import CostModel
    from .provision import PolicySpec, ProvisionSpec, Workload, provision

    _warn_deprecated("provision_sweep_costs(...)", "result.cost with a windows axis")
    derived = (beta_on + beta_off) / P
    if abs(derived - float(delta)) > 1e-6:
        raise ValueError(
            f"delta={delta} disagrees with (beta_on+beta_off)/P={derived}; "
            "the spec API derives delta from CostModel — drop the delta kwarg"
        )
    spec = ProvisionSpec(
        costs=CostModel(P=P, beta_on=beta_on, beta_off=beta_off),
        workload=Workload(demand=a, predicted=predicted),
        policy=PolicySpec(name=policy, windows=windows, generator=generator,
                          uniforms=uniforms),
        n_levels=n_levels, device=device,
    )
    return provision(spec).cost


def provision_cost(a, on_matrix, P: float, beta_on: float, beta_off: float):
    """Deprecated: use ``on_matrix_cost(a, on_matrix, CostModel(...))`` or the
    ``cost``/``level_cost`` fields of a :func:`provision` result.

    Total cost of a per-level schedule (energy + toggles + forced final off),
    on the device of ``on_matrix``.  Supports leading batch axes: ``a``
    (..., T), ``on_matrix`` (..., T, N).
    """
    from .costs import CostModel

    _warn_deprecated("provision_cost(...)", "result.cost / on_matrix_cost")
    return on_matrix_cost(a, on_matrix, CostModel(P=P, beta_on=beta_on, beta_off=beta_off))


def provision_schedule_sharded(mesh, a, *, n_levels: int, delta: int, window: int = 0,
                               axis: str = "data", policy: str = "A1", generator=None,
                               uniforms=None, predicted=None, device="cuda"):
    """Deprecated: use ``provision(ProvisionSpec(..., mesh=mesh))``.

    Same as :func:`provision_schedule`, levels sharded over ``mesh``'s axis
    ``axis`` (a ``DeviceMesh`` on ``device``'s type; every rank calls it
    with the same arguments and gets the whole x).
    """
    from .provision import PolicySpec, ProvisionSpec, Workload, provision

    _warn_deprecated("provision_schedule_sharded(...)", "mesh= on the spec")
    spec = ProvisionSpec(
        costs=_dynamics_costs(delta),
        workload=Workload(demand=a, predicted=predicted),
        policy=PolicySpec(name=policy, window=window, generator=generator, uniforms=uniforms),
        n_levels=n_levels, device=device, mesh=mesh, mesh_axis=axis,
    )
    return provision(spec).x
