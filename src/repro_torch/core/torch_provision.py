"""The paper's provisioning algorithms as a batched PyTorch engine.

The PyTorch port of the single-device half of ``repro.core.jax_provision``.
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
from typing import NamedTuple

import torch

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
                n_levels, max_h, policy, t_chunk, record=False):
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
    """
    if policy == "offline":
        raise ValueError(
            "offline is closed-form over the full trace; the streaming engine "
            "is online-only — use provision() for offline"
        )
    from ..kernels.provision_scan import provision_scan_stream

    T = ab.shape[1]
    W = len(windows)
    inputs, (S, Wc, B) = _grid_inputs(
        ab, predb, windows, delta, uniforms,
        n_levels=n_levels, max_h=max_h, policy=policy, uniform_waits=True,
    )
    del inputs["delta"]
    x, accs, carry = provision_scan_stream(
        **inputs, t_chunk=t_chunk, n_levels=n_levels, record=record)
    lead = (S, Wc, B, n_levels)
    # close the trace: a level still on at T that the last slot's demand
    # does not need turns off (every lane is a real level in this layout)
    busy_end = ab[:, T - 1, None] > inputs["routes"]             # (B, N)
    final_off = (carry["on"].reshape(lead) & ~busy_end).to(torch.int32)
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
