"""K1 and K2: the per-level provisioning scans, as CUDA kernels for Hopper.

The port of ``repro.kernels.provision_scan`` (the Pallas TPU kernels
``_grid_scan_kernel`` and ``_stream_scan_kernel``).  One call runs the whole
(noise-std x window x trace) grid of a provisioning sweep: cell ``g`` scans
demand row ``traces[cell_trace[g]]`` for every level, with its own predicted
row, wait-threshold table and per-level peek reach.

  * K1, :func:`provision_scan_grid` (``csrc/provision_scan.cu``), writes the
    ``(G, T, N)`` bool on-matrix, and on request the decision counters and
    the per-slot reason codes;
  * K2, :func:`provision_scan_stream` (``csrc/provision_scan_stream.cu``),
    returns what the engine reduces the on-matrix to — x(t), per-lane
    totals and the carry that continues the trace in a later call — so its
    memory stays O(G·(T + N)) at any trace length.  Its uniforms route
    (``thresholds`` a :class:`~repro_torch.core.torch_provision.
    UniformWaits`) draws the waits from the uniforms itself.

Both kernels run one slot loop (``csrc/slot_step.cuh``), which skips the
sub-tiles of slots in a steady state and loads wait entries ahead of their
slot, by cp.async of a sub-tile's entries into a shared-memory ring.

Routes split by device, never by failure: on CUDA tensors a wrapper
launches its kernel (built at first use, see
:mod:`repro_torch.kernels._build`) and raises if it cannot; on CPU tensors
it runs the plain PyTorch version (``*_ref``), which is also the kernel's
oracle on the card.  :data:`launches` and :data:`stream_launches` count
kernel launches, and nothing else.
"""
from __future__ import annotations

import torch

from ..core.torch_provision import (
    STREAM_ACCS,
    UniformWaits,
    _on_matrix_scan,
    _stream_scan,
    _waits,
)
from ..obs import provenance as _prov
from ..obs.telemetry import get_telemetry

#: routing id given to pad lanes: larger than any int32 demand value, so a
#: padded lane's dispatcher compare is never true and it can never turn on
PAD_ROUTE = 2**30

#: slots per tile of the streaming scan, as in the reference
DEFAULT_T_CHUNK = 512

#: K1 and K2 launches since import (or since a caller reset them); the plain
#: versions on CPU tensors never count
launches = 0
stream_launches = 0


def _normalize(traces, predicted, thresholds, cells, *, delta, horizon,
               base_level, routes, level_horizon):
    """Shared argument checks and defaults of the kernels and their plain
    versions (``delta=None``: no upper bound on the horizon)."""
    traces = torch.as_tensor(traces).to(torch.int32)
    dev = traces.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"provision_scan_grid runs on cuda or cpu tensors, got {dev}")
    predicted = torch.as_tensor(predicted, device=dev).to(torch.int32)
    if traces.ndim != 2 or predicted.ndim != 2:
        raise ValueError(
            f"traces/predicted must be (B, T)/(R, T), got {tuple(traces.shape)} "
            f"and {tuple(predicted.shape)}"
        )
    T = traces.shape[1]
    if predicted.shape[1] != T:
        raise ValueError(f"predicted rows have {predicted.shape[1]} slots, traces {T}")
    if horizon < 0 or (delta is not None and horizon > int(delta)):
        raise ValueError(f"need 0 <= horizon <= delta, got {horizon}, {delta}")
    cells = [torch.as_tensor(c).to(torch.int32).reshape(-1) for c in cells]
    if len({c.shape[0] for c in cells}) != 1:
        raise ValueError(f"cell maps differ in length: {[c.shape[0] for c in cells]}")
    if isinstance(thresholds, UniformWaits):
        thresholds = _uniform_waits_args(thresholds, T, cells[0].shape[0], dev)
        rows, n = thresholds.span.shape
    else:
        thresholds = torch.as_tensor(thresholds, device=dev).to(torch.float32)
        if thresholds.ndim != 3 or thresholds.shape[1] not in (1, T):
            raise ValueError(
                f"thresholds must be (K, 1, N) or (K, T={T}, N), got {tuple(thresholds.shape)}"
            )
        rows, n = thresholds.shape[0], thresholds.shape[-1]
    if level_horizon is None:
        level_horizon = torch.full((1, n), float(horizon), dtype=torch.float32, device=dev)
    level_horizon = torch.as_tensor(level_horizon, device=dev).to(torch.float32)
    if level_horizon.ndim != 2 or level_horizon.shape[1] != n:
        raise ValueError(f"level_horizon must be (H, {n}), got {tuple(level_horizon.shape)}")
    if cells[0].shape[0]:
        # the kernel indexes the tables with these, so they are checked on
        # the host first: free for maps made on the host (as the engine's
        # are), one device sync for maps that already live on the card
        lo, hi = torch.stack(cells).aminmax(dim=1)
        rows = (traces.shape[0], predicted.shape[0], rows, level_horizon.shape[0])
        for name, a, b, k in zip(("cell_trace", "cell_pred", "cell_thr", "cell_hor"),
                                 # repro-torch-lint: disable=RPT002 (host maps on the engine's path)
                                 lo.tolist(), hi.tolist(), rows):
            if a < 0 or b >= k:
                raise ValueError(f"{name} indexes rows [{a}, {b}] of a table with {k} rows")
    cells = [c.to(dev, non_blocking=True) for c in cells]
    if routes is None:
        routes = base_level + torch.arange(n, dtype=torch.int32, device=dev)
    routes = torch.as_tensor(routes, device=dev).to(torch.int32).reshape(-1)
    if routes.shape[0] != n:
        raise ValueError(f"routes must be ({n},), got {tuple(routes.shape)}")
    return traces, predicted, thresholds, cells, routes, level_horizon


def _uniform_waits_args(w, T, G, dev):
    """A :class:`UniformWaits` checked and on ``dev``: (Bu, T, N) uniforms,
    (K, N) span rows, u0 and p0 together or not at all, a cell map of G
    rows into the uniforms."""
    f32 = [None if v is None else torch.as_tensor(v, device=dev).to(torch.float32)
           for v in (w.u0, w.u, w.span, w.p0)]
    u0, u, span, p0 = f32
    if u.ndim != 3 or u.shape[1] != T:
        raise ValueError(f"uniforms must be (Bu, T={T}, N), got {tuple(u.shape)}")
    n = u.shape[-1]
    if span.ndim != 2 or span.shape[1] != n:
        raise ValueError(f"span must be (K, {n}), got {tuple(span.shape)}")
    if (u0 is None) != (p0 is None):
        raise ValueError("u0 and p0 come together (A3's atom) or not at all")
    if u0 is not None and (u0.shape != u.shape or p0.shape != span.shape):
        raise ValueError(f"u0/p0 must be shaped as u/span, got {tuple(u0.shape)}, "
                         f"{tuple(p0.shape)}")
    cell = torch.as_tensor(w.cell).to(torch.int32).reshape(-1)
    if cell.shape[0] != G:
        raise ValueError(f"the uniforms' cell map has {cell.shape[0]} rows, the cells {G}")
    if G:
        # as in _normalize: the engine makes the cell map on the host, so
        # this check reads no device memory on its path
        lo, hi = cell.aminmax()
        # repro-torch-lint: disable=RPT002 (a host map on the engine's path)
        if int(lo) < 0 or int(hi) >= u.shape[0]:
            # repro-torch-lint: disable=RPT002 (the error message of the check above)
            raise ValueError(f"the uniforms' cell map indexes rows [{int(lo)}, {int(hi)}] "
                             f"of {u.shape[0]}")
    return UniformWaits(u0, u, span, p0, cell.to(dev, non_blocking=True))


def _grid_args(traces, predicted, thresholds, cells, *, delta, horizon, base_level, routes,
               level_horizon, record, codes):
    if codes and not record:
        raise ValueError("codes=True needs record=True")
    if isinstance(thresholds, UniformWaits):
        raise ValueError("K1 takes wait tables; the uniforms route is K2's")
    return _normalize(traces, predicted, thresholds, cells, delta=delta, horizon=horizon,
                      base_level=base_level, routes=routes, level_horizon=level_horizon)


def provision_scan_grid_ref(traces, predicted, thresholds, cell_trace, cell_pred,
                            cell_thr, cell_hor, *, delta, horizon, base_level=0,
                            routes=None, level_horizon=None, record=False, codes=False):
    """The plain PyTorch version of :func:`provision_scan_grid`: the engine's
    slot loop (:func:`repro_torch.core.torch_provision._on_matrix_scan`) on
    whatever device the tensors are on, with the per-slot reason codes
    summed into K1's ``(G, 4, N)`` counters under ``record``."""
    args = _grid_args(traces, predicted, thresholds,
                      (cell_trace, cell_pred, cell_thr, cell_hor), delta=delta,
                      horizon=horizon, base_level=base_level, routes=routes,
                      level_horizon=level_horizon, record=record, codes=codes)
    return _plain(*args, horizon=horizon, record=record, codes=codes)


def _plain(traces, predicted, thresholds, cells, routes, level_horizon, *, horizon, record,
           codes):
    ons, bits = _on_matrix_scan(
        traces, predicted, thresholds, *cells, level_horizon=level_horizon,
        routes=routes, horizon=horizon, record=record,
    )
    if not record:
        return ons
    counts = torch.stack(
        [((bits & bit) != 0).sum(dim=1, dtype=torch.int32) for bit in _prov.COUNT_BITS],
        dim=1,
    )
    return (ons, counts, bits) if codes else (ons, counts)


def _paths_ptr(paths, dev):
    """The pointer of a (3,) int32 path-counter tensor on ``dev``, or None."""
    if paths is None:
        return None
    if paths.dtype != torch.int32 or tuple(paths.shape) != (3,) or paths.device != dev \
            or not paths.is_contiguous():
        raise ValueError("paths must be a contiguous (3,) int32 tensor on the kernel's device")
    return paths.data_ptr()


def provision_scan_grid(traces, predicted, thresholds, cell_trace, cell_pred,
                        cell_thr, cell_hor, *, delta, horizon, base_level=0,
                        routes=None, level_horizon=None, record=False, codes=False,
                        paths=None):
    """(G, T, N) bool on-matrix: one (noise, window, trace) cell per row.

    ``traces`` (B, T) int32 demand rows; ``predicted`` (R, T) int32 rows the
    peek reads; ``thresholds`` (K, 1, N) constant waits or (K, T, N) sampled
    waits (entry [t, l] consumed iff level l becomes newly idle in slot t);
    the four ``(G,)`` cell maps pick each cell's demand, predicted,
    threshold and ``level_horizon`` (H, N) rows.  ``delta``: the peek bound
    ``ceil(max Δ)``; ``horizon``: peek slots examined (``<= delta``; 0 for
    no peek).  Lane ``j`` dispatches against level id ``routes[j]``,
    defaulting to ``base_level + j``.

    ``record=True`` returns ``(ons, counts)`` with ``counts`` (G, 4, N)
    int32 — per-lane decision counters in
    :data:`repro_torch.obs.provenance.COUNT_ORDER` row order — and with
    ``codes=True`` also the (G, T, N) uint8 per-slot reason bitmask of
    :mod:`repro_torch.obs.provenance`, as ``(ons, counts, codes)``.

    CUDA tensors launch K1 (and count in :data:`launches`); CPU tensors run
    :func:`provision_scan_grid_ref`.  On CUDA, ``paths`` (a zeroed (3,)
    int32 tensor) receives the number of (level block, cell, sub-tile)
    triples that ran the slot step, were all busy, or had nothing on and
    nothing to turn on; it never changes a result.
    """
    global launches
    args = _grid_args(traces, predicted, thresholds,
                      (cell_trace, cell_pred, cell_thr, cell_hor), delta=delta,
                      horizon=horizon, base_level=base_level, routes=routes,
                      level_horizon=level_horizon, record=record, codes=codes)
    traces, predicted, thresholds, cells, routes, level_horizon = args
    dev = traces.device
    if dev.type == "cpu":
        return _plain(*args, horizon=horizon, record=record, codes=codes)
    from ._build import load_provision_scan

    lib = load_provision_scan()
    max_horizon = lib.repro_provision_scan_max_horizon()
    if horizon > max_horizon:
        raise ValueError(
            f"horizon {horizon} exceeds the {max_horizon} slots K1's "
            "shared-memory peek tile holds on this card"
        )
    G = cells[0].shape[0]
    T = traces.shape[1]
    n = thresholds.shape[-1]
    ins = [traces, predicted, thresholds, *cells, level_horizon, routes]
    ins = [x.contiguous() for x in ins]
    out = torch.empty((G, T, n), dtype=torch.bool, device=dev)
    counts = torch.empty((G, 4, n), dtype=torch.int32, device=dev) if record else None
    bits = torch.empty((G, T, n), dtype=torch.uint8, device=dev) if codes else None
    if G and T and n:
        err = lib.repro_provision_scan_grid(
            *[x.data_ptr() for x in ins], out.data_ptr(),
            *[None if v is None else v.data_ptr() for v in (counts, bits)],
            _paths_ptr(paths, dev), G, T, n, horizon, int(thresholds.shape[1] != 1),
            int(record), torch.cuda.current_stream(dev).cuda_stream,
        )
        if err:
            raise RuntimeError(
                "provision_scan_grid: K1 launch failed: "
                + lib.repro_cuda_error_string(err).decode()
            )
        launches += 1
        get_telemetry().count("kernels/provision_scan_launches")
    if not record:
        return out
    return (out, counts, bits) if codes else (out, counts)


def provision_scan(a, thresholds, *, delta, horizon, base_level=0, predicted=None,
                   level_horizon=None):
    """(T, N) bool on-matrix for levels [base_level, base_level + N).

    The single-cell convenience wrapper over :func:`provision_scan_grid`
    (one trace, one window, one noise level — ``G = 1``): ``a`` (T,) demand,
    ``thresholds`` (N,) constant waits or (T, N) sampled waits,
    ``predicted`` the (T,) trace the peek reads (default ``a``),
    ``level_horizon`` an (N,) per-level peek reach.
    """
    a = torch.as_tensor(a).to(torch.int32)
    thresholds = torch.as_tensor(thresholds, device=a.device).to(torch.float32)
    m3d = thresholds[None] if thresholds.ndim == 2 else thresholds[None, None]
    pred = a if predicted is None else torch.as_tensor(predicted, device=a.device)
    lh = None if level_horizon is None else torch.as_tensor(level_horizon)[None]
    zero = torch.zeros((1,), dtype=torch.int32, device=a.device)
    out = provision_scan_grid(
        a[None], pred[None], m3d, zero, zero, zero, zero,
        delta=delta, horizon=horizon, base_level=base_level, level_horizon=lh,
    )
    return out[0]


def _stream_args(traces, predicted, thresholds, cells, *, horizon, t_chunk, n_levels,
                 base_level, routes, level_horizon, carry):
    """:func:`_normalize` plus the streaming scan's own checks — the tile
    size (clamped to T, as in the reference), the lane mask's level count
    and the carry's shapes — as the keyword arguments of
    :func:`repro_torch.core.torch_provision._stream_scan`."""
    traces, predicted, thresholds, cells, routes, level_horizon = _normalize(
        traces, predicted, thresholds, cells, delta=None, horizon=horizon,
        base_level=base_level, routes=routes, level_horizon=level_horizon,
    )
    if int(t_chunk) < 1:
        raise ValueError(f"t_chunk must be >= 1, got {t_chunk}")
    G = cells[0].shape[0]
    n = (thresholds.span if isinstance(thresholds, UniformWaits) else thresholds).shape[-1]
    if carry is not None:
        dev = traces.device
        carry = {
            "r": torch.as_tensor(carry["r"], device=dev).to(torch.float32),
            "on": torch.as_tensor(carry["on"], device=dev).to(torch.bool),
            "wait": torch.as_tensor(carry["wait"], device=dev).to(torch.float32),
        }
        for name, v in carry.items():
            if tuple(v.shape) != (G, n):
                raise ValueError(
                    f"carry[{name!r}] must be (G, N) = {(G, n)}, got {tuple(v.shape)}")
    return dict(
        traces=traces, predicted=predicted, thresholds=thresholds,
        cell_trace=cells[0], cell_pred=cells[1], cell_thr=cells[2], cell_hor=cells[3],
        level_horizon=level_horizon, routes=routes, horizon=horizon,
        t_chunk=int(min(int(t_chunk), max(traces.shape[1], 1))),
        n_levels=n if n_levels is None else int(n_levels), carry=carry,
    )


def provision_scan_stream_ref(traces, predicted, thresholds, cell_trace, cell_pred,
                              cell_thr, cell_hor, *, horizon, t_chunk=DEFAULT_T_CHUNK,
                              n_levels=None, base_level=0, routes=None,
                              level_horizon=None, record=False, carry=None):
    """The plain PyTorch version of :func:`provision_scan_stream`: the
    engine's tiled slot loop (:func:`repro_torch.core.torch_provision.
    _stream_scan`) on whatever device the tensors are on."""
    args = _stream_args(
        traces, predicted, thresholds, (cell_trace, cell_pred, cell_thr, cell_hor),
        horizon=horizon, t_chunk=t_chunk, n_levels=n_levels, base_level=base_level,
        routes=routes, level_horizon=level_horizon, carry=carry,
    )
    return _stream_scan(**args, record=record)


def provision_scan_stream(traces, predicted, thresholds, cell_trace, cell_pred,
                          cell_thr, cell_hor, *, horizon, t_chunk=DEFAULT_T_CHUNK,
                          n_levels=None, base_level=0, routes=None, level_horizon=None,
                          record=False, carry=None, paths=None):
    """The streaming scan: x(t), per-lane totals and the end carry, any T.

    The arguments are :func:`provision_scan_grid`'s, less ``delta``
    (``horizon`` peek slots are examined; the peek reads 0 past T), plus:

      * ``t_chunk``: slots per tile, clamped to T; it never changes a
        result (K2 also caps it at what its shared memory holds);
      * ``n_levels``: lane ``j`` counts in ``x`` and every total iff
        ``routes[j] < n_levels`` (default N);
      * ``carry``: None for a fresh trace — the virtual x(0) = a(0) edge, so
        nothing toggles at the first slot — or the ``{"r", "on", "wait"}``
        (G, N) dict a previous call returned, to continue that trace.

    ``thresholds`` may be a :class:`~repro_torch.core.torch_provision.
    UniformWaits` (the uniforms route): K2 then draws each wait from the
    uniforms where a lane consumes it, and ``cell_thr`` picks span rows.

    Returns ``(x, accs, carry)``: ``x`` (G, T) int32; ``accs`` a dict of
    (G, N) int32 totals ``run``/``up``/``down`` (plus the four
    :data:`repro_torch.obs.provenance.COUNT_ORDER` counters under
    ``record``), without the forced x(T) = a(T) final off, which is the
    caller's to add; ``carry`` the state after the last slot.

    CUDA tensors launch K2 (and count in :data:`stream_launches`); CPU
    tensors run :func:`provision_scan_stream_ref`.  ``paths`` is as for
    :func:`provision_scan_grid`.
    """
    global stream_launches
    args = _stream_args(
        traces, predicted, thresholds, (cell_trace, cell_pred, cell_thr, cell_hor),
        horizon=horizon, t_chunk=t_chunk, n_levels=n_levels, base_level=base_level,
        routes=routes, level_horizon=level_horizon, carry=carry,
    )
    dev = args["traces"].device
    if dev.type == "cpu":
        return _stream_scan(**args, record=record)
    from ._build import load_provision_scan

    thr = args["thresholds"]
    if isinstance(thr, UniformWaits):       # spans in place of the table, then the draws
        source = 2 if thr.p0 is None else 3
        draws = [thr.u, thr.u0, thr.p0, thr.cell]
        thr = thr.span
    else:
        source = int(thr.shape[1] != 1)
        draws = [None] * 4
    lib = load_provision_scan()
    max_tile = lib.repro_provision_scan_stream_max_tile(horizon, source)
    if max_tile < 1:
        raise ValueError(
            f"horizon {horizon} leaves no room for a tile in K2's shared memory "
            "on this card"
        )
    G, T = args["cell_trace"].shape[0], args["traces"].shape[1]
    n = thr.shape[-1]
    names = STREAM_ACCS + (_prov.COUNT_ORDER if record else ())
    ins = [args[k] for k in ("traces", "predicted")] + [thr] + [
        args[k] for k in ("cell_trace", "cell_pred", "cell_thr", "cell_hor", "level_horizon",
                          "routes")] + draws
    ins = [None if v is None else v.contiguous() for v in ins]
    carry = args["carry"]
    ins += [None] * 3 if carry is None else [carry[k].contiguous()
                                              for k in ("r", "on", "wait")]
    x = torch.zeros((G, T), dtype=torch.int32, device=dev)      # K2 adds into it
    accs = torch.empty((G, len(names), n), dtype=torch.int32, device=dev)
    out = {"r": torch.empty((G, n), dtype=torch.float32, device=dev),
           "on": torch.empty((G, n), dtype=torch.bool, device=dev),
           "wait": torch.empty((G, n), dtype=torch.float32, device=dev)}
    if G and n:                     # T = 0 still writes the totals and the carry
        err = lib.repro_provision_scan_stream(
            *[None if v is None else v.data_ptr() for v in ins],
            x.data_ptr(), accs.data_ptr(), *[v.data_ptr() for v in out.values()],
            _paths_ptr(paths, dev), G, T, n, horizon, min(args["t_chunk"], max_tile),
            args["n_levels"], source, int(record), torch.cuda.current_stream(dev).cuda_stream,
        )
        if err:
            raise RuntimeError(
                "provision_scan_stream: K2 launch failed: "
                + lib.repro_cuda_error_string(err).decode()
            )
        stream_launches += 1
        get_telemetry().count("kernels/provision_scan_stream_launches")
    return x, {name: accs[:, i] for i, name in enumerate(names)}, out


def _uniform_waits_probe(u0, u, span, p0=None):
    """A test-only entry point, on no path of the engine: the waits K2's
    uniforms route draws, for every entry of ``u`` (..., N) against one (N,)
    ``span`` row (and A3's ``p0`` row with ``u0``).  On CUDA tensors a
    probe kernel applies K2's own arithmetic (``wait_from_uniforms`` of
    ``csrc/slot_step.cuh``) to every entry; on CPU tensors this is
    :func:`repro_torch.core.torch_provision._waits`, the table route's.
    ``chip_smoke.py`` holds the two equal on every entry of its tables, which
    is what makes the uniforms route exact."""
    u = torch.as_tensor(u).to(torch.float32)
    dev = u.device
    span = torch.as_tensor(span, device=dev).to(torch.float32).reshape(-1)
    if (u0 is None) != (p0 is None):
        raise ValueError("u0 and p0 come together (A3's atom) or not at all")
    if p0 is not None:
        u0 = torch.as_tensor(u0, device=dev).to(torch.float32)
        p0 = torch.as_tensor(p0, device=dev).to(torch.float32).reshape(-1)
    if span.shape[0] != u.shape[-1] or (p0 is not None and (
            p0.shape != span.shape or u0.shape != u.shape)):
        raise ValueError("span/p0 must be (N,) rows for u/u0 of shape (..., N)")
    if dev.type == "cpu":
        return _waits(u0, u, span, p0)
    from ._build import load_provision_scan

    lib = load_provision_scan()
    ins = [v if v is None else v.contiguous() for v in (u, u0, span, p0)]
    out = torch.empty_like(u)
    if u.numel():
        err = lib.repro_uniform_waits(
            *[None if v is None else v.data_ptr() for v in ins], out.data_ptr(),
            u.numel(), span.shape[0], int(p0 is not None),
            torch.cuda.current_stream(dev).cuda_stream)
        if err:
            raise RuntimeError("_uniform_waits_probe: launch failed: "
                               + lib.repro_cuda_error_string(err).decode())
    return out
