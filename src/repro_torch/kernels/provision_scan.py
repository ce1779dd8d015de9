"""K1: the fused per-level provisioning scan, as a CUDA kernel for Hopper.

The port of ``provision_scan_grid`` / ``provision_scan`` in
``repro.kernels.provision_scan`` (the Pallas TPU kernel
``_grid_scan_kernel``).  One call runs the whole (noise-std x window x
trace) grid of a provisioning sweep: cell ``g`` scans demand row
``traces[cell_trace[g]]`` over all ``T`` slots for every level, with its
own predicted row, wait-threshold table and per-level peek reach, and
writes a ``(G, T, N)`` bool on-matrix.

Routes split by device, never by failure: on CUDA tensors the wrapper
launches the kernel in ``csrc/provision_scan.cu`` (built at first use, see
:mod:`repro_torch.kernels._build`) and raises if it cannot; on CPU tensors
it runs :func:`provision_scan_grid_ref`, the plain PyTorch version, which is
also the kernel's oracle on the card.  :data:`launches` counts kernel
launches, and nothing else.
"""
from __future__ import annotations

import torch

from ..core.torch_provision import _on_matrix_scan
from ..obs import provenance as _prov
from ..obs.telemetry import get_telemetry

#: routing id given to pad lanes: larger than any int32 demand value, so a
#: padded lane's dispatcher compare is never true and it can never turn on
PAD_ROUTE = 2**30

#: K1 launches since import (or since a caller reset it); the plain version
#: on CPU tensors never counts
launches = 0


def _normalize(traces, predicted, thresholds, cells, *, delta, horizon,
               base_level, routes, level_horizon):
    """Shared argument checks and defaults of the kernel and its plain version."""
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
    if not 0 <= horizon <= int(delta):
        raise ValueError(f"need 0 <= horizon <= delta, got {horizon}, {delta}")
    thresholds = torch.as_tensor(thresholds, device=dev).to(torch.float32)
    if thresholds.ndim != 3 or thresholds.shape[1] not in (1, T):
        raise ValueError(
            f"thresholds must be (K, 1, N) or (K, T={T}, N), got {tuple(thresholds.shape)}"
        )
    n = thresholds.shape[-1]
    cells = [torch.as_tensor(c).to(torch.int32).reshape(-1) for c in cells]
    if len({c.shape[0] for c in cells}) != 1:
        raise ValueError(f"cell maps differ in length: {[c.shape[0] for c in cells]}")
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
        rows = (traces.shape[0], predicted.shape[0], thresholds.shape[0],
                level_horizon.shape[0])
        for name, a, b, k in zip(("cell_trace", "cell_pred", "cell_thr", "cell_hor"),
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


def provision_scan_grid_ref(traces, predicted, thresholds, cell_trace, cell_pred,
                            cell_thr, cell_hor, *, delta, horizon, base_level=0,
                            routes=None, level_horizon=None, record=False):
    """The plain PyTorch version of :func:`provision_scan_grid`: the engine's
    slot loop (:func:`repro_torch.core.torch_provision._on_matrix_scan`) on
    whatever device the tensors are on, with the per-slot reason codes
    summed into K1's ``(G, 4, N)`` counters under ``record``."""
    traces, predicted, thresholds, cells, routes, level_horizon = _normalize(
        traces, predicted, thresholds, (cell_trace, cell_pred, cell_thr, cell_hor),
        delta=delta, horizon=horizon, base_level=base_level, routes=routes,
        level_horizon=level_horizon,
    )
    return _plain(traces, predicted, thresholds, cells, routes, level_horizon,
                  horizon=horizon, record=record)


def _plain(traces, predicted, thresholds, cells, routes, level_horizon, *, horizon, record):
    ons, codes = _on_matrix_scan(
        traces, predicted, thresholds, *cells, level_horizon=level_horizon,
        routes=routes, horizon=horizon, record=record,
    )
    if not record:
        return ons
    counts = torch.stack(
        [((codes & bit) != 0).sum(dim=1, dtype=torch.int32) for bit in _prov.COUNT_BITS],
        dim=1,
    )
    return ons, counts


def provision_scan_grid(traces, predicted, thresholds, cell_trace, cell_pred,
                        cell_thr, cell_hor, *, delta, horizon, base_level=0,
                        routes=None, level_horizon=None, record=False):
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
    :data:`repro_torch.obs.provenance.COUNT_ORDER` row order.

    CUDA tensors launch K1 (and count in :data:`launches`); CPU tensors run
    :func:`provision_scan_grid_ref`.
    """
    global launches
    traces, predicted, thresholds, cells, routes, level_horizon = _normalize(
        traces, predicted, thresholds, (cell_trace, cell_pred, cell_thr, cell_hor),
        delta=delta, horizon=horizon, base_level=base_level, routes=routes,
        level_horizon=level_horizon,
    )
    dev = traces.device
    if dev.type == "cpu":
        return _plain(traces, predicted, thresholds, cells, routes, level_horizon,
                      horizon=horizon, record=record)
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
    if G and T and n:
        err = lib.repro_provision_scan_grid(
            *[x.data_ptr() for x in ins], out.data_ptr(),
            None if counts is None else counts.data_ptr(),
            G, T, n, horizon, int(thresholds.shape[1] != 1), int(record),
            torch.cuda.current_stream(dev).cuda_stream,
        )
        if err:
            raise RuntimeError(
                "provision_scan_grid: K1 launch failed: "
                + lib.repro_cuda_error_string(err).decode()
            )
        launches += 1
        get_telemetry().count("kernels/provision_scan_launches")
    return (out, counts) if record else out


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
