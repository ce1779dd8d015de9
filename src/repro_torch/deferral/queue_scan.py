"""Vectorized slack-aware queueing: water-filled deferral + a batched queue scan.

The PyTorch port of ``repro.deferral.queue_scan``.  Two primitives replace
the heap a discrete-event queue simulator would use (Adnan et al., "Dynamic
Deferral of Workload for Capacity Provisioning in Data Centers", arXiv
1109.3839, PAPERS.md):

  * :func:`defer_demand` — the *defer-then-provision* transform.  Arrivals
    ``a(t)`` with per-job slack become the water-filled service profile
    ``ã(t)``: the least capacity that still meets every deadline, computed
    from two prefix-sum envelopes (cumulative arrivals ``A`` above,
    cumulative work due ``L`` below) with an optimal-available rate rule —
    at each slot serve ``max_k ceil((L(t+k) − S(t−1)) / (k+1))`` over the
    remaining horizon.  Zero slack makes every envelope tight, so
    ``ã ≡ a`` bit-exactly.

  * :func:`queue_scan` — the measurement half.  Given true arrivals and a
    capacity profile ``x(t)``, simulate the queue under a dispatch rule and
    return backlog/latency metrics.  The backlog lives in *age buckets*:
    ``w[j]`` is the unserved work of the batch that arrived ``j`` slots ago
    (``j ≤ max_slack``, plus one merged bucket for late work), so each slot
    is a shift + a sorted prefix-sum waterfill.

Every function takes one trace ``(T,)`` or a batch ``(..., T)`` and runs one
loop over the slots, vectorised over (rows, buckets or horizon) on the
input's device — where the reference ``vmap``s a ``lax.scan`` over rows.
The results are the reference's, bit for bit: integer arithmetic in int64
(every output is int32, as the reference's), the reference's ``lexsort``
as one stable ``argsort`` of a composite key (the secondary key is unique
per bucket), and its float32 p99 threshold.  Nothing here is a kernel: the
reference computes this layer with ``lax.scan`` outside any Pallas kernel.

Dispatch rules (:data:`repro_torch.deferral.spec.RULES`): ``EDF`` (earliest
deadline first among live batches, expired work last), ``FIFO`` (strict
arrival order, expired work included), ``SPT`` / ``LPT`` (smallest /
largest remaining batch first among live batches, expired work last).

Metric conventions: a unit *misses* its deadline when it is still queued as
its remaining slack crosses below zero (counted once, at expiry; late units
stay queued, so ``served + unserved == arrived`` always).  Queueing delay of
a served unit is its age in slots at service time; delays beyond
``max_slack + 1`` are lumped into the merged late bucket.
"""
from __future__ import annotations

import torch

_I64 = torch.int64


def _rows(a) -> tuple[torch.Tensor, tuple]:
    """``a`` as a (R, T) int64 tensor plus its leading shape."""
    a = torch.as_tensor(a)
    return a.reshape(-1, a.shape[-1]).to(_I64), tuple(a.shape[:-1])


def _slack_vector(slack, T: int, device) -> torch.Tensor:
    """Scalar or (T,) slack as a (T,) int64 tensor."""
    s = torch.as_tensor(slack, device=device).to(_I64)
    if s.ndim == 1 and s.shape[0] != T:
        raise ValueError(
            f"per-slot slack has length {s.shape[0]} but the trace has {T} slots"
        )
    return s.broadcast_to((T,))


def due_envelope(a, slack) -> torch.Tensor:
    """``L(t)``: cumulative work whose deadline is at or before slot ``t``.

    ``a``: (..., T) integer arrivals; ``slack``: scalar or (T,) slots of
    slack for the batch arriving at each slot (deadline ``t + slack(t)``,
    clipped to the horizon).  A scatter-add + prefix sum; (..., T) int32.
    """
    rows, lead = _rows(a)
    return _envelope(rows, slack).to(torch.int32).reshape(lead + rows.shape[-1:])


def _envelope(rows, slack) -> torch.Tensor:
    """:func:`due_envelope` of (R, T) int64 rows, in int64."""
    T = rows.shape[-1]
    dead = torch.arange(T, device=rows.device) + _slack_vector(slack, T, rows.device)
    return torch.zeros_like(rows).index_add_(1, dead.clamp(0, T - 1), rows).cumsum(1)


def defer_demand(a, slack, *, cap: int | None = None) -> torch.Tensor:
    """Water-filled service profile ``ã``: (..., T) int32, the deferred demand.

    The optimal-available rate rule over the deadline envelope: with
    ``S(t−1)`` work served so far, slot ``t`` serves

        ``ã(t) = min(A(t) − S,  max_{k=0..T−1−t} ⌈(L(t+k) − S)/(k+1)⌉)``

    never exceeding what has arrived (``A`` = cumulative arrivals).  The
    density max ranges over the full remaining horizon, so this is O(T²) per
    trace by design.  ``cap`` clamps ``ã(t) ≤ cap`` after first tightening
    the lower envelope to ``L'(t) = max_{j≥t} (L(j) − cap·(j−t))``, so work
    the cap displaces is served earlier instead of dropped (an infeasible cap
    leaves a shortfall that :func:`queue_scan` reports).  With ``slack = 0``
    and no cap, ``ã == a`` bit-exactly.
    """
    rows, lead = _rows(a)
    R, T = rows.shape
    dev = rows.device
    A = rows.cumsum(1)
    L = _envelope(rows, slack)
    if cap is not None:
        j = torch.arange(T, device=dev) * int(cap)
        L = torch.cummax((L - j).flip(1), dim=1).values.flip(1) + j
    # pad with the total so out-of-horizon terms are dominated, not special
    Lpad = torch.cat([L, L[:, -1:].expand(R, T)], dim=1)
    k = torch.arange(T, device=dev)
    k1 = k + 1
    S = torch.zeros(R, dtype=_I64, device=dev)
    out = torch.empty(R, T, dtype=_I64, device=dev)
    for t in range(T):
        need = (Lpad[:, t:t + T] - S[:, None]).clamp_(min=0).add_(k).floor_divide_(k1)
        c = torch.minimum(need.amax(1), A[:, t] - S)             # causality
        if cap is not None:
            c = c.clamp_(max=int(cap))
        c = c.clamp_(min=0)
        S = S + c
        out[:, t] = c
    return out.to(torch.int32).reshape(lead + (T,))


# ---------------------------------------------------------------------------
# the queue: priorities and one slot's waterfill
# ---------------------------------------------------------------------------

def _priority(rule: str, w, rem, live, ages, n_buckets):
    """(primary, secondary) sort keys, smaller served first.

    Expired work (``~live``) sorts after every live batch for all rules
    except FIFO, whose strict arrival order keeps it head-of-line.  The
    secondary key breaks ties oldest-first, so every rule is a total,
    deterministic order.
    """
    late = n_buckets + 1
    if rule == "EDF":
        prim = torch.where(live, rem, late)
    elif rule == "FIFO":
        prim = -ages                                  # oldest first, late included
    elif rule == "SPT":
        prim = torch.where(live, w, 2**30)
    elif rule == "LPT":
        prim = torch.where(live, -w, 2**30)
    else:  # pragma: no cover - guarded by DeferralSpec.validate
        raise ValueError(f"unknown dispatch rule {rule!r}")
    return prim, (n_buckets - 1) - ages


def _order(prim, sec, n_buckets):
    """The reference's ``lexsort((sec, prim))``: ``sec`` is a permutation of
    0..n_buckets-1, so ``prim * n_buckets + sec`` orders lexicographically
    (negative ``prim`` included) and has no ties."""
    return torch.argsort(prim * n_buckets + sec, dim=-1, stable=True)


def _waterfill(w_new, order, x_t):
    """Serve ``x_t`` (R,) units from buckets ``w_new`` (R, nb) in ``order``:
    ``clip(x − work_ahead, 0, w)`` cumulatively.  Returns the served (R, nb)."""
    ws = w_new.gather(1, order)
    ahead = ws.cumsum(1) - ws
    served_sorted = torch.minimum((x_t[:, None] - ahead).clamp_(min=0), ws)
    return torch.empty_like(w_new).scatter_(1, order, served_sorted)


def _age(w, a_t):
    """Age every bucket by one slot and admit ``a_t``: ages past the last
    deadline bucket merge into the late bucket."""
    w_new = torch.cat([a_t[:, None], w[:, :-1]], dim=1)
    w_new[:, -1] += w[:, -1]
    return w_new


def _delays(hist, ages):
    """``max_delay`` and ``p99_delay`` (R,) from the served-by-age histogram,
    with the reference's float32 threshold ``ceil(0.99 · total)``."""
    total = hist.sum(1)
    cum = hist.cumsum(1)
    thresh = torch.ceil(torch.tensor(0.99, dtype=torch.float32, device=hist.device)
                        * total.to(torch.float32))
    p99 = (cum.to(torch.float32) >= thresh[:, None]).to(torch.int32).argmax(1)
    max_delay = torch.where(hist > 0, ages, -1).amax(1).clamp(min=0)
    return max_delay, p99


def queue_scan(a, x, slack, *, rule: str = "EDF", max_slack: int) -> dict:
    """Simulate the deferral queue for (arrivals, capacity) pairs.

    ``a``/``x``: (..., T) integer arrivals and per-slot service capacity of
    the same shape; ``slack``: scalar or (T,) slack of each slot's arrival
    batch; ``max_slack``: bucket bound (≥ the largest slack).  Each slot:
    age the buckets (counting units whose deadline just expired), admit the
    new batch, then serve ``x(t)`` units by the rule's sorted prefix-sum
    waterfill.  Late work stays queued at the rule's late priority until
    served or the trace ends.

    Returns a dict of int32 tensors with the leading shape of ``a``:
    ``backlog`` (..., T), ``served_by_age`` (..., max_slack + 2),
    ``deadline_misses``, ``unserved``, ``max_delay`` and ``p99_delay`` (...).
    """
    rows, lead = _rows(a)
    xr, _ = _rows(x)
    if xr.shape != rows.shape:
        raise ValueError(f"arrivals {tuple(rows.shape)} and capacity {tuple(xr.shape)} differ")
    R, T = rows.shape
    dev = rows.device
    K = int(max_slack)
    nb = K + 2                                          # ages 0..K + merged late
    ages = torch.arange(nb, device=dev)
    slack_t = _slack_vector(slack, T, dev)
    # rem[t, j] = remaining slack of the batch aged j at slot t (junk where
    # t - j < 0, whose bucket is empty); the late bucket has -1
    src = torch.arange(T, device=dev)[:, None] - ages[None, :K + 1]
    rem = torch.cat([
        torch.where(src >= 0, slack_t[src.clamp(min=0)], 0) - ages[:K + 1],
        torch.full((T, 1), -1, dtype=_I64, device=dev),
    ], dim=1)                                           # (T, nb)
    # units whose last service chance was slot t-1 (slot -1 reads slot 0's
    # window, as the reference's clamped slice does; the buckets are empty)
    expired = rem[(torch.arange(T, device=dev) - 1).clamp(min=0), :K + 1] == 0
    static = rule in ("EDF", "FIFO")                    # keys independent of w
    if static:
        prim, sec = _priority(rule, None, rem, rem >= 0, ages, nb)
        orders = _order(prim.broadcast_to((T, nb)), sec, nb)

    w = torch.zeros(R, nb, dtype=_I64, device=dev)
    miss = torch.zeros(R, dtype=_I64, device=dev)
    hist = torch.zeros(R, nb, dtype=_I64, device=dev)
    backlog = torch.empty(R, T, dtype=_I64, device=dev)
    for t in range(T):
        miss += (w[:, :K + 1] * expired[t]).sum(1)
        w_new = _age(w, rows[:, t])
        if static:
            order = orders[t].expand(R, nb)
        else:
            prim, sec = _priority(rule, w_new, rem[t], rem[t] >= 0, ages, nb)
            order = _order(prim, sec, nb)
        served = _waterfill(w_new, order, xr[:, t])
        w = w_new - served
        hist += served
        backlog[:, t] = w.sum(1)
    # deadlines that expire exactly at the horizon never age past it inside
    # the loop; count their leftovers here, and the merged late leftovers
    miss += (w[:, :K + 1] * (rem[T - 1, :K + 1] <= 0)).sum(1) + w[:, nb - 1]
    max_delay, p99 = _delays(hist, ages)

    def shaped(v):
        return v.to(torch.int32).reshape(lead + tuple(v.shape[1:]))

    return {
        "backlog": shaped(backlog),
        "served_by_age": shaped(hist),
        "deadline_misses": shaped(miss),
        "unserved": shaped(w.sum(1)),
        "max_delay": shaped(max_delay),
        "p99_delay": shaped(p99),
    }


# ---------------------------------------------------------------------------
# Streaming (carry-based) twins: O(slack) state, chunk-size invariant
# ---------------------------------------------------------------------------

def _valid_rows(valid, rows, lead) -> torch.Tensor:
    """The pad mask, (Tc,) or (..., Tc), as a (R, Tc) bool tensor."""
    if valid is None:
        return torch.ones_like(rows, dtype=torch.bool)
    v = torch.as_tensor(valid, device=rows.device).to(torch.bool)
    return v.broadcast_to(lead + rows.shape[-1:]).reshape(rows.shape)


def defer_stream_init(slack: int, batch: tuple = (), device=None) -> dict:
    """Fresh carry for :func:`defer_stream`: ``awin[..., j]`` = cumulative
    arrivals through ``j + 1`` slots ago (all zero before the trace) and
    ``served`` = total work served so far; ``batch`` is the leading shape
    of the chunks the carry will see."""
    K = int(slack)
    return {
        "awin": torch.zeros(tuple(batch) + (max(K, 1),), dtype=torch.int32, device=device),
        "served": torch.zeros(tuple(batch), dtype=torch.int32, device=device),
    }


def defer_stream(a, state, *, slack: int, cap: int | None = None, valid=None):
    """Causal streaming deferral: one chunk of arrivals → service profile.

    The batch arriving at ``u`` is due by ``u + slack``, so by slot ``t`` the
    work due within ``k`` more slots is ``A(t − slack + k)`` — cumulative
    arrivals only — and the slot serves the smallest rate that clears every
    known deadline::

        c(t) = clip(min(A(t) − S, max_{k ≤ slack} ⌈(A(t−slack+k) − S)/(k+1)⌉),
                    0, cap)

    The carry is the ``slack``-deep cumulative-arrival window plus the
    served total, so any split of the stream into calls yields the same
    output; ``slack = 0`` returns the arrivals bit-exactly.  This is the
    causal rule of live serving, not :func:`defer_demand`'s hindsight rule.

    ``a``: (..., Tc) integer chunk of arrivals; ``valid``: optional (Tc,) or
    (..., Tc) bool — masked slots serve nothing and freeze the carry.
    Returns ``(deferred (..., Tc) int32, new_state)``.
    """
    K = int(slack)
    rows, lead = _rows(a)
    R, Tc = rows.shape
    v = _valid_rows(valid, rows, lead)
    awin = state["awin"].reshape(R, -1).to(_I64)
    S = state["served"].reshape(R).to(_I64)
    if K == 0:
        out = torch.where(v, rows, 0)
        S = S + out.sum(1)
    else:
        k = torch.arange(K + 1, device=rows.device)
        out = torch.empty_like(rows)
        for t in range(Tc):
            A_t = awin[:, 0] + rows[:, t]                 # cumulative arrivals through t
            lvals = torch.cat([awin.flip(1), A_t[:, None]], dim=1)   # A(t-K) .. A(t)
            need = (lvals - S[:, None]).clamp_(min=0).add_(k).floor_divide_(k + 1)
            c = torch.minimum(need.amax(1), A_t - S)
            if cap is not None:
                c = c.clamp_(max=int(cap))
            c = torch.where(v[:, t], c.clamp_(min=0), 0)
            awin = torch.where(v[:, t, None], torch.cat([A_t[:, None], awin[:, :-1]], dim=1),
                               awin)
            S = S + c
            out[:, t] = c
    new = {
        "awin": awin.to(torch.int32).reshape(state["awin"].shape),
        "served": S.to(torch.int32).reshape(state["served"].shape),
    }
    return out.to(torch.int32).reshape(lead + (Tc,)), new


def queue_stream_init(max_slack: int, batch: tuple = (), device=None) -> dict:
    """Fresh carry for :func:`queue_stream`: empty age buckets, zero miss
    counter, zero served-by-age histogram; ``batch`` as in
    :func:`defer_stream_init`."""
    nb = int(max_slack) + 2
    batch = tuple(batch)
    return {
        "w": torch.zeros(batch + (nb,), dtype=torch.int32, device=device),
        "miss": torch.zeros(batch, dtype=torch.int32, device=device),
        "hist": torch.zeros(batch + (nb,), dtype=torch.int32, device=device),
    }


def queue_stream(a, x, state, *, rule: str = "EDF", max_slack: int, valid=None):
    """One chunk of the deferral queue, carry in age buckets.

    The streaming twin of :func:`queue_scan` for *scalar* slack: the same
    per-slot dynamics, but the ``(w, miss, hist)`` state crosses call
    boundaries.  The end-of-horizon correction is **not** applied here; call
    :func:`queue_stream_finalize` when the trace has ended.

    ``a``/``x``: (..., Tc) integer arrivals and capacity; ``valid``: optional
    pad mask (masked slots freeze the carry and repeat the previous
    backlog).  Returns ``(backlog (..., Tc) int32, new_state)``.
    """
    K = int(max_slack)
    nb = K + 2
    rows, lead = _rows(a)
    xr, _ = _rows(x)
    R, Tc = rows.shape
    dev = rows.device
    v = _valid_rows(valid, rows, lead)
    ages = torch.arange(nb, device=dev)
    rem = torch.cat([K - ages[:K + 1], torch.full((1,), -1, dtype=_I64, device=dev)])
    # EDF/FIFO keys depend only on ages under scalar slack: one order for
    # every slot; SPT/LPT re-key per slot (bucket sizes)
    static = rule in ("EDF", "FIFO")
    if static:
        prim, sec = _priority(rule, None, rem, rem >= 0, ages, nb)
        order0 = _order(prim, sec, nb).expand(R, nb)
    w = state["w"].reshape(R, nb).to(_I64)
    miss = state["miss"].reshape(R).to(_I64)
    hist = state["hist"].reshape(R, nb).to(_I64)
    backlog = torch.empty(R, Tc, dtype=_I64, device=dev)
    for t in range(Tc):
        miss2 = miss + w[:, K]                          # last chance was the previous slot
        w_new = _age(w, rows[:, t])
        if static:
            order = order0
        else:
            p, s = _priority(rule, w_new, rem, rem >= 0, ages, nb)
            order = _order(p, s, nb)
        served = _waterfill(w_new, order, xr[:, t])
        vt = v[:, t]
        w = torch.where(vt[:, None], w_new - served, w)
        miss = torch.where(vt, miss2, miss)
        hist = torch.where(vt[:, None], hist + served, hist)
        backlog[:, t] = w.sum(1)
    new = {
        "w": w.to(torch.int32).reshape(state["w"].shape),
        "miss": miss.to(torch.int32).reshape(state["miss"].shape),
        "hist": hist.to(torch.int32).reshape(state["hist"].shape),
    }
    return backlog.to(torch.int32).reshape(lead + (Tc,)), new


def queue_stream_finalize(state, *, max_slack: int) -> dict:
    """Close the horizon on a :func:`queue_stream` carry: apply
    :func:`queue_scan`'s end-of-trace correction (units due exactly at the
    final slot plus merged-late leftovers count as misses) and derive the
    delay metrics from the served-by-age histogram.  Returns the same
    metric names as :func:`queue_scan` minus the per-slot ``backlog``."""
    K = int(max_slack)
    nb = K + 2
    w = state["w"].reshape(-1, nb).to(_I64)
    hist = state["hist"].reshape(-1, nb).to(_I64)
    lead = tuple(state["miss"].shape)
    miss = state["miss"].reshape(-1).to(_I64) + w[:, K] + w[:, nb - 1]
    max_delay, p99 = _delays(hist, torch.arange(nb, device=hist.device))

    def shaped(v):
        return v.to(torch.int32).reshape(lead + tuple(v.shape[1:]))

    return {
        "served_by_age": shaped(hist),
        "deadline_misses": shaped(miss),
        "unserved": shaped(w.sum(1)),
        "max_delay": shaped(max_delay),
        "p99_delay": shaped(p99),
    }
