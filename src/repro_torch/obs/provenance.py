"""Decision provenance: why each level toggled, as per-slot reason codes.

A copy of ``repro.obs.provenance`` (numpy only) so that ``repro_torch``
stands alone; the bit values and ``COUNT_ORDER`` are shared with the
reference, so decision counts compare one to one.

The paper's algorithms are explainable by construction — every on/off
decision has one local cause — and ``provision(spec,
record_decisions=True)`` carries that cause out of the slot scan as
a per-slot, per-level **bitmask** on ``ProvisionResult.decisions``
(shape ``(..., T, N)``, uint8).  The bits:

======================  =====  =================================================
constant                value  meaning at slot ``t``, level ``l``
======================  =====  =================================================
``DEMAND_RISE``         1      the dispatcher turned the level on: ``a(t) > l``
                               and the level was off entering the slot
``WAIT_EXPIRED``        2      the level is idle and its ski-rental clock has
                               reached its wait (deterministic ``(1−α)Δ_l``
                               timer, or the sampled A2/A3/AQ-rand draw)
``PEEK_FIRED``          4      the clock had expired but the prediction peek
                               saw demand above the level inside
                               ``min(w+1, Δ_l)`` slots, vetoing the power-off
``TOGGLE_OFF``          8      the level powered off this slot (clock expired,
                               nothing seen in the window)
======================  =====  =================================================

``WAIT_EXPIRED`` stays set on every idle slot past the wait, so
``WAIT_EXPIRED & ~(PEEK_FIRED | TOGGLE_OFF)`` never occurs: an expired
clock either fires the peek or fires the toggle.  A slot with code 0 is a
hold (busy-and-on, idle-within-wait, or off).

The codes *reconstruct the schedule exactly* (property-tested): with
``x(0) = min(a(0), N)``,

    ``x(t) = x(0) + Σ_{u<=t} (#DEMAND_RISE(u) − #TOGGLE_OFF(u))``

which is what :func:`reconstruct_schedule` computes and
:func:`toggles_from_decisions` exposes per slot.  Both routes of
``provision()`` record both (on CUDA, kernel K1 writes the codes);
``provision_stream()`` records the aggregate per-level counters only
(``ProvisionResult.decision_counts``).

Everything here is plain numpy over host arrays; nothing imports the
engine, so the engine can import these constants without a cycle.
"""
from __future__ import annotations

import numpy as np

#: dispatcher turn-on: demand exceeded the level while it was off
DEMAND_RISE = 1
#: the level's ski-rental clock is at or past its (sampled) wait
WAIT_EXPIRED = 2
#: the prediction peek saw demand inside the window and vetoed the off
PEEK_FIRED = 4
#: the level powered off this slot
TOGGLE_OFF = 8

#: bit value -> human-readable reason name, in priority order
REASON_NAMES = {
    DEMAND_RISE: "demand-rise",
    WAIT_EXPIRED: "wait-expired",
    PEEK_FIRED: "peek-fired",
    TOGGLE_OFF: "toggle-off",
}

#: the order ``decision_counts`` rows are stored in (engine + kernel)
COUNT_ORDER = ("demand_rise", "wait_expired", "peek_fired", "toggle_off")
#: the bit each :data:`COUNT_ORDER` row counts, same order
COUNT_BITS = (DEMAND_RISE, WAIT_EXPIRED, PEEK_FIRED, TOGGLE_OFF)


def toggles_from_decisions(decisions) -> tuple[np.ndarray, np.ndarray]:
    """Per-slot (rises, offs) counts, each ``(..., T)`` int64.

    ``rises[t]`` = number of levels the dispatcher turned on in slot ``t``;
    ``offs[t]`` = number that powered off.  Their running difference is the
    schedule's derivative (see :func:`reconstruct_schedule`).
    """
    d = np.asarray(decisions)
    rises = ((d & DEMAND_RISE) != 0).sum(axis=-1).astype(np.int64)
    offs = ((d & TOGGLE_OFF) != 0).sum(axis=-1).astype(np.int64)
    return rises, offs


def reconstruct_schedule(decisions, x0) -> np.ndarray:
    """Rebuild ``x`` ``(..., T)`` from reason codes and the initial count.

    ``x0`` is the slot-0 *entry* state ``min(a(0), N)`` (broadcastable to
    the leading axes).  Exactness against ``ProvisionResult.x`` is the
    provenance contract: the codes are sufficient statistics for the
    schedule, property-tested in ``tests/test_obs.py``.
    """
    rises, offs = toggles_from_decisions(decisions)
    return np.asarray(x0)[..., None] + np.cumsum(rises - offs, axis=-1)


def decision_counts(decisions) -> dict[str, np.ndarray]:
    """Aggregate per-level reason counters ``{name: (..., N) int32}`` —
    the same four rows, in :data:`COUNT_ORDER`, that the CUDA route
    records natively in ``ProvisionResult.decision_counts``."""
    d = np.asarray(decisions)
    return {
        name: ((d & bit) != 0).sum(axis=-2).astype(np.int32)
        for name, bit in zip(COUNT_ORDER, COUNT_BITS)
    }


def explain_slot(decisions, t: int) -> list[str]:
    """Human-readable event lines for slot ``t`` of a single-trace
    ``(T, N)`` decision matrix — the debugging view of one scheduling step."""
    d = np.asarray(decisions)
    if d.ndim != 2:
        raise ValueError(
            f"explain_slot wants a single-trace (T, N) matrix, got {d.shape}"
        )
    lines = []
    for level in np.flatnonzero(d[t]):
        bits = [name for bit, name in REASON_NAMES.items() if d[t, level] & bit]
        lines.append(f"t={t} level={int(level)}: " + " + ".join(bits))
    return lines
