"""repro_torch.obs — telemetry and decision provenance.

Copies of the reference's stdlib/numpy-only modules, so the port stands
alone:

* :mod:`repro_torch.obs.telemetry` — counters/gauges/histograms + ``span()``
  timers with Chrome-trace and JSON-lines exports; no-op by default.
* :mod:`repro_torch.obs.provenance` — per-slot decision reason-code bitmask
  (demand-rise / wait-expired / peek-fired / toggle-off) and the
  schedule-reconstruction helpers that make the codes checkable.
"""
from .provenance import (
    COUNT_BITS,
    COUNT_ORDER,
    DEMAND_RISE,
    PEEK_FIRED,
    REASON_NAMES,
    TOGGLE_OFF,
    WAIT_EXPIRED,
    decision_counts,
    explain_slot,
    reconstruct_schedule,
    toggles_from_decisions,
)
from .telemetry import (
    NullTelemetry,
    Telemetry,
    get_telemetry,
    set_telemetry,
    telemetry_session,
)

__all__ = [
    "COUNT_BITS",
    "COUNT_ORDER",
    "DEMAND_RISE",
    "NullTelemetry",
    "PEEK_FIRED",
    "REASON_NAMES",
    "TOGGLE_OFF",
    "Telemetry",
    "WAIT_EXPIRED",
    "decision_counts",
    "explain_slot",
    "get_telemetry",
    "reconstruct_schedule",
    "set_telemetry",
    "telemetry_session",
    "toggles_from_decisions",
]
