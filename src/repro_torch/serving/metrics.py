"""Serving-side plan metrics with a Prometheus text exporter.

A copy of ``repro.serving.metrics`` (stdlib only), mirroring into
:mod:`repro_torch.obs.telemetry`.  :class:`PlanMetrics` is the operational
counterpart of the eval report's runtime columns: every
:meth:`FleetProvisioner.advance()
<repro_torch.serving.autoscaler.FleetProvisioner.advance>` step records how
long the stepper took, how many replica toggles the new plan carries over
the chunk, and the queue backlog depth — the three signals an operator
watches on a streaming capacity planner (plan latency must stay inside the
slot, toggle churn is the paper's cost being spent, backlog depth is the
deferral queue's health).

Exports: Python-side accessors (``latency_quantile(0.99)``, ``.toggles``,
``.backlog_depth``) plus :meth:`PlanMetrics.prometheus_text` — the
Prometheus `text exposition format
<https://prometheus.io/docs/instrumenting/exposition_formats/>`__, ready to
serve from a ``/metrics`` endpoint (summary with p50/p99 quantile labels
for latency, counters for plans/toggles, a gauge for backlog).  Metrics
also mirror into the active :mod:`repro_torch.obs.telemetry` registry when
one is installed, so a benchmark's Chrome trace and a serving loop's
Prometheus scrape come from the same instrumentation.
"""
from __future__ import annotations

import dataclasses

from ..obs.telemetry import get_telemetry

#: latency quantiles the Prometheus summary exports
_QUANTILES = (0.5, 0.99)


@dataclasses.dataclass
class PlanMetrics:
    """Rolling metrics of one :class:`FleetProvisioner`'s advance() loop.

    ``plans``: advance() calls observed.  ``plan_latencies_ms``: one wall
    sample per call (device compute + host dispatch).  ``toggles``:
    cumulative replica on/off transitions the returned chunk plans
    (``sum(|Δx|)`` within the chunk plus the seam from the previous
    chunk's last slot).  ``backlog_depth``: the queue depth after the last
    planned slot (0 without a deferral spec); ``peak_backlog`` its high
    water mark.
    """

    plans: int = 0
    toggles: int = 0
    backlog_depth: int = 0
    peak_backlog: int = 0
    plan_latencies_ms: list[float] = dataclasses.field(default_factory=list)

    def observe_plan(self, latency_ms: float, toggles: int, backlog: int) -> None:
        """Record one advance() step (called by the planner)."""
        self.plans += 1
        self.plan_latencies_ms.append(float(latency_ms))
        self.toggles += int(toggles)
        self.backlog_depth = int(backlog)
        self.peak_backlog = max(self.peak_backlog, int(backlog))
        tel = get_telemetry()
        tel.observe("serving/plan_latency_ms", float(latency_ms))
        tel.count("serving/toggles", int(toggles))
        tel.gauge("serving/backlog_depth", int(backlog))

    def latency_quantile(self, q: float) -> float | None:
        """Nearest-rank q-quantile (0..1) of the plan latencies, ms."""
        if not self.plan_latencies_ms:
            return None
        s = sorted(self.plan_latencies_ms)
        return s[min(len(s) - 1, max(0, round(q * (len(s) - 1))))]

    def prometheus_text(self, prefix: str = "repro_serving") -> str:
        """The metrics in Prometheus text exposition format.

        A summary (``<prefix>_plan_latency_ms`` with p50/p99 quantile
        labels, ``_sum``/``_count``), counters for plans and toggles, and
        gauges for the current and peak backlog depth.
        """
        lat = self.plan_latencies_ms
        lines = [
            f"# HELP {prefix}_plan_latency_ms Wall time of one advance() step.",
            f"# TYPE {prefix}_plan_latency_ms summary",
        ]
        for q in _QUANTILES:
            v = self.latency_quantile(q)
            if v is not None:
                lines.append(
                    f'{prefix}_plan_latency_ms{{quantile="{q}"}} {v:.6f}'
                )
        lines += [
            f"{prefix}_plan_latency_ms_sum {sum(lat):.6f}",
            f"{prefix}_plan_latency_ms_count {len(lat)}",
            f"# HELP {prefix}_plans_total advance() calls observed.",
            f"# TYPE {prefix}_plans_total counter",
            f"{prefix}_plans_total {self.plans}",
            f"# HELP {prefix}_toggles_total Replica on/off transitions planned.",
            f"# TYPE {prefix}_toggles_total counter",
            f"{prefix}_toggles_total {self.toggles}",
            f"# HELP {prefix}_backlog_depth Queued work after the last planned slot.",
            f"# TYPE {prefix}_backlog_depth gauge",
            f"{prefix}_backlog_depth {self.backlog_depth}",
            f"# HELP {prefix}_backlog_peak High-water mark of the backlog depth.",
            f"# TYPE {prefix}_backlog_peak gauge",
            f"{prefix}_backlog_peak {self.peak_backlog}",
        ]
        return "\n".join(lines) + "\n"
