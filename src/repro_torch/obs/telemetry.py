"""Host-side telemetry: counters, gauges, histograms, and span timers.

A copy of ``repro.obs.telemetry`` (stdlib only) so that ``repro_torch``
stands alone.  The port adds four counter names, bumped by its kernel
wrappers on every CUDA launch: ``kernels/provision_scan_launches`` and
``kernels/provision_scan_stream_launches`` (K1 and K2,
:mod:`repro_torch.kernels.provision_scan`),
``kernels/flash_attention_launches`` (K3,
:mod:`repro_torch.kernels.flash_attention`) and
``kernels/decode_attention_launches`` (K4,
:mod:`repro_torch.kernels.decode_attention`, two launches per call).

One :class:`Telemetry` instance is a process-local registry of metrics plus
a buffer of timing events, exportable two ways:

  * **Chrome trace-event JSON** (:meth:`Telemetry.chrome_trace`) — every
    ``span()`` becomes a complete ("ph": "X") event, loadable in Perfetto
    (https://ui.perfetto.dev) or ``chrome://tracing`` for a flame view of
    where a benchmark's wall time went;
  * **JSON-lines metrics** (:meth:`Telemetry.metrics_records`) — one JSON
    object per counter/gauge/histogram, machine-diffable next to
    ``BENCH_provision.json``.

The process-global default is a :class:`NullTelemetry`: every instrumented
call site reads ``get_telemetry()`` and gets an object whose methods do
nothing, so instrumentation left in library code costs one attribute lookup
and one no-op call when nobody is collecting.  That is the **zero-overhead
contract** (docs/observability.md): telemetry never allocates and never
times when disabled.  Spans wrap *host-side* work (a ``provision`` call, a
benchmark cell); per-slot provenance is
:mod:`repro_torch.obs.provenance`'s job.

Enable collection for a region with::

    from repro_torch.obs import Telemetry, telemetry_session

    with telemetry_session() as tel:          # or telemetry_session(Telemetry())
        run_benchmark()
    tel.write_chrome_trace("bench.trace.json")
    tel.write_metrics_jsonl("bench.metrics.jsonl")

Labels: every metric accepts keyword labels (``tel.count("cells", policy="A1")``);
a (name, labels) pair is one series.  All methods are thread-safe.
"""
from __future__ import annotations

import contextlib
import json
import os
import pathlib
import threading
import time


def _label_key(labels: dict) -> tuple:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


class Telemetry:
    """A live metric registry + trace-event buffer (see module docstring)."""

    enabled: bool = True

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: dict[tuple, float] = {}
        self._gauges: dict[tuple, float] = {}
        self._hists: dict[tuple, list[float]] = {}
        self._events: list[dict] = []
        self._t0_ns = time.perf_counter_ns()

    # ------------------------------------------------------------- metrics
    def count(self, name: str, value: float = 1.0, **labels) -> None:
        """Increment counter ``name`` (monotone; value may be fractional)."""
        k = (name, _label_key(labels))
        with self._lock:
            self._counters[k] = self._counters.get(k, 0.0) + value

    def gauge(self, name: str, value: float, **labels) -> None:
        """Set gauge ``name`` to its latest value."""
        with self._lock:
            self._gauges[(name, _label_key(labels))] = float(value)

    def observe(self, name: str, value: float, **labels) -> None:
        """Record one sample into histogram ``name``."""
        k = (name, _label_key(labels))
        with self._lock:
            self._hists.setdefault(k, []).append(float(value))

    def counter_value(self, name: str, **labels) -> float:
        return self._counters.get((name, _label_key(labels)), 0.0)

    def gauge_value(self, name: str, **labels) -> float | None:
        return self._gauges.get((name, _label_key(labels)))

    def samples(self, name: str, **labels) -> list[float]:
        return list(self._hists.get((name, _label_key(labels)), ()))

    def quantile(self, name: str, q: float, **labels) -> float | None:
        """The q-quantile (0..1, nearest-rank) of histogram ``name``."""
        vals = self._hists.get((name, _label_key(labels)))
        if not vals:
            return None
        s = sorted(vals)
        i = min(len(s) - 1, max(0, round(q * (len(s) - 1))))
        return s[i]

    # --------------------------------------------------------------- spans
    def _now_us(self) -> float:
        return (time.perf_counter_ns() - self._t0_ns) / 1e3

    @contextlib.contextmanager
    def span(self, name: str, **args):
        """Time a host-side region: a Chrome "X" event + a duration sample.

        The duration (ms) also lands in histogram ``span/<name>``, so p50/
        p99 of a repeated span are one :meth:`quantile` call away.
        """
        ts = self._now_us()
        try:
            yield self
        finally:
            dur = self._now_us() - ts
            ev = {
                "name": name, "ph": "X", "ts": ts, "dur": dur,
                "pid": os.getpid(), "tid": threading.get_ident(),
                "cat": "repro",
            }
            if args:
                ev["args"] = {k: str(v) for k, v in args.items()}
            with self._lock:
                self._events.append(ev)
            self.observe(f"span/{name}", dur / 1e3)

    def instant(self, name: str, **args) -> None:
        """Mark a point in time (Chrome "i" instant event)."""
        ev = {
            "name": name, "ph": "i", "ts": self._now_us(), "s": "p",
            "pid": os.getpid(), "tid": threading.get_ident(), "cat": "repro",
        }
        if args:
            ev["args"] = {k: str(v) for k, v in args.items()}
        with self._lock:
            self._events.append(ev)

    # ------------------------------------------------------------- exports
    def chrome_trace(self) -> dict:
        """The buffered spans as a Chrome trace-event JSON object.

        Loadable as-is in Perfetto / ``chrome://tracing`` (the
        ``traceEvents`` envelope with microsecond timestamps).
        """
        with self._lock:
            events = list(self._events)
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def write_chrome_trace(self, path) -> pathlib.Path:
        path = pathlib.Path(path)
        path.write_text(json.dumps(self.chrome_trace(), indent=1) + "\n")
        return path

    def metrics_records(self) -> list[dict]:
        """One JSON-able record per metric series (counters, gauges, and
        histograms with count/sum/min/max/p50/p99)."""
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            hists = {k: list(v) for k, v in self._hists.items()}
        out: list[dict] = []
        for (name, labels), v in sorted(counters.items()):
            out.append({"type": "counter", "name": name,
                        "labels": dict(labels), "value": v})
        for (name, labels), v in sorted(gauges.items()):
            out.append({"type": "gauge", "name": name,
                        "labels": dict(labels), "value": v})
        for (name, labels), vals in sorted(hists.items()):
            s = sorted(vals)
            out.append({
                "type": "histogram", "name": name, "labels": dict(labels),
                "count": len(s), "sum": sum(s), "min": s[0], "max": s[-1],
                "p50": s[round(0.5 * (len(s) - 1))],
                "p99": s[min(len(s) - 1, round(0.99 * (len(s) - 1)))],
            })
        return out

    def write_metrics_jsonl(self, path) -> pathlib.Path:
        path = pathlib.Path(path)
        lines = [json.dumps(r) for r in self.metrics_records()]
        path.write_text("\n".join(lines) + ("\n" if lines else ""))
        return path


@contextlib.contextmanager
def _noop_span(tel):
    yield tel


class NullTelemetry(Telemetry):
    """The disabled default: every method is a no-op and ``span`` neither
    times nor allocates.  Instrumented library code runs against this unless
    a caller installs a live :class:`Telemetry` (``telemetry_session``)."""

    enabled = False

    def __init__(self) -> None:  # no buffers, no lock traffic
        pass

    def count(self, name, value=1.0, **labels):
        pass

    def gauge(self, name, value, **labels):
        pass

    def observe(self, name, value, **labels):
        pass

    def counter_value(self, name, **labels):
        return 0.0

    def gauge_value(self, name, **labels):
        return None

    def samples(self, name, **labels):
        return []

    def quantile(self, name, q, **labels):
        return None

    def span(self, name, **args):
        return _noop_span(self)

    def instant(self, name, **args):
        pass

    def chrome_trace(self):
        return {"traceEvents": [], "displayTimeUnit": "ms"}

    def metrics_records(self):
        return []


#: the process-global registry every instrumented call site reads
_ACTIVE: Telemetry = NullTelemetry()


def get_telemetry() -> Telemetry:
    """The active registry (a no-op :class:`NullTelemetry` by default)."""
    return _ACTIVE


def set_telemetry(tel: Telemetry) -> Telemetry:
    """Install ``tel`` as the process-global registry; returns the old one."""
    global _ACTIVE
    old, _ACTIVE = _ACTIVE, tel
    return old


@contextlib.contextmanager
def telemetry_session(tel: Telemetry | None = None):
    """Install a live registry for a ``with`` region, restoring the previous
    one on exit.  ``telemetry_session()`` creates a fresh :class:`Telemetry`."""
    tel = Telemetry() if tel is None else tel
    old = set_telemetry(tel)
    try:
        yield tel
    finally:
        set_telemetry(old)
