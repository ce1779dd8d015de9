"""Fault tolerance: preemption handling, straggler mitigation, failure policy.

Production posture (1000+ nodes):
  * checkpoint/restart — atomic async checkpoints + deterministic
    step-indexed data (``TokenPipeline.batch_at``) give exactly-once
    semantics across restarts;
  * preemption — SIGTERM triggers a final checkpoint before exit;
  * stragglers — per-step wall-time is tracked with an EMA; a replica/pod
    whose step time exceeds ``threshold x`` the fleet median is *evicted the
    way the paper retires a server*: it is treated as a departed job at the
    provisioning layer (LIFO push), and re-admitted only when demand pops it
    — no state migration, identical to the no-KV-migration argument.

A copy of ``repro.distributed.fault_tolerance`` (the stdlib only).
"""
from __future__ import annotations

import dataclasses
import signal
import time
from typing import Callable


@dataclasses.dataclass
class PreemptionGuard:
    """Installs SIGTERM/SIGINT hooks that request a clean stop."""

    requested: bool = False

    def install(self) -> "PreemptionGuard":
        def handler(signum, frame):
            self.requested = True

        signal.signal(signal.SIGTERM, handler)
        return self

    def should_stop(self) -> bool:
        return self.requested


@dataclasses.dataclass
class StragglerDetector:
    """EMA-based straggler detection over per-worker step times."""

    threshold: float = 2.0
    decay: float = 0.9
    ema: dict = dataclasses.field(default_factory=dict)

    def observe(self, worker: int, step_time: float) -> None:
        prev = self.ema.get(worker, step_time)
        self.ema[worker] = self.decay * prev + (1 - self.decay) * step_time

    def median(self) -> float:
        if not self.ema:
            return 0.0
        vals = sorted(self.ema.values())
        return vals[len(vals) // 2]

    def stragglers(self) -> list[int]:
        med = self.median()
        if med <= 0:
            return []
        return [w for w, v in self.ema.items() if v > self.threshold * med]


@dataclasses.dataclass
class StepWatchdog:
    """Wall-clock budget per step; on breach calls the eviction callback.

    The callback is expected to push the worker into the provisioning stack
    (paper semantics: the straggler 'departs'); the autoscaler's ski-rental
    then decides whether it powers off.
    """

    budget_s: float
    on_evict: Callable[[int], None]
    _start: float = 0.0

    def begin(self) -> None:
        self._start = time.monotonic()

    def end(self, worker: int) -> bool:
        elapsed = time.monotonic() - self._start
        if elapsed > self.budget_s:
            self.on_evict(worker)
            return True
        return False
