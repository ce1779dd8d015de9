"""`DeferralSpec`: the slack/deadline model attached to a :class:`Workload`.

The PyTorch port of ``repro.deferral.spec``.  Declares *how long arriving
work may wait*: a scalar slack (every batch may wait that many slots) or a
per-slot ``(T,)`` slack vector (the batch arriving at ``t`` must finish by
``t + slack[t]``), plus the dispatch rule the queue uses and an optional
per-slot service cap.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from .queue_scan import defer_demand as _defer_demand
from .queue_scan import queue_scan as _queue_scan

#: dispatch rules understood by the queue scan
RULES = ("EDF", "FIFO", "SPT", "LPT")


@dataclasses.dataclass(frozen=True, eq=False)
class DeferralSpec:
    """Slack/deadline model for deferrable work.

    Attributes:
        slack: scalar or per-slot ``(T,)`` integer slots of slack.  The
            batch arriving at slot ``t`` must be served by ``t + slack``
            (clipped to the trace horizon).  ``0`` means rigid — the
            deferred profile is bit-exact with the raw demand.  Per-slot
            slack keeps the zero-miss guarantee only under *monotone
            effective deadlines* (``t + slack[t]`` non-decreasing).
        rule: dispatch rule for the measurement queue, one of :data:`RULES`.
        cap: optional per-slot ceiling on the deferred service profile
            (e.g. a fleet-size limit).  Displaced work re-enters the backlog
            rather than being dropped.
        max_slack: the queue's bucket bound, ``>= max(slack)``; inferred
            from ``slack`` when None.  An explicit value keeps the bucket
            count (and so the queue's shapes) fixed across a slack sweep.
    """

    slack: Any = 0
    rule: str = "EDF"
    cap: int | None = None
    max_slack: int | None = None

    def validate(self) -> "DeferralSpec":
        if self.rule not in RULES:
            raise ValueError(
                f"unknown dispatch rule {self.rule!r}; expected one of {RULES}"
            )
        if self.cap is not None and int(self.cap) <= 0:
            raise ValueError(f"cap must be positive, got {self.cap}")
        bound = self.bound()
        if bound < 0:
            raise ValueError(f"slack must be non-negative, got {self.slack}")
        if np.ndim(self._slack_numpy()) > 1:
            raise ValueError(
                f"slack must be a scalar or a (T,) vector, got shape "
                f"{np.shape(self._slack_numpy())}"
            )
        return self

    def _slack_numpy(self) -> np.ndarray:
        s = self.slack
        if isinstance(s, torch.Tensor):
            s = s.detach().cpu().numpy()
        return np.asarray(s)

    def bound(self) -> int:
        """The slack bound (bucket count - 2): ``max_slack``, else
        ``max(slack)``."""
        if self.max_slack is not None:
            return int(self.max_slack)
        return int(np.max(self._slack_numpy()))

    def slack_for(self, n_slots: int, device=None) -> torch.Tensor:
        """The per-slot slack vector, broadcast to ``(n_slots,)`` int32."""
        s = torch.as_tensor(self.slack, device=device).to(torch.int32)
        if s.ndim == 1 and s.shape[0] != n_slots:
            raise ValueError(
                f"per-slot slack has length {s.shape[0]} but the workload "
                f"has {n_slots} slots"
            )
        return s.broadcast_to((n_slots,))

    def apply(self, demand) -> torch.Tensor:
        """Deferred service profile ``ã`` for ``(T,)`` or ``(B, T)`` demand,
        on the demand's device."""
        demand = torch.as_tensor(demand).to(torch.int32)
        slack_t = self.slack_for(demand.shape[-1], demand.device)
        return _defer_demand(demand, slack_t, cap=self.cap)

    def metrics(self, arrivals, x) -> dict:
        """Queue metrics for true ``arrivals`` under capacity profile ``x``.

        ``arrivals``: ``(T,)`` or ``(B, T)``; ``x``: any shape broadcastable
        to ``(..., B, T)`` (e.g. the engine's ``(S, W, B, T)`` sweep grid).
        Leaves keep the leading sweep axes: ``backlog`` is ``(..., T)``,
        scalars (misses/unserved/max_delay/p99_delay) are ``(...,)``.
        """
        x = torch.as_tensor(x).to(torch.int32)
        a = torch.as_tensor(arrivals, device=x.device).to(torch.int32).broadcast_to(x.shape)
        slack_t = self.slack_for(x.shape[-1], x.device)
        return _queue_scan(a, x, slack_t, rule=self.rule, max_slack=self.bound())
