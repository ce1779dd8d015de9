"""repro_torch.deferral — slack-aware workload deferral in PyTorch.

The port of ``repro.deferral``.  :func:`defer_demand` turns arrivals +
slack into the water-filled service profile the provisioning engine runs
on (defer-then-provision), and :func:`queue_scan` measures the resulting
queue — backlog, queueing delay, deadline misses — under a dispatch rule.
:class:`DeferralSpec` is the user-facing model attached to
``Workload(deferral=...)``; see ``docs/deferral.md``.

The streaming twins — :func:`defer_stream` (the causal deferral rule,
O(slack) state) and :func:`queue_stream` / :func:`queue_stream_finalize`
(the same age-bucket queue with the carry crossing call boundaries) — are
chunk-size invariant by construction; the serving stepper will use them.
"""
from .queue_scan import (
    defer_demand,
    defer_stream,
    defer_stream_init,
    due_envelope,
    queue_scan,
    queue_stream,
    queue_stream_finalize,
    queue_stream_init,
)
from .spec import RULES, DeferralSpec

__all__ = [
    "DeferralSpec",
    "RULES",
    "defer_demand",
    "defer_stream",
    "defer_stream_init",
    "due_envelope",
    "queue_scan",
    "queue_stream",
    "queue_stream_finalize",
    "queue_stream_init",
]
