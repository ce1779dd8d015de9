"""The traced sub-window: a few batches under ``torch.profiler``, reduced
in memory (nothing is written to disk) to what the per-layer readers and
the result's ``breakdown`` need.

Device time is the union of the card's kernel, copy and fill records.
Launches are the device's kernel records, with the K3 launches that the
trace lost added back: CUPTI has dropped records of the kernels that the
port launches from its own ctypes libraries (K3 and K4), so the K3 records
the trace kept are counted beside the K3 launches that the port's counter
``kernels/flash_attention_launches`` saw over the same batches.  Where the
two differ, the busy time is short by the lost records and the idle share
read from it is an upper bound.  The host's launch API records are kept
beside them by name; they miss the launches of the port's libraries, which
link a CUDA runtime of their own.
"""
from __future__ import annotations

import dataclasses
import sys
import time
from collections import Counter, defaultdict

#: the host's kernel-launch calls, by their runtime and driver API names
LAUNCH_APIS = frozenset({"cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                         "cuLaunchKernelEx", "cudaLaunchCooperativeKernel"})
#: name prefixes of the device's copy and fill records (every other work record is a kernel)
COPIES = ("Memcpy", "Memset")
#: the names of K3's kernels (``csrc/flash_attention.cu``)
K3_KERNELS = ("flash_wgmma_kernel", "flash_kernel")
MARKER = "perfbench.traced_window"
#: the host label of an idle gap in which no operator ran
BETWEEN_OPS = "python between operators"


@dataclasses.dataclass
class Trace:
    batches: int
    window_s: float             # the traced window, on the profiler's clock
    busy_s: float               # the union of the device's records
    launches: int               # kernels that ran: the device's records and K3's lost ones
    launch_apis: dict           # the host's kernel-launch API records, by API name
    device_ops: list            # [(name, seconds)] over the window, most first
    idle_gaps: list             # [(host operator, idle seconds)] most first
    k3_records: int             # K3 kernels the device records kept
    k3_launches: int            # K3 launches the port counted


def profile(run, batches: int) -> Trace:
    """``run(batches)`` under the profiler; it must return with the card
    idle (the engine's last batch ends in a copy to the host)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.obs.telemetry import telemetry_session

    torch.cuda.synchronize()
    with telemetry_session() as tel:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with record_function(MARKER):
                run(batches)
                torch.cuda.synchronize()
    counted = int(tel.counter_value("kernels/flash_attention_launches"))
    t0 = time.perf_counter()
    events = prof.profiler.kineto_results.events()
    out = reduce(events, batches, counted)
    print(f"trace: {batches} batches reduced in {time.perf_counter() - t0:.2f} s; device "
          f"records by kind {dict(Counter(_work(e) for e in events))}", flush=True,
          file=sys.stderr)
    return out


def reduce(events, batches: int, k3_launches: int) -> Trace:
    """The trace's numbers from the profiler's raw events (objects with
    ``name()``, ``device_type()``, ``start_ns()``, ``duration_ns()`` and
    ``start_thread_id()``)."""
    marker = next(e for e in events if e.name() == MARKER and _on_host(e))
    w0 = marker.start_ns()
    w1 = w0 + marker.duration_ns()
    device, host, kernels = [], [], 0
    for e in events:
        work = _work(e)
        if work is not None:
            device.append((e.start_ns(), e.start_ns() + e.duration_ns(), e.name()))
            kernels += work == "kernel"
        elif _on_host(e) and e.name() != MARKER:
            host.append(e)

    by_op = defaultdict(int)
    for s, t, name in device:
        by_op[name] += t - s
    merged = []
    for s, t, _ in sorted((max(s, w0), min(t, w1), n) for s, t, n in device if t > w0 and s < w1):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    busy = sum(t - s for s, t in merged)

    gaps, cursor = [], w0
    for s, t in merged:
        if s > cursor:
            gaps.append((cursor, s))
        cursor = max(cursor, t)
    if w1 > cursor:
        gaps.append((cursor, w1))

    threads = Counter(e.start_thread_id() for e in host)
    main = threads.most_common(1)[0][0] if threads else None
    ops = sorted(((e.start_ns(), e.start_ns() + e.duration_ns(), e.name()) for e in host
                  if e.start_thread_id() == main), key=lambda x: (x[0], -x[1]))
    idle = defaultdict(int)
    for (g0, g1), label in zip(gaps, _innermost(ops, [(a + b) // 2 for a, b in gaps])):
        idle[label] += g1 - g0

    apis = Counter(e.name() for e in host if e.name() in LAUNCH_APIS)
    k3 = sum(1 for _, _, name in device if any(k in name for k in K3_KERNELS))

    def top(d):
        return [(name, ns / 1e9) for name, ns in sorted(d.items(), key=lambda x: -x[1])]

    return Trace(batches, (w1 - w0) / 1e9, busy / 1e9, kernels + max(k3_launches - k3, 0),
                 dict(apis), top(by_op), top(idle), k3, k3_launches)


def _on_host(e) -> bool:
    return str(e.device_type()).endswith("CPU")


def _work(e) -> str | None:
    """``"kernel"`` or ``"copy"`` for a record of work on the card, None for
    anything else (host records, and the profiler's annotations on the
    device's timeline)."""
    if (not str(e.device_type()).endswith("CUDA") or e.name() == MARKER
            or getattr(e, "is_user_annotation", lambda: False)()):
        return None
    return "copy" if e.name().startswith(COPIES) else "kernel"


def _innermost(ops, points):
    """For each of the ascending ``points``, the name of the innermost host
    operator running then (``ops``: (start, end, name) sorted by start, the
    longer first on a tie, nested as one thread's calls are), or
    :data:`BETWEEN_OPS`."""
    stack, i, out = [], 0, []
    for p in points:
        while i < len(ops) and ops[i][0] <= p:
            while stack and stack[-1][1] <= ops[i][0]:
                stack.pop()
            stack.append(ops[i])
            i += 1
        while stack and stack[-1][1] < p:
            stack.pop()
        out.append(stack[-1][2] if stack else BETWEEN_OPS)
    return out
