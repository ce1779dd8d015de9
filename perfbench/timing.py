"""The held timer: a copy of ``repro_torch.obs.torchwatch.held_ms``, kept
under the benchmark so that a change to the program cannot change how the
benchmark times a kernel.

CUPTI drops records of the kernels that the port launches from its own
libraries, so a kernel is timed here with CUDA events, on a stream held by
a spinning kernel until the host has queued the whole call: the device
span of the call's launches, without the host's launch overhead between
them.
"""
from __future__ import annotations

import statistics

import torch

#: the first hold (about 1 ms at 1.98 GHz) and the most times it may double
HOLD_CYCLES, HOLD_DOUBLINGS = 1 << 21, 6


def held_ms(fn, reps: int) -> float:
    """Median device milliseconds of one ``fn()`` call over ``reps`` calls.
    A call is kept only if its start event was still pending when the host
    had queued its end event; else the hold doubles, and a call that still
    outruns the longest hold raises ``RuntimeError``."""
    fn()
    torch.cuda.synchronize()
    cycles, times = HOLD_CYCLES, []
    while len(times) < reps:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        fn()
        end.record()
        held = not start.query()
        end.synchronize()
        if held:
            times.append(start.elapsed_time(end))
            continue
        cycles *= 2
        if cycles > HOLD_CYCLES << HOLD_DOUBLINGS:
            raise RuntimeError(f"held stream: the host had not queued the call after a "
                               f"hold of {cycles // 2} cycles")
    return statistics.median(times)
