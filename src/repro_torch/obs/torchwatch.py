"""Runtime health of the port: kernel-build accounting and profiler hooks.

The PyTorch counterpart of ``repro.obs.jaxwatch``.  The port compiles
nothing with ``torch.compile``; its one compile step is building a kernel
library with ``nvcc`` (:mod:`repro_torch.kernels._build`), at most once per
library and process.  :class:`CompileWatcher` counts those builds across a
region, as the reference's counts jit programs added to the engine's
caches, so the same gates apply: a cold run builds the library its path
needs, and a warmed run, or a serving loop in its steady state, builds
nothing.

The count is a plain counter the build step keeps, so it is always
observable: ``available`` is True and ``added`` is never -1 after a region.
:func:`install_monitoring` forwards the builds' durations into a
:class:`~repro_torch.obs.telemetry.Telemetry` registry, and
:func:`profile_to` wraps a region in ``torch.profiler`` and writes a Chrome
trace — the hook behind ``python -m repro_torch.eval --profile DIR``.
:func:`held_ms` is the one timer of a kernel call's device time: CUDA
events around the call on a stream held until the host has queued it.
"""
from __future__ import annotations

import contextlib
import pathlib
import statistics

from .telemetry import Telemetry, get_telemetry


def _libraries(fns) -> tuple[str, ...]:
    """The library names a watcher counts: every library for None, else one
    per entry, each a loader of :mod:`repro_torch.kernels._build`
    (``load_provision_scan``, ``load_attention``) or a library name."""
    from ..kernels import _build

    loaders = {_build.load_provision_scan: _build.PROVISION_SCAN,
               _build.load_attention: _build.ATTENTION}
    if fns is None:
        return tuple(_build.builds)
    names = tuple(loaders.get(f, f) for f in fns)
    unknown = [n for n in names if n not in _build.builds]
    if unknown:
        raise ValueError(f"not a kernel library of the port: {unknown}; "
                         f"the libraries are {tuple(_build.builds)}")
    return names


class CompileWatcher:
    """Count kernel-library builds across a region.

    ``fns``: which libraries to watch — the loaders ``load_provision_scan``
    (K1 and K2) and ``load_attention`` (K3 and K4) of
    :mod:`repro_torch.kernels._build`, or their library names; the default
    is both.  Use as a context manager::

        with CompileWatcher() as w:
            provision(spec)
        assert w.added <= 1          # the cold build; 0 once it is loaded

    or imperatively via :meth:`snapshot` deltas.  On context exit the delta
    is also counted into the active telemetry registry (counter
    ``torch/compiles``) when one is installed.
    """

    def __init__(self, fns=None, telemetry: Telemetry | None = None):
        self.libraries = _libraries(fns)
        self.telemetry = telemetry
        self._start: int | None = None
        self.added: int = -1

    @property
    def available(self) -> bool:
        """Always True: the build counter is the port's own."""
        return True

    def snapshot(self) -> int:
        """Builds so far in this process over the watched libraries."""
        from ..kernels import _build

        return sum(_build.builds[name] for name in self.libraries)

    def __enter__(self) -> "CompileWatcher":
        self._start = self.snapshot()
        return self

    def __exit__(self, *exc) -> bool:
        self.added = self.snapshot() - self._start
        tel = self.telemetry if self.telemetry is not None else get_telemetry()
        if self.added > 0:
            tel.count("torch/compiles", self.added)
        return False


def engine_cache_size() -> int:
    """Kernel libraries built or loaded so far in this process — the
    counterpart of the reference's compiled-program count."""
    return CompileWatcher().snapshot()


_MONITORING_INSTALLED = False


def install_monitoring(telemetry: Telemetry | None = None) -> bool:
    """Forward each kernel-library build into ``telemetry``.

    The build step always records into the *active* registry (counter
    ``kernels/builds``, histogram ``kernels/build_ms``, labelled by
    library); with an explicit ``telemetry`` this also records every later
    build there, unless that registry is the active one at the time.  The
    first explicit registry is installed, at most one per process; returns
    True.
    """
    global _MONITORING_INSTALLED
    if _MONITORING_INSTALLED or telemetry is None:     # the build step records already
        return True
    from ..kernels import _build

    def on_build(name: str, seconds: float) -> None:
        if telemetry is not get_telemetry():
            telemetry.count("kernels/builds", library=name)
            telemetry.observe("kernels/build_ms", seconds * 1e3, library=name)

    _build.build_listeners.append(on_build)
    _MONITORING_INSTALLED = True
    return True


@contextlib.contextmanager
def profile_to(directory=None):
    """``torch.profiler`` over a region when ``directory`` is set, a no-op
    otherwise: the host's operators, and the card's kernels when CUDA is
    available, exported as a Chrome trace to ``directory/trace.json``
    (open it in https://ui.perfetto.dev)."""
    if directory is None:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = pathlib.Path(directory)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(str(out / "trace.json"))


#: the first hold of :func:`held_ms` (about 1 ms at 1.98 GHz) and the most
#: times it may double
HOLD_CYCLES, HOLD_DOUBLINGS = 1 << 21, 6


def held_ms(fn, reps):
    """Median device milliseconds of one ``fn()`` call over ``reps`` calls,
    each between a pair of CUDA events while a spinning kernel
    (``torch.cuda._sleep``) holds the stream until the host has queued the
    whole call: the device span of the call's launches, without the host's
    launch overhead between them.  A call is kept only if its start event
    was still pending when the host had queued its end event; else the hold
    doubles, up to ``HOLD_CYCLES << HOLD_DOUBLINGS``, and a call that still
    outruns it (one that waits for the card) raises ``RuntimeError``."""
    import torch

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
