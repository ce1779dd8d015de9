"""Runtime sanitizer: one gated implementation of the build check.

The PyTorch counterpart of ``repro.lint.sanitize``.  :func:`tracer_sanitizer`
wraps a region in the runtime invariant the port's paths promise: **no
unexpected compiles** — a :class:`~repro_torch.obs.torchwatch.CompileWatcher`
over the kernel libraries hard-fails with :class:`RecompileError` when the
region builds more libraries than ``max_compiles`` allows
(``exact_compiles`` pins the count exactly — the "cold build == 1" form of
the gate).

The reference also checks for tracer leaks (``jax.checking_leaks``).
PyTorch runs eagerly and traces nothing, so there is no leak to check;
the port keeps the reference's name for the function all the same.
"""
from __future__ import annotations

import contextlib
from typing import Iterator

from ..obs.torchwatch import CompileWatcher


class RecompileError(AssertionError):
    """The sanitized region compiled more (or other than) it declared."""


class UnobservableCacheError(RuntimeError):
    """The compile count cannot be observed.  Kept for the reference's API:
    the port's build counter is its own and always observable, so the
    port never raises it."""


@contextlib.contextmanager
def tracer_sanitizer(
    fns=None,
    *,
    max_compiles: int | None = 0,
    exact_compiles: int | None = None,
) -> Iterator[CompileWatcher]:
    """Gate a region on zero (or a declared number of) kernel-library
    builds.  Yields the live :class:`CompileWatcher`; after the block its
    ``added`` holds the build count of the region.

    ``fns``: which libraries — the provisioning scans
    (``repro_torch.kernels._build.load_provision_scan``), the attention
    kernels (``load_attention``), or both (None, the default); see
    :class:`CompileWatcher`.  ``max_compiles=None`` disables the gate;
    ``exact_compiles`` overrides ``max_compiles`` with an equality check.
    """
    watcher = CompileWatcher(fns=fns)
    with watcher:
        yield watcher
    added = watcher.added
    if exact_compiles is not None:
        if added != exact_compiles:
            raise RecompileError(
                f"region built {added} kernel library(ies), declared exactly "
                f"{exact_compiles}"
            )
    elif max_compiles is not None and added > max_compiles:
        raise RecompileError(
            f"region built {added} kernel library(ies), declared at most "
            f"{max_compiles} — a loader's cache was probably dropped"
        )
