"""repro_torch.lint — static analysis aware of PyTorch and CUDA, and the
runtime sanitizer of the port.

Static side (``python -m repro_torch.lint src/repro_torch chip_smoke.py
--strict``): seven rules (RPT001–RPT007) over the port's Python modules and
its CUDA sources that enforce the port's invariants — explicit generators,
no host sync and no host work on the launch path, one kernel builder and
no fast math, an explicit device for a step's tensors, one owner for each
build and launch counter, no fallback from a kernel to its plain version.
The five static modules (``analyzer``, ``context``, ``findings``,
``rules``, ``__main__``) import only the standard library.  Runtime side:
:func:`repro_torch.lint.sanitize.tracer_sanitizer`, the one gated build
check, the counterpart of ``repro.lint.sanitize``.

See ``docs/static_analysis_torch.md`` for the rule ↔ invariant table, the
launch path and the suppression syntax
(``# repro-torch-lint: disable=RPT002``; ``//`` in CUDA sources).
"""
from .analyzer import (
    EXCLUDED_DIRS,
    LintResult,
    iter_source_files,
    lint_file,
    lint_paths,
)
from .findings import Finding, diff_summaries, summarize
from .rules import HOST_PARAMS, LAUNCH_PATH, RULES, Rule
from .sanitize import RecompileError, UnobservableCacheError, tracer_sanitizer

__all__ = [
    "EXCLUDED_DIRS",
    "Finding",
    "HOST_PARAMS",
    "LAUNCH_PATH",
    "LintResult",
    "RULES",
    "RecompileError",
    "Rule",
    "UnobservableCacheError",
    "diff_summaries",
    "iter_source_files",
    "lint_file",
    "lint_paths",
    "summarize",
    "tracer_sanitizer",
]
