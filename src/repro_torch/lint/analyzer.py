"""File walking, rule dispatch and suppression filtering.

:func:`lint_paths` is the programmatic entry point behind the CLI and the
self-check test: walk the given files/directories (skipping
``__pycache__``-style noise and the deliberately violating
``tests/lint_fixtures``), parse each Python module once and read each CUDA
source (``.cu``/``.cuh``) once, run every rule over the shared context,
and mark findings that a ``# repro-torch-lint: disable=...`` comment
(``// repro-torch-lint: ...`` in CUDA) covers as suppressed (they still
count in the summary, so suppression drift shows in the findings diff).
"""
from __future__ import annotations

import ast
import dataclasses
import os
from typing import Iterable, Iterator, Sequence

from .context import CudaContext, ModuleContext
from .findings import Finding, active, summarize
from .rules import RULES, Rule

#: directory basenames never walked into (explicit file arguments bypass
#: this — the rule fixture tests lint files under lint_fixtures directly)
EXCLUDED_DIRS = frozenset({
    "__pycache__", ".git", ".venv", "node_modules", "lint_fixtures",
    ".mypy_cache", ".ruff_cache", ".pytest_cache",
})

#: suffixes of the CUDA sources the walk picks up
CUDA_SUFFIXES = (".cu", ".cuh")


@dataclasses.dataclass
class LintResult:
    findings: list[Finding]
    files: int
    parse_errors: list[Finding]
    unknown_suppressions: list[Finding]

    @property
    def ok(self) -> bool:
        return not active(self.findings) and not self.parse_errors

    def strict_ok(self) -> bool:
        return self.ok and not self.unknown_suppressions

    def summary(self, paths: Sequence[str] = ()) -> dict:
        return summarize(
            self.findings + self.parse_errors,
            files=self.files,
            rule_ids=RULES,
            paths=list(paths),
        )


def iter_source_files(paths: Iterable[str]) -> Iterator[str]:
    """Yield ``.py``, ``.cu`` and ``.cuh`` files under the given
    files/directories.  Arguments that are neither are skipped here;
    :func:`lint_paths` turns them into gating ``path-error`` findings so a
    typo'd path cannot silently lint nothing."""
    for path in paths:
        if os.path.isfile(path):
            yield path
        elif os.path.isdir(path):
            for root, dirs, files in os.walk(path):
                dirs[:] = sorted(d for d in dirs if d not in EXCLUDED_DIRS)
                for name in sorted(files):
                    if name.endswith((".py",) + CUDA_SUFFIXES):
                        yield os.path.join(root, name)


def lint_file(
    path: str, *, rules: Sequence[Rule] | None = None, source: str | None = None
) -> LintResult:
    """Lint one file; a Python syntax error becomes a single
    ``parse-error`` finding instead of an exception (rendered like a rule
    hit, gated by ``--strict`` and the default exit code alike)."""
    if source is None:
        with open(path, encoding="utf-8") as fh:
            source = fh.read()
    ctx: ModuleContext | CudaContext
    if path.endswith(CUDA_SUFFIXES):
        ctx = CudaContext(path, source)
    else:
        try:
            tree = ast.parse(source, filename=path)
        except SyntaxError as e:
            return LintResult(
                findings=[],
                files=1,
                parse_errors=[Finding(
                    path, e.lineno or 1, (e.offset or 1) - 1,
                    "parse-error", f"cannot parse: {e.msg}",
                )],
                unknown_suppressions=[],
            )
        ctx = ModuleContext(path, source, tree)
    findings: list[Finding] = []
    for rule in rules if rules is not None else RULES.values():
        check = rule.check_cuda if isinstance(ctx, CudaContext) else rule.check
        if check is None:
            continue
        for line, col, message in check(ctx):
            findings.append(Finding(
                path, line, col, rule.id, message,
                suppressed=ctx.is_suppressed(rule.id, line),
            ))
    unknown = [
        Finding(
            path, line, 0, "unknown-suppression",
            f"suppression names unknown rule id `{rid}`",
        )
        for line, rid in ctx.unknown_suppressions
    ]
    return LintResult(sorted(findings), 1, [], unknown)


def lint_paths(
    paths: Sequence[str], *, rules: Sequence[Rule] | None = None
) -> LintResult:
    findings: list[Finding] = []
    parse_errors: list[Finding] = []
    unknown: list[Finding] = []
    files = 0
    for path in paths:
        if not os.path.isfile(path) and not os.path.isdir(path):
            parse_errors.append(Finding(
                path, 1, 0, "path-error",
                "path is neither a file nor a directory — nothing was "
                "linted under this argument (typo in the invocation?)",
            ))
    for path in iter_source_files(paths):
        res = lint_file(path, rules=rules)
        files += 1
        findings.extend(res.findings)
        parse_errors.extend(res.parse_errors)
        unknown.extend(res.unknown_suppressions)
    return LintResult(sorted(findings), files, sorted(parse_errors),
                      sorted(unknown))
