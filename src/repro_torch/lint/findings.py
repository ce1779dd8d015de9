"""Finding model and output formats for :mod:`repro_torch.lint`.

One :class:`Finding` per rule hit, sortable into (path, line, col) order.
Three render targets: ``text`` (editor-clickable ``path:line:col``),
``github`` (workflow-command annotations that surface inline on PR diffs),
and ``json`` (the machine-readable summary document, schema
``repro_torch.lint/v1``, with the keys of the reference's ``repro.lint/v1``).  Suppressed findings
never render but are counted in the summary, so suppression drift is visible
in the per-PR findings diff (:func:`diff_summaries`).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Iterable, Mapping, Sequence

SCHEMA = "repro_torch.lint/v1"


@dataclasses.dataclass(frozen=True, order=True)
class Finding:
    """One rule violation at a source location (1-indexed line, 0-indexed
    col, matching CPython's ``ast`` convention)."""

    path: str
    line: int
    col: int
    rule: str
    message: str
    suppressed: bool = False

    def to_dict(self) -> dict:
        return {
            "path": self.path,
            "line": self.line,
            "col": self.col,
            "rule": self.rule,
            "message": self.message,
            "suppressed": self.suppressed,
        }


def active(findings: Iterable[Finding]) -> list[Finding]:
    """The findings that actually gate: everything not suppressed."""
    return [f for f in findings if not f.suppressed]


def format_text(findings: Sequence[Finding]) -> str:
    return "\n".join(
        f"{f.path}:{f.line}:{f.col + 1}: {f.rule} {f.message}"
        for f in active(findings)
    )


def format_github(findings: Sequence[Finding]) -> str:
    """GitHub Actions workflow-command annotations (``--format github``)."""

    def esc(s: str) -> str:
        # the workflow-command grammar reserves %, \r, \n in values
        return s.replace("%", "%25").replace("\r", "%0D").replace("\n", "%0A")

    def esc_prop(s: str) -> str:
        # property values (file=, title=) additionally reserve the
        # parameter separators , and :
        return esc(s).replace(",", "%2C").replace(":", "%3A")

    return "\n".join(
        f"::error file={esc_prop(f.path)},line={f.line},col={f.col + 1},"
        f"title={esc_prop(f.rule)}::{esc(f.message)}"
        for f in active(findings)
    )


def summarize(
    findings: Sequence[Finding],
    *,
    files: int,
    rule_ids: Iterable[str],
    paths: Sequence[str] = (),
) -> dict:
    """The ``repro_torch.lint/v1`` JSON document: per-rule active/suppressed
    counts plus the full finding list."""
    rules = {
        rid: {"count": 0, "suppressed": 0} for rid in sorted(rule_ids)
    }
    for f in findings:
        row = rules.setdefault(f.rule, {"count": 0, "suppressed": 0})
        row["suppressed" if f.suppressed else "count"] += 1
    return {
        "schema": SCHEMA,
        "paths": list(paths),
        "files": files,
        "findings_total": sum(r["count"] for r in rules.values()),
        "suppressed_total": sum(r["suppressed"] for r in rules.values()),
        "rules": rules,
        "findings": [f.to_dict() for f in sorted(findings)],
    }


def format_json(summary: Mapping) -> str:
    return json.dumps(summary, indent=2, sort_keys=False)


def diff_summaries(old: Mapping, new: Mapping) -> str:
    """Informational per-rule drift between two summary documents — the
    ``bench_diff.py``-style trajectory line of ``--diff``.  Never
    raises and never gates; rule-count drift is a review signal, not an
    error (new rules and new suppressions both show up here)."""
    lines = [
        f"lint diff: files {old.get('files', 0)} -> {new.get('files', 0)}, "
        f"findings {old.get('findings_total', 0)} -> "
        f"{new.get('findings_total', 0)}, "
        f"suppressed {old.get('suppressed_total', 0)} -> "
        f"{new.get('suppressed_total', 0)}"
    ]
    old_rules = dict(old.get("rules", {}))
    new_rules = dict(new.get("rules", {}))
    for rid in sorted(set(old_rules) | set(new_rules)):
        o = old_rules.get(rid, {"count": 0, "suppressed": 0})
        n = new_rules.get(rid, {"count": 0, "suppressed": 0})
        if (o["count"], o["suppressed"]) != (n["count"], n["suppressed"]):
            lines.append(
                f"  {rid}: count {o['count']} -> {n['count']}, "
                f"suppressed {o['suppressed']} -> {n['suppressed']}"
            )
    if len(lines) == 1:
        lines.append("  per-rule counts unchanged")
    return "\n".join(lines)
