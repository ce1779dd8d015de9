"""Per-file analysis context shared by every lint rule.

One parse per file.  :class:`ModuleContext` (a Python module) resolves
import aliases to dotted module paths (``F.pad`` -> ``torch.nn.functional.pad``
under ``import torch.nn.functional as F``; ``m = importlib.import_module("a.b")``
binds ``m`` to ``a.b``), finds the module's *launch-path regions* — the
per-step entry functions that :data:`repro_torch.lint.rules.LAUNCH_PATH`
lists for it, or that a ``# repro-torch-lint: launch-path=f,g`` comment
declares, each with the functions of the same module it calls,
transitively — and indexes ``# repro-torch-lint: disable=...`` suppression
comments by line.  :class:`CudaContext` is the same for a CUDA source
(``.cu``/``.cuh``): its code with comments and literals blanked, and its
``// repro-torch-lint: disable=...`` comments.

The prefix is the port's own: the reference's ``# repro-lint:`` comments
are not read here, and this package's are not read by ``repro.lint``.
"""
from __future__ import annotations

import ast
import dataclasses
import io
import re
import tokenize

#: a suppression comment's body, after its ``#`` or ``//``
_SUPPRESS_BODY = (
    r"repro-torch-lint:\s*(disable|disable-file)\s*=\s*"
    r"([A-Za-z0-9_]+(?:\s*,\s*[A-Za-z0-9_]+)*|all)"
)
_SUPPRESS_RE = re.compile(r"#\s*" + _SUPPRESS_BODY)
_CUDA_SUPPRESS_RE = re.compile(r"(?://|/\*)\s*" + _SUPPRESS_BODY)
_LAUNCH_RE = re.compile(
    r"#\s*repro-torch-lint:\s*launch-path\s*=\s*"
    r"([A-Za-z_][\w.]*(?:\s*,\s*[A-Za-z_][\w.]*)*)"
)

Suppressions = tuple[dict[int, set[str]], set[int], set[str], list[tuple[int, str]]]


@dataclasses.dataclass(frozen=True)
class LaunchRegion:
    """One function on the launch path: ``entry`` is the listed function
    whose calls reach it (itself, for an entry).  ``qualname`` is
    ``f`` or ``Class.method``."""

    node: ast.FunctionDef | ast.AsyncFunctionDef
    qualname: str
    entry: str


class _Suppressible:
    suppressions: dict[int, set[str]]
    standalone_lines: set[int]
    file_suppressions: set[str]

    def is_suppressed(self, rule: str, line: int) -> bool:
        """True when ``rule`` is disabled at ``line`` — by a trailing
        comment on the line itself, a standalone suppression comment on the
        line above, or a file-level ``disable-file``."""
        if rule in self.file_suppressions or "all" in self.file_suppressions:
            return True
        here = self.suppressions.get(line, ())
        if rule in here or "all" in here:
            return True
        if line - 1 in self.standalone_lines:
            above = self.suppressions.get(line - 1, ())
            if rule in above or "all" in above:
                return True
        return False


class ModuleContext(_Suppressible):
    """Everything rules need to know about one parsed Python module."""

    def __init__(self, path: str, source: str, tree: ast.Module):
        self.path = path
        self.posix_path = path.replace("\\", "/")
        self.source = source
        self.tree = tree
        #: every node of the tree, in ``ast.walk`` order (walked once)
        self.nodes = list(ast.walk(tree))
        self.import_map = _collect_imports(self.nodes)
        comments = _python_comments(source)
        (
            self.suppressions,
            self.standalone_lines,
            self.file_suppressions,
            self.unknown_suppressions,
        ) = _collect_suppressions(comments, _SUPPRESS_RE)
        self.launch_regions = _collect_launch_regions(self, comments)

    def dotted(self, node: ast.AST) -> str | None:
        """Resolve ``a.b.c`` through the import map to a dotted path, or
        None when the base is not a known import binding."""
        parts: list[str] = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if not isinstance(node, ast.Name):
            return None
        base = self.import_map.get(node.id)
        if base is None:
            return None
        parts.append(base)
        return ".".join(reversed(parts))

    def in_module(self, *suffixes: str) -> bool:
        """Whether this file is one of the package's modules ``suffixes``
        (paths below ``repro_torch/``, e.g. ``kernels/_build.py``)."""
        return any(
            self.posix_path == f"repro_torch/{s}"
            or self.posix_path.endswith(f"/repro_torch/{s}")
            for s in suffixes
        )


class CudaContext(_Suppressible):
    """A CUDA source: ``code_lines`` holds its lines with every comment and
    string or character literal blanked (line numbers kept)."""

    def __init__(self, path: str, source: str):
        self.path = path
        code, comments = _split_c_source(source)
        self.code_lines = code.splitlines()
        (
            self.suppressions,
            self.standalone_lines,
            self.file_suppressions,
            self.unknown_suppressions,
        ) = _collect_suppressions(comments, _CUDA_SUPPRESS_RE)


def _collect_imports(nodes: list[ast.AST]) -> dict[str, str]:
    out: dict[str, str] = {}
    for node in nodes:
        if isinstance(node, ast.Import):
            for alias in node.names:
                local = alias.asname or alias.name.split(".")[0]
                out[local] = alias.name if alias.asname else alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom):
            mod = ("." * node.level) + (node.module or "")
            for alias in node.names:
                if alias.name == "*":
                    continue
                local = alias.asname or alias.name
                out[local] = f"{mod}.{alias.name}" if mod else alias.name
        elif (isinstance(node, ast.Assign) and len(node.targets) == 1
              and isinstance(node.targets[0], ast.Name)
              and isinstance(node.value, ast.Call) and node.value.args
              and isinstance(node.value.args[0], ast.Constant)
              and isinstance(node.value.args[0].value, str)
              and ast.unparse(node.value.func) in ("importlib.import_module",
                                                   "import_module")):
            out[node.targets[0].id] = node.value.args[0].value
    return out


#: (line, text, whether the comment is alone on its line)
Comment = tuple[int, str, bool]


def _python_comments(source: str) -> list[Comment]:
    try:
        tokens = list(tokenize.generate_tokens(io.StringIO(source).readline))
    except (tokenize.TokenError, IndentationError, SyntaxError):
        return []
    return [
        (tok.start[0], tok.string, tok.line[: tok.start[1]].strip() == "")
        for tok in tokens
        if tok.type == tokenize.COMMENT
    ]


def _split_c_source(source: str) -> tuple[str, list[Comment]]:
    """``(code, comments)``: the source with comments and string/char
    literals replaced by spaces (newlines kept), and its comments."""
    out: list[str] = []
    comments: list[Comment] = []
    i, n, line = 0, len(source), 1
    line_start = 0
    while i < n:
        c = source[i]
        if source.startswith("//", i):
            j = source.find("\n", i)
            j = n if j < 0 else j
            alone = source[line_start:i].strip() == ""
            comments.append((line, source[i:j], alone))
            out.append(" " * (j - i))
            i = j
        elif source.startswith("/*", i):
            j = source.find("*/", i + 2)
            j = n if j < 0 else j + 2
            alone = source[line_start:i].strip() == ""
            comments.append((line, source[i:j], alone))
            body = source[i:j]
            out.append("".join("\n" if ch == "\n" else " " for ch in body))
            line += body.count("\n")
            if "\n" in body:
                line_start = i + body.rfind("\n") + 1
            i = j
        elif c in "\"'":
            j = i + 1
            while j < n and source[j] != c and source[j] != "\n":
                j += 2 if source[j] == "\\" else 1
            j = min(j + 1, n)
            out.append(c + " " * (j - i - 2) + (c if j - i >= 2 else ""))
            i = j
        else:
            if c == "\n":
                line += 1
                line_start = i + 1
            out.append(c)
            i += 1
    return "".join(out), comments


def _collect_suppressions(comments: list[Comment], pattern: re.Pattern) -> Suppressions:
    """Map line -> suppressed rule ids, the lines whose suppression comment
    stands alone (those scope to the *next* line too), file-level
    suppressions, and ``(line, id)`` pairs whose id is not a known rule
    (reported under ``--strict``)."""
    from .rules import RULES  # late import: rules.py imports this module

    by_line: dict[int, set[str]] = {}
    file_level: set[str] = set()
    unknown: list[tuple[int, str]] = []
    standalone: set[int] = set()
    for line, text, alone in comments:
        m = pattern.search(text)
        if not m:
            continue
        kind, ids_raw = m.group(1), m.group(2)
        ids = {s.strip() for s in ids_raw.split(",")}
        for rid in sorted(ids):
            if rid != "all" and rid not in RULES:
                unknown.append((line, rid))
        if kind == "disable-file":
            file_level |= ids
        else:
            by_line.setdefault(line, set()).update(ids)
            if alone:
                standalone.add(line)
    return by_line, standalone, file_level, unknown


def _collect_launch_regions(ctx: ModuleContext, comments: list[Comment]) -> list[LaunchRegion]:
    """The launch path's functions in this module: the entries that
    ``LAUNCH_PATH`` lists for it or a ``launch-path=`` comment declares,
    and the module's functions they call by name (``f(...)``, and
    ``self.m(...)`` within a class), transitively."""
    from .rules import LAUNCH_PATH  # late import, as above

    entries: list[str] = []
    for suffix, names in LAUNCH_PATH.items():
        if ctx.in_module(suffix):
            entries.extend(names)
    for _line, text, _alone in comments:
        m = _LAUNCH_RE.search(text)
        if m:
            entries.extend(s.strip() for s in m.group(1).split(","))
    if not entries:
        return []

    defs: dict[str, ast.FunctionDef | ast.AsyncFunctionDef] = {}
    for node in ctx.tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            defs[node.name] = node
        elif isinstance(node, ast.ClassDef):
            for item in node.body:
                if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    defs[f"{node.name}.{item.name}"] = item

    regions: list[LaunchRegion] = []
    seen: set[str] = set()
    for entry in entries:
        queue = [entry]
        while queue:
            name = queue.pop(0)
            if name in seen or name not in defs:
                continue
            seen.add(name)
            node = defs[name]
            regions.append(LaunchRegion(node, name, entry))
            cls = name.rpartition(".")[0]
            for sub in ast.walk(node):
                if not isinstance(sub, ast.Call):
                    continue
                f = sub.func
                if isinstance(f, ast.Name) and f.id in defs:
                    queue.append(f.id)
                elif (cls and isinstance(f, ast.Attribute)
                      and isinstance(f.value, ast.Name) and f.value.id == "self"):
                    queue.append(f"{cls}.{f.attr}")
    return regions
