"""repro_torch.lint: the port's rules RPT001–RPT007 on their fixtures,
planted faults in copies of the port's own files, the CLI's contract
against the reference's, and the self-checks — the port's tree is clean
under both packages' lint.

The fixtures under ``tests/lint_fixtures/torch/`` deliberately violate the
rules; ``lint_fixtures`` is in both packages' ``EXCLUDED_DIRS``, so these
tests hand the files to :func:`lint_file` directly.
"""
from __future__ import annotations

import ast
import json
import os
import shutil
import sys

import pytest

from repro_torch.lint import (
    EXCLUDED_DIRS,
    HOST_PARAMS,
    LAUNCH_PATH,
    RULES,
    lint_file,
    lint_paths,
)
from repro_torch.lint.__main__ import main as port_main
from repro_torch.lint.context import ModuleContext
from repro_torch.lint.findings import Finding, active, diff_summaries, format_github

TESTS_DIR = os.path.dirname(os.path.abspath(__file__))
REPO_ROOT = os.path.dirname(TESTS_DIR)
FIXTURES = os.path.join(TESTS_DIR, "lint_fixtures", "torch")
REF_FIXTURES = os.path.join(TESTS_DIR, "lint_fixtures")
PORT = os.path.join(REPO_ROOT, "src", "repro_torch")
SMOKE = os.path.join(REPO_ROOT, "chip_smoke.py")
STATIC_MODULES = ("analyzer", "context", "findings", "rules", "__main__")


def fixture(name: str) -> str:
    return os.path.join(FIXTURES, name)


def active_rules(path: str) -> set[str]:
    res = lint_file(path)
    assert not res.parse_errors, res.parse_errors
    return {f.rule for f in active(res.findings)}


def run_cli(main, argv, capsys) -> tuple[int, str, str]:
    """A CLI's ``main(argv)`` in this process: its exit code (argparse's
    errors included), stdout and stderr."""
    try:
        rc = main(list(argv))
    except SystemExit as e:
        rc = e.code
    out = capsys.readouterr()
    return rc, out.out, out.err


# ---------------------------------------------------------------------------
# per-rule fixtures: every rule has a catching and a passing fixture
# ---------------------------------------------------------------------------

CATCH = [
    ("rpt001_bad.py", "RPT001"),
    ("rpt002_bad.py", "RPT002"),
    ("rpt003_bad.py", "RPT003"),
    ("rpt003_bad.cu", "RPT003"),
    ("rpt004_bad.py", "RPT004"),
    ("rpt005_bad.py", "RPT005"),
    ("rpt006_bad.py", "RPT006"),
    ("rpt007_bad.py", "RPT007"),
]

PASS = [
    "rpt001_good.py", "rpt002_good.py", "rpt003_good.py", "rpt003_good.cu",
    "rpt004_good.py", "rpt005_good.py", "rpt006_good.py", "rpt007_good.py",
]


@pytest.mark.parametrize("name,rule", CATCH)
def test_bad_fixture_fires_its_rule_and_no_other(name, rule):
    assert active_rules(fixture(name)) == {rule}


@pytest.mark.parametrize("name", PASS)
def test_good_fixture_is_clean_under_every_rule(name):
    res = lint_file(fixture(name))
    assert res.findings == [] and res.strict_ok(), res.findings


def test_every_rule_has_fixtures():
    assert {r for _, r in CATCH} == set(RULES)
    assert {n.split("_")[0].upper() for n in PASS} == set(RULES)


@pytest.mark.parametrize("name,lines", [
    ("rpt001_bad.py", {7, 11, 18}),
    ("rpt002_bad.py", {7, 12, 15, 17, 18, 19, 20}),
    ("rpt003_bad.py", {7, 11, 15}),
    ("rpt003_bad.cu", {4}),
    ("rpt004_bad.py", {11, 12, 13}),
    ("rpt005_bad.py", {8, 12}),
    ("rpt006_bad.py", {11, 12, 16}),
    ("rpt007_bad.py", {8, 15}),
])
def test_bad_fixture_lines(name, lines):
    # every planted violation is found, each once per site
    res = lint_file(fixture(name))
    assert {f.line for f in res.findings} == lines
    sites = [(f.line, f.col) for f in res.findings]
    assert len(sites) == len(set(sites))


def test_rpt002_reaches_called_functions_of_the_module():
    res = lint_file(fixture("rpt002_bad.py"))
    helper = [f for f in res.findings if f.line == 7]
    assert helper and "`_count` (on the launch path from `step`)" in helper[0].message


def test_rpt002_taint_flow(tmp_path):
    src = tmp_path / "m.py"
    src.write_text(
        "# repro-torch-lint: launch-path=step\n"
        "def step(x, lengths, window: int = 0):\n"
        "    n = x.shape[0]\n"          # metadata: host
        "    if n > 1:\n"
        "        pass\n"
        "    y = x + 1\n"               # tainted through arithmetic
        "    y += n\n"                  # an AugAssign keeps the taint
        "    if y:\n"                   # line 8: fires
        "        pass\n"
        "    y = n\n"                   # a plain reassignment clears it
        "    if y and window:\n"
        "        pass\n"
        "    z = helper(x)\n"           # an opaque call: not taken as tainted
        "    if z:\n"
        "        pass\n"
        "    if [t.ndim for t in lengths if t.is_cuda]:\n"  # metadata per element
        "        pass\n"
        "    if [t for t in lengths if t > 0]:\n"         # line 18: values
        "        pass\n"
    )
    res = lint_file(str(src))
    assert sorted(f.line for f in res.findings) == [8, 18]


def test_rpt001_reseed_rules(tmp_path):
    src = tmp_path / "m.py"
    src.write_text(
        "import torch\n"
        "def f(g, s):\n"
        "    g.manual_seed(s)\n"
        "    g.manual_seed(s)\n"         # no draw in between: nothing repeats
        "    a = torch.rand(2, generator=g)\n"
        "    if a.sum() > 0:\n"
        "        g.manual_seed(s + 1)\n"
        "    else:\n"
        "        g.manual_seed(s)\n"     # line 9: repeats the first draw
        "    return torch.rand(2, generator=g)\n"
    )
    res = lint_file(str(src))
    assert [(f.rule, f.line) for f in res.findings] == [("RPT001", 9)]


def test_rpt006_allows_resets_only():
    res = lint_file(fixture("rpt006_good.py"))
    assert res.findings == []
    msgs = [f.message for f in lint_file(fixture("rpt006_bad.py")).findings]
    assert any("kernels/_build.py" in m for m in msgs)


def test_cuda_comments_and_literals_are_not_code():
    from repro_torch.lint.context import CudaContext

    src = 'a = 1; // __expf\n/* x\n __logf */ b = "__powf";\n__sinf(x);\n'
    ctx = CudaContext("k.cu", src)
    assert len(ctx.code_lines) == 4
    assert "__" not in "".join(ctx.code_lines[:3]) and "__sinf" in ctx.code_lines[3]
    assert [(f.line, f.rule) for f in lint_file("k.cu", source=src).findings] == [
        (4, "RPT003")]


# ---------------------------------------------------------------------------
# suppressions: the port's own prefix
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,count", [
    ("suppressed.py", 2), ("suppressed_file.py", 2), ("suppressed.cu", 1),
])
def test_suppressions_silence_but_still_count(name, count):
    res = lint_file(fixture(name))
    assert active(res.findings) == []
    assert sum(f.suppressed for f in res.findings) == count
    assert res.ok and res.strict_ok()


def test_reference_suppression_prefix_is_not_read():
    res = lint_file(fixture("reference_suppression.py"))
    assert [f.rule for f in active(res.findings)] == ["RPT001"]
    assert res.unknown_suppressions == []


def test_unknown_suppression_is_strict_only():
    res = lint_file(fixture("unknown_suppression.py"))
    assert res.ok and not res.strict_ok()
    (f,) = res.unknown_suppressions
    assert "RPT999" in f.message


def test_parse_error_becomes_finding():
    res = lint_file(fixture("parse_error.py"))
    assert not res.ok
    (f,) = res.parse_errors
    assert f.rule == "parse-error"


# ---------------------------------------------------------------------------
# planted faults in copies of the port's own files
# ---------------------------------------------------------------------------

def _plant(tmp_path, rel, old, new):
    """A copy of ``src/repro_torch/<rel>`` under ``tmp_path/repro_torch``
    (so that its module's entries in LAUNCH_PATH apply) with ``old``
    replaced by ``new``."""
    src = os.path.join(PORT, rel)
    dst = tmp_path / "repro_torch" / rel
    dst.parent.mkdir(parents=True, exist_ok=True)
    shutil.copy(src, dst)
    text = dst.read_text()
    assert text.count(old) == 1, (rel, old)
    dst.write_text(text.replace(old, new))
    return str(dst), str(tmp_path / "repro_torch" / rel)


PLANTED = [
    ("models/transformer.py",
     "    cur_len = int(cur_len)\n",
     "    cur_len = int(cur_len)\n    first = token[0].item()\n", "RPT002"),
    ("core/torch_provision.py",
     "    u0 = torch.rand(shape, generator=generator, device=generator.device)\n",
     "    u0 = torch.rand(shape, device=generator.device)\n", "RPT001"),
    ("kernels/_build.py",
     'CUDA_FLAGS = ["-O3", ',
     'CUDA_FLAGS = ["-O3", "--use_fast_math", ', "RPT003"),
    ("kernels/csrc/flash_attention.cu",
     "      const float alpha = expf(m[i] - m_new);\n",
     "      const float alpha = __expf(m[i] - m_new);\n", "RPT003"),
    ("kernels/flash_attention.py",
     "    return _launch(q, k, v, causal, window, scale)\n",
     "    try:\n        return _launch(q, k, v, causal, window, scale)\n"
     "    except RuntimeError:\n"
     "        return flash_attention_plain(q, k, v, causal=causal, window=window, "
     "scale=scale)\n", "RPT007"),
]


@pytest.mark.parametrize("rel,old,new,rule", PLANTED, ids=[p[3] + ":" + p[0] for p in PLANTED])
def test_planted_fault_in_a_port_file_fails_the_cli(tmp_path, capsys, rel, old, new, rule):
    path, _ = _plant(tmp_path, rel, old, new)
    clean = os.path.join(PORT, rel)
    assert run_cli(port_main, [clean, "--strict"], capsys)[0] == 0
    rc, out, _err = run_cli(port_main, [path, "--strict"], capsys)
    assert rc == 1
    assert {line.split(" ")[1] for line in out.strip().splitlines()} == {rule}
    # the copy without the fault is clean where the original is
    shutil.copy(clean, path)
    assert run_cli(port_main, [path, "--strict"], capsys)[0] == 0


def test_launch_path_entries_exist():
    # the table names functions (and methods) that exist, so it cannot rot
    for rel, entries in LAUNCH_PATH.items():
        path = os.path.join(PORT, rel)
        with open(path, encoding="utf-8") as fh:
            source = fh.read()
        ctx = ModuleContext(path, source, ast.parse(source))
        found = {r.qualname for r in ctx.launch_regions}
        assert set(entries) <= found, (rel, set(entries) - found)
    for entry in HOST_PARAMS:
        module = entry.rpartition(":")[0]
        assert not module or os.path.isfile(os.path.join(PORT, module)), entry


def test_launch_path_regions_follow_calls():
    path = os.path.join(PORT, "models", "attention.py")
    with open(path, encoding="utf-8") as fh:
        source = fh.read()
    ctx = ModuleContext(path, source, ast.parse(source))
    regions = {r.qualname: r.entry for r in ctx.launch_regions}
    assert regions["_ring_slots"] == "decode_attention"
    assert "_decode_kernel" in regions and "_flash" in regions
    assert "attention_train" not in regions and "init_kv_cache" not in regions


# ---------------------------------------------------------------------------
# the CLI's contract is the reference's
# ---------------------------------------------------------------------------

CLI_KINDS = [
    ("clean", ["rpl006_good.py"], ["rpt006_good.py"]),
    ("finding", ["rpl003_bad.py"], ["rpt003_bad.py"]),
    ("parse error", ["parse_error.py"], ["parse_error.py"]),
    ("unknown suppression", ["unknown_suppression.py", "--strict"],
     ["unknown_suppression.py", "--strict"]),
    ("nonexistent path", ["no/such/dir"], ["no/such/dir"]),
    ("unknown select", ["rpl003_bad.py", "--select", "RPL999"],
     ["rpt003_bad.py", "--select", "RPT999"]),
]


def _argv(base, args):
    return [os.path.join(base, a) if a.endswith(".py") else a for a in args]


def _keys(doc):
    return (
        sorted(doc),
        sorted({k for row in doc["rules"].values() for k in row}),
        sorted({k for f in doc["findings"] for k in f}),
    )


@pytest.mark.parametrize("kind,ref_args,port_args", CLI_KINDS, ids=[k[0] for k in CLI_KINDS])
def test_cli_exit_codes_and_summary_keys_match_the_reference(capsys, kind, ref_args,
                                                             port_args):
    from repro.lint.__main__ import main as ref_main

    ref = run_cli(ref_main, _argv(REF_FIXTURES, ref_args) + ["--format", "json"], capsys)
    port = run_cli(port_main, _argv(FIXTURES, port_args) + ["--format", "json"], capsys)
    assert port[0] == ref[0]
    if kind == "unknown select":
        assert port[0] == 2 and "RPT999" in port[2]
        return
    from repro.lint import RULES as REF_RULES

    ref_doc, port_doc = json.loads(ref[1]), json.loads(port[1])
    assert port_doc["schema"] == "repro_torch.lint/v1"
    # one row per rule, plus the same rows for parse and path errors
    assert set(RULES) <= set(port_doc["rules"])
    assert set(port_doc["rules"]) - set(RULES) == set(ref_doc["rules"]) - set(REF_RULES)
    assert (port_doc["findings_total"] > 0) == (ref_doc["findings_total"] > 0)
    assert _keys(port_doc)[:2] == _keys(ref_doc)[:2]
    if ref_doc["findings"]:
        assert _keys(port_doc)[2] == _keys(ref_doc)[2]


def test_cli_formats_and_json_out(tmp_path, capsys):
    out = tmp_path / "lint.json"
    rc, stdout, _ = run_cli(port_main, [fixture("rpt003_bad.py"), "--format", "json",
                                        "--json-out", str(out)], capsys)
    assert rc == 1
    doc = json.loads(stdout)
    assert doc["rules"]["RPT003"]["count"] == 3
    assert json.loads(out.read_text()) == doc
    rc, stdout, _ = run_cli(port_main, [fixture("rpt003_bad.py"), "--format", "github"],
                            capsys)
    assert rc == 1 and stdout.startswith("::error file=") and "title=RPT003" in stdout
    rc, _, err = run_cli(port_main, [fixture("rpt003_bad.py"), "--diff", str(out)], capsys)
    assert rc == 1 and "per-rule counts unchanged" in err
    rc, _, _ = run_cli(port_main, [fixture("rpt003_bad.py"), "--select", "RPT006"], capsys)
    assert rc == 0


def test_findings_helpers():
    f = Finding("dir,x/a:b.py", 3, 0, "RPT001", "100% sure\nnext")
    (line,) = format_github([f]).splitlines()
    assert "file=dir%2Cx/a%3Ab.py" in line and "%25" in line and "%0A" in line
    old = {"files": 1, "findings_total": 0, "suppressed_total": 0,
           "rules": {"RPT001": {"count": 0, "suppressed": 0}}}
    new = {"files": 2, "findings_total": 2, "suppressed_total": 1,
           "rules": {"RPT001": {"count": 2, "suppressed": 1}}}
    assert "RPT001: count 0 -> 2, suppressed 0 -> 1" in diff_summaries(old, new)


# ---------------------------------------------------------------------------
# self-checks
# ---------------------------------------------------------------------------

def test_static_modules_import_only_the_standard_library():
    siblings = {"analyzer", "context", "findings", "rules"}
    for name in STATIC_MODULES:
        path = os.path.join(PORT, "lint", f"{name}.py")
        with open(path, encoding="utf-8") as fh:
            tree = ast.parse(fh.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                if node.level:
                    assert node.level == 1 and node.module in siblings, (name, node.module)
                    continue
                mods = [node.module]
            else:
                continue
            for mod in mods:
                top = mod.split(".")[0]
                assert top == "__future__" or top in sys.stdlib_module_names, (name, mod)


def test_port_tree_is_lint_clean_under_strict(capsys):
    res = lint_paths([PORT, SMOKE])
    assert res.files > 100
    assert active(res.findings) == [] and res.parse_errors == [], res.findings
    assert res.strict_ok()
    # the CUDA sources are linted too, and the § 3.9 host read stands suppressed
    cuda = {f.path for f in res.findings} | {
        os.path.join(PORT, "kernels", "csrc", n)
        for n in os.listdir(os.path.join(PORT, "kernels", "csrc"))}
    assert len([p for p in cuda if p.endswith((".cu", ".cuh"))]) >= 6
    ring = [f for f in res.findings if f.path.endswith("attention.py") and f.suppressed]
    assert {f.rule for f in ring} == {"RPT002"} and len(ring) == 3
    assert run_cli(port_main, [PORT, SMOKE, "--strict"], capsys)[0] == 0


def test_fixture_dirs_are_skipped_by_the_walk():
    assert "lint_fixtures" in EXCLUDED_DIRS
    res = lint_paths([TESTS_DIR])
    assert res.files > 50
    assert not any("lint_fixtures" in f.path for f in res.findings)
    assert res.parse_errors == []  # the parse_error.py fixtures were skipped


def test_reference_lint_is_clean_on_the_port():
    # the repo's CI lint job runs the reference's lint over src, tests and
    # examples: the port's modules, its example twins and its tests pass it
    from repro.lint import findings as ref_findings
    from repro.lint import lint_paths as ref_lint_paths

    tests = sorted(os.path.join(TESTS_DIR, n) for n in os.listdir(TESTS_DIR)
                   if n.startswith("test_torch_") and n.endswith(".py"))
    examples = sorted(os.path.join(REPO_ROOT, "examples", n)
                      for n in os.listdir(os.path.join(REPO_ROOT, "examples"))
                      if n.endswith("_torch.py"))
    assert len(examples) == 4
    res = ref_lint_paths([PORT] + examples + tests)
    assert ref_findings.active(res.findings) == [], ref_findings.format_text(res.findings)
    assert res.parse_errors == [] and res.strict_ok()
