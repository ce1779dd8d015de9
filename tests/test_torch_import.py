"""repro_torch stands alone: importing it loads neither jax nor repro."""
import ast
import os
import pathlib
import subprocess
import sys

import pytest

# The port's tests need torch.  CI's jax-only tier-1 job installs no torch,
# so there these files skip instead of failing at import.
pytest.importorskip("torch")

REPO_ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO_ROOT / "src" / "repro_torch"
MODULES = sorted(
    ".".join(p.relative_to(REPO_ROOT / "src").with_suffix("").parts).removesuffix(".__init__")
    for p in PORT.rglob("*.py")
)


def test_port_modules_found():
    for m in ("repro_torch", "repro_torch.convert", "repro_torch.core.provision",
              "repro_torch.core.torch_provision", "repro_torch.kernels._build",
              "repro_torch.kernels.provision_scan", "repro_torch.kernels.ops",
              "repro_torch.kernels.flash_attention", "repro_torch.kernels.decode_attention",
              "repro_torch.kernels.ref", "repro_torch.obs.telemetry",
              "repro_torch.core.events", "repro_torch.data.requests",
              "repro_torch.configs.base", "repro_torch.models.attention",
              "repro_torch.models.model_zoo", "repro_torch.serving.cluster",
              "repro_torch.serving.engine", "repro_torch.launch.serve",
              "repro_torch.core.segments", "repro_torch.core.offline",
              "repro_torch.core.online", "repro_torch.core.fluid",
              "repro_torch.core.dp_oracle", "repro_torch.core.analysis",
              "repro_torch.utils", "repro_torch.utils.tree", "repro_torch.data.tokens",
              "repro_torch.optim.adamw", "repro_torch.distributed.compression",
              "repro_torch.distributed.fault_tolerance", "repro_torch.launch.mesh",
              "repro_torch.checkpoint.checkpointer", "repro_torch.train.trainer",
              "repro_torch.launch.train", "repro_torch.models.ssm",
              "repro_torch.models.moe", "repro_torch.models.xlstm",
              "repro_torch.configs.hymba_1_5b", "repro_torch.configs.qwen3_moe_30b_a3b",
              "repro_torch.configs.llama4_scout_17b_a16e", "repro_torch.configs.xlstm_1_3b",
              "repro_torch.models.encdec", "repro_torch.configs.paligemma_3b",
              "repro_torch.configs.seamless_m4t_large_v2", "repro_torch.distributed.world",
              "repro_torch.distributed.sharding", "repro_torch.distributed.ctx",
              "repro_torch.distributed.elastic"):
        assert m in MODULES


def test_import_loads_neither_jax_nor_repro():
    code = (
        "import importlib, sys\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'repro' or m.startswith('repro.'))\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO_ROOT / "src") + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, env=env,
        cwd=REPO_ROOT, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr


def _imported_roots(tree: ast.AST) -> set[str]:
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(PORT)))
def test_no_file_imports_jax_or_repro(path):
    roots = _imported_roots(ast.parse(path.read_text(), filename=str(path)))
    assert not roots & {"jax", "jaxlib", "repro"}, roots


def test_chip_smoke_imports_neither_jax_nor_repro():
    roots = _imported_roots(ast.parse((REPO_ROOT / "chip_smoke.py").read_text()))
    assert not roots & {"jax", "jaxlib", "repro"}, roots


def test_scanner_catches_a_forbidden_import():
    tree = ast.parse("import jax.numpy as jnp\nfrom repro.core import costs\n")
    assert _imported_roots(tree) == {"jax", "repro"}
