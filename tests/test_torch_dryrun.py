"""repro_torch's dry-run, roofline and hill-climb against the JAX reference's,
on the CPU.

The dry-run creates a ``"fake"`` process group, so everything that traces
runs in ONE subprocess for the module (:data:`TRACES`; the pytest process
never initialises a process group): ``python -m repro_torch.launch.dryrun
--arch llama3.2-1b --shape decode_32k`` and both launchers' ``--dry-run``
(each through ``runpy``, as ``python -m`` runs it), then the laws of the
trace: the depth extrapolation of the reference, ``total(L) = f(p) + (L/p
- 1) * (f(2p) - f(p))``, from llama3.2-1b's decode_32k step at depths 1
and 2 equals the CLI's full-depth report (FLOPs and every collective
kind); on a fake world of ``("data"=4, "model"=1)`` 4 x the FLOPs per rank
of the reduced llama3.2-1b's train step equals a one-rank world's total.
The tests then hold: the report's keys to the reference's
(``src/repro/launch/dryrun.py:150-177``); its ``argument``
bytes to the per-device bytes the sharding rules plan (each dim divided by
its axes, as ``chip_smoke.py`` phase 18 plans them); ``collective_bytes``
on synthetic records (the counterparts of ``tests/test_dryrun_tools.py``'s
parser tests); the roofline's cell facts, model FLOPs, traffic model and
sLSTM correction to the reference's for every runnable cell on both
meshes, exactly; ``analyse`` on one synthetic report to the reference's
terms times the ratio of the two packages' constants (rtol 1e-12); and
``parse_override`` to the reference's on every value kind.

The same subprocess traces the reduced llama3.2-1b's train and prefill
steps (B 4, S 32, ``remat="none"``) on a fake world of ``("data"=1,
"model"=4)`` with and without ``seq_parallel``: under it no all-reduce has
the residual stream's (B_local, S, D) shape; per layer the forward pass
gathers the stream twice and reduce-scatters it twice onto (B_local, S/4,
D) (the embedding once more, the loss's gather once in a train step), and
the train step's backward pass mirrors every one; the result bytes are at
most 1.10 x, the temp bytes at most those of the step without it; without
it the collectives and temp bytes are those of the tree before sequence
parallelism was laid out (:data:`NO_SP`).

The hybrid and xLSTM families trace in a second subprocess
(:data:`HYBRID_TRACES`): the dry-run CLI for hymba-1.5b's and xlstm-1.3b's
decode_32k and long_500k on 16x16 (exit 0, reports under
``reports/hybrid``), xlstm-1.3b's decode_32k step at depths 8 and 16 (its
period ``p`` = 8: an sLSTM layer every 8th), and the reduced configs'
train steps on fake worlds of ``("data"=4, "model"=1)`` and one rank.
Held: each report's ``argument`` bytes to the planned bytes per device;
the FLOPs law; xlstm-1.3b's depth extrapolation ``f(p) + (L/p - 1) *
(f(2p) - f(p))`` to the full-depth report; and that no collective of its
decode step has a result as large as one layer's mLSTM state on a rank,
the collectives of the step under 0.1 GB per device in all.
"""
import json
import math
import os
import pathlib
import subprocess
import sys

import pytest

# The port's tests need torch.  CI's jax-only tier-1 job installs no torch,
# so there these files skip instead of failing at import.
torch = pytest.importorskip("torch")

from repro_torch.configs import SHAPES, get_config, runnable_cells  # noqa: E402
from repro_torch.distributed.sharding import (  # noqa: E402
    batch_specs,
    cache_specs,
    param_specs,
)
from repro_torch.launch import roofline as port_roofline  # noqa: E402
from repro_torch.launch.dryrun import collective_bytes  # noqa: E402
from repro_torch.launch.hillclimb import parse_override  # noqa: E402
from repro_torch.models import model_zoo as zoo  # noqa: E402
from repro_torch.utils.tree import tree_leaves  # noqa: E402

REPO_ROOT = pathlib.Path(__file__).resolve().parents[1]
MESH16 = {"data": 16, "model": 16}
# the keys of the reference's report (src/repro/launch/dryrun.py:150-177)
REPORT_KEYS = {"arch", "shape", "mesh", "n_chips", "compile_s", "depth_probe_s",
               "bytes_per_device", "hlo_flops_per_device", "hlo_bytes_per_device",
               "collective_bytes_per_device", "collective_total_per_device", "roofline"}
BYTES_KEYS = {"argument", "output", "temp", "generated_code"}
ROOFLINE_KEYS = {"compute_s", "memory_s_hlo_upper", "collective_s"}

TRACES = """
import json, math, runpy, sys
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.configs import SHAPES, ShapeCell, get_config
from repro_torch.launch.dryrun import collective_counts, fake_world, trace_cell, with_depth
from repro_torch.launch.mesh import make_production_mesh

def as_main(module, argv):
    sys.argv = [module] + argv
    try:
        runpy.run_module(module, run_name="__main__", alter_sys=True)
    except SystemExit as e:
        return e.code
    return 0

out = {"rc": {
    "dryrun": as_main("repro_torch.launch.dryrun",
                      ["--arch", "llama3.2-1b", "--shape", "decode_32k"]),
    "serve": as_main("repro_torch.launch.serve", ["--arch", "llama3.2-1b", "--dry-run"]),
    "train": as_main("repro_torch.launch.train", ["--arch", "llama3.2-1b", "--dry-run"]),
}}
with fake_world(256):
    mesh = make_production_mesh(device="cpu")
    out["depth"] = {}
    for k in (1, 2):
        got = trace_cell(with_depth(get_config("llama3.2-1b"), k), SHAPES["decode_32k"], mesh)
        out["depth"][k] = {"flops": got["flops"], "coll": got["collectives"]}
cfg = get_config("llama3.2-1b", reduced=True).replace(n_layers=1)
shape = ShapeCell("law", 32, 8, "train")
with fake_world(4):
    mesh = init_device_mesh("cpu", (4, 1), mesh_dim_names=("data", "model"))
    out["per_rank_of_4"] = trace_cell(cfg, shape, mesh)["flops"]
with fake_world(1):
    mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
    out["one_rank"] = trace_cell(cfg, shape, mesh)["flops"]
cfg = get_config("llama3.2-1b", reduced=True).replace(remat="none")
out["sp"] = {}
with fake_world(4):
    mesh = init_device_mesh("cpu", (1, 4), mesh_dim_names=("data", "model"))
    for sp in (False, True):
        for kind in ("train", "prefill"):
            got = trace_cell(cfg.replace(seq_parallel=sp), ShapeCell("sp", SP_S, SP_B, kind), mesh)
            out["sp"][f"{kind}|{sp}"] = {
                "temp": got["temp"], "coll": collective_counts(got["records"]),
                "records": [[k, math.prod(res[0][0])] for op, res in got["records"]
                            for k in collective_counts([(op, res)])]}
print(json.dumps(out))
"""


HYBRID_CELLS = [(a, s) for a in ("hymba-1.5b", "xlstm-1.3b") for s in ("decode_32k", "long_500k")]

HYBRID_TRACES = """
import json, runpy, sys
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.configs import SHAPES, ShapeCell, get_config
from repro_torch.launch.dryrun import collective_bytes, fake_world, trace_cell, with_depth
from repro_torch.launch.mesh import make_production_mesh

def as_main(module, argv):
    sys.argv = [module] + argv
    try:
        runpy.run_module(module, run_name="__main__", alter_sys=True)
    except SystemExit as e:
        return e.code
    return 0

out = {"rc": {f"{a}|{s}": as_main("repro_torch.launch.dryrun",
                                  ["--arch", a, "--shape", s, "--out", "reports/hybrid"])
              for a, s in CELLS}}
with fake_world(256):
    mesh = make_production_mesh(device="cpu")
    out["depth"] = {}
    for k in (8, 16):
        got = trace_cell(with_depth(get_config("xlstm-1.3b"), k), SHAPES["decode_32k"], mesh)
        out["depth"][k] = {"flops": got["flops"], "coll": got["collectives"],
                           "largest": max(sum(collective_bytes([r]).values())
                                          for r in got["records"])}
shape = ShapeCell("law", 32, 8, "train")
out["share"] = {}
for arch in ("hymba-1.5b", "xlstm-1.3b"):
    cfg = get_config(arch, reduced=True)
    with fake_world(4):
        mesh = init_device_mesh("cpu", (4, 1), mesh_dim_names=("data", "model"))
        per_rank = trace_cell(cfg, shape, mesh)["flops"]
    with fake_world(1):
        mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
        out["share"][arch] = (per_rank, trace_cell(cfg, shape, mesh)["flops"])
print(json.dumps(out))
"""


# the sequence-parallel law's steps: the reduced llama3.2-1b (2 layers, D 64) at
# B 4, S 32 on ("data"=1, "model"=4)
SP_B, SP_S, SP_TP = 4, 32, 4
# the collectives (kind: count, result bytes) and temp bytes of those steps
# without seq_parallel, as the tree traced them before sequence parallelism
# was laid out: a step without it must not move
NO_SP = {"train": ({"all-reduce": [20, 246228.0]}, 1196412),
         "prefill": ({"all-reduce": [5, 81920.0], "all-gather": [1, 8192.0]}, 204928)}


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    """The subprocess's results and the directory it ran in (its reports
    under ``reports/dryrun``)."""
    cwd = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO_ROOT / "src") + os.pathsep + env.get("PYTHONPATH", "")
    script = f"SP_B, SP_S = {SP_B}, {SP_S}\n" + TRACES
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                          env=env, cwd=cwd, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-5000:]
    return json.loads(proc.stdout.strip().splitlines()[-1]), cwd / "reports" / "dryrun", \
        proc.stdout


@pytest.fixture(scope="module")
def hybrid(tmp_path_factory):
    """:data:`HYBRID_TRACES`'s results and the directory of its reports."""
    cwd = tmp_path_factory.mktemp("dryrun_hybrid")
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO_ROOT / "src") + os.pathsep + env.get("PYTHONPATH", "")
    script = f"CELLS = {HYBRID_CELLS!r}\n" + HYBRID_TRACES
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                          env=env, cwd=cwd, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-5000:]
    return json.loads(proc.stdout.strip().splitlines()[-1]), cwd / "reports" / "hybrid"


def _report(reports, arch, shape, mesh="16x16"):
    return json.loads((reports / f"{arch}__{shape}__{mesh}.json").read_text())


def test_cli_and_launchers_exit_0_and_print_the_references_lines(traced):
    out, reports, stdout = traced
    assert out["rc"] == {"dryrun": 0, "serve": 0, "train": 0}
    assert "OK   llama3.2-1b x decode_32k x 16x16: " in stdout
    assert "compiled llama3.2-1b x decode_32k: flops/dev=" in stdout
    assert "compiled llama3.2-1b x train_4k: flops/dev=" in stdout
    assert sorted(p.name for p in reports.glob("*.json")) == [
        "llama3.2-1b__decode_32k__16x16.json", "llama3.2-1b__train_4k__16x16.json"]


@pytest.mark.parametrize("shape", ["decode_32k", "train_4k"])
def test_report_has_the_references_keys(traced, shape):
    rep = _report(traced[1], "llama3.2-1b", shape)
    assert set(rep) == REPORT_KEYS
    assert set(rep["bytes_per_device"]) == BYTES_KEYS
    assert set(rep["roofline"]) == ROOFLINE_KEYS
    assert rep["n_chips"] == 256 and rep["mesh"] == "16x16"
    assert rep["hlo_flops_per_device"] > 0 and rep["bytes_per_device"]["temp"] > 0
    assert rep["collective_total_per_device"] == sum(rep["collective_bytes_per_device"].values())
    # the roofline table reads it unchanged
    a = port_roofline.analyse(rep)
    assert a["dominant"] in ("compute", "memory", "collective") and a["model_flops"] > 0


def _planned_bytes(tree, specs, sizes) -> int:
    """Per-device bytes of ``tree`` under ``specs``: each sharded dim divided
    by the product of its axes' sizes (no placement code)."""
    total = 0
    for x, spec in zip(tree_leaves(tree), tree_leaves(specs)):
        local = list(x.shape)
        for d, part in enumerate(spec):
            axes = () if part is None else part if isinstance(part, tuple) else (part,)
            n = math.prod(sizes[a] for a in axes)
            assert x.shape[d] % n == 0
            local[d] //= n
        total += math.prod(local) * x.element_size()
    return total


def test_argument_bytes_equal_the_planned_bytes_per_device(traced):
    cfg = get_config("llama3.2-1b")
    params = zoo.abstract_params(cfg)
    # train_4k: parameters, AdamW's two float32 moments and its int32 step, the batch
    shape = SHAPES["train_4k"]
    batch = zoo.input_specs(cfg, shape)
    p = _planned_bytes(params, param_specs(params, MESH16), MESH16)
    want = 3 * p + 4 + _planned_bytes(batch, batch_specs(batch, MESH16), MESH16)
    assert _report(traced[1], "llama3.2-1b", "train_4k")["bytes_per_device"]["argument"] == want
    # decode_32k: the serving parameters, the token, the position, the cache
    shape = SHAPES["decode_32k"]
    cache = zoo.abstract_cache(cfg, shape)
    token = torch.empty((shape.global_batch,), dtype=torch.int32, device="meta")
    want = (_planned_bytes(params, param_specs(params, MESH16, serving=True), MESH16)
            + _planned_bytes([token], batch_specs([token], MESH16), MESH16) + 4
            + _planned_bytes(cache, cache_specs(cache, MESH16), MESH16))
    assert _report(traced[1], "llama3.2-1b", "decode_32k")["bytes_per_device"]["argument"] == want


def _planned_decode_bytes(cfg, shape) -> int:
    """The serving parameters, the token, the position and the cache of a
    decode cell, per device on 16x16, as the rules plan them."""
    params, cache = zoo.abstract_params(cfg), zoo.abstract_cache(cfg, shape)
    token = torch.empty((shape.global_batch,), dtype=torch.int32, device="meta")
    return (_planned_bytes(params, param_specs(params, MESH16, serving=True), MESH16)
            + _planned_bytes([token], batch_specs([token], MESH16), MESH16) + 4
            + _planned_bytes(cache, cache_specs(cache, MESH16), MESH16))


@pytest.mark.parametrize("arch,shape", HYBRID_CELLS)
def test_hybrid_cells_trace_with_the_planned_argument_bytes(hybrid, arch, shape):
    out, reports = hybrid
    assert out["rc"][f"{arch}|{shape}"] == 0
    rep = _report(reports, arch, shape)
    assert set(rep) == REPORT_KEYS and rep["hlo_flops_per_device"] > 0
    want = _planned_decode_bytes(get_config(arch), SHAPES[shape])
    assert rep["bytes_per_device"]["argument"] == want


def test_xlstm_depth_extrapolation_equals_the_full_depth_count(hybrid):
    out, reports = hybrid
    full = _report(reports, "xlstm-1.3b", "decode_32k")
    cfg = get_config("xlstm-1.3b")
    p = cfg.slstm_every
    f1, f2 = out["depth"][str(p)], out["depth"][str(2 * p)]
    n = cfg.n_layers // p
    assert f1["flops"] + (n - 1) * (f2["flops"] - f1["flops"]) == full["hlo_flops_per_device"]
    coll = full["collective_bytes_per_device"]
    assert set(f1["coll"]) == set(f2["coll"]) == set(coll) and coll
    for kind in coll:
        assert f1["coll"][kind] + (n - 1) * (f2["coll"][kind] - f1["coll"][kind]) == coll[kind]


def test_xlstm_decode_reduces_no_recurrent_state(hybrid):
    """The decode step's collectives move (B, di) products, never a layer's
    (B, nh, hd, hd + 1) mLSTM state: every result is smaller than one
    layer's state on a rank, and all of them together under 0.1 GB."""
    out, reports = hybrid
    cfg, shape = get_config("xlstm-1.3b"), SHAPES["decode_32k"]
    h = zoo.abstract_cache(cfg, shape)["mlstm"].h
    layer_state = _planned_bytes([h], [cache_specs({"h": h}, MESH16)["h"]], MESH16) // cfg.n_layers
    assert max(d["largest"] for d in out["depth"].values()) < layer_state
    assert _report(reports, "xlstm-1.3b", "decode_32k")["collective_total_per_device"] < 0.1e9


@pytest.mark.parametrize("arch", ["hymba-1.5b", "xlstm-1.3b"])
def test_hybrid_flops_per_rank_are_the_ranks_share(hybrid, arch):
    per_rank, one_rank = hybrid[0]["share"][arch]
    assert one_rank > 0 and 4 * per_rank == one_rank


def test_depth_extrapolation_equals_the_full_depth_count(traced):
    depth, full = traced[0]["depth"], _report(traced[1], "llama3.2-1b", "decode_32k")
    f1, f2 = depth["1"], depth["2"]
    L = get_config("llama3.2-1b").n_layers
    assert f1["flops"] + (L - 1) * (f2["flops"] - f1["flops"]) == full["hlo_flops_per_device"]
    coll = full["collective_bytes_per_device"]
    assert set(f1["coll"]) == set(f2["coll"]) == set(coll) and coll
    for kind in coll:
        assert f1["coll"][kind] + (L - 1) * (f2["coll"][kind] - f1["coll"][kind]) == coll[kind]


def test_flops_per_rank_are_the_ranks_share(traced):
    out = traced[0]
    assert out["one_rank"] > 0 and 4 * out["per_rank_of_4"] == out["one_rank"]


@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_seq_parallel_collective_law(traced, kind):
    """Under seq_parallel the residual stream's all-reduces become a gather
    into each tensor-parallel region and a reduce-scatter out of it."""
    sp, plain = traced[0]["sp"][f"{kind}|True"], traced[0]["sp"][f"{kind}|False"]
    cfg = get_config("llama3.2-1b", reduced=True)
    L, stream = cfg.n_layers, SP_B * SP_S * cfg.d_model

    def count(k, numel):
        return sum(1 for r in sp["records"] if r == [k, numel])

    assert count("all-reduce", stream) == 0, sp["coll"]
    # forward: 2 gathers and 2 scatters a layer, the embedding's scatter (and
    # in a train step the loss's gather); the backward pass mirrors each
    gathers, scatters = 2 * L + (kind == "train"), 2 * L + 1
    if kind == "train":
        gathers, scatters = gathers + scatters, scatters + gathers
    assert count("all-gather", stream) == gathers, sp["records"]
    assert count("reduce-scatter", stream // SP_TP) == scatters, sp["records"]
    total = sum(b for _, b in sp["coll"].values())
    assert total <= 1.10 * sum(b for _, b in plain["coll"].values())
    assert sp["temp"] <= plain["temp"]


@pytest.mark.parametrize("kind", ["train", "prefill"])
def test_steps_without_seq_parallel_unchanged(traced, kind):
    plain = traced[0]["sp"][f"{kind}|False"]
    coll, temp = NO_SP[kind]
    assert plain["coll"] == coll and plain["temp"] == temp


# ---------------------------------------------------------------------------
# collective_bytes on synthetic records
# ---------------------------------------------------------------------------

def test_collective_bytes_sync_ops():
    records = [
        ("_c10d_functional::all_reduce", [((256, 1024), torch.float32)]),
        ("all_gather_into_tensor.default", torch.empty((64, 512), dtype=torch.bfloat16)),
        ("_c10d_functional.reduce_scatter_tensor.default", [((32,), torch.float32)]),
        ("aten::mm", [((8, 8), torch.float32)]),
    ]
    got = collective_bytes(records)
    assert got == {"all-reduce": 256 * 1024 * 4, "all-gather": 64 * 512 * 2,
                   "reduce-scatter": 32 * 4}


def test_collective_bytes_wait_not_double_counted():
    records = [("all_reduce.default", [((128,), torch.float32)]),
               ("wait_tensor.default", [((128,), torch.float32)])]
    assert collective_bytes(records) == {"all-reduce": 128 * 4}


def test_collective_bytes_coalesced_results():
    records = [("all_gather_into_tensor_coalesced.default",
                [((16, 64), torch.bfloat16), ((16, 64), torch.bfloat16)]),
               ("all_to_all_single", ((4, 4), torch.int32))]
    assert collective_bytes(records) == {"all-gather": 2 * 16 * 64 * 2, "all-to-all": 64}


# ---------------------------------------------------------------------------
# roofline and hill-climb against the reference
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref_roofline():
    """The reference's roofline, its parameter tree built once per config
    (its counts trace ``init_params`` on every call)."""
    import functools

    from repro.launch import roofline
    from repro.models import model_zoo as ref_zoo

    original = ref_zoo.abstract_params
    ref_zoo.abstract_params = functools.lru_cache(maxsize=None)(original)
    try:
        yield roofline
    finally:
        ref_zoo.abstract_params = original


FACT_KEYS = ("n_chips", "tp", "dp", "n_total", "n_embed", "n_active", "body", "body_active",
             "B", "S", "b_loc")


def test_roofline_cells_equal_the_reference(ref_roofline):
    cells = 0
    for arch, shape in runnable_cells():
        for mesh in ("16x16", "2x16x16"):
            want = ref_roofline.cell_facts(arch, shape, mesh)
            got = port_roofline.cell_facts(arch, shape, mesh)
            assert {k: got[k] for k in FACT_KEYS} == {k: want[k] for k in FACT_KEYS}, (arch, shape)
            for fn in ("model_flops", "analytic_memory_bytes", "slstm_correction_flops"):
                assert getattr(port_roofline, fn)(got) == getattr(ref_roofline, fn)(want), \
                    (fn, arch, shape, mesh)
            cells += 1
    assert cells == 2 * len(runnable_cells()) > 40


def test_analyse_scales_by_the_constants(ref_roofline):
    report = {
        "arch": "llama3.2-1b", "shape": "train_4k", "mesh": "16x16",
        "hlo_flops_per_device": 3.5e13, "collective_total_per_device": 2.0e10,
        "collective_bytes_per_device": {"all-gather": 1.5e10, "all-reduce": 5.0e9},
        "bytes_per_device": {"argument": 1, "output": 2, "temp": 3},
        "roofline": {"memory_s_hlo_upper": None},
    }
    want, got = ref_roofline.analyse(report), port_roofline.analyse(report)
    ratios = {"compute_s": ref_roofline.PEAK_FLOPS_BF16 / port_roofline.PEAK_FLOPS_BF16,
              "memory_s": ref_roofline.HBM_BW / port_roofline.HBM_BW,
              "collective_s": ref_roofline.ICI_BW / port_roofline.LINK_BW}
    for k, r in ratios.items():
        assert got[k] == pytest.approx(want[k] * r, rel=1e-12)
    assert got["model_flops"] == want["model_flops"]
    assert got["hlo_flops_total"] == want["hlo_flops_total"]
    assert got["useful_frac"] == pytest.approx(want["useful_frac"], rel=1e-12)


def test_roofline_constants_are_the_h100s():
    assert (port_roofline.PEAK_FLOPS_BF16, port_roofline.PEAK_FLOPS_F32,
            port_roofline.HBM_BW, port_roofline.LINK_BW) == (989e12, 67e12, 3.35e12, 50e9)


@pytest.mark.parametrize("kv", ["kv_cache_dtype=bfloat16", "kv_cache_dtype=float8_e4m3fn",
                                "param_dtype=float32", "sp_decode=true", "fsdp_only=False",
                                "n_layers=4", "capacity_factor=1.25", "remat=dots"])
def test_parse_override_equals_the_reference(kv, monkeypatch):
    # the reference's module sets XLA_FLAGS on import; restore it after
    monkeypatch.setenv("XLA_FLAGS", os.environ.get("XLA_FLAGS", ""))
    from repro.launch.hillclimb import parse_override as ref_parse

    (rk, rv), (pk, pv) = ref_parse(kv), parse_override(kv)
    assert pk == rk
    if isinstance(pv, torch.dtype):
        assert str(pv).removeprefix("torch.") == getattr(rv, "__name__", str(rv))
    else:
        assert type(pv) is type(rv) and pv == rv
