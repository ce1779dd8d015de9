"""The benchmark's yardstick on the CPU: the manifest and the files it names,
the traffic generator, the arithmetic, the trace reduction, and the rule
that nothing under ``perfbench/`` loads JAX or the JAX package."""
from __future__ import annotations

import ast
import json
import pathlib
import shutil
from types import SimpleNamespace

import numpy as np
import pytest

from perfbench import arith, manifest, trace
from perfbench.traffic import Schedule, Traffic, log_uniform_strata

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
WORKLOADS = [w["name"] for w in MANIFEST["workloads"]]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_each_cell_finds_its_files_by_name(workload):
    cell = manifest.load_cell(workload)
    w = next(x for x in MANIFEST["workloads"] if x["name"] == workload)
    assert cell.config["name"] == w["config"] and cell.traffic.name == w["traffic"]
    assert cell.batch >= 1 and cell.check_requests >= 1
    assert set(cell.limits) <= {"logit_err", "logit_err_p75", "token_gap", "token_excess"}
    assert cell.limits["token_excess"] == 0.0
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
    for m in cell.per_layer:
        assert callable(manifest.reader(m["name"]))


@pytest.mark.parametrize("name, error", [("no-such.cell", KeyError), ("bad name", ValueError),
                                         ("../yi-9b.longdoc", ValueError)])
def test_an_unknown_or_malformed_workload_is_refused(name, error):
    with pytest.raises(error):
        manifest.load_cell(name)


@pytest.mark.parametrize("metric, error", [("no_such_metric", FileNotFoundError),
                                           ("../harness", ValueError)])
def test_an_unknown_metric_reader_is_refused(metric, error):
    with pytest.raises(error):
        manifest.reader(metric)


def test_a_new_cell_is_added_by_files_and_entries_alone(tmp_path):
    """A copy of the benchmark's data, with a new mix, cell, metric and
    workload entry added and no file that was there edited: the harness
    finds all of it by name."""
    shutil.copytree(HERE, tmp_path / "perfbench", ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (tmp_path / "perfbench").rglob("*") if p.is_file()}
    (tmp_path / "perfbench" / "traffic" / "midlength.json").write_text(json.dumps({
        "name": "midlength", "why": "a test mix", "loop": "closed", "clients": 1,
        "prompt": {"min": 512, "max": 1024, "multiple": 64, "spread": "log-uniform"},
        "strata": 4, "n_new": 1}))
    (tmp_path / "perfbench" / "cells" / "yi-9b.midlength.json").write_text(json.dumps({
        "batch": 4, "check_requests": 2, "limits": {"logit_err": 0.1, "token_excess": 0.0}}))
    (tmp_path / "perfbench" / "metrics" / "batches_seen.py").write_text(
        "def read(run):\n    return float(len(run.window.batches))\n")
    m = json.loads(json.dumps(MANIFEST))
    m["workloads"].append({"name": "yi-9b.midlength", "config": "yi-9b",
                           "traffic": "midlength", "chips": 1, "why": "a test cell"})
    m["per_layer"].append({"name": "batches_seen", "unit": "batches", "better": "higher",
                           "source": "host_clock", "layer": "the device",
                           "moves": "tokens_per_s", "workloads": ["yi-9b.midlength"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))

    cell = manifest.load_cell("yi-9b.midlength", root=tmp_path)
    assert cell.traffic.lengths == (512, 640, 768, 1024) and cell.batch == 4
    assert [x["name"] for x in cell.per_layer] == ["batches_seen"]
    read = manifest.reader("batches_seen", root=tmp_path)
    assert read(SimpleNamespace(window=SimpleNamespace(batches=[1, 2, 3]))) == 3.0
    assert all(p.read_bytes() == b for p, b in before.items())


def test_strata_are_the_log_uniform_quantiles_rounded_down():
    assert log_uniform_strata(1024, 4032, 64, 8) == (1024, 1216, 1472, 1792, 2240, 2688,
                                                     3264, 4032)
    assert log_uniform_strata(128, 512, 64, 8) == (128, 128, 128, 192, 256, 320, 384, 512)


@pytest.mark.parametrize("mix", ["longdoc", "shortdoc"])
def test_traffic_is_made_again_from_the_seed_and_changes_with_it(mix):
    traffic = Traffic.from_file(HERE / "traffic" / f"{mix}.json")
    seed = 2 ** 31 + 12345
    a, b = Schedule(traffic, 2, 64000, seed), Schedule(traffic, 2, 64000, seed)
    c = Schedule(traffic, 2, 64000, seed + 1)
    n = 3 * len(traffic.lengths)
    assert [a.length(i) for i in range(n)] == [b.length(i) for i in range(n)]
    assert all(np.array_equal(a.tokens(i), b.tokens(i)) for i in (0, 5, 17))
    assert np.array_equal(a.warmup_tokens(), b.warmup_tokens())
    assert a.warmup_tokens().shape == (2, traffic.longest)
    assert not np.array_equal(a.tokens(0)[:, :64], c.tokens(0)[:, :64])
    assert [a.length(i) for i in range(n)] != [c.length(i) for i in range(n)]
    for r in range(3):      # every seed sends each round's set of lengths, in its own order
        lo, hi = r * len(traffic.lengths), (r + 1) * len(traffic.lengths)
        for s in (a, c):
            assert sorted(s.length(i) for i in range(lo, hi)) == sorted(traffic.lengths)
    t = a.tokens(3)
    assert t.dtype == np.int32 and t.min() >= 0 and t.max() < 64000


@pytest.mark.parametrize("spec, why", [
    ({"loop": "open"}, "closed loop"), ({"clients": 2}, "closed loop"),
    ({"prompt": {"min": 100, "max": 50, "multiple": 64, "spread": "log-uniform"}}, "multiple"),
    ({"prompt": {"min": 64, "max": 128, "multiple": 64, "spread": "uniform"}}, "spread")])
def test_a_mix_the_generator_cannot_make_is_refused(tmp_path, spec, why):
    base = json.loads((HERE / "traffic" / "longdoc.json").read_text())
    path = tmp_path / "mix.json"
    path.write_text(json.dumps({**base, **spec}))
    with pytest.raises(ValueError, match=why.split()[0]):
        Traffic.from_file(path)


def _model(name):
    return json.loads((HERE / "configs" / f"{name}.json").read_text())["model"]


def test_flops_equal_hand_counts_at_the_published_configurations():
    # yi-9b: q, k, v and o projections and the SwiGLU's three products, 48 layers
    per_layer = 2 * 4096 * (32 + 8) * 128 + 2 * 4096 * 4096 + 6 * 4096 * 11008
    assert arith.product_flops_per_token(_model("yi-9b")) == 48 * per_layer == 16_609_443_840
    # qwen3-moe-30b-a3b at head_dim 128: projections, the router, 8 experts' SwiGLU
    per_layer = 2 * 2048 * 40 * 128 + 2 * 4096 * 2048 + 2 * 2048 * 128 + 8 * 6 * 2048 * 768
    assert arith.product_flops_per_token(_model("qwen3-moe-30b-a3b")) == 48 * per_layer
    # a prefill adds causal attention in every layer and one unembedded position
    yi = _model("yi-9b")
    assert arith.prefill_flops(yi, 2, 1024) == (2 * 1024 * 16_609_443_840
                                                + 48 * 2 * 2 * 32 * 1024 ** 2 * 128
                                                + 2 * 2 * 4096 * 64000)


def test_k3_bound_equals_the_hand_count():
    peak = arith.peaks("NVIDIA H100 80GB HBM3")
    yi = _model("yi-9b")
    # B 1, S 4096, 32 heads of 128: 2 * 32 * 4096^2 * 128 flops at 989 TFLOP/s
    assert arith.attention_bound_s(yi, 1, 4096, peak) * 1e3 == pytest.approx(0.13897, rel=1e-4)
    assert arith.attention_flops(1, 4096, 32, 128) == 137_438_953_472
    # q, k, v, o: 4096 * (32 + 4 + 4 + 32) * 128 * 2 bytes, the bound at short prompts
    assert arith.attention_bytes(1, 4096, 32, 4, 128) == 4096 * 72 * 128 * 2
    assert arith.attention_bound_s(yi, 16, 128, peak) == pytest.approx(
        16 * 128 * 72 * 128 * 2 / 3.35e12)
    assert arith.peaks("a card not in the table") is None


def _imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module)
    return names


SOURCES = sorted(HERE.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(HERE)))
def test_nothing_here_imports_jax_or_the_jax_package(path):
    """Top-level names compared whole: ``repro_torch`` is the port, ``repro``
    the JAX package."""
    tops = {name.split(".")[0] for name in _imports(path)}
    assert not tops & {"jax", "jaxlib", "flax", "repro"}, tops


def test_the_reference_imports_nothing_of_the_port():
    tops = {name.split(".")[0] for name in _imports(HERE / "reference.py")}
    assert tops <= {"__future__", "torch"}, tops


class _Event:
    """A raw profiler record, with the methods that torch 2.11's have."""

    def __init__(self, name, kind, start, dur, device="CPU", thread=1):
        self._v = (name, kind, start, dur, device, thread)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def device_type(self):
        return f"DeviceType.{self._v[4]}"

    def start_thread_id(self):
        return self._v[5]


def test_the_trace_reduces_to_busy_time_launches_and_labelled_gaps():
    ev = [
        _Event(trace.MARKER, "user_annotation", 0, 1000),
        _Event(trace.MARKER, "gpu_user_annotation", 0, 1000, "CUDA"),   # not work
        _Event("aten::mm", "cpu_op", 10, 100),
        _Event("cudaLaunchKernel", "cuda_runtime", 20, 5),
        _Event("aten::index", "cpu_op", 400, 300),
        _Event("cudaLaunchKernel", "cuda_runtime", 410, 5),
        _Event("gemm", "kernel", 100, 200, "CUDA"),
        _Event("gemm", "kernel", 250, 100, "CUDA"),          # overlaps the first
        _Event("flash_wgmma_kernel<bf16>", "kernel", 500, 100, "CUDA"),
        _Event("Memcpy DtoH", "gpu_memcpy", 900, 50, "CUDA"),
    ]
    t = trace.reduce(ev, batches=2, k3_launches=3)
    assert t.window_s == pytest.approx(1000e-9)
    assert t.busy_s == pytest.approx((250 + 100 + 50) * 1e-9)
    assert t.k3_records == 1 and t.launches == 3 + 2          # 3 kernel records, 2 K3 lost
    assert t.launch_apis == {"cudaLaunchKernel": 2}
    assert dict(t.device_ops) == pytest.approx({"gemm": 300e-9, "flash_wgmma_kernel<bf16>":
                                               100e-9, "Memcpy DtoH": 50e-9})
    # gaps: 0-100 (in aten::mm), 350-500 (in aten::index at 425), 600-900 (midpoint 750:
    # no operator), 950-1000 (none)
    assert dict(t.idle_gaps) == pytest.approx({"aten::mm": 100e-9, "aten::index": 150e-9,
                                              trace.BETWEEN_OPS: 350e-9})
