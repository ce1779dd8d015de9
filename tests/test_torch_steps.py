"""repro_torch's step builders == the JAX reference's, on the CPU.

The reference's ``build_{train,prefill,decode}_step`` run on the reduced
llama3.2-1b and the reduced qwen3-moe (its MoE constraint site) in float32,
``fn`` jitted on a 1x1 mesh of its one CPU device.  The port's bundles run
in ONE world of four gloo ranks for the module
(``repro_torch.distributed.world.run_world`` on a ``(2, 2)`` ``("data",
"model")`` mesh; the ranks import this module, which imports jax only
inside functions; the pytest process never initialises a process group),
each argument placed by the bundle's ``in_shardings`` (``steps.place``):
the train step at ``(2, 2)`` (and, for llama3.2-1b, with ``fsdp_only``,
held to the same reference step: on one device ``fsdp_only`` moves
nothing), the prefill and 4 decode steps (teacher-forced tokens from a
seeded numpy generator) at ``(2, 2)``.  The weights are normals from a
seeded numpy generator in the reference's tree (its layers stacked),
carried across by ``repro_torch.convert.lm_params_from_numpy``.  Held: the prefill's logits
and every cache leaf, each decode step's logits, the train step's loss, its
metrics and every new parameter, within rtol 1e-5 and atol 1e-5 x the
leaf's largest |value| of the reference (the form of
``tests/test_torch_train.py``'s AdamW check; sharded sums reorder the
additions).  The ranks also run llama3.2-1b's prefill and decode steps on
the kernel route (``kernel=True``, forced onto CPU tensors by a stand-in
for ``attention._kernel_route``: the kernels' plain versions run where K3
and K4 would, on each rank's local heads), held to the same bound.  Under
sequence parallelism (``seq_parallel``: the residual stream split by
sequence over ``"model"``, a gather into every tensor-parallel region and a
reduce-scatter out of it) both archs' train steps, and llama3.2-1b's
prefill and 4 decode steps on both routes, run in the same world at
``(2, 2)``, held to
the reference's steps with ``seq_parallel=True`` (on its one device, the
same numbers) within the same bound.

Specs: every bundle's in and out specs equal the reference bundle's, leaf
for leaf (a stacked layer's spec without its leading ``None``), on 16x16
and 2x16x16 for both archs and all three kinds.  The reference builds its
bundles in one subprocess with 512 host devices (as
``tests/test_dryrun_tools.py`` does) on meshes of ``Auto`` axes: its
``make_production_mesh`` gives ``Explicit`` axes under this JAX, on which
its ``with_sharding_constraint`` refuses to trace (ROADMAP.md § 3); nothing
is lowered.  The port plans on plain mappings of axis names to sizes.
"""
import concurrent.futures
import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

# The port's tests need torch.  CI's jax-only tier-1 job installs no torch,
# so there these files skip instead of failing at import.
torch = pytest.importorskip("torch")

from repro_torch.configs import SHAPES, ShapeCell, get_config  # noqa: E402
from repro_torch.distributed.world import run_world  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.utils.tree import tree_leaves, tree_map, tree_paths  # noqa: E402

# The ranks import this module (its target), so the reference — and jax —
# are imported where the tests need them, never at the top.

REPO_ROOT = pathlib.Path(__file__).resolve().parents[1]
WORLD, MESH, AXES = 4, (2, 2), ("data", "model")
ARCHS = ("llama3.2-1b", "qwen3-moe-30b-a3b")
B, S, SLOTS, N_DECODE = 4, 16, 32, 4
RTOL = 1e-5                     # and atol RTOL x the reference leaf's largest |value|
SEED = 11
WORLD_TIMEOUT_S = 240
STACKED_TOPS = ("blocks", "encoder", "decoder")
SPEC_MESHES = {"16x16": {"data": 16, "model": 16},
               "2x16x16": {"pod": 2, "data": 16, "model": 16}}
SPEC_SHAPES = ("train_4k", "prefill_32k", "decode_32k")
# what the world runs of each arch: the train step's modes, the serving routes
TRAIN_MODES = {"llama3.2-1b": ("mesh", "fsdp_only", "seq_parallel"),
               "qwen3-moe-30b-a3b": ("mesh", "seq_parallel")}
SERVE_ROUTES = {"llama3.2-1b": (False, True), "qwen3-moe-30b-a3b": (False,)}
# the archs whose serving steps also run under sequence parallelism, on both routes
SP_SERVE = ("llama3.2-1b",)
WEIGHT_STD = 0.05


def port_cfg(arch, mode="mesh"):
    return get_config(arch, reduced=True).replace(
        compute_dtype=torch.float32, kv_cache_dtype=torch.float32,
        fsdp_only=mode == "fsdp_only", seq_parallel=mode == "seq_parallel")


def inputs(arch):
    """The prompt and the teacher-forced decode tokens, from numpy."""
    vocab = get_config(arch, reduced=True).vocab_size
    rng = np.random.default_rng(SEED)
    return (rng.integers(0, vocab, (B, S), dtype=np.int32),
            rng.integers(0, vocab, (N_DECODE, B), dtype=np.int32))


# ---------------------------------------------------------------------------
# The world's ranks
# ---------------------------------------------------------------------------

def _whole(tree):
    """Every ``DTensor`` of ``tree`` gathered (a collective on every rank)."""
    return tree_map(lambda x: x.full_tensor().clone() if hasattr(x, "full_tensor") else x, tree)


def serve_steps(mesh, cfg, weights, prompt, picks, kernel):
    """The prefill and ``N_DECODE`` teacher-forced decode steps of ``cfg`` on
    ``mesh`` (``kernel``: forced onto CPU tensors, so that K3's and K4's plain
    versions run where the kernels would, on each rank's local heads); the
    gathered logits and caches."""
    import unittest.mock

    from repro_torch.models import attention, init_cache

    cell = ShapeCell("p", SLOTS, B, "prefill")
    forced = unittest.mock.patch.object(attention, "_kernel_route", lambda x, kernel: kernel)
    if kernel:
        forced.start()
    try:
        prefill = steps.build_prefill_step(cfg, mesh, cell, kernel=kernel)
        decode = steps.build_decode_step(cfg, mesh, dataclasses.replace(cell, kind="decode"),
                                         kernel=kernel)
        params, batch, cache = steps.place(
            (weights, {"tokens": prompt}, init_cache(cfg, B, SLOTS, device="cpu")),
            prefill.in_shardings)
        logits, cache = prefill.fn(params, batch, cache)
        got = {"prefill": _whole((logits, cache)), "decode": []}
        for i in range(N_DECODE):
            token, cur_len = steps.place((picks[i], torch.tensor(S + i, dtype=torch.int32)),
                                         decode.in_shardings[1:3])
            logits, cache = decode.fn(params, token, cur_len, cache)
            got["decode"].append(_whole(logits))
        got["cache"] = _whole(cache)
    finally:
        if kernel:
            forced.stop()
    return got


def rank_steps(mesh, payload):
    """One rank: for each arch, the train step in each of its modes at (2,
    2), then the prefill and decode steps on both routes (for ``SP_SERVE``
    also under ``seq_parallel``); rank 0 returns the gathered outputs."""
    import torch.distributed as dist

    from repro_torch.optim import init_adamw

    out = {}
    for arch in ARCHS:
        prompt, picks = (torch.as_tensor(x) for x in inputs(arch))
        weights = payload[arch]
        for mode in TRAIN_MODES[arch]:
            bundle = steps.build_train_step(port_cfg(arch, mode), mesh,
                                            ShapeCell("t", S, B, "train"))
            params = tree_map(lambda x: x.clone(), weights)
            args = steps.place((params, init_adamw(params), {"tokens": prompt}),
                               bundle.in_shardings)
            new_params, _, metrics = bundle.fn(*args)
            out[arch, "train", mode] = _whole((new_params, metrics))
        for kernel in SERVE_ROUTES[arch]:
            out[arch, "serve", kernel] = serve_steps(mesh, port_cfg(arch), weights, prompt,
                                                     picks, kernel)
            if arch in SP_SERVE:
                out[arch, "serve_sp", kernel] = serve_steps(
                    mesh, port_cfg(arch, "seq_parallel"), weights, prompt, picks, kernel)
    return out if dist.get_rank() == 0 else None


# ---------------------------------------------------------------------------
# The reference
# ---------------------------------------------------------------------------

def _ref_cfg(arch, seq_parallel=False):
    import jax.numpy as jnp

    from repro.configs import get_config as ref_config

    return ref_config(arch, reduced=True).replace(
        compute_dtype=jnp.float32, kv_cache_dtype=jnp.float32, seq_parallel=seq_parallel)


def _ref_mesh():
    import jax

    auto = (jax.sharding.AxisType.Auto,) * 2
    return jax.make_mesh((1, 1), AXES, axis_types=auto, devices=jax.devices()[:1])


def reference_weights():
    """Weights of each arch in the reference's tree (its layers stacked on
    axis 0), as numpy normals at ``WEIGHT_STD`` from a seeded generator,
    drawn leaf by leaf over the port's meta tree: no jax before the world
    starts."""
    from repro_torch.models import model_zoo

    rng = np.random.default_rng(SEED)

    def draw(x):
        return (rng.standard_normal(tuple(x.shape)) * WEIGHT_STD).astype(
            str(x.dtype).removeprefix("torch."))

    def stack(layers):
        if isinstance(layers[0], dict):
            return {k: stack([layer[k] for layer in layers]) for k in layers[0]}
        return np.stack(layers)

    out = {}
    for arch in ARCHS:
        tree = tree_map(draw, model_zoo.abstract_params(port_cfg(arch)))
        out[arch] = {k: stack(v) if k in STACKED_TOPS else v for k, v in tree.items()}
    return out


def _ref_serve(cfg, mesh, params, prompt, picks):
    """The reference's prefill and ``N_DECODE`` decode steps, jitted."""
    import jax
    import jax.numpy as jnp

    from repro.launch import steps as ref_steps
    from repro.models import init_cache

    cell = ShapeCell("p", SLOTS, B, "prefill")
    prefill = jax.jit(ref_steps.build_prefill_step(cfg, mesh, cell).fn)
    decode = jax.jit(ref_steps.build_decode_step(
        cfg, mesh, dataclasses.replace(cell, kind="decode")).fn)
    logits, cache = prefill(params, {"tokens": jnp.asarray(prompt)}, init_cache(cfg, B, SLOTS))
    got = {"prefill": jax.tree.map(np.asarray, (logits, cache)), "decode": []}
    for i in range(N_DECODE):
        logits, cache = decode(params, jnp.asarray(picks[i]), jnp.int32(S + i), cache)
        got["decode"].append(np.asarray(logits))
    got["cache"] = jax.tree.map(np.asarray, cache)
    return got


def reference_steps(weights):
    """The reference's bundles on its one device: for each arch the train
    step, the prefill and the decode steps, and the same with
    ``seq_parallel`` (the train step, and for ``SP_SERVE`` the serving
    steps)."""
    import jax
    import jax.numpy as jnp

    from repro.launch import steps as ref_steps
    from repro.optim import init_adamw

    mesh, out = _ref_mesh(), {}
    for arch in ARCHS:
        prompt, picks = inputs(arch)
        params = jax.tree.map(jnp.asarray, weights[arch])
        # on one device fsdp_only moves nothing: one train step holds both
        # modes; seq_parallel is the reference's own flag
        for sp in (False, True) if "seq_parallel" in TRAIN_MODES[arch] else (False,):
            bundle = ref_steps.build_train_step(_ref_cfg(arch, sp), mesh,
                                                ShapeCell("t", S, B, "train"))
            new_params, _, metrics = jax.jit(bundle.fn)(params, init_adamw(params),
                                                        {"tokens": jnp.asarray(prompt)})
            out[arch, "train_sp" if sp else "train"] = jax.tree.map(np.asarray,
                                                                    (new_params, metrics))
        out[arch, "serve"] = _ref_serve(_ref_cfg(arch), mesh, params, prompt, picks)
        if arch in SP_SERVE:
            out[arch, "serve_sp"] = _ref_serve(_ref_cfg(arch, True), mesh, params, prompt, picks)
    return out


REF_SPECS = """
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
import jax
from repro.configs import SHAPES, get_config
from repro.launch.steps import build_step

def leaves(tree):
    out = {}
    for path, x in jax.tree_util.tree_leaves_with_path(tree):
        key = "/".join(str(getattr(k, "key", getattr(k, "name", getattr(k, "idx", k))))
                       for k in path)
        out[key] = [list(p) if isinstance(p, tuple) else p for p in x.spec]
    return out

res = {}
for name, (shape, axes) in {"16x16": ((16, 16), ("data", "model")),
                            "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}.items():
    mesh = jax.make_mesh(shape, axes, axis_types=(jax.sharding.AxisType.Auto,) * len(axes))
    for arch in ARCHS:
        for cell in SPEC_SHAPES:
            b = build_step(get_config(arch), mesh, SHAPES[cell])
            res["|".join((arch, cell, name))] = [leaves(b.in_shardings), leaves(b.out_shardings)]
print(json.dumps(res))
"""


@pytest.fixture(scope="module")
def results():
    """(the port's world's results, the reference's, the reference's
    specs): the world and the spec subprocess run while the reference
    computes."""
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO_ROOT / "src") + os.pathsep + env.get("PYTHONPATH", "")
    script = f"ARCHS = {ARCHS!r}\nSPEC_SHAPES = {SPEC_SHAPES!r}\n" + REF_SPECS
    specs = subprocess.Popen([sys.executable, "-c", script], stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True, env=env, cwd=REPO_ROOT)
    try:
        from repro_torch.convert import lm_params_from_numpy

        weights = reference_weights()
        payload = {arch: lm_params_from_numpy(weights[arch], port_cfg(arch), device="cpu")
                   for arch in ARCHS}
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            world = pool.submit(run_world, "test_torch_steps:rank_steps", WORLD, device="cpu",
                                payload=payload, timeout=WORLD_TIMEOUT_S, mesh_shape=MESH,
                                mesh_dim_names=AXES)
            want = reference_steps(weights)
            got = world.result()[0]
        stdout, stderr = specs.communicate(timeout=240)
    finally:
        if specs.poll() is None:
            specs.kill()
    assert specs.returncode == 0, stderr[-4000:]
    return got, want, json.loads(stdout.strip().splitlines()[-1])


def assert_leaves_close(got, want, what):
    """Every leaf of the port's ``got`` (per-layer lists) against the
    reference's ``want`` (numpy, layers stacked), within RTOL."""
    got, want = tree_leaves(got), tree_leaves(want)
    assert len(got) == len(want), what
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape, (what, i, g.shape, w.shape)
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=RTOL * float(np.abs(w).max()),
                                   err_msg=f"{what}: leaf {i}")


@pytest.mark.parametrize("arch,mode", [(a, m) for a in ARCHS for m in TRAIN_MODES[a]])
def test_train_step_matches_reference(results, arch, mode):
    from repro_torch.convert import lm_params_from_numpy

    got = results[0][arch, "train", mode]
    want = results[1][arch, "train_sp" if mode == "seq_parallel" else "train"]
    new_params, metrics = got
    want_params, want_metrics = want
    assert sorted(metrics) == sorted(want_metrics) == sorted(steps.METRICS)
    for k in want_metrics:
        np.testing.assert_allclose(float(metrics[k]), float(want_metrics[k]), rtol=RTOL,
                                   err_msg=f"{arch} {mode} metric {k}")
    want_params = lm_params_from_numpy(want_params, port_cfg(arch), device="cpu")
    assert tree_paths(new_params) == tree_paths(want_params)
    assert_leaves_close(new_params, want_params, f"{arch} {mode} params")


def assert_serving_close(got, want, what):
    assert_leaves_close(got["prefill"][0], want["prefill"][0], f"{what} prefill logits")
    assert_leaves_close(got["prefill"][1], want["prefill"][1], f"{what} prefill cache")
    for i, (g, w) in enumerate(zip(got["decode"], want["decode"], strict=True)):
        assert_leaves_close(g, w, f"{what} decode step {i}")
    assert_leaves_close(got["cache"], want["cache"], f"{what} cache after decode")


@pytest.mark.parametrize("arch,kernel", [(a, k) for a in ARCHS for k in SERVE_ROUTES[a]],
                         ids=lambda v: {False: "plain", True: "kernel"}.get(v, v))
def test_serving_steps_match_reference(results, arch, kernel):
    assert_serving_close(results[0][arch, "serve", kernel], results[1][arch, "serve"], arch)


@pytest.mark.parametrize("arch,kernel", [(a, k) for a in SP_SERVE for k in SERVE_ROUTES[a]],
                         ids=lambda v: {False: "plain", True: "kernel"}.get(v, v))
def test_seq_parallel_serving_steps_match_reference(results, arch, kernel):
    """The prefill under sequence parallelism (and the decode steps after
    it) against the reference's with ``seq_parallel=True``, and against the
    world's own steps without it."""
    got = results[0][arch, "serve_sp", kernel]
    assert_serving_close(got, results[1][arch, "serve_sp"], f"{arch} seq_parallel")
    assert_serving_close(got, results[0][arch, "serve", kernel], f"{arch} seq_parallel vs not")


def _port_spec_leaves(bundle_tree):
    """The port bundle's specs by the reference's paths (argument index,
    then the leaf's path without its layer index)."""
    out = {}
    for i, tree in enumerate(bundle_tree):
        for path, s in zip(tree_paths(tree), tree_leaves(tree)):
            parts = path.split("/") if path else []
            layer = [j for j in range(1, len(parts))
                     if parts[j].isdigit() and parts[j - 1] in STACKED_TOPS]
            key = "/".join([str(i)] + [p for j, p in enumerate(parts) if j not in layer])
            spec = [list(p) if isinstance(p, tuple) else p for p in s.spec]
            out.setdefault(key, []).append((bool(layer), spec))
    return out


@pytest.mark.parametrize("mesh", list(SPEC_MESHES))
@pytest.mark.parametrize("cell", SPEC_SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_bundle_specs_match_reference(results, arch, cell, mesh):
    want_in, want_out = results[2]["|".join((arch, cell, mesh))]
    bundle = steps.build_step(get_config(arch), SPEC_MESHES[mesh], SHAPES[cell])
    for want, ours in ((want_in, bundle.in_shardings), (want_out, bundle.out_shardings)):
        got = _port_spec_leaves(ours)
        assert set(got) == set(want)
        for key, specs in got.items():
            for stacked, spec in specs:
                assert (want[key][1:] if stacked else want[key]) == spec, (key, spec, want[key])
