"""repro_torch's sharded steps of the hybrid (hymba-1.5b) and xLSTM
(xlstm-1.3b) families == the JAX reference's, on the CPU.

The reference's ``build_{train,prefill,decode}_step`` run on the reduced
configs in float32, ``fn`` jitted on a 1x1 mesh of its one CPU device, as
``tests/test_torch_steps.py`` runs them.  hymba's heads are replaced in
both packages (6 query heads and 2 KV heads of 64, so 2 SSM heads of 64),
and its vocabulary (511 tokens, which divide "model" no more than the full
model's 32001 do):
on a ``(2, 2)`` ``("data", "model")`` mesh every head count divides
``"model"`` (attention, the SSM and the mLSTM on each rank's heads), on a
``(1, 4)`` mesh none does (attention in the reference's sequence layout,
the SSM's state split on its head dim, the mLSTM on whole heads, the sLSTM
state on its head dim).  The port's bundles run in ONE world of four gloo
ranks for the module (``run_world``; its ranks import this module, which
imports jax only inside functions), both meshes built over it, each
argument placed by the bundle's ``in_shardings``: the train step, then the
prefill and 4 teacher-forced decode steps, on the plain route and, for
hymba, on the kernel route (``kernel=True`` forced onto CPU tensors by a
stand-in for ``attention._kernel_route``: K3's and K4's plain versions run
where the kernels would, K3 with the window on each rank, K4 over the
ring's valid slots gathered to the front).  The prompt (20 tokens) is
longer than hymba's window (16), so its ring wraps.  The weights are
normals from a seeded numpy generator in the reference's tree, carried
across by ``repro_torch.convert.lm_params_from_numpy``.  Held, within
``test_torch_steps.py``'s form (rtol 1e-5, atol 1e-5 x the leaf's largest
|value|): the train step's loss, metrics and new parameters, the prefill's
logits and every cache leaf, each decode step's logits and the cache after
them.  Under sequence parallelism (``seq_parallel``) both archs' train
steps, and hymba's prefill and 4 decode steps on the plain route, run on
both meshes too: hymba's attention on ``(2, 2)`` in the heads layout, on
``(1, 4)`` in the sequence layout (each rank's own query rows, k and v
gathered), the SSM, mLSTM and sLSTM gathering the sequence at entry and
reduce-scattering at exit; held to the
reference's steps with ``seq_parallel=True`` in the same form.  Specs:
every bundle's in and out specs equal the reference's, leaf for leaf, on
16x16 and 2x16x16 for both archs and all three kinds (one 512-device
subprocess, as in ``test_torch_steps.py``).
"""
import concurrent.futures
import dataclasses
import json
import os
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
from repro_torch.utils.tree import tree_map, tree_paths  # noqa: E402
from test_torch_steps import (  # noqa: E402
    REF_SPECS,
    REPO_ROOT,
    STACKED_TOPS,
    _port_spec_leaves,
    _ref_mesh,
    assert_leaves_close,
)

# The ranks import this module (its target), so the reference — and jax —
# are imported where the tests need them, never at the top.

WORLD, AXES = 4, ("data", "model")
MESHES = {"2x2": (2, 2), "1x4": (1, 4)}
ARCHS = ("hymba-1.5b", "xlstm-1.3b")
HEADS = {"hymba-1.5b": {"n_heads": 6, "n_kv_heads": 2, "head_dim": 64, "vocab_size": 511},
         "xlstm-1.3b": {}}
B, S, SLOTS, N_DECODE = 4, 20, 32, 4
RTOL = 1e-5
SEED = 12
WEIGHT_STD = 0.05
WORLD_TIMEOUT_S = 240
SERVE_ROUTES = {"hymba-1.5b": (False, True), "xlstm-1.3b": (False,)}
SP_SERVE = ("hymba-1.5b",)      # its plain route's serving steps also run under seq_parallel
SPEC_MESHES = {"16x16": {"data": 16, "model": 16},
               "2x16x16": {"pod": 2, "data": 16, "model": 16}}
SPEC_SHAPES = ("train_4k", "prefill_32k", "decode_32k")


def port_cfg(arch, seq_parallel=False):
    return get_config(arch, reduced=True).replace(
        compute_dtype=torch.float32, kv_cache_dtype=torch.float32, seq_parallel=seq_parallel,
        **HEADS[arch])


def inputs(arch):
    """The prompt and the teacher-forced decode tokens, from numpy."""
    rng = np.random.default_rng(SEED)
    vocab = port_cfg(arch).vocab_size
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
    versions run where the kernels would); the gathered logits and caches."""
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
            token, cur_len = steps.place(
                (picks[i], torch.tensor(S + i, dtype=torch.int32)), decode.in_shardings[1:3])
            logits, cache = decode.fn(params, token, cur_len, cache)
            got["decode"].append(_whole(logits))
        got["cache"] = _whole(cache)
    finally:
        if kernel:
            forced.stop()
    return got


def train_step(mesh, cfg, weights, prompt):
    """One train step of ``cfg`` on ``mesh``: the gathered new parameters
    and metrics."""
    from repro_torch.optim import init_adamw

    bundle = steps.build_train_step(cfg, mesh, ShapeCell("t", S, B, "train"))
    params = tree_map(lambda x: x.clone(), weights)
    args = steps.place((params, init_adamw(params), {"tokens": prompt}), bundle.in_shardings)
    new_params, _, metrics = bundle.fn(*args)
    return _whole((new_params, metrics))


def rank_steps(mesh, payload):
    """One rank: on each mesh, for each arch, the train step, then the
    prefill and decode steps on each route, and under ``seq_parallel`` the
    train step (and for ``SP_SERVE`` the plain route's serving steps);
    rank 0 returns the gathered outputs."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    out = {}
    for name, shape in MESHES.items():
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=AXES)
        for arch in ARCHS:
            cfg, weights = port_cfg(arch), payload[arch]
            prompt, picks = (torch.as_tensor(x) for x in inputs(arch))
            out[name, arch, "train"] = train_step(mesh, cfg, weights, prompt)
            for kernel in SERVE_ROUTES[arch]:
                out[name, arch, "serve", kernel] = serve_steps(mesh, cfg, weights, prompt, picks,
                                                               kernel)
            sp = port_cfg(arch, seq_parallel=True)
            out[name, arch, "train_sp"] = train_step(mesh, sp, weights, prompt)
            if arch in SP_SERVE:
                out[name, arch, "serve_sp"] = serve_steps(mesh, sp, weights, prompt, picks, False)
    return out if dist.get_rank() == 0 else None


# ---------------------------------------------------------------------------
# The reference
# ---------------------------------------------------------------------------

def _ref_cfg(arch, seq_parallel=False):
    import jax.numpy as jnp

    from repro.configs import get_config as ref_config

    return ref_config(arch, reduced=True).replace(
        compute_dtype=jnp.float32, kv_cache_dtype=jnp.float32, seq_parallel=seq_parallel,
        **HEADS[arch])


def reference_weights():
    """Each arch's weights in the reference's tree (its layers stacked on
    axis 0), numpy normals at ``WEIGHT_STD`` from a seeded generator, drawn
    leaf by leaf over the port's meta tree: no jax before the world
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


def reference_steps(weights):
    """The reference's bundles on its one device: for each arch the train
    step, the prefill and the decode steps, and with ``seq_parallel=True``
    the train step (and for ``SP_SERVE`` the serving steps)."""
    import jax
    import jax.numpy as jnp

    from repro.launch import steps as ref_steps
    from repro.models import init_cache
    from repro.optim import init_adamw

    mesh, out = _ref_mesh(), {}
    for arch in ARCHS:
        prompt, picks = inputs(arch)
        params = jax.tree.map(jnp.asarray, weights[arch])
        for sp in (False, True):
            cfg, tag = _ref_cfg(arch, sp), "_sp" if sp else ""
            bundle = ref_steps.build_train_step(cfg, mesh, ShapeCell("t", S, B, "train"))
            new_params, _, metrics = jax.jit(bundle.fn)(params, init_adamw(params),
                                                        {"tokens": jnp.asarray(prompt)})
            out[arch, "train" + tag] = jax.tree.map(np.asarray, (new_params, metrics))
            if sp and arch not in SP_SERVE:
                continue
            cell = ShapeCell("p", SLOTS, B, "prefill")
            prefill = jax.jit(ref_steps.build_prefill_step(cfg, mesh, cell).fn)
            decode = jax.jit(ref_steps.build_decode_step(
                cfg, mesh, dataclasses.replace(cell, kind="decode")).fn)
            logits, cache = prefill(params, {"tokens": jnp.asarray(prompt)},
                                    init_cache(cfg, B, SLOTS))
            got = {"prefill": jax.tree.map(np.asarray, (logits, cache)), "decode": []}
            for i in range(N_DECODE):
                logits, cache = decode(params, jnp.asarray(picks[i]), jnp.int32(S + i), cache)
                got["decode"].append(np.asarray(logits))
            got["cache"] = jax.tree.map(np.asarray, cache)
            out[arch, "serve" + tag] = got
    return out


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
            world = pool.submit(run_world, "test_torch_steps_hybrid:rank_steps", WORLD,
                                device="cpu", payload=payload, timeout=WORLD_TIMEOUT_S,
                                mesh_shape=MESHES["2x2"], mesh_dim_names=AXES)
            want = reference_steps(weights)
            got = world.result()[0]
        stdout, stderr = specs.communicate(timeout=240)
    finally:
        if specs.poll() is None:
            specs.kill()
    assert specs.returncode == 0, stderr[-4000:]
    return got, want, json.loads(stdout.strip().splitlines()[-1])


def assert_train_close(got, want, arch, what):
    from repro_torch.convert import lm_params_from_numpy

    new_params, metrics = got
    want_params, want_metrics = want
    assert sorted(metrics) == sorted(want_metrics) == sorted(steps.METRICS)
    for k in want_metrics:
        np.testing.assert_allclose(float(metrics[k]), float(want_metrics[k]), rtol=RTOL,
                                   err_msg=f"{what} metric {k}")
    want_params = lm_params_from_numpy(want_params, port_cfg(arch), device="cpu")
    assert tree_paths(new_params) == tree_paths(want_params)
    assert_leaves_close(new_params, want_params, f"{what} params")


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(results, arch, mesh):
    assert_train_close(results[0][mesh, arch, "train"], results[1][arch, "train"], arch,
                       f"{arch} {mesh}")


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_seq_parallel_train_step_matches_reference(results, arch, mesh):
    assert_train_close(results[0][mesh, arch, "train_sp"], results[1][arch, "train_sp"], arch,
                       f"{arch} {mesh} seq_parallel")


def assert_serving_close(got, want, what):
    assert_leaves_close(got["prefill"][0], want["prefill"][0], f"{what} prefill logits")
    assert_leaves_close(got["prefill"][1], want["prefill"][1], f"{what} prefill cache")
    for i, (g, w) in enumerate(zip(got["decode"], want["decode"], strict=True)):
        assert_leaves_close(g, w, f"{what} decode step {i}")
    assert_leaves_close(got["cache"], want["cache"], f"{what} cache after decode")


@pytest.mark.parametrize("arch,kernel", [(a, k) for a in ARCHS for k in SERVE_ROUTES[a]],
                         ids=lambda v: {False: "plain", True: "kernel"}.get(v, v))
@pytest.mark.parametrize("mesh", list(MESHES))
def test_serving_steps_match_reference(results, mesh, arch, kernel):
    assert_serving_close(results[0][mesh, arch, "serve", kernel], results[1][arch, "serve"],
                         f"{arch} {mesh} {'kernel' if kernel else 'plain'}")


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", SP_SERVE)
def test_seq_parallel_serving_steps_match_reference(results, arch, mesh):
    got = results[0][mesh, arch, "serve_sp"]
    assert_serving_close(got, results[1][arch, "serve_sp"], f"{arch} {mesh} seq_parallel")
    assert_serving_close(got, results[0][mesh, arch, "serve", False],
                         f"{arch} {mesh} seq_parallel vs not")


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
