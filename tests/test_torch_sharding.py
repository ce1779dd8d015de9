"""repro_torch's sharding rules, sharding context and abstract shapes ==
the JAX reference's, on the CPU, with no device and no process group.

The reference runs on ``jax.sharding.AbstractMesh``; the port plans on a
mapping of axis names to sizes (its rules read nothing else of a mesh).
For all ten archs at full width, on the production meshes 16x16 and
2x16x16 and the host-sized (4, 2) and (2, 4): ``param_specs`` (train,
serving, ``fsdp_only``) leaf for leaf — the reference stacks a model's
layers on axis 0 and prepends ``None`` to their specs, the port keeps one
leaf per layer, and each of its layers must carry the reference's spec
without that ``None`` —, ``batch_specs`` on ``input_specs`` and
``cache_specs`` (``prefer_seq`` both ways) on ``abstract_cache`` for every
``SHAPES`` cell; ``abstract_params``, ``input_specs`` and
``abstract_cache`` against the reference's ``jax.eval_shape`` trees
(shapes and dtypes, every leaf on the meta device).  Specs compare exactly:
the port's :class:`PartitionSpec` against ``tuple(P(...))``.  The names
``constrain`` pins are read from the reference by a stand-in for
``jax.lax.with_sharding_constraint`` that records the ``NamedSharding``'s
spec, and from the port by a spy on its ``resolve``.  The placements and
elastic restore across ranks: ``tests/test_torch_elastic.py``.
"""
import functools

import numpy as np
import pytest

# The port's tests need torch.  CI's jax-only tier-1 job installs no torch,
# so there these files skip instead of failing at import.
torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402
from jax.sharding import PartitionSpec as RefP  # noqa: E402

from repro.configs import SHAPES as REF_SHAPES  # noqa: E402
from repro.configs import get_config as ref_config  # noqa: E402
from repro.configs import list_archs as ref_archs  # noqa: E402
from repro.distributed import ctx as ref_ctx  # noqa: E402
from repro.distributed import sharding as ref_sharding  # noqa: E402
from repro.models import model_zoo as ref_zoo  # noqa: E402
from repro_torch.configs import SHAPES, get_config, list_archs  # noqa: E402
from repro_torch.distributed import ctx as port_ctx  # noqa: E402
from repro_torch.distributed import sharding as port_sharding  # noqa: E402
from repro_torch.distributed.sharding import PartitionSpec, to_placements  # noqa: E402
from repro_torch.models import model_zoo as port_zoo  # noqa: E402
from repro_torch.utils.tree import tree_leaves, tree_paths  # noqa: E402

ARCHS = ref_archs()
MESHES = {
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
    "4x2": ((4, 2), ("data", "model")),
    "2x4": ((2, 4), ("data", "model")),
}
MODES = {"train": {}, "serving": {"serving": True}, "fsdp_only": {"fsdp_only": True}}
STACKED_TOPS = ("blocks", "encoder", "decoder")


def ref_mesh(name):
    sizes, names = MESHES[name]
    return AbstractMesh(sizes, names)


def port_mesh(name):
    sizes, names = MESHES[name]
    return dict(zip(names, sizes))


def _key(k) -> str:
    return str(getattr(k, "key", getattr(k, "name", k)))


def ref_leaves(tree) -> dict:
    """The reference tree's leaves by path (``"blocks/attn/wq"``), specs
    as tuples."""
    leaves = jax.tree_util.tree_leaves_with_path(tree, is_leaf=lambda x: isinstance(x, RefP))
    return {"/".join(_key(k) for k in path): tuple(x) if isinstance(x, RefP) else x
            for path, x in leaves}


def ref_path(port_path: str) -> str:
    """A port leaf's path in the reference's tree: no layer index."""
    return "/".join(p for p in port_path.split("/") if not p.isdigit())


def dtype_name(dtype) -> str:
    return str(dtype).removeprefix("torch.")


@functools.cache
def trees(arch):
    """``(reference abstract params, port abstract params)`` at full width."""
    return ref_zoo.abstract_params(ref_config(arch)), port_zoo.abstract_params(get_config(arch))


@functools.cache
def cell_trees(arch, shape):
    """The reference's and the port's ``input_specs`` and ``abstract_cache``."""
    rc, pc = ref_config(arch), get_config(arch)
    ref_cell, cell = REF_SHAPES[shape], SHAPES[shape]
    return (ref_zoo.input_specs(rc, ref_cell), ref_zoo.abstract_cache(rc, ref_cell),
            port_zoo.input_specs(pc, cell), port_zoo.abstract_cache(pc, cell))


def test_archs_and_shapes_match_reference():
    assert list_archs() == ARCHS
    assert {k: (v.seq_len, v.global_batch, v.kind) for k, v in SHAPES.items()} == {
        k: (v.seq_len, v.global_batch, v.kind) for k, v in REF_SHAPES.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_params_match_reference(arch):
    ref, port = trees(arch)
    want = ref_leaves(ref)
    paths = tree_paths(port)
    assert {ref_path(p) for p in paths} == set(want)
    for path, leaf in zip(paths, tree_leaves(port)):
        assert leaf.is_meta, path                         # nothing allocated
        r = want[ref_path(path)]
        stacked = path.split("/")[0] in STACKED_TOPS
        assert tuple(leaf.shape) == (r.shape[1:] if stacked else r.shape), path
        assert dtype_name(leaf.dtype) == str(r.dtype), path
    assert port_zoo.param_count(get_config(arch)) == sum(x.numel() for x in tree_leaves(port))


@pytest.mark.parametrize("shape", list(REF_SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_and_abstract_cache_match_reference(arch, shape):
    ref_in, ref_cache, port_in, port_cache = cell_trees(arch, shape)
    for ref, port in ((ref_in, port_in), (ref_cache, port_cache)):
        want = ref_leaves(ref)
        assert tree_paths(port) == list(want)
        for path, leaf in zip(tree_paths(port), tree_leaves(port)):
            assert leaf.is_meta, path
            assert tuple(leaf.shape) == want[path].shape, path
            assert dtype_name(leaf.dtype) == str(want[path].dtype), path
    assert port_zoo.encdec_src_len(get_config(arch), SHAPES[shape]) == ref_zoo.encdec_src_len(
        ref_config(arch), REF_SHAPES[shape])


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_reference(arch, mesh, mode):
    ref, port = trees(arch)
    want = ref_leaves(ref_sharding.param_specs(ref, ref_mesh(mesh), **MODES[mode]))
    got = port_sharding.param_specs(port, port_mesh(mesh), **MODES[mode])
    sizes = port_mesh(mesh)
    for path, leaf, spec in zip(tree_paths(port), tree_leaves(port), tree_leaves(got)):
        assert isinstance(spec, PartitionSpec), path
        expect = want[ref_path(path)]
        if path.split("/")[0] in STACKED_TOPS:
            assert expect[0] is None, path
            expect = expect[1:]
        assert tuple(spec) == expect, (path, spec, expect)
        for dim, part in zip(leaf.shape, spec):          # every sharded dim divides
            axes = part if isinstance(part, tuple) else (part,) if part else ()
            assert dim % int(np.prod([sizes[a] for a in axes])) == 0, (path, spec)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("shape", list(REF_SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_and_cache_specs_match_reference(arch, shape, mesh):
    ref_in, ref_cache, port_in, port_cache = cell_trees(arch, shape)
    for fsdp_only in (False, True):
        want = ref_leaves(ref_sharding.batch_specs(ref_in, ref_mesh(mesh), fsdp_only=fsdp_only))
        got = port_sharding.batch_specs(port_in, port_mesh(mesh), fsdp_only=fsdp_only)
        assert [tuple(s) for s in tree_leaves(got)] == list(want.values())
    for prefer_seq in (False, True):
        want = ref_leaves(ref_sharding.cache_specs(ref_cache, ref_mesh(mesh),
                                                   prefer_seq=prefer_seq))
        got = port_sharding.cache_specs(port_cache, port_mesh(mesh), prefer_seq=prefer_seq)
        assert tree_paths(port_cache) == list(want)
        assert [tuple(s) for s in tree_leaves(got)] == list(want.values())


def test_fallback_breaks_ties_as_numpy_argsort():
    """Square and equal dims: the fallback's order is numpy's argsort's."""
    mesh = {"data": 4, "model": 2}
    for shape in ((8, 8), (8, 8, 8), (16, 8, 16), (4, 4, 2)):
        got = port_sharding._param_candidates(("x", "odd"), shape)
        want = ref_sharding._param_candidates(("x", "odd"), shape)
        assert [tuple(s) for s in got] == [tuple(s) for s in want]
        assert tuple(port_sharding.best_spec(got, shape, mesh)) == tuple(
            ref_sharding.best_spec(want, shape, AbstractMesh((4, 2), ("data", "model"))))


def test_partition_spec_stores_entries_as_jax_does():
    for parts in ((), (None,), ("data", None), (("data",), None), (("pod", "data"), "model"),
                  ((), "model"), (None, ("data", "model"), None)):
        assert tuple(PartitionSpec(*parts)) == tuple(RefP(*parts))
        assert PartitionSpec(*parts) == tuple(RefP(*parts))
    assert PartitionSpec("data") == PartitionSpec(("data",))
    assert hash(PartitionSpec("data", None)) == hash(PartitionSpec(("data",), None))


def test_to_placements():
    from torch.distributed.tensor import Replicate, Shard

    mesh = port_mesh("2x16x16")
    assert to_placements(PartitionSpec(), mesh) == (Replicate(),) * 3
    assert to_placements(PartitionSpec("model", "data"), mesh) == (Replicate(), Shard(1), Shard(0))
    assert to_placements(PartitionSpec(("pod", "data"), None, "model"), mesh) == (
        Shard(0), Shard(0), Shard(2))
    assert to_placements(PartitionSpec(None, ("pod", "data", "model")), mesh) == (Shard(1),) * 3
    with pytest.raises(ValueError, match="mesh's order"):
        to_placements(PartitionSpec(("data", "pod")), mesh)
    with pytest.raises(ValueError, match="named twice"):
        to_placements(PartitionSpec("data", "data"), mesh)
    with pytest.raises(ValueError, match="no mesh axis"):
        to_placements(PartitionSpec("expert"), mesh)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_dp_axes_and_global_batch(mesh):
    from repro.distributed import elastic as ref_elastic
    from repro_torch.distributed import elastic as port_elastic

    assert port_sharding.dp_axes(port_mesh(mesh)) == ref_sharding.dp_axes(ref_mesh(mesh))
    assert port_elastic.global_batch_for(port_mesh(mesh), 3) == ref_elastic.global_batch_for(
        ref_mesh(mesh), 3)


# the shapes the constrain points see: (B, S, D) tokens, (B, S, H, hd) q with
# (B, S, KVH, hd) k/v, (B, S_cache, KVH, hd) decode caches; divisible and not
TOKENS = ((256, 4096, 2048), (3, 7, 64), (32, 1, 4096), (2, 16, 8))
ATTENTION = (((4, 4096, 32, 128), (4, 4096, 8, 128)), ((2, 4096, 25, 64), (2, 4096, 5, 64)),
             ((8, 448, 8, 256), (8, 448, 1, 256)), ((16, 1, 40, 128), (16, 1, 8, 128)),
             ((1, 7, 16, 64), (1, 7, 16, 64)), ((3, 32, 48, 64), (3, 32, 16, 64)))
DECODE = (((128, 1, 32, 128), (128, 32768, 8, 128)), ((1, 1, 25, 64), (1, 100, 5, 64)),
          ((6, 1, 16, 64), (6, 4096, 16, 64)))
SPECS = ((("dp", "model", None), (64, 32, 8)), (("dp", None), (3, 512)),
         (("dp", "model", "model"), (256, 64, 64)), (("dp", None, "data"), (32, 2, 64)),
         ((None, "dp", "model", None), (4, 3, 16, 2)))


def _drive(module, x):
    """Every constrain point of ``module`` on inputs made by ``x(shape)``."""
    for s in TOKENS:
        module.constrain_tokens_3d(x(s))
    for qs, ks in ATTENTION:
        module.constrain_attention(x(qs), x(ks), x(ks))
    for qs, ks in DECODE:
        module.constrain_attention_decode(x(qs), x(ks), x(ks))
    for spec, s in SPECS:
        module.constrain(x(s), *spec)


@pytest.mark.parametrize("fsdp_only", [False, True])
@pytest.mark.parametrize("seq_parallel", [False, True])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_constrain_resolves_names_as_reference(mesh, seq_parallel, fsdp_only, monkeypatch):
    want, got = [], []

    def pinned(x, sharding):
        want.append(tuple(sharding.spec))
        return x

    monkeypatch.setattr(jax.lax, "with_sharding_constraint", pinned)
    with ref_ctx.shard_ctx(ref_mesh(mesh), seq_parallel=seq_parallel, fsdp_only=fsdp_only):
        _drive(ref_ctx, lambda s: jax.ShapeDtypeStruct(s, np.float32))

    resolve = port_ctx.resolve

    def spy(*args):
        got.append(tuple(resolve(*args)))
        return got[-1]

    monkeypatch.setattr(port_ctx, "resolve", spy)
    t = torch.zeros(4, 2)
    with port_ctx.shard_ctx(port_mesh(mesh), seq_parallel=seq_parallel, fsdp_only=fsdp_only):
        _drive(port_ctx, lambda s: torch.empty(s, device="meta"))
        assert want and got == want
        assert port_ctx.constrain(t, "dp", None) is t          # a plain tensor: unchanged
    assert port_ctx.constrain(t, "dp", None) is t              # no context: unchanged
    q = torch.zeros(4, 16, 16, 2)
    assert all(y is q for y in port_ctx.constrain_attention(q, q, q))
