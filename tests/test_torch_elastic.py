"""Placements, the sharding context and elastic restore of repro_torch
across ranks, on the CPU.

One world of four gloo ranks runs in subprocesses for the module
(``repro_torch.distributed.world.run_world`` on a ``(2, 2)`` ``("data",
"model")`` mesh; the pytest process never initialises a process group).
Its target, :func:`rank_checks`, takes the reduced llama3.2-1b with the
reference's weights (carried across by ``lm_params_from_numpy``) and
returns each rank's local blocks; the tests hold them to the blocks that
jax's ``NamedSharding`` gives a device at that mesh coordinate, computed
here from the spec alone (a dim named by axes ``(a, b)`` splits into
``|a| * |b|`` equal blocks, ``a`` major): ``to_placements`` of the train,
serving and ``fsdp_only`` specs through ``distribute_tensor(...,
src_data_rank=None)``; the tree placed on ``(2, 2)``, saved (each leaf
gathered, rank 0 writing) and restored by ``reshard_restore`` onto ``(4,
1)`` and ``(1, 4)``, bit for bit — the reference's ``(4, 2)`` to ``(2, 4)``
test (``tests/test_fault_tolerance.py``) in a world of four; the restore's
block split against DTensor's own on uneven dims; ``constrain``
redistributing a ``DTensor`` and leaving a plain tensor alone.
``make_production_mesh`` runs in one subprocess on the ``"fake"`` backend
at 256 and 512 ranks.
"""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

# The port's tests need torch.  CI's jax-only tier-1 job installs no torch,
# so there these files skip instead of failing at import.
torch = pytest.importorskip("torch")

from repro_torch.checkpoint import restore  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.distributed.world import run_world  # noqa: E402
from repro_torch.utils.tree import tree_leaves, tree_paths  # noqa: E402

# The ranks import this module (its target), so the reference — and jax —
# are imported where the tests need them, never at the top.

REPO_ROOT = pathlib.Path(__file__).resolve().parents[1]
WORLD, MESH, AXES = 4, (2, 2), ("data", "model")
RESTORE_MESHES = ((4, 1), (1, 4))
MODES = {"train": {}, "serving": {"serving": True}, "fsdp_only": {"fsdp_only": True}}
STEP = 5
WORLD_TIMEOUT_S = 120
# (shape, placements as (kind, dim) per mesh dim) on (2, 2), dims that do not divide
UNEVEN = (((5, 3), (("S", 0), ("S", 1))), ((3, 7), (("S", 1), ("S", 1))),
          ((1, 9), (("S", 0), ("R", 0))), ((7,), (("R", 0), ("S", 0))))


def _placements(pairs):
    from torch.distributed.tensor import Replicate, Shard

    return tuple(Shard(d) if kind == "S" else Replicate() for kind, d in pairs)


def rank_checks(mesh, payload):
    """One rank's part of every check (the world's target): this rank's
    coordinates and local blocks."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, distribute_tensor

    from repro_torch.checkpoint import checkpointer, save
    from repro_torch.distributed import ctx
    from repro_torch.distributed.elastic import reshard_restore
    from repro_torch.distributed.sharding import param_shardings, param_specs, to_placements
    from repro_torch.utils.tree import tree_map

    params = payload["params"]
    out = {"rank": dist.get_rank(), "coord": tuple(mesh.get_coordinate()), "placed": {},
           "restored": {}, "uneven": [], "tuples_equal": True}

    def local(tree):
        return [(str(x.placements), x.to_local().clone()) for x in tree_leaves(tree)]

    # to_placements through distribute_tensor, for every spec mode
    for mode, kw in MODES.items():
        specs = param_specs(params, mesh, **kw)
        out["placed"][mode] = [
            distribute_tensor(x, mesh, to_placements(s, mesh), src_data_rank=None).to_local()
            for x, s in zip(tree_leaves(params), tree_leaves(specs))]

    # place on (2, 2), save (gathers; rank 0 writes), restore onto other meshes
    sharded = tree_map(lambda x, s: distribute_tensor(x, s.mesh, s.placements, src_data_rank=None),
                       params, param_shardings(params, mesh))
    save(payload["dir"], STEP, sharded)
    for shape in RESTORE_MESHES:
        other = init_device_mesh("cpu", shape, mesh_dim_names=AXES)
        got = reshard_restore(payload["dir"], STEP, params, other)
        assert all(isinstance(x, DTensor) for x in tree_leaves(got))
        out["restored"][shape] = {"coord": tuple(other.get_coordinate()), "leaves": local(got)}
        # the same restore from a tree of plain (mesh, placements) pairs
        pairs = tree_map(lambda s: (s.mesh, s.placements), param_shardings(params, other))
        again = restore(payload["dir"], STEP, params, shardings=pairs)
        out["tuples_equal"] &= all(torch.equal(a.to_local(), b.to_local())
                                   for a, b in zip(tree_leaves(got), tree_leaves(again)))

    # the restore's block split against DTensor's own, on uneven dims
    for shape, pairs in UNEVEN:
        x = torch.arange(int(np.prod(shape)), dtype=torch.float32).reshape(shape)
        placements = _placements(pairs)
        want = distribute_tensor(x, mesh, placements, src_data_rank=None).to_local()
        out["uneven"].append(torch.equal(x[checkpointer._block(shape, mesh, placements)], want))

    # constrain: a DTensor is redistributed, a plain tensor left alone
    x = torch.arange(8 * 4 * 6, dtype=torch.float32).reshape(8, 4, 6)
    replicated = distribute_tensor(x, mesh, _placements((("R", 0), ("R", 0))), src_data_rank=None)
    with ctx.shard_ctx(mesh):
        pinned = ctx.constrain(replicated, "dp", "model", None)
        out["plain_untouched"] = ctx.constrain(x, "dp", "model", None) is x
    out["constrained"] = (str(pinned.placements), pinned.to_local().clone())
    return out


def ref_block(x: np.ndarray, spec, sizes: dict, coord: dict) -> np.ndarray:
    """The block of ``x`` a jax device at mesh coordinate ``coord`` holds
    under ``spec``: each dim split into equal blocks over its axes, the
    first axis major."""
    index = []
    for d, n in enumerate(x.shape):
        part = spec[d] if d < len(spec) else None
        axes = () if part is None else part if isinstance(part, tuple) else (part,)
        count, block = 1, 0
        for a in axes:
            count *= sizes[a]
            block = block * sizes[a] + coord[a]
        size = n // count
        index.append(slice(block * size, (block + 1) * size))
    return x[tuple(index)]


@pytest.fixture(scope="module")
def reduced_params():
    """The reduced llama3.2-1b with the reference's weights, as the port's tree."""
    import jax

    from repro.configs import get_config as ref_config
    from repro.models import init_params as ref_init
    from repro_torch.convert import lm_params_from_numpy

    cfg = get_config("llama3.2-1b", reduced=True)
    ref = jax.tree.map(np.asarray, ref_init(ref_config("llama3.2-1b", reduced=True),
                                            jax.random.key(0)))
    return lm_params_from_numpy(ref, cfg, device="cpu")


@pytest.fixture(scope="module")
def ranks(reduced_params, tmp_path_factory):
    workdir = tmp_path_factory.mktemp("elastic_world")
    ckpt = tmp_path_factory.mktemp("elastic_ckpt")
    out = run_world("test_torch_elastic:rank_checks", WORLD, device="cpu",
                    payload={"params": reduced_params, "dir": str(ckpt)},
                    timeout=WORLD_TIMEOUT_S, workdir=workdir, mesh_shape=MESH,
                    mesh_dim_names=AXES)
    return out, ckpt


def _arrays(params):
    return [x.numpy() for x in tree_leaves(params)]


@pytest.mark.parametrize("mode", list(MODES))
def test_to_placements_agree_with_jax_blocks(ranks, reduced_params, mode):
    from repro_torch.distributed.sharding import param_specs

    sizes = dict(zip(AXES, MESH))
    specs = tree_leaves(param_specs(reduced_params, sizes, **MODES[mode]))
    assert any(isinstance(p, tuple) for s in specs for p in s) == (mode == "fsdp_only")
    for out in ranks[0]:
        coord = dict(zip(AXES, out["coord"]))
        for path, x, spec, got in zip(tree_paths(reduced_params), _arrays(reduced_params), specs,
                                      out["placed"][mode]):
            np.testing.assert_array_equal(got.numpy(), ref_block(x, spec, sizes, coord),
                                          err_msg=f"rank {out['rank']} {path} {spec}")


def test_sharded_save_writes_the_whole_tree(ranks, reduced_params):
    got = restore(ranks[1], STEP, reduced_params)
    for path, a, b in zip(tree_paths(reduced_params), tree_leaves(reduced_params),
                          tree_leaves(got)):
        assert a.dtype == b.dtype and torch.equal(a, b), path


@pytest.mark.parametrize("shape", RESTORE_MESHES, ids=lambda s: "x".join(map(str, s)))
def test_reshard_restore_round_trips_bit_for_bit(ranks, reduced_params, shape):
    from repro_torch.distributed.sharding import param_specs, to_placements

    sizes = dict(zip(AXES, shape))
    specs = tree_leaves(param_specs(reduced_params, sizes))
    held = {}
    for out in ranks[0]:
        restored = out["restored"][shape]
        coord = dict(zip(AXES, restored["coord"]))
        for path, x, spec, (placements, got) in zip(
                tree_paths(reduced_params), _arrays(reduced_params), specs, restored["leaves"]):
            assert placements == str(to_placements(spec, sizes)), path
            want = ref_block(x, spec, sizes, coord)
            assert got.numpy().view(np.uint32).tobytes() == want.view(np.uint32).tobytes(), (
                f"rank {out['rank']} {path}")
            held[path] = held.get(path, 0) + got.numel()
        assert out["tuples_equal"]
    # every element is held by the ranks at least once, and a sharded leaf once
    for path, x, spec in zip(tree_paths(reduced_params), _arrays(reduced_params), specs):
        copies = WORLD // int(np.prod([sizes[a] for p in spec if p
                                       for a in (p if isinstance(p, tuple) else (p,))]))
        assert held[path] == x.size * copies, path


def test_restore_splits_uneven_dims_as_dtensor(ranks):
    for out in ranks[0]:
        assert out["uneven"] == [True] * len(UNEVEN), out["rank"]


def test_constrain_redistributes_a_dtensor(ranks):
    x = np.arange(8 * 4 * 6, dtype=np.float32).reshape(8, 4, 6)
    sizes = dict(zip(AXES, MESH))
    for out in ranks[0]:
        placements, got = out["constrained"]
        assert placements == "(Shard(dim=0), Shard(dim=1))"
        want = ref_block(x, ("data", "model", None), sizes, dict(zip(AXES, out["coord"])))
        np.testing.assert_array_equal(got.numpy(), want)
        assert out["plain_untouched"]


def test_run_world_refuses_a_mesh_that_does_not_hold_the_world():
    for shape, names in (((2, 3), AXES), ((2, 2), ("data",)), ((8,), ("data",))):
        with pytest.raises(ValueError, match="for a world of 4"):
            run_world("test_torch_elastic:rank_checks", WORLD, device="cpu", mesh_shape=shape,
                      mesh_dim_names=names)


PRODUCTION = """
import torch, torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.distributed.sharding import param_shardings, param_specs
from repro_torch.configs import get_config
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.model_zoo import abstract_params

params = abstract_params(get_config("llama3.2-1b"))
for world, multi_pod in ((256, False), (512, True)):
    dist.init_process_group("fake", store=FakeStore(), rank=3, world_size=world)
    mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    assert mesh.mesh_dim_names == names and mesh.size() == world, mesh
    assert tuple(mesh.shape) == ((2, 16, 16) if multi_pod else (16, 16)), mesh
    wq = param_shardings(params, mesh)["blocks"][0]["attn"]["wq"]
    assert tuple(param_specs(params, mesh)["blocks"][0]["attn"]["wq"]) == ("data", "model", None)
    assert [repr(p) for p in wq.placements][-2:] == ["Shard(dim=0)", "Shard(dim=1)"], wq
    try:
        make_production_mesh(multi_pod=not multi_pod, device="cpu")
    except ValueError as e:
        assert str(512 if world == 256 else 256) in str(e), e
    else:
        raise AssertionError("a mesh of the wrong size was built")
    dist.destroy_process_group()
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
for multi_pod in (False, True):
    try:
        make_production_mesh(multi_pod=multi_pod, device="cpu")
    except ValueError as e:
        assert "has 8" in str(e), e
    else:
        raise AssertionError("a production mesh over 8 ranks")
dist.destroy_process_group()
print("PRODUCTION_OK")
"""


def test_make_production_mesh_on_the_fake_backend():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO_ROOT / "src") + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", PRODUCTION], capture_output=True, text=True,
                          env=env, cwd=REPO_ROOT, timeout=120)
    assert "PRODUCTION_OK" in proc.stdout, proc.stdout + proc.stderr
