"""PartitionSpec rules for parameters, optimizer state, activations, caches,
as ``torch.distributed`` DTensor placements.

Strategy (the reference's): 2-D FSDP x TP inside a pod —

  * parameters/optimizer state: one dim sharded over 'data' (FSDP / ZeRO-3),
    one over 'model' (TP);   the 'pod' axis is pure DP (grad all-reduce).
  * activations: batch over ('pod','data'), model-parallel dims over 'model'.
  * KV caches: batch over dp, heads (or head_dim) over 'model'.

Rules are *candidate lists* per parameter name; each candidate is filtered by
divisibility against the actual mesh and the highest-coverage survivor wins.
This keeps every (arch x mesh) cell placeable without per-arch tables — e.g.
hymba's vocab 32001 is indivisible, so the embedding falls back to sharding
d_model only.

The port of ``repro.distributed.sharding``, with the same specs leaf for
leaf.  The rules read only a mesh's axis names and sizes: a ``DeviceMesh``
or a plain mapping of names to sizes, so the 256- and 512-rank production
meshes are planned with no process group.  A spec is a
:class:`PartitionSpec`; :func:`to_placements` turns it into DTensor
placements.  The port's layer stacks are lists of per-layer dicts (the
reference stacks the layers on axis 0 and prepends ``None`` to their
specs), so a leaf of ``blocks[i]``, ``encoder[i]`` or ``decoder[i]`` takes
the reference's per-layer spec; the decode cache is stacked in both
packages and keeps its leading layer axis.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np

from ..utils.tree import tree_map, tree_map_with_path

FSDP_AXIS = "data"
TP_AXIS = "model"


def _canonical(part):
    """One entry of a spec: ``None``, an axis name, or a tuple of two or more
    names (a tuple of one is its name, an empty one ``None``, as jax's
    ``PartitionSpec`` stores them)."""
    if isinstance(part, (tuple, list)):
        part = tuple(part)
        if not part:
            return None
        if len(part) == 1:
            return part[0]
    return part


class PartitionSpec:
    """Per tensor dim: ``None`` (replicated), a mesh axis name, or a tuple of
    names (the dim split over those axes, major first).  Trailing dims not
    named are replicated.  Iterates, indexes and compares like the tuple of
    its entries; a leaf, not a container, for :mod:`repro_torch.utils.tree`."""

    __slots__ = ("_parts",)

    def __init__(self, *parts):
        self._parts = tuple(_canonical(p) for p in parts)

    def __iter__(self):
        return iter(self._parts)

    def __len__(self):
        return len(self._parts)

    def __getitem__(self, i):
        return self._parts[i]

    def __eq__(self, other):
        if isinstance(other, PartitionSpec):
            return self._parts == other._parts
        if isinstance(other, tuple):
            return self._parts == other
        return NotImplemented

    def __hash__(self):
        return hash(self._parts)

    def __repr__(self):
        return f"PartitionSpec{self._parts!r}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class Sharding:
    """Where a tensor lives: a ``DeviceMesh`` and one DTensor placement per
    mesh dim (the counterpart of jax's ``NamedSharding``), and where it was
    made from one, its :class:`PartitionSpec` (``spec``, as jax's
    ``NamedSharding.spec``; not compared).  Unpacks as ``mesh,
    placements``."""

    mesh: Any
    placements: tuple
    spec: Any = dataclasses.field(default=None, compare=False)

    def __iter__(self):
        return iter((self.mesh, self.placements))


def mesh_shape(mesh) -> dict[str, int]:
    """``mesh``'s axis sizes by name, in the mesh's order: a ``DeviceMesh``
    with named dims, or a mapping of names to sizes."""
    if hasattr(mesh, "mesh_dim_names"):
        if mesh.mesh_dim_names is None:
            raise ValueError("the sharding rules need a DeviceMesh with named dims "
                             "(init_device_mesh(..., mesh_dim_names=...))")
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return dict(mesh)


def dp_axes(mesh):
    """Axes used for data parallelism (batch dim)."""
    return ("pod", "data") if "pod" in mesh_shape(mesh) else ("data",)


def _axis_size(sizes: dict, name) -> int:
    if name is None:
        return 1
    if isinstance(name, tuple):
        return math.prod(_axis_size(sizes, n) for n in name)
    return sizes[name]


def fit_spec(spec: PartitionSpec, shape: tuple[int, ...], mesh) -> tuple[PartitionSpec, int]:
    """Drop axis names whose size doesn't divide the dim; return (spec, score)."""
    sizes = mesh_shape(mesh)
    out = []
    score = 1
    for d, name in enumerate(tuple(spec) + (None,) * (len(shape) - len(spec))):
        if name is None:
            out.append(None)
            continue
        size = _axis_size(sizes, name)
        if shape[d] % size == 0:
            out.append(name)
            score *= size
        else:
            out.append(None)
    return P(*out), score


def best_spec(candidates: list[PartitionSpec], shape: tuple[int, ...], mesh) -> PartitionSpec:
    best, best_score = P(), 0
    for cand in candidates:
        spec, score = fit_spec(cand, shape, mesh)
        if score > best_score:
            best, best_score = spec, score
    return best


def to_placements(spec: PartitionSpec, mesh) -> tuple:
    """``spec`` as DTensor placements on ``mesh``, one per mesh dim:
    ``Shard(d)`` on the dim of each axis that names tensor dim ``d``,
    ``Replicate()`` elsewhere.  A tuple of axes on one tensor dim becomes
    ``Shard(d)`` on each of their mesh dims, which DTensor splits in the
    mesh's order; so the tuple must name them in that order (``ValueError``
    otherwise, and for an axis the mesh lacks or one named twice)."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh_shape(mesh))
    out: list = [Replicate()] * len(names)
    for d, part in enumerate(spec):
        if part is None:
            continue
        axes = part if isinstance(part, tuple) else (part,)
        missing = [a for a in axes if a not in names]
        if missing:
            raise ValueError(f"{spec}: no mesh axis {missing} in {names}")
        dims = [names.index(a) for a in axes]
        if dims != sorted(dims):
            raise ValueError(f"{spec}: axes {axes} on one dim must follow the mesh's order "
                             f"{names}; DTensor cannot split a dim in another order")
        for i in dims:
            if not out[i].is_replicate():
                raise ValueError(f"{spec}: mesh axis {names[i]!r} named twice")
            out[i] = Shard(d)
    return tuple(out)


# ---------------------------------------------------------------------------
# Parameter rules (leaf-name keyed; the port's layers are per-layer leaves)
# ---------------------------------------------------------------------------

def _param_candidates(path: tuple[str, ...], shape: tuple[int, ...]) -> list[PartitionSpec]:
    name = path[-1]
    parent = path[-2] if len(path) > 1 else ""
    f, t = FSDP_AXIS, TP_AXIS
    rank = len(shape)

    if name in ("embed", "unembed"):                       # (V, D)
        return [P(t, f), P(f, t), P(None, t), P(None, f)]
    if name in ("final_ln", "enc_ln", "ln1", "ln2", "lnx"):
        return [P()]
    if name == "frontend_proj":
        return [P(f, t), P(None, t)]
    if parent in ("attn", "xattn"):
        # Megatron-style: shard heads over 'model'; when the head count is
        # indivisible (hymba 25H/5KV, paligemma 1KV) fall back to replicated
        # heads — attention then runs model-replicated.
        if name == "wq":                                   # (D, H, hd)
            return [P(f, t, None), P(f, None, None)]
        if name in ("wk", "wv"):                           # (D, KVH, hd)
            return [P(f, t, None), P(f, None, None)]
        if name == "wo":                                   # (H, hd, D)
            return [P(t, None, f), P(None, None, f)]
    if parent == "mlp":
        if name in ("wi", "wg"):                           # (D, F)
            return [P(f, t), P(None, t)]
        if name == "wo":                                   # (F, D)
            return [P(t, f), P(t, None)]
    if parent == "moe":
        if name == "router":                               # (D, E)
            return [P(f, None), P()]
        if name in ("wi", "wg"):                           # (E, D, F)
            return [P(t, f, None), P(t, None, None), P(None, f, t)]
        if name == "wo":                                   # (E, F, D)
            return [P(t, None, f), P(t, None, None), P(None, t, f)]
    if parent == "ssm":
        if name == "in_proj":                              # (D, 2di)
            return [P(f, t), P(None, t)]
        if name == "conv":                                 # (W, di)
            return [P(None, t)]
        if name in ("wbc", "wdt"):                         # (di, .)
            return [P(t, None)]
        if name == "out_proj":                             # (di, D)
            return [P(t, f), P(t, None)]
        return [P()]                                       # a_log, d_skip, dt_bias
    if parent == "mlstm":
        if name == "in_proj":
            return [P(f, t), P(None, t)]
        if name in ("wq", "wk"):                           # (di, nh, hd)
            return [P(t, None, None), P(None, None, t)]
        if name == "wif":                                  # (di, 2nh)
            return [P(t, None)]
        if name == "out_proj":
            return [P(t, f), P(t, None)]
        return [P()]
    if parent == "slstm":
        if name == "w_in":                                 # (D, nh, 4hd)
            return [P(f, None, t), P(None, None, t)]
        if name == "r_in":                                 # (nh, hd, 4hd)
            return [P(None, None, t), P(None, t, None)]
        if name == "bias":                                 # (nh, 4hd)
            return [P(None, t)]
        if name == "out_proj":
            return [P(t, f), P(t, None)]
        return [P()]
    # fallback: shard the largest dim over model, next over data (numpy's
    # argsort, so that ties between equal dims break as the reference's do)
    order = np.argsort(shape)[::-1]
    cand = [None] * rank
    cand[order[0]] = t
    if rank > 1:
        cand[order[1]] = f
    return [P(*cand), P()]


def _fsdp_only_spec(shape: tuple[int, ...], mesh) -> PartitionSpec:
    """Shard one dim over ALL mesh axes (ZeRO-3 across the whole slice)."""
    sizes = mesh_shape(mesh)
    axes = tuple(sizes)
    total = math.prod(sizes.values())
    if len(shape) < 2:
        return P()
    for d in range(len(shape)):
        if shape[d] % total == 0:
            out = [None] * len(shape)
            out[d] = axes
            return P(*out)
    for d in range(len(shape)):          # fall back to the data axis only
        if shape[d] % sizes[FSDP_AXIS] == 0:
            out = [None] * len(shape)
            out[d] = FSDP_AXIS
            return P(*out)
    return P()


def _names(path) -> tuple[str, ...]:
    """A leaf's path without its list indices (a layer's place in its stack)."""
    return tuple(k for k in path if isinstance(k, str))


def param_specs(params_shape: Any, mesh, serving: bool = False,
                fsdp_only: bool = False) -> Any:
    """PartitionSpec tree matching a parameter tree (of tensors, meta
    tensors or anything with a ``.shape``).

    ``serving``: inference replicas keep weights TP-sharded but replicated
    over the data axis (no ZeRO/FSDP — a per-token weight all-gather would
    dominate decode latency).  Training keeps FSDP over 'data'.
    """

    def walk(path, leaf):
        shape = tuple(leaf.shape)
        if fsdp_only:
            return _fsdp_only_spec(shape, mesh)
        cands = _param_candidates(_names(path), shape)
        if serving:
            cands = [P(*(None if n == FSDP_AXIS else n for n in c)) for c in cands]
        return best_spec(cands, shape, mesh)

    return tree_map_with_path(walk, params_shape)


def param_shardings(params_shape: Any, mesh) -> Any:
    """The training specs of :func:`param_specs` as a tree of
    :class:`Sharding` on ``mesh`` (a ``DeviceMesh``)."""
    return to_shardings(param_specs(params_shape, mesh), mesh)


# ---------------------------------------------------------------------------
# Activations / batches / caches
# ---------------------------------------------------------------------------

def batch_specs(batch_shape: Any, mesh, fsdp_only: bool = False) -> Any:
    """Shard the leading batch dim over dp axes (dropped if indivisible)."""
    dp = tuple(mesh_shape(mesh)) if fsdp_only else dp_axes(mesh)

    def leaf(x):
        if not x.shape:
            return P()
        return best_spec([P(dp), P(dp[-1:],)], tuple(x.shape), mesh)

    return tree_map(leaf, batch_shape)


def cache_specs(cache_shape: Any, mesh, prefer_seq: bool = False) -> Any:
    """KV caches: (L, B, S, KVH, hd) -> batch over dp, sequence (else
    heads) over model.

    ``prefer_seq`` (sp_decode) asks for the cache's *sequence* dim over
    'model'; it is already the first candidate, so the flag changes nothing,
    as in the reference.

    SSM states (L, B, nh, dk, dv) and conv states (L, B, W, di) follow the
    same batch-first rule with 'model' on the widest trailing dim.  Leaves
    are keyed on their NamedTuple field names (``k``, ``v``, ``pos``, ``h``,
    ``conv``) and the encoder-decoder's ``xk`` and ``xv``.
    """
    dp = dp_axes(mesh)
    t = TP_AXIS

    def walk(path, leaf):
        shape = tuple(leaf.shape)
        name = path[-1] if path else ""
        if name == "pos" or len(shape) < 3:
            return P()
        # leading L (stacked layers), then batch
        if name in ("k", "v", "xk", "xv"):                 # (L, B, S, KVH, hd)
            # Sequence-sharding over 'model' is the default decode layout:
            # none of the assigned archs has kv_heads divisible by TP=16, and
            # a head_dim-sharded cache forces a full re-shard every step.
            cands = [
                P(None, dp, t, None, None),
                P(None, dp, None, t, None),
                P(None, dp, None, None, None),
            ]
            return best_spec(cands, shape, mesh)
        if name == "h":                                    # (L, B, nh, dk, dv)
            return best_spec(
                [P(None, dp, t, None, None), P(None, dp, None, None, t),
                 P(None, dp, None, None, None)],
                shape, mesh,
            )
        if name == "conv":                                 # (L, B, W, di)
            return best_spec(
                [P(None, dp, None, t), P(None, dp, None, None)], shape, mesh
            )
        # slstm states (L, B, nh, hd) etc.
        cands = [P(None, dp, None, t), P(None, dp, None, None)]
        if len(shape) == 3:
            cands = [P(None, dp, t), P(None, dp, None)]
        return best_spec(cands, shape, mesh)

    return tree_map_with_path(walk, cache_shape)


def to_shardings(spec_tree: Any, mesh) -> Any:
    """A tree of :class:`PartitionSpec` as a tree of :class:`Sharding`."""
    return tree_map(lambda s: Sharding(mesh, to_placements(s, mesh), s), spec_tree)
