"""Sharding context: activation layouts for model code.

Model code is mesh-agnostic; a step builder installs a context (mesh + dp
axes) around the step, and ``constrain`` points in the model then pin
activation layouts, so that a head count indivisible by the TP axis does not
collapse the layout to replication.

The port of ``repro.distributed.ctx``.  ``constrain`` resolves the names
as the reference does; on a ``DTensor`` it then redistributes the tensor
to those placements on the context's mesh (a ``DeviceMesh``, the tensor's
own).  With no context installed, or on a plain tensor, it returns ``x``
unchanged: the reference's single-host no-op.  The mesh may also be a
mapping of axis names to sizes, for planning.
"""
from __future__ import annotations

import contextlib
import contextvars
import math
import sys
from typing import Iterator

from .sharding import PartitionSpec, mesh_shape, to_placements

_CTX: contextvars.ContextVar = contextvars.ContextVar("repro_torch_shard_ctx", default=None)


@contextlib.contextmanager
def shard_ctx(mesh, seq_parallel: bool = False, fsdp_only: bool = False) -> Iterator[None]:
    names = tuple(mesh_shape(mesh))
    if fsdp_only:
        dp = names
    elif "pod" in names:
        dp = ("pod", "data")
    else:
        dp = ("data",)
    token = _CTX.set((mesh, dp, seq_parallel, fsdp_only))
    try:
        yield
    finally:
        _CTX.reset(token)


def _get():
    return _CTX.get()


def resolve(shape, spec, mesh, dp) -> PartitionSpec:
    """The layout ``constrain`` pins for a tensor of ``shape``: ``"dp"``
    entries expand to the axes ``dp``, each mesh axis is used at most once,
    and an axis that does not divide its dim is dropped (that dim then
    replicated)."""
    sizes = mesh_shape(mesh)
    names = []
    used: set = set()
    for dim, s in enumerate(spec):
        if s == "dp":
            size = math.prod(sizes[a] for a in dp)
            if shape[dim] % size == 0:
                names.append(dp)
                used.update(dp)
            else:
                names.append(None)
        elif s is None or s in used:       # a mesh axis may appear only once
            names.append(None)
        else:
            if shape[dim] % sizes[s] == 0:
                names.append(s)
                used.add(s)
            else:
                names.append(None)
    return PartitionSpec(*names)


def constrain(x, *spec):
    """Pin ``x``'s layout: 'dp' entries expand to the data axes; None =
    replicated.

    No-op when no context is installed (single-host tests) or on a tensor
    that is not a ``DTensor``; a dim indivisible by its axes is replicated.
    """
    ctx = _get()
    if ctx is None:
        return x
    mesh, dp = ctx[0], ctx[1]
    names = resolve(tuple(x.shape), spec, mesh, dp)
    tensor = sys.modules.get("torch.distributed.tensor")   # no DTensor unless it is loaded
    if tensor is None or not isinstance(x, tensor.DTensor):
        return x
    return x.redistribute(mesh, to_placements(names, mesh))


def _tp(ctx) -> int:
    return mesh_shape(ctx[0])["model"]


def constrain_tokens_3d(x):
    """(B, S, D) activations: batch over dp (+ S over 'model' in SP mode).

    Megatron-style sequence parallelism: pinning the residual stream
    S-sharded between blocks turns each TP boundary all-reduce into a
    reduce-scatter (1/TP the result bytes) + a later all-gather, and stores
    layer-boundary activations at 1/TP the footprint.
    """
    ctx = _get()
    if ctx is not None and len(ctx) > 2 and ctx[2]:
        return constrain(x, "dp", "model", None)
    return constrain(x, "dp", None, None)


def constrain_attention_decode(q, k, v):
    """Decode layout: KV sequence sharded over 'model', q tiny + replicated.

    The masked softmax over the sharded KV length lowers to local partials +
    small reductions of the (B, H, 1) stats — the collective-optimal way to
    read a long cache when kv_heads don't divide the TP axis (all assigned
    archs).
    """
    ctx = _get()
    if ctx is None:
        return q, k, v
    if k.shape[1] % _tp(ctx) == 0:
        k = constrain(k, "dp", "model", None, None)
        v = constrain(v, "dp", "model", None, None)
        q = constrain(q, "dp", None, None, None)
    return q, k, v


def constrain_attention(q, k, v):
    """Pick the attention TP layout for (B, S, H, hd) tensors.

    Heads shard over 'model' when divisible (Megatron); otherwise queries
    shard along their *sequence* dim (context parallelism) with K/V
    replicated — so archs like hymba (25H) / llama4 (40H) / paligemma (8H)
    still split their S x S score matrices across the TP axis instead of
    replicating them.
    """
    ctx = _get()
    if ctx is None or (len(ctx) > 3 and ctx[3]):   # fsdp_only: dp covers all
        return q, k, v
    tp = _tp(ctx)
    if q.shape[2] % tp == 0 and k.shape[2] % tp == 0:
        q = constrain(q, "dp", None, "model", None)
        k = constrain(k, "dp", None, "model", None)
        v = constrain(v, "dp", None, "model", None)
    elif q.shape[1] % tp == 0 and q.shape[1] > 1:
        q = constrain(q, "dp", "model", None, None)
        k = constrain(k, "dp", None, None, None)
        v = constrain(v, "dp", None, None, None)
    return q, k, v
