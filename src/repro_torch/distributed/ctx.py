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

Where the reference's caches are new arrays, the port writes them in
place; :func:`store_rows` and :func:`fill_rows` are those writes, and on
a ``DTensor`` each rank writes the part of its own block that the rows
cover, so a dim sharded across ranks (the sequence-sharded decode cache)
takes a write with no gather of the cache.

XLA chooses the layout of every operation between two constraints; DTensor
chooses each operation's own, greedily, and can split a dim inside a head
or gather a whole batch.  So the model's products run through
:func:`mesh_matmul` and :func:`mesh_embed`, which lay their operands out as
Megatron does (the batch over the data axes, weights gathered over them,
heads, features or the vocabulary over ``"model"``) and multiply each
rank's blocks (:func:`local_block`, :func:`from_block`); :func:`whole`
reduces a partial sum where DTensor would reduce it onto a shard.
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


def is_dtensor(x) -> bool:
    """Whether ``x`` is a ``DTensor`` (never loading DTensor to find out)."""
    tensor = sys.modules.get("torch.distributed.tensor")
    return tensor is not None and isinstance(x, tensor.DTensor)


def _block_span(shape, mesh, placements, dim: int) -> tuple[int, int]:
    """(global offset, length) along ``dim`` of this rank's block of a
    tensor of ``shape`` placed as ``placements``, cut as DTensor cuts a
    ``Shard``: ``torch.chunk``'s pieces, in mesh order."""
    first, n = 0, shape[dim]
    coord = mesh.get_coordinate()
    for i, p in enumerate(placements):
        if p.is_shard(dim):
            piece = -(-n // mesh.size(i))
            lo = min(coord[i] * piece, n)
            first, n = first + lo, min(lo + piece, n) - lo
    return first, n


def _local_span(dst, dim: int, start: int, stop: int):
    """This rank's block of ``dst`` and the indices ``start..stop`` of
    ``dim`` that it holds, as (local block, global first, global stop,
    the block's global offset)."""
    first, n = _block_span(dst.shape, dst.device_mesh, dst.placements, dim)
    return dst.to_local(), max(start, first), min(stop, first + n), first


def layout(shape, *spec) -> tuple:
    """The placements ``constrain`` pins for a tensor of ``shape`` and
    ``spec`` under the installed context (a ``DeviceMesh``)."""
    mesh, dp = _get()[:2]
    return to_placements(resolve(tuple(shape), spec, mesh, dp), mesh)


def local_block(x, placements, out_placements):
    """This rank's block of the ``DTensor`` ``x`` laid out as
    ``placements``, for a computation whose result is placed as
    ``out_placements``: where ``x`` is whole on a mesh dim that splits the
    result (a shard or a partial sum), each rank's gradient is a part of
    the whole, so the block's gradient flows back as a partial sum there."""
    from torch.distributed.tensor import Partial

    x = x.redistribute(x.device_mesh, placements)
    grads = [Partial() if p.is_replicate() and not o.is_replicate() else p
             for p, o in zip(placements, out_placements)]
    return x.to_local(grad_placements=grads)


def from_block(local, mesh, placements, shape):
    """``local``, this rank's block (made contiguous), as a ``DTensor`` of
    global ``shape`` placed as ``placements`` (no collective)."""
    import torch
    from torch.distributed.tensor import DTensor

    stride, step = [], 1
    for n in reversed(tuple(shape)):
        stride.append(step)
        step *= n
    return DTensor.from_local(local.contiguous(), mesh, placements, run_check=False,
                              shape=torch.Size(shape), stride=tuple(reversed(stride)))


def mesh_matmul(x, w, split: str | None):
    """``x (..., K) @ w (K, N)`` for ``DTensor`` s, laid out as Megatron
    lays a linear layer: ``x``'s leading (batch) dim over the data axes and
    the rest whole, ``w`` gathered over the data axes (FSDP); ``split``
    ``"cols"``: ``w``'s columns over ``"model"``, the product sharded on its
    last dim; ``"rows"``: ``w``'s rows and ``x``'s last dim over
    ``"model"``, the partial products summed over ``"model"`` (an
    all-reduce); ``None``: ``w`` whole on every rank.  Each rank multiplies
    its blocks; the gradients flow back to the placements ``x`` and ``w``
    came with."""
    import torch
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = x.device_mesh
    xp = list(layout(x.shape, "dp", *([None] * (x.ndim - 1))))
    wp, yp = [Replicate()] * mesh.ndim, list(xp)
    if split is not None:
        i = mesh.mesh_dim_names.index("model")
        wp[i] = Shard(1 if split == "cols" else 0)
        if split == "cols":
            yp[i] = Shard(x.ndim - 1)
        else:
            xp[i], yp[i] = Shard(x.ndim - 1), Partial()
    y = torch.matmul(local_block(x, xp, yp), local_block(w, wp, yp))
    y = from_block(y, mesh, yp, (*x.shape[:-1], w.shape[1]))
    if split == "rows":
        y = y.redistribute(mesh, [Replicate() if p.is_partial() else p for p in yp])
    return y


def mesh_embed(tokens, table, dtype):
    """``table[tokens]`` cast to ``dtype`` for a ``DTensor`` table (V, D),
    as a vocab-parallel embedding: the table gathered over the data axes
    and split over ``"model"`` by rows where they divide it, each rank
    looking up the tokens of its batch rows that fall in its rows, the
    partial sums (one term each) reduced over ``"model"``."""
    import torch
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = table.device_mesh
    tp = [Replicate()] * mesh.ndim
    xp = list(layout(tokens.shape, "dp", *([None] * (tokens.ndim - 1))))
    yp = list(xp)
    if model_split(table.shape[0]):
        i = mesh.mesh_dim_names.index("model")
        tp[i], yp[i] = Shard(0), Partial()
    local = local_block(table, tp, yp)
    first = _block_span(table.shape, mesh, tp, 0)[0]
    idx = (local_block(tokens, xp, yp) - first).long()
    valid = (idx >= 0) & (idx < local.shape[0])
    rows = (local[idx.clamp(0, local.shape[0] - 1)] * valid[..., None]).to(dtype)
    return whole(from_block(rows, mesh, yp, (*tokens.shape, table.shape[1])))


def whole(x):
    """A ``DTensor`` whose partial sums (or maxima) are reduced: each
    ``Partial`` placement made ``Replicate``, the rest kept.  DTensor left
    alone may reduce a partial onto a shard of another dim, which the
    tensors it meets later then gather."""
    from torch.distributed.tensor import Replicate

    return x.redistribute(x.device_mesh, [Replicate() if p.is_partial() else p
                                          for p in x.placements])


def model_split(n: int) -> bool:
    """Whether a dim of ``n`` (heads, features) splits over the context's
    ``"model"`` axis."""
    tp = model_axis_size()
    return tp > 1 and n % tp == 0


def local_offset(x, dim: int) -> int:
    """The global index of the first element of this rank's block of the
    ``DTensor`` ``x`` along ``dim``."""
    return _block_span(x.shape, x.device_mesh, x.placements, dim)[0]


def store_rows(dst, dim: int, start: int, rows):
    """In place: ``dst``'s indices ``start..start + n`` along ``dim`` take
    ``rows`` (n = ``rows.shape[dim]``, cast to ``dst``'s dtype).  On a
    ``DTensor`` ``rows`` (a ``DTensor``, or a plain tensor taken as
    replicated) is laid out as ``dst`` with ``dim`` whole, and each rank
    copies the part its block holds."""
    n = rows.shape[dim]
    if not is_dtensor(dst):
        dst.narrow(dim, start, n).copy_(rows)
        return dst
    from torch.distributed.tensor import DTensor, Replicate

    mesh = dst.device_mesh
    if not is_dtensor(rows):
        rows = DTensor.from_local(rows, mesh, [Replicate()] * mesh.ndim, run_check=False)
    spread = [Replicate() if p.is_shard(dim) else p for p in dst.placements]
    src = rows.redistribute(mesh, spread).to_local()
    local, lo, hi, first = _local_span(dst, dim, start, start + n)
    if lo < hi:
        local.narrow(dim, lo - first, hi - lo).copy_(src.narrow(dim, lo - start, hi - lo))
    return dst


def fill_rows(dst, dim: int, start: int, stop: int, value):
    """In place: ``dst``'s indices ``start..stop`` along ``dim`` take
    ``value``; on a ``DTensor`` each rank fills the part its block holds."""
    if not is_dtensor(dst):
        dst.narrow(dim, start, stop - start).fill_(value)
        return dst
    local, lo, hi, first = _local_span(dst, dim, start, stop)
    if lo < hi:
        local.narrow(dim, lo - first, hi - lo).fill_(value)
    return dst


def _tp(ctx) -> int:
    return mesh_shape(ctx[0])["model"]


def model_axis_size() -> int:
    """The size of the installed context's ``"model"`` axis (1 with no
    context, or under ``fsdp_only``, whose layouts leave heads whole)."""
    ctx = _get()
    if ctx is None or ctx[3]:
        return 1
    return mesh_shape(ctx[0]).get("model", 1)


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
