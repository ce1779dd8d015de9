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
reduces a partial sum where DTensor would reduce it onto a shard.  The
recurrent blocks (the SSM, mLSTM and sLSTM) compute on each rank's
channels (:func:`channels`) in the layout of their stored state; their
products keep a weight where it is stored and move the activation, or
gather the weight, whichever moves fewer bytes (:func:`mesh_cols`,
:func:`mesh_rows`), and their states are read and written in their own
blocks (:func:`state_block`, :func:`store_block`, :func:`read_channels`,
:func:`write_channels`).

Under sequence parallelism (``seq_parallel``, :func:`sequence_parallel`) the
residual stream between blocks is split by sequence over ``"model"``, as
Megatron lays it out: the norms and the residual adds run on each rank's
own rows; a tensor-parallel region's input is gathered once
(:func:`gather_sequence`, an all-gather whose backward is a
reduce-scatter), and its output is reduced onto the sequence (``seq=True``
of :func:`mesh_matmul` and :func:`mesh_rows`: a reduce-scatter of the
partial sums, whose backward is an all-gather) instead of reduced whole.
"""
from __future__ import annotations

import contextlib
import contextvars
import math
import sys
from typing import Iterator

import torch

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
    placements = to_placements(names, mesh)
    if sequence_parallel() and tuple(x.placements) == tuple(placements):
        return x        # as local_block: partial gradients pass on to the gather
    return x.redistribute(mesh, placements)


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
    the whole, so the block's gradient flows back as a partial sum there.
    Under sequence parallelism an ``x`` already laid out so is taken as it
    is, so that those partial sums flow back unreduced to where a region
    gathered its sequence, and are reduce-scattered there once."""
    from torch.distributed.tensor import Partial

    if not sequence_parallel() or tuple(x.placements) != tuple(placements):
        x = x.redistribute(x.device_mesh, placements)
    grads = [Partial() if p.is_replicate() and not o.is_replicate() else p
             for p, o in zip(placements, out_placements)]
    return x.to_local(grad_placements=grads)


def _stride(shape) -> tuple:
    """The strides of a contiguous tensor of ``shape``."""
    stride, step = [], 1
    for n in reversed(tuple(shape)):
        stride.append(step)
        step *= n
    return tuple(reversed(stride))


def from_block(local, mesh, placements, shape):
    """``local``, this rank's block (made contiguous), as a ``DTensor`` of
    global ``shape`` placed as ``placements`` (no collective)."""
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(local.contiguous(), mesh, placements, run_check=False,
                              shape=torch.Size(shape), stride=_stride(shape))


def mesh_matmul(x, w, split: str | None, seq: bool = False):
    """``x (..., K) @ w (K, N)`` for ``DTensor`` s, laid out as Megatron
    lays a linear layer: ``x``'s leading (batch) dim over the data axes and
    the rest whole, ``w`` gathered over the data axes (FSDP); ``split``
    ``"cols"``: ``w``'s columns over ``"model"``, the product sharded on its
    last dim; ``"rows"``: ``w``'s rows and ``x``'s last dim over
    ``"model"``, the partial products summed over ``"model"`` (an
    all-reduce); ``None``: ``w`` whole on every rank.  Each rank multiplies
    its blocks; the gradients flow back to the placements ``x`` and ``w``
    came with.  ``seq``: the product joins the residual stream, and under
    sequence parallelism is laid out as it (:func:`onto_sequence`): the
    partial sums of ``"rows"`` reduce-scattered onto the sequence, and
    without a split each rank multiplies its own rows of an ``x`` that is
    split by sequence."""
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
    elif seq and sequence_parallel() and by_sequence(x):
        i = mesh.mesh_dim_names.index("model")
        xp[i] = yp[i] = Shard(1)
    y = torch.matmul(local_block(x, xp, yp), local_block(w, wp, yp))
    y = from_block(y, mesh, yp, (*x.shape[:-1], w.shape[1]))
    if seq and split != "cols":
        return onto_sequence(y)
    return whole(y) if split == "rows" else y


def mesh_embed(tokens, table, dtype):
    """``table[tokens]`` cast to ``dtype`` for a ``DTensor`` table (V, D),
    as a vocab-parallel embedding: the table gathered over the data axes
    and split over ``"model"`` by rows where they divide it, each rank
    looking up the tokens of its batch rows that fall in its rows, the
    partial sums (one term each) reduced over ``"model"`` (onto the
    sequence under sequence parallelism).  Where the rows
    do not divide it and the table is stored with its columns split there,
    each rank looks its tokens up in its own columns and the rows are
    gathered, when they are fewer than the table's (a decode step's);
    else the table is gathered whole."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = table.device_mesh
    tp = [Replicate()] * mesh.ndim
    xp = list(layout(tokens.shape, "dp", *([None] * (tokens.ndim - 1))))
    yp = list(xp)
    i = _model_dim(mesh)
    s = table.placements[i] if i is not None else None
    if (not model_split(table.shape[0]) and s is not None and s.is_shard(1)
            and _block_span(tokens.shape, mesh, xp, 0)[1] * math.prod(tokens.shape[1:])
            < table.shape[0]):
        tp[i], yp[i] = Shard(1), Shard(tokens.ndim)
        rows = local_block(table, tp, yp)[local_block(tokens, xp, yp).long()].to(dtype)
        return from_block(rows, mesh, yp, (*tokens.shape, table.shape[1])).redistribute(mesh, xp)
    if model_split(table.shape[0]):
        i = mesh.mesh_dim_names.index("model")
        tp[i], yp[i] = Shard(0), Partial()
    local = local_block(table, tp, yp)
    first = _block_span(table.shape, mesh, tp, 0)[0]
    idx = (local_block(tokens, xp, yp) - first).long()
    valid = (idx >= 0) & (idx < local.shape[0])
    rows = (local[idx.clamp(0, local.shape[0] - 1)] * valid[..., None]).to(dtype)
    return onto_sequence(from_block(rows, mesh, yp, (*tokens.shape, table.shape[1])))


def _model_dim(mesh) -> int | None:
    """The mesh dim of the context's ``"model"`` axis where it splits
    channels (None with no such split)."""
    return mesh.mesh_dim_names.index("model") if model_axis_size() > 1 else None


def channels(shape, axis=None) -> list:
    """Each ``"model"`` rank's channels of a block laid out as ``shape`` and
    split over ``"model"`` on ``axis``: flat indices into the block, one
    tensor per rank in coordinate order (``torch.chunk``'s pieces, as
    DTensor cuts a ``Shard``), or one tensor of every index where
    ``axis`` is None or ``"model"`` splits nothing."""
    tp = model_axis_size()
    if axis is None or tp == 1:
        return [torch.arange(math.prod(shape))]
    return _stored_parts(shape, axis, tp)


def _mine(mesh, parts):
    """This rank's tensor of ``parts`` (from :func:`channels`)."""
    if len(parts) == 1:
        return parts[0]
    return parts[mesh.get_coordinate()[_model_dim(mesh)]]


def _same(parts, others) -> bool:
    """Whether two lists of per-rank channels are the same, on every rank
    (so that every rank takes the same branch)."""
    return len(parts) == len(others) and all(
        a.shape == b.shape and torch.equal(a, b) for a, b in zip(parts, others))


def _stored_parts(shape, dim: int, tp: int) -> list:
    """Each rank's flat indices of a tensor of ``shape`` whose dim ``dim``
    is split over ``"model"`` (of ``tp`` ranks)."""
    idx = torch.arange(math.prod(shape)).reshape(shape)
    return [c.reshape(-1) for c in idx.chunk(tp, dim)]


def _take(t, parts, mesh, dim=-1):
    return t.index_select(dim, _mine(mesh, parts).to(t.device))


def block_layout(x, split: bool) -> tuple[list, list]:
    """(``x``'s layout with its leading dim over the data axes and the rest
    whole, the layout of what each rank computes from it: the same, or
    split over ``"model"`` on the last dim where ``split``).  The second
    declares how gradients flow back (:func:`local_block`): as partial sums
    over ``"model"`` where the ranks compute different parts."""
    from torch.distributed.tensor import Shard

    xp = list(layout(x.shape, "dp", *([None] * (x.ndim - 1))))
    yp = list(xp)
    i = _model_dim(x.device_mesh)
    if split and i is not None:
        yp[i] = Shard(x.ndim - 1)
    return xp, yp


def local_rows(x, xp) -> int:
    """Rows of ``x``'s block laid out as ``xp``: every dim but the last."""
    return _block_span(x.shape, x.device_mesh, xp, 0)[1] * math.prod(x.shape[1:-1])


def stored_product(x, w):
    """``x (..., K)`` times ``w (K, ...)`` for ``DTensor`` s, computed in
    ``w``'s own layout over ``"model"`` (``x``'s last dim split to match a
    split of ``w``'s first, the product split where ``w`` is split on
    another dim), then whole over ``"model"`` (gathered, or the partial
    sums reduced); ``x``'s batch over the data axes, ``w`` gathered over
    them.  Returns the ``DTensor`` ``(..., *w.shape[1:])``."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = x.device_mesh
    i = _model_dim(mesh)
    xp = list(layout(x.shape, "dp", *([None] * (x.ndim - 1))))
    s = w.placements[i] if i is not None else Replicate()
    wp, xs, yp = [Replicate()] * mesh.ndim, list(xp), list(xp)
    if s.is_shard():
        wp[i] = s
        if s.dim == 0:
            xs[i], yp[i] = Shard(x.ndim - 1), Partial()
        else:
            yp[i] = Shard(x.ndim - 2 + s.dim)
    wl = local_block(w, wp, yp)
    y = torch.matmul(local_block(x, xs, yp), wl.reshape(wl.shape[0], -1))
    y = from_block(y.unflatten(-1, wl.shape[1:]), mesh, yp, (*x.shape[:-1], *w.shape[1:]))
    return y.redistribute(mesh, [Replicate() if j == i else p for j, p in enumerate(yp)])


def mine(t, parts, split: bool):
    """This rank's channels ``parts`` (:func:`channels`) of the last dim of
    ``t``, a ``DTensor`` whole over ``"model"``, as a local tensor (its
    batch rows), its gradient a partial sum over ``"model"`` where
    ``split``."""
    xp, yp = block_layout(t, split)
    return _take(local_block(t, xp, yp), parts, t.device_mesh)


def mesh_cols(x, w, parts=None):
    """``x @ w`` for a ``DTensor`` ``x (..., K)`` and a ``DTensor`` ``w (K,
    ...)`` in its stored layout, ``w``'s trailing dims taken flat (N in
    all).  With ``parts`` (:func:`channels` of those N), this rank's columns
    as a local tensor ``(..., n)`` of its batch rows; without, the whole
    product as a ``DTensor`` whole over ``"model"``.  Moves the fewest
    bytes: nothing where ``w``'s own block on every rank is exactly its
    columns; else ``w`` gathered whole (K x N elements), or the product
    taken in ``w``'s own layout and gathered (rows x N,
    :func:`stored_product`), whichever is fewer."""
    from torch.distributed.tensor import Replicate

    mesh = x.device_mesh
    i = _model_dim(mesh)
    K, N = w.shape[0], math.prod(w.shape[1:])
    split = parts is not None and len(parts) > 1
    xp, yp = block_layout(x, split)
    s = w.placements[i] if i is not None else None
    if s is not None and s.is_shard() and s.dim > 0 and parts is not None and _same(
            parts, _stored_parts(w.shape[1:], s.dim - 1, mesh.size(i))):
        wp = [Replicate()] * mesh.ndim
        wp[i] = s
        return torch.matmul(local_block(x, xp, yp), local_block(w, wp, yp).reshape(K, -1))
    if s is None or not s.is_shard() or local_rows(x, xp) >= K:
        wl = local_block(w, [Replicate()] * mesh.ndim, yp).reshape(K, N)
        if parts is not None:
            return torch.matmul(local_block(x, xp, yp), _take(wl, parts, mesh))
        return from_block(torch.matmul(local_block(x, xp, yp), wl), mesh, xp,
                          (*x.shape[:-1], N))
    y = stored_product(x, w).flatten(x.ndim - 1)
    return y if parts is None else mine(y, parts, split)


def gather_channels(y, parts, like):
    """The channels ``parts`` (:func:`channels`, split across ``"model"``)
    that each rank holds as ``y (..., n)``, a local tensor of the batch
    rows of ``like`` (a ``DTensor`` ``(..., ·)``), gathered over
    ``"model"`` into their order: a ``DTensor`` ``(*like.shape[:-1],
    K)`` whole over ``"model"``."""
    from torch.distributed.tensor import Shard

    mesh = like.device_mesh
    xp, _ = block_layout(like, False)
    sp = list(xp)
    sp[_model_dim(mesh)] = Shard(y.ndim - 1)
    shape = (*like.shape[:-1], len(parts) * y.shape[-1])
    g = from_block(y, mesh, sp, shape).redistribute(mesh, xp).to_local()
    order = torch.argsort(torch.cat(parts)).to(g.device)
    return from_block(g.index_select(-1, order), mesh, xp, shape)


def mesh_rows(y, parts, w, like, seq: bool = False):
    """The sum over ``"model"`` of ``y @ w[idx]``: ``y (..., n)`` a local
    tensor, this rank's channels ``parts`` (:func:`channels` of ``w``'s
    first dim, K) of an input whose batch rows are those of ``like`` (a
    ``DTensor``); returns the ``DTensor`` ``(*like.shape[:-1], N)`` with its
    batch over the data axes, whole over ``"model"``.  Where every rank
    holds every channel, as :func:`mesh_matmul` with ``w``'s own split or
    ``w`` whole, whichever moves fewer bytes; where the ranks' channels
    partition K, each rank multiplies its own rows of ``w`` (its stored
    block where that is exactly them, else ``w`` gathered whole, or ``y``'s
    channels gathered where that moves fewer bytes) and the partial sums
    are reduced.  ``seq``: the product joins the residual stream, as in
    :func:`mesh_matmul`."""
    from torch.distributed.tensor import Partial, Replicate

    mesh = like.device_mesh
    i = _model_dim(mesh)
    K, N = w.shape
    xp, _ = block_layout(like, False)
    rows = y.numel() // max(y.shape[-1], 1)
    s = w.placements[i] if i is not None else None
    by_rows = s is not None and s.is_shard(0)
    if len(parts) == 1:
        return mesh_matmul(from_block(y, mesh, xp, (*like.shape[:-1], K)), w,
                           "rows" if by_rows and rows < K else None, seq)
    yp = list(xp)
    yp[i] = Partial()
    shape = (*like.shape[:-1], N)
    reduce = onto_sequence if seq else whole
    if by_rows and _same(parts, _stored_parts((K,), 0, mesh.size(i))):
        wp = [Replicate()] * mesh.ndim
        wp[i] = s
        return reduce(from_block(torch.matmul(y, local_block(w, wp, yp)), mesh, yp, shape))
    if N <= rows:
        wl = _take(local_block(w, [Replicate()] * mesh.ndim, yp), parts, mesh, 0)
        return reduce(from_block(torch.matmul(y, wl), mesh, yp, shape))
    return mesh_matmul(gather_channels(y, parts, like), w, "rows" if by_rows else None, seq)


def weight_part(w, parts, use):
    """This rank's entries ``parts`` (:func:`channels` of ``w`` taken flat)
    of the ``DTensor`` ``w``, a local tensor for a computation laid out as
    ``use`` (:func:`block_layout`'s second): ``w``'s own block where that is
    exactly them on every rank, else ``w`` gathered whole."""
    from torch.distributed.tensor import Replicate

    mesh = w.device_mesh
    i = _model_dim(mesh)
    wp = [Replicate()] * mesh.ndim
    s = w.placements[i] if i is not None else None
    if s is not None and s.is_shard() and _same(parts, _stored_parts(w.shape, s.dim, mesh.size(i))):
        wp[i] = s
        return local_block(w, wp, use).reshape(-1)
    return _take(local_block(w, wp, use).reshape(-1), parts, mesh)


def stored_channels(state, parts) -> bool:
    """Whether each rank's block of the ``DTensor`` ``state`` holds, on its
    last dim, exactly its channels ``parts`` (:func:`channels`)."""
    i = _model_dim(state.device_mesh)
    s = state.placements[i] if i is not None else None
    if s is None or not s.is_shard():
        return len(parts) == 1
    return s.dim == state.ndim - 1 and _same(
        parts, _stored_parts((state.shape[-1],), 0, state.device_mesh.size(i)))


def read_channels(state, parts):
    """This rank's channels ``parts`` of the last dim of a state leaf, a
    ``DTensor`` (B, ..., C), as a local tensor of its batch rows: its own
    block where it is stored so, else gathered over ``"model"``."""
    if stored_channels(state, parts):
        return state.to_local()
    xp, _ = block_layout(state, False)
    return _take(state_block(state, xp), parts, state.device_mesh)


def write_channels(state, local, parts):
    """In place: a state leaf, a ``DTensor`` (B, ..., C), takes the value of
    which ``local`` is this rank's channels ``parts``; each rank writes its
    own block (the channels gathered first where they are not stored
    so)."""
    if stored_channels(state, parts):
        state.to_local().copy_(local)
        return state
    xp, _ = block_layout(state, False)
    if len(parts) > 1:
        local = gather_channels(local, parts, state).to_local()
    return store_block(state, local, xp)


def state_block(state, placements):
    """This rank's block of the ``DTensor`` ``state`` laid out as
    ``placements`` (a redistribute where the stored layout differs)."""
    if tuple(state.placements) != tuple(placements):
        state = state.redistribute(state.device_mesh, placements)
    return state.to_local()


def store_block(dst, local, placements):
    """In place: ``dst`` (a ``DTensor``) takes the value whose block on this
    rank, laid out as ``placements``, is ``local``; each rank writes its own
    block of ``dst`` (a redistribute where the layouts differ)."""
    if tuple(dst.placements) != tuple(placements):
        local = from_block(local, dst.device_mesh, placements, dst.shape).redistribute(
            dst.device_mesh, dst.placements).to_local()
    dst.to_local().copy_(local)
    return dst


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


def sequence_parallel() -> bool:
    """Whether the installed context holds the residual stream split by
    sequence over a ``"model"`` axis that splits anything (``seq_parallel``
    set, not ``fsdp_only``)."""
    ctx = _get()
    return ctx is not None and ctx[2] and model_axis_size() > 1


def by_sequence(x) -> bool:
    """Whether ``x`` is a ``DTensor`` (B, S, ...) split by sequence over
    ``"model"``."""
    if not is_dtensor(x) or x.ndim < 2 or "model" not in x.device_mesh.mesh_dim_names:
        return False
    return x.placements[x.device_mesh.mesh_dim_names.index("model")].is_shard(1)


def gather_sequence(x):
    """Into a tensor-parallel region: ``x`` (B, S, ...) whole over
    ``"model"``, its sequence gathered once for every product of the region
    (an all-gather; in the backward pass the region's partial gradients
    reduce-scattered back onto the sequence).  ``x`` itself where it is not
    split by sequence."""
    if not by_sequence(x):
        return x
    from torch.distributed.tensor import Replicate

    i = x.device_mesh.mesh_dim_names.index("model")
    return x.redistribute(x.device_mesh, [Replicate() if j == i else p
                                          for j, p in enumerate(x.placements)])


def _as_partial(grad):
    """A ``DTensor`` gradient with its ``"model"`` dim a partial sum: kept
    where it is one, else the whole on the first ``"model"`` rank and zeros
    on the others (the same sum, exactly)."""
    from torch.distributed.tensor import DTensor, Partial

    mesh = grad.device_mesh
    i = mesh.mesh_dim_names.index("model")
    if not grad.placements[i].is_replicate():
        return grad
    local = grad.to_local()
    if mesh.get_coordinate()[i]:
        local = torch.zeros_like(local)
    placements = list(grad.placements)
    placements[i] = Partial()
    return DTensor.from_local(local, mesh, placements, run_check=False, shape=grad.shape,
                              stride=grad.stride())


class _PartialGrad(torch.autograd.Function):
    """The identity; its gradient goes on as a partial sum over
    ``"model"``."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _as_partial(grad)


class _FromBlockPartial(torch.autograd.Function):
    """``DTensor.from_local`` whose backward keeps (or makes) the gradient a
    partial sum over ``"model"``, its other mesh dims laid out as given."""

    @staticmethod
    def forward(ctx, local, mesh, placements, shape):
        from torch.distributed.tensor import DTensor

        ctx.spec = (mesh, tuple(placements))
        return DTensor.from_local(local, mesh, placements, run_check=False,
                                  shape=torch.Size(shape), stride=_stride(shape))

    @staticmethod
    def backward(ctx, grad):
        from torch.distributed.tensor import Partial

        mesh, placements = ctx.spec
        i = mesh.mesh_dim_names.index("model")
        grad = _as_partial(grad)
        target = [Partial() if j == i else p for j, p in enumerate(placements)]
        if tuple(grad.placements) != tuple(target):
            grad = grad.redistribute(mesh, target)
        return grad.to_local(), None, None, None


def partial_grad(x):
    """``x``, whose gradient, where it comes back whole over ``"model"``,
    goes on as a partial sum there (the whole on the first ``"model"`` rank,
    zeros on the others: the same sum, exactly).  Under sequence
    parallelism a region's product that every rank computes whole (k and v
    where their heads do not divide ``"model"``) reads its gathered input
    through it, so that its gradient joins the region's other partial sums
    for the one reduce-scatter, whatever DTensor would do with a whole
    gradient and a partial one.  ``x`` itself elsewhere."""
    if not sequence_parallel() or not is_dtensor(x):
        return x
    return _PartialGrad.apply(x)


def from_block_partial(local, mesh, placements, shape):
    """:func:`from_block` for a block that each rank computed whole over
    ``"model"`` and whose users there each use a part: its gradient comes
    back as a partial sum over ``"model"`` (unreduced; a whole one given to
    the first rank), for a :func:`local_block` that declared its gradient
    partial there.  Under sequence parallelism the expanded k and v of the
    sequence layout are made so, so that their gradients reach the gather of
    k and v as partial sums, reduce-scattered there."""
    return _FromBlockPartial.apply(local.contiguous(), mesh, placements, tuple(shape))


def onto_sequence(y):
    """Out of a tensor-parallel region: the ``DTensor`` ``y`` (B, S, ...)
    laid out as the residual stream.  Under sequence parallelism, where S
    splits over ``"model"``, its sequence over ``"model"`` (partial sums
    reduce-scattered, a whole product cut to each rank's rows, with no
    collective) and its other partial sums reduced; else every partial sum
    reduced (:func:`whole`)."""
    tp = model_axis_size()
    if not sequence_parallel() or y.ndim < 3 or y.shape[1] % tp:
        return whole(y) if any(p.is_partial() for p in y.placements) else y
    from torch.distributed.tensor import Replicate, Shard

    i = _model_dim(y.device_mesh)
    placements = [Shard(1) if j == i else Replicate() if p.is_partial() else p
                  for j, p in enumerate(y.placements)]
    return y if tuple(placements) == tuple(y.placements) else y.redistribute(y.device_mesh,
                                                                             placements)


def last_position(x):
    """``x[:, -1:]`` of ``x`` (B, S, ...).  Where ``x`` is split by sequence
    over ``"model"`` (in even blocks, as ``constrain`` splits it), each rank's
    last row is gathered ((B, ranks, ...), one row a rank) and the last
    kept: the sequence itself is never gathered."""
    if not by_sequence(x):
        return x[:, -1:]
    mesh = x.device_mesh
    rows = x.to_local()[:, -1:]
    n = mesh.size(mesh.mesh_dim_names.index("model"))
    return from_block(rows, mesh, x.placements, (x.shape[0], n, *x.shape[2:]))[:, -1:]


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
