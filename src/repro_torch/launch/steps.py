"""Step builders: train / prefill / decode steps with shardings.

Used by the trainer, the serving engine, and the multi-pod dry-run: each
builder returns (fn, in_shardings, out_shardings, abstract_args) so callers
can either execute or just trace the step on abstract arguments.

The port of ``repro.launch.steps``.  A bundle's shardings are trees of
:class:`~repro_torch.distributed.sharding.Sharding` (the mesh and one
DTensor placement per mesh dim, with the reference's ``PartitionSpec`` as
``.spec``), leaf for leaf the reference's; its abstract arguments are meta
tensors.  ``fn`` takes ``DTensor`` arguments placed by ``in_shardings``,
runs the model under the sharding context (:func:`~repro_torch.distributed.
ctx.shard_ctx`, with DTensor's implicit replication of the plain tensors the
model makes, such as positions and masks) and returns its outputs placed as
``out_shardings``.  It is the same function on a world of processes,
where it computes (:func:`place` puts the arguments there), and on a
``"fake"`` process group with meta tensors for local blocks, where
:func:`lower_step` traces it with nothing allocated (the dry-run).  The mesh may also be a
plain mapping of axis names to sizes: a bundle's shardings then plan, and
``fn`` needs a ``DeviceMesh``.

The train step differentiates attention on the einsum route
(``kernel=False``), as the trainer does: K3 and K4 have no backward pass.
The serving steps take ``kernel``: on the card (the default) prefill runs
K3 and a decode step K4 on each rank's heads.  Parameters, optimizer state
and caches are updated in place: ``donate_argnums`` names the arguments
a step consumes, as the reference's donation does.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable

import torch

from ..configs.base import ModelConfig, ShapeCell
from ..distributed import sharding as shd
from ..distributed.ctx import from_block, is_dtensor, shard_ctx
from ..distributed.world import host_collectives
from ..models import model_zoo as zoo
from ..optim import AdamWConfig, AdamWState, adamw_update
from ..utils.tree import tree_leaves, tree_map

P = shd.PartitionSpec
META = torch.device("meta")
#: the train step's metrics, as the reference's ``eval_shape`` finds them:
#: the loss's, the loss itself and AdamW's
METRICS = ("aux", "ce", "grad_norm", "loss", "lr")


@dataclasses.dataclass
class StepBundle:
    fn: Callable
    in_shardings: Any
    out_shardings: Any
    abstract_args: tuple
    donate_argnums: tuple = ()


def _named(tree_spec, mesh):
    return shd.to_shardings(tree_spec, mesh)


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


@contextlib.contextmanager
def _step_ctx(mesh, **kw):
    """The sharding context of a step, with DTensor's implicit replication
    of plain tensors (positions, masks, zeros the model makes), and over
    gloo on CUDA its collectives moved through the host
    (:func:`~repro_torch.distributed.world.host_collectives`)."""
    from torch.distributed.tensor.experimental import implicit_replication

    with shard_ctx(mesh, **kw), implicit_replication(), host_collectives(mesh):
        yield


def _placed(x, sharding):
    """``x`` (a ``DTensor``, or a plain tensor taken as replicated) placed as
    ``sharding``: a redistribute where the placements differ."""
    from torch.distributed.tensor import DTensor, Replicate

    mesh, placements = sharding
    if not is_dtensor(x):
        x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim, run_check=False)
    if tuple(x.placements) != tuple(placements):
        x = x.redistribute(mesh, placements)
    return x


def _outputs(tree, shardings):
    return tree_map(_placed, tree, shardings)


# ---------------------------------------------------------------------------
# Train step
# ---------------------------------------------------------------------------

def _opt_shape(params_shape) -> AdamWState:
    f32 = tree_map(lambda p: _meta(p.shape, torch.float32), params_shape)
    return AdamWState(step=_meta((), torch.int32), m=f32,
                      v=tree_map(lambda p: _meta(p.shape, torch.float32), params_shape))


def build_train_step(
    cfg: ModelConfig,
    mesh,
    shape: ShapeCell,
    opt_cfg: AdamWConfig | None = None,
) -> StepBundle:
    opt_cfg = opt_cfg or AdamWConfig()
    params_shape = zoo.abstract_params(cfg)
    opt_shape = _opt_shape(params_shape)
    batch_shape = zoo.input_specs(cfg, shape)

    p_spec = shd.param_specs(params_shape, mesh, fsdp_only=cfg.fsdp_only)
    o_spec = AdamWState(step=P(), m=p_spec, v=p_spec)
    b_spec = shd.batch_specs(batch_shape, mesh, fsdp_only=cfg.fsdp_only)
    m_spec = {k: P() for k in METRICS}
    out_shardings = (_named(p_spec, mesh), _named(o_spec, mesh), _named(m_spec, mesh))

    def train_step(params, opt_state, batch):
        with _step_ctx(mesh, seq_parallel=cfg.seq_parallel, fsdp_only=cfg.fsdp_only):
            leaves = tree_leaves(params)
            for p in leaves:
                p.requires_grad_(True)
            loss, metrics = zoo.loss_fn(params, cfg, batch, kernel=False)
            # zeros for the leaves the loss does not reach (an xLSTM layer's
            # unused half), as the reference's gradient has them
            grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
            for p in leaves:
                p.requires_grad_(False)
            new_params, new_opt, opt_metrics = adamw_update(
                list(grads), opt_state, params, opt_cfg
            )
            metrics = {k: v.detach() for k, v in dict(metrics, loss=loss, **opt_metrics).items()}
            return _outputs((new_params, new_opt, metrics), out_shardings)

    return StepBundle(
        fn=train_step,
        in_shardings=(_named(p_spec, mesh), _named(o_spec, mesh), _named(b_spec, mesh)),
        out_shardings=out_shardings,
        abstract_args=(params_shape, opt_shape, batch_shape),
        donate_argnums=(0, 1),
    )


# ---------------------------------------------------------------------------
# Serving steps
# ---------------------------------------------------------------------------

def _serving_params_shape(cfg: ModelConfig):
    ps = zoo.abstract_params(cfg)
    if cfg.serve_weight_dtype is None:
        return ps
    dt = cfg.serve_weight_dtype
    return tree_map(lambda s: _meta(s.shape, dt) if s.dtype.is_floating_point else s, ps)


def _logits_shape(cfg: ModelConfig, batch: int) -> torch.Tensor:
    """A serving step's last-position logits: (B, V) float32."""
    return _meta((batch, cfg.vocab_size), torch.float32)


def build_prefill_step(cfg: ModelConfig, mesh, shape: ShapeCell,
                       kernel: bool = True) -> StepBundle:
    params_shape = _serving_params_shape(cfg)
    batch_shape = zoo.input_specs(
        cfg, dataclasses.replace(shape, kind="prefill")
    )
    cache_shape = zoo.abstract_cache(cfg, shape)

    p_spec = shd.param_specs(params_shape, mesh, serving=True)
    b_spec = shd.batch_specs(batch_shape, mesh)
    c_spec = shd.cache_specs(cache_shape, mesh)
    l_spec = shd.batch_specs(_logits_shape(cfg, shape.global_batch), mesh)
    out_shardings = (_named(l_spec, mesh), _named(c_spec, mesh))

    def prefill(params, batch, cache):
        with _step_ctx(mesh, seq_parallel=cfg.seq_parallel), torch.no_grad():
            return _outputs(zoo.prefill_fn(params, cfg, batch, cache, kernel=kernel),
                            out_shardings)

    return StepBundle(
        fn=prefill,
        in_shardings=(_named(p_spec, mesh), _named(b_spec, mesh), _named(c_spec, mesh)),
        out_shardings=out_shardings,
        abstract_args=(params_shape, batch_shape, cache_shape),
        donate_argnums=(2,),
    )


def build_decode_step(cfg: ModelConfig, mesh, shape: ShapeCell,
                      kernel: bool = True) -> StepBundle:
    params_shape = _serving_params_shape(cfg)
    cache_shape = zoo.abstract_cache(cfg, shape)
    B = shape.global_batch
    token_shape = _meta((B,), torch.int32)
    len_shape = _meta((), torch.int32)

    p_spec = shd.param_specs(params_shape, mesh, serving=True)
    c_spec = shd.cache_specs(cache_shape, mesh, prefer_seq=cfg.sp_decode)
    t_spec = shd.batch_specs(token_shape, mesh)
    l_spec = shd.batch_specs(_logits_shape(cfg, B), mesh)
    out_shardings = (_named(l_spec, mesh), _named(c_spec, mesh))

    def decode(params, token, cur_len, cache):
        # the model indexes the cache by the position on the host
        cur_len = int(cur_len.to_local() if is_dtensor(cur_len) else cur_len)
        with _step_ctx(mesh), torch.no_grad():
            return _outputs(zoo.decode_fn(params, cfg, token, cur_len, cache, kernel=kernel),
                            out_shardings)

    return StepBundle(
        fn=decode,
        in_shardings=(
            _named(p_spec, mesh),
            _named(t_spec, mesh),
            _named(P(), mesh),
            _named(c_spec, mesh),
        ),
        out_shardings=out_shardings,
        abstract_args=(params_shape, token_shape, len_shape, cache_shape),
        donate_argnums=(3,),
    )


def build_step(cfg: ModelConfig, mesh, shape: ShapeCell, **kw) -> StepBundle:
    if shape.kind == "train":
        return build_train_step(cfg, mesh, shape, **kw)
    if shape.kind == "prefill":
        return build_prefill_step(cfg, mesh, shape, **kw)
    return build_decode_step(cfg, mesh, shape, **kw)


# ---------------------------------------------------------------------------
# Placing arguments, and the trace of a step
# ---------------------------------------------------------------------------

def place(tree, shardings):
    """A tree of whole tensors, the same on every rank, placed as
    ``shardings``: each rank keeps its own block (``distribute_tensor``
    with no source rank: no collective; a block may share the given
    tensor's storage).  A ``DTensor`` leaf is redistributed where its
    placements differ; leaves that are not tensors pass through."""
    from torch.distributed.tensor import distribute_tensor

    def one(x, s):
        if not isinstance(x, torch.Tensor):
            return x
        if is_dtensor(x):
            return _placed(x, s)
        mesh, placements = s
        return distribute_tensor(x, mesh, placements, src_data_rank=None)

    return tree_map(one, tree, shardings)


def _local_shape(x, sharding) -> tuple[int, ...]:
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    mesh, placements = sharding
    return tuple(compute_local_shape_and_global_offset(x.shape, mesh, placements)[0])


def abstract_placed(tree, shardings):
    """Meta ``tree`` as ``DTensor`` s placed as ``shardings`` whose local
    blocks are meta tensors (nothing allocated): the arguments of a
    trace."""
    def one(x, s):
        mesh, placements = s
        return from_block(torch.empty(_local_shape(x, s), dtype=x.dtype, device=META), mesh,
                          placements, x.shape)

    return tree_map(one, tree, shardings)


def lower_step(bundle: StepBundle, mesh, *, cur_len: int = 0, observe: Callable | None = None):
    """Trace ``bundle.fn`` on its abstract arguments with nothing allocated:
    each argument a ``DTensor`` on the bundle's mesh (``mesh``, as in the
    reference's signature; a ``DeviceMesh``, as a rule over the ``"fake"``
    process group, whose collectives do nothing) whose local block is a
    meta tensor, so every operation computes shapes and dtypes only.  A decode step's position, which the model reads on the host, is
    ``cur_len``.  ``observe(args)`` returns a context manager entered around
    the call (the dry-run's counters).  Returns ``(outputs, placed
    arguments)``."""
    placed = [abstract_placed(a, s) for a, s in zip(bundle.abstract_args, bundle.in_shardings)]
    if len(placed) == 4:                    # the decode step's (params, token, cur_len, cache)
        placed[2] = cur_len
    with observe(placed) if observe is not None else contextlib.nullcontext():
        out = bundle.fn(*placed)
    return out, placed
