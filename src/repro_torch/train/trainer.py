"""Fault-tolerant training loop.

Wires together: the step (the loss, its backward pass, optional int8
gradient compression with error feedback, AdamW), deterministic
step-indexed data, async atomic checkpoints with auto-resume, preemption
handling and straggler detection.

The port of ``repro.train.trainer``, on one device (the card unless
``TrainerConfig.device`` is ``"cpu"``).  Where the reference jits a step
with ``jax.value_and_grad``, the port runs it eagerly: ``loss_fn(...,
kernel=False)`` — the reference's einsum attention, the only path either
package differentiates (kernels K3 and K4 are forward-only) — then
``loss.backward()``, then the compression and :func:`~repro_torch.optim.
adamw_update`, which writes the parameters and moments in place.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Callable

import torch

from ..checkpoint import Checkpointer, latest_step, restore
from ..configs.base import ModelConfig
from ..data.tokens import TokenPipeline
from ..distributed.compression import compress_grads, init_error_feedback
from ..distributed.fault_tolerance import PreemptionGuard, StragglerDetector
from ..launch.mesh import make_host_mesh
from ..models import model_zoo as zoo
from ..optim import AdamWConfig, adamw_update, init_adamw
from ..utils import get_logger
from ..utils.tree import tree_leaves, tree_map

log = get_logger("trainer")


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 200
    batch: int = 8
    seq: int = 128
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")
    ckpt_every: int = 50
    keep: int = 3
    log_every: int = 10
    seed: int = 0
    grad_compression: bool = False
    model_parallel: int = 1
    opt: AdamWConfig = dataclasses.field(default_factory=AdamWConfig)
    device: str = "cuda"


class Trainer:
    def __init__(self, model_cfg: ModelConfig, tcfg: TrainerConfig,
                 hooks: dict[str, Callable] | None = None):
        self.model_cfg = model_cfg
        self.tcfg = tcfg
        self.hooks = hooks or {}
        self.device = make_host_mesh(tcfg.model_parallel, tcfg.device)
        self.pipeline = TokenPipeline(model_cfg, tcfg.batch, tcfg.seq, tcfg.seed, self.device)
        self.ckpt = Checkpointer(tcfg.ckpt_dir, keep=tcfg.keep)
        self.guard = PreemptionGuard()
        self.straggler = StragglerDetector()

    def train_step(self, params, opt_state, ef_state, batch):
        """One step; returns (params, opt_state, ef_state, metrics).  The
        parameters and moments are updated in place, and each parameter's
        ``.grad`` keeps this step's gradient (before compression)."""
        cfg, tcfg = self.model_cfg, self.tcfg
        for p in tree_leaves(params):
            p.grad = None
        loss, metrics = zoo.loss_fn(params, cfg, batch, kernel=False)
        loss.backward()
        grads = tree_map(lambda p: p.grad, params)
        cmetrics = {}
        if tcfg.grad_compression:
            grads, ef_state, cmetrics = compress_grads(grads, ef_state)
        params, opt_state, omet = adamw_update(grads, opt_state, params, tcfg.opt)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return params, opt_state, ef_state, dict(metrics, loss=loss.detach(), **omet,
                                                 **cmetrics)

    def init_state(self):
        """Parameters drawn from a ``torch.Generator`` on the device, seeded
        with ``tcfg.seed``; zero AdamW and error-feedback state."""
        gen = torch.Generator(device=self.device).manual_seed(self.tcfg.seed)
        params = zoo.init_params(self.model_cfg, gen, device=self.device)
        return params, init_adamw(params), init_error_feedback(params)

    def run(self, fail_at_step: int | None = None, init=None) -> dict:
        """Train; auto-resumes from the newest checkpoint in ckpt_dir.

        ``fail_at_step`` injects a crash (tests the restart path).  ``init``
        replaces :meth:`init_state`'s ``(params, opt_state, ef_state)``, for
        example with the reference's state carried across by
        :mod:`repro_torch.convert`; a checkpoint still takes precedence.
        """
        tcfg = self.tcfg
        self.guard.install()
        params, opt_state, ef_state = self.init_state() if init is None else init
        start = 0
        last = latest_step(tcfg.ckpt_dir)
        if last is not None:
            log.info("resuming from checkpoint step %d", last)
            params, opt_state, ef_state = restore(
                tcfg.ckpt_dir, last, (params, opt_state, ef_state)
            )
            start = last
        for p in tree_leaves(params):
            p.requires_grad_(True)

        history = []
        for step in range(start, tcfg.total_steps):
            if fail_at_step is not None and step == fail_at_step:
                raise RuntimeError(f"injected failure at step {step}")
            t0 = time.monotonic()
            batch = self.pipeline.batch_at(step)
            params, opt_state, ef_state, metrics = self.train_step(
                params, opt_state, ef_state, batch
            )
            dt = time.monotonic() - t0
            self.straggler.observe(0, dt)
            if (step + 1) % tcfg.log_every == 0 or step == start:
                loss = float(metrics["loss"])
                history.append((step + 1, loss))
                log.info("step %d loss %.4f (%.2fs)", step + 1, loss, dt)
                if "on_log" in self.hooks:
                    self.hooks["on_log"](step + 1, metrics)
            if (step + 1) % tcfg.ckpt_every == 0:
                self.ckpt.save_async(step + 1, (params, opt_state, ef_state),
                                     extra={"loss": float(metrics["loss"])})
            if self.guard.should_stop():
                log.info("preemption requested: checkpointing at step %d", step + 1)
                self.ckpt.wait()
                self.ckpt.save_async(step + 1, (params, opt_state, ef_state))
                break
        self.ckpt.wait()
        final = {
            "params": params,
            "opt_state": opt_state,
            "history": history,
            "final_step": step + 1 if tcfg.total_steps > start else start,
        }
        return final
