"""The O(1)-state incremental stepper behind ``FleetProvisioner.advance()``.

The PyTorch port of ``repro.serving.stepper``.  The per-level ski-rental
engine state (idle-run clocks, on bits, residual wait thresholds), the
causal deferral window and the queue's age buckets are carried across calls
as an explicit :class:`StepperState`, so each ``advance(chunk)`` costs
O(chunk · levels) however long the fleet has been running.

One chunk is one call of the streaming scan at G = 1 cell
(:func:`repro_torch.kernels.provision_scan.provision_scan_stream`): on the
card one launch of kernel K2, on the CPU its plain version.  K2 already is
the stepper's step: it takes the ``(r, on, wait)`` carry in and returns it;
without a carry it applies the virtual x(0) = a(0) edge, the stepper's
``t0 == 0`` rule; its peek reads 0 past the chunk's end; and its per-lane
``run``/``up``/``down`` totals leave out the forced final off, which is the
chunk-local cost.

Semantics — *commit-as-returned*, as in the reference:

* every slot's decision is final the moment ``advance`` returns it.  The
  no-peek policies (``delayedoff``/``AQ-det``/``AQ-rand``) are therefore
  **chunk-size invariant**.  Peeking policies read the prediction window
  *within* the chunk only (past the chunk's end the peek sees quiet), so at
  ``T_chunk = 1`` they degrade to their no-peek behaviour.
* randomized policies draw the wait uniforms of slot ``t`` from a stream of
  that slot alone (:func:`slot_uniforms`, the counterpart of the
  reference's ``fold_in(key, global_slot)``), so schedules are chunk-size
  invariant and reproducible from the seed and the demand stream.  The
  ``(t0, n) -> (u0, u)`` draw is injectable, which is how the tests feed
  the reference's own draws.
* deferral uses the **causal** :func:`repro_torch.deferral.defer_stream`
  rule; queue metrics accumulate across calls through
  :func:`repro_torch.deferral.queue_stream`.

The reference pads chunks to power-of-two buckets so that its jitted step
compiles once per bucket.  K2 takes the slot count at run time and the port
compiles nothing per shape, so the port runs each chunk over exactly its
slots; the reference's pad mask only freezes the state past the chunk, so
the results are the same.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.provision import _resolve_device
from ..core.torch_provision import KEYED, NO_PEEK, STREAM_ACCS, _grid_inputs
from ..deferral import defer_stream_init, queue_stream_init
from ..kernels.provision_scan import (
    DEFAULT_T_CHUNK,
    provision_scan_stream,
    provision_scan_stream_ref,
)

#: smallest chunk bucket of the reference's jitted step
MIN_BUCKET = 8


def pow2_bucket(n: int) -> int:
    """Smallest power-of-two ≥ ``n`` (floored at :data:`MIN_BUCKET`): the
    padded slot count one compiled step of the reference serves.  Kept as
    the reference's API; the port does not pad (K2 takes the slot count at
    run time), so no stepper call of the port uses it."""
    return max(MIN_BUCKET, 1 << (int(n) - 1).bit_length())


@dataclasses.dataclass(frozen=True, eq=False)
class StepperState:
    """Everything ``advance()`` carries between calls — O(levels + slack).

    ``t``: global slot counter (how many slots have been committed).
    ``r``/``on``/``wait``: the (N,) per-level engine carry on the planner's
    device — idle-run clocks, on bits, residual wait thresholds — exactly
    the state K2 chains on.  ``defer``/``queue``: the causal-deferral and
    age-bucket queue carries (None when the planner has no deferral spec).
    """

    t: int
    r: torch.Tensor
    on: torch.Tensor
    wait: torch.Tensor
    defer: dict | None = None
    queue: dict | None = None


def stepper_init(n_levels: int, delta_lv, *, policy: str, window: int = 0,
                 deferral=None, device="cuda") -> StepperState:
    """Fresh carry on ``device`` (the card unless given ``"cpu"``; without
    CUDA the default raises): clocks at zero, everything off,
    deterministic waits pre-loaded with the static threshold — the full
    break-even timer Δ_l for the no-peek policies, ``max(0, Δ_l − w − 1)``
    for the peeking A1; randomized policies start at zero and draw theirs at
    first idle from the slot-indexed stream."""
    device = _resolve_device(device, "stepper_init")
    b = torch.as_tensor(delta_lv, dtype=torch.float32, device=device).broadcast_to((n_levels,))
    if policy in KEYED:
        wait0 = torch.zeros((n_levels,), dtype=torch.float32, device=device)
    elif policy in NO_PEEK:
        wait0 = b.clone()
    else:
        wait0 = torch.clamp(b - float(window) - 1.0, min=0.0)
    return StepperState(
        t=0,
        r=torch.zeros((n_levels,), dtype=torch.float32, device=device),
        on=torch.zeros((n_levels,), dtype=torch.bool, device=device),
        wait=wait0,
        defer=None if deferral is None else defer_stream_init(deferral.bound(), device=device),
        queue=None if deferral is None else queue_stream_init(deferral.bound(), device=device),
    )


def _slot_seed(seed: int, t: int) -> int:
    """(seed, slot) hashed into 32 bits, all that a CPU generator keeps of a
    seed."""
    return int(np.random.SeedSequence([seed % 2**64, t]).generate_state(1, np.uint32)[0])


def slot_uniforms(generator: torch.Generator, n_levels: int, device):
    """The default ``(t0, n) -> (u0, u)`` draw of a keyed policy: two (n, N)
    float32 tables whose row ``i`` is drawn on ``device`` from a generator
    of slot ``t0 + i`` alone, seeded from ``generator.initial_seed()`` and
    the slot.  The running state of ``generator`` is never read, so a slot's
    draws do not depend on how the stream was cut into chunks."""
    seed = generator.initial_seed()

    def draw(t0: int, n: int):
        u0, u = [], []
        for t in range(t0, t0 + n):
            g = torch.Generator(device=device).manual_seed(_slot_seed(seed, t))
            u0.append(torch.rand(n_levels, generator=g, device=device))
            u.append(torch.rand(n_levels, generator=g, device=device))
        return torch.stack(u0), torch.stack(u)

    return draw


def stepper_chunk(a, t0, r, on, wait, delta_lv, *, policy, n_levels, max_h, window,
                  uniforms=None, kernel=True):
    """One committed chunk of the per-level engine.

    ``a``: (n,) demand the chunk serves, on the planner's device; ``t0``:
    global slot of ``a[0]``; ``r``/``on``/``wait``: the (N,) engine carry
    in; ``delta_lv``: (N,) Δ per level; ``max_h``: the peek bound
    ``ceil(max Δ)``; ``uniforms``: the chunk's two (n, N) uniform tables
    for the keyed policies (else None).  The peek reads the chunk itself
    (the stepper's demand is already the best per-slot prediction) and
    sees quiet past its end; the thresholds, horizon and per-level reach
    are the engine's for one window.

    ``kernel=True`` runs one launch of K2 on CUDA tensors (its plain version
    on CPU tensors); ``kernel=False`` runs the plain version on any device,
    which is how the kernel route is checked on the card.

    Returns ``(x, (r, on, wait), totals)``: the (n,) int32 replica counts,
    the carry out, and the chunk's per-level ``run``/``up``/``down`` int32
    totals (toggle edges against the carried state; the virtual x(0) = a(0)
    edge applies only at ``t0 = 0``, where the carry in is not read).
    """
    a = torch.as_tensor(a).to(torch.int32).reshape(1, -1)
    dev = a.device
    delta = torch.as_tensor(delta_lv, dtype=torch.float32, device=dev).broadcast_to((n_levels,))
    if policy in KEYED:
        if uniforms is None:
            raise ValueError(f"policy {policy!r} is randomized: the chunk needs its uniforms")
        uniforms = tuple(torch.as_tensor(u, device=dev).to(torch.float32)[None]
                         for u in uniforms)
    inputs, _ = _grid_inputs(a, a[None], [int(window)], delta, uniforms, n_levels=n_levels,
                             max_h=max_h, policy=policy, uniform_waits=True)
    del inputs["delta"]
    carry = None if t0 == 0 else {"r": r[None], "on": on[None], "wait": wait[None]}
    scan = provision_scan_stream if kernel else provision_scan_stream_ref
    x, accs, out = scan(**inputs, t_chunk=DEFAULT_T_CHUNK, n_levels=n_levels, carry=carry)
    return (x[0], (out["r"][0], out["on"][0], out["wait"][0]),
            {k: accs[k][0] for k in STREAM_ACCS})
