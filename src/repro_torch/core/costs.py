"""Server-operation cost model (paper Section II-B, problem SCP).

The PyTorch port of ``repro.core.costs``.  ``CostModel`` holds host data:
``P``/``beta_on``/``beta_off`` are python scalars **or** ``(n_levels,)``
numpy arrays, so one model describes either the paper's homogeneous fleet
or a heterogeneous one (per-level server types, Albers & Quedenfeld,
PAPERS.md).  The critical interval ``delta`` is always *derived* —
Δ = (β_on + β_off) / P per level (paper eq. 12) — never passed separately,
and it is computed with the same numpy expressions as the reference, so the
two packages agree on Δ bit for bit.  :meth:`CostModel.per_level` turns the
fields into float32 tensors on the device the engine runs on.

Typed fleets (Albers & Quedenfeld, arXiv 2107.14672) are first-class:
:meth:`CostModel.from_groups` builds a model from :class:`ServerGroup`
declarations — one group per server *type*, each with its own power draw,
toggle costs and level count.  Groups are concatenated in routing-priority
order (ascending ``P`` by default, so the cheapest-to-run type takes base
load), which makes the greedy demand split implicit in the level stack:
level ``j`` of the flat model is busy iff demand exceeds ``j``, exactly the
homogeneous dispatcher compare.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Union

import numpy as np
import torch

from .stepfn import StepFn

#: a cost field: a python scalar or an ``(n_levels,)`` numpy array
CostField = Union[float, np.ndarray]


@dataclasses.dataclass(frozen=True)
class ServerGroup:
    """One server *type*: ``n_servers`` identical machines with shared costs.

    The building block of a typed fleet (Albers & Quedenfeld's *d* server
    types): ``P`` is the per-slot energy of one running server of this type,
    ``beta_on``/``beta_off`` its toggle costs, so the type's critical
    interval is Δ = (β_on + β_off) / P (paper eq. 12, per type).
    """

    name: str
    n_servers: int
    P: float = 1.0
    beta_on: float = 3.0
    beta_off: float = 3.0

    @property
    def delta(self) -> float:
        return (self.beta_on + self.beta_off) / self.P

    def validate(self) -> "ServerGroup":
        if self.n_servers < 1:
            raise ValueError(f"group {self.name!r}: n_servers must be >= 1")
        if self.P <= 0 or self.beta_on < 0 or self.beta_off < 0:
            raise ValueError(f"group {self.name!r}: need P > 0 and beta >= 0")
        return self


@dataclasses.dataclass(frozen=True, eq=False)
class CostModel:
    """P: energy per unit time per running server; beta_on/off: toggle costs.

    Each field is a scalar (homogeneous fleet) or an ``(n_levels,)`` numpy
    array (per-level server types); scalars broadcast against array fields.

    ``group_sizes``/``group_names``: optional metadata marking the level
    stack as a *typed* fleet of ``d = len(group_sizes)`` server types —
    levels ``[offset_g, offset_g + group_sizes[g])`` all belong to type
    ``g``.  Build typed models with :meth:`from_groups`; the metadata drives
    per-type cost aggregation (:meth:`group_reduce`).
    """

    P: CostField = 1.0
    beta_on: CostField = 3.0
    beta_off: CostField = 3.0
    group_sizes: tuple[int, ...] | None = None
    group_names: tuple[str, ...] | None = None

    @classmethod
    def from_groups(cls, *groups: ServerGroup, order: str | None = "energy") -> "CostModel":
        """Typed fleet from :class:`ServerGroup` declarations.

        ``order="energy"`` (default) sorts groups by ascending ``P`` (stable)
        so the cheapest-to-run type takes base load — the routing-priority
        convention that makes the greedy demand split implicit in the level
        stack.  ``order=None`` keeps the declared order (the caller asserts
        its own routing priority).
        """
        if not groups:
            raise ValueError("from_groups needs at least one ServerGroup")
        for g in groups:
            g.validate()
        names = [g.name for g in groups]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate group names: {names}")
        if order == "energy":
            groups = tuple(sorted(groups, key=lambda g: g.P))
        elif order is not None:
            raise ValueError(f"order must be 'energy' or None, got {order!r}")
        return cls(
            P=np.concatenate([np.full(g.n_servers, g.P, np.float32) for g in groups]),
            beta_on=np.concatenate(
                [np.full(g.n_servers, g.beta_on, np.float32) for g in groups]
            ),
            beta_off=np.concatenate(
                [np.full(g.n_servers, g.beta_off, np.float32) for g in groups]
            ),
            group_sizes=tuple(int(g.n_servers) for g in groups),
            group_names=tuple(g.name for g in groups),
        )

    @property
    def beta(self):
        return self.beta_on + self.beta_off

    @property
    def delta(self):
        """Critical interval Delta = (beta_on + beta_off) / P  (paper eq. 12).

        Scalar for homogeneous models, ``(n_levels,)`` for heterogeneous.
        """
        return self.beta / self.P

    @property
    def is_heterogeneous(self) -> bool:
        return any(np.ndim(f) > 0 for f in (self.P, self.beta_on, self.beta_off))

    @property
    def n_levels(self) -> int | None:
        """Fleet size the model pins down, or None for scalar models."""
        sizes = {np.shape(f)[0] for f in (self.P, self.beta_on, self.beta_off)
                 if np.ndim(f) > 0}
        if not sizes:
            return None
        if len(sizes) > 1:
            raise ValueError(f"inconsistent per-level field lengths: {sorted(sizes)}")
        return int(sizes.pop())

    @property
    def n_groups(self) -> int:
        """Number of server types d (1 for ungrouped models)."""
        return 1 if self.group_sizes is None else len(self.group_sizes)

    @property
    def group_offsets(self) -> tuple[int, ...]:
        """First level id of each group (``group_sizes`` prefix sums)."""
        if self.group_sizes is None:
            return (0,)
        return tuple(int(o) for o in np.cumsum((0,) + self.group_sizes)[:-1])

    @property
    def groups(self) -> tuple[ServerGroup, ...] | None:
        """Reconstructed :class:`ServerGroup` tuple (None when ungrouped)."""
        if self.group_sizes is None:
            return None
        self.validate_groups()
        out = []
        for name, size, off in zip(self.group_names, self.group_sizes, self.group_offsets):
            P, bon, boff = (np.asarray(f).reshape(-1) for f in
                            (self.P, self.beta_on, self.beta_off))
            out.append(ServerGroup(
                name=name, n_servers=size, P=float(P[off]),
                beta_on=float(bon[off]), beta_off=float(boff[off]),
            ))
        return tuple(out)

    def validate_groups(self) -> "CostModel":
        """Check the group metadata is consistent with the per-level arrays."""
        if self.group_sizes is None:
            return self
        if self.group_names is None or len(self.group_names) != len(self.group_sizes):
            raise ValueError(
                f"group_names {self.group_names} must name every group in "
                f"group_sizes {self.group_sizes}"
            )
        if any(int(s) < 1 for s in self.group_sizes):
            raise ValueError(f"group_sizes must all be >= 1, got {self.group_sizes}")
        n = self.n_levels
        total = int(sum(self.group_sizes))
        if n is None or n != total:
            raise ValueError(
                f"group_sizes sum to {total} but the per-level cost arrays "
                f"pin {n} levels"
            )
        return self

    def group_reduce(self, level_values: torch.Tensor) -> torch.Tensor:
        """Sum a trailing ``(..., n_levels)`` axis per group -> ``(..., d)``.

        The per-type aggregation behind ``ProvisionResult.group_cost``.
        Works on an ungrouped model too (one group spanning the whole stack).
        """
        v = torch.as_tensor(level_values)
        if self.group_sizes is None:
            return v.sum(dim=-1, keepdim=True)
        self.validate_groups()
        return torch.stack(
            [v[..., o:o + s].sum(dim=-1)
             for o, s in zip(self.group_offsets, self.group_sizes)],
            dim=-1,
        )

    def delta_slots(self) -> int:
        """Static scan bound: ceil of the largest per-level Delta (slots)."""
        return int(math.ceil(float(np.max(np.asarray(self.delta)))))

    def per_level(self, n_levels: int, device: torch.device | str = "cpu"):
        """(P, beta_on, beta_off) broadcast to ``(n_levels,)`` float32 tensors
        on ``device``."""
        own = self.n_levels
        if own is not None and own != n_levels:
            raise ValueError(
                f"cost model is pinned to {own} levels, asked for {n_levels}"
            )
        return tuple(
            torch.as_tensor(np.asarray(f, np.float32), device=device)
            .broadcast_to((n_levels,))
            for f in (self.P, self.beta_on, self.beta_off)
        )


#: The paper's experimental setting: P = 1, beta_on + beta_off = 6 => Delta = 6.
PAPER_COSTS = CostModel(P=1.0, beta_on=3.0, beta_off=3.0)


def schedule_cost(x: StepFn, costs: CostModel, *, final_level: float | None = None) -> float:
    """Total cost of a schedule x(t): P * integral(x) + toggle costs.

    ``final_level``: if given, enforce the boundary x(T) = a(T) by charging the
    final forced turn-off/on at T (paper eq. 5).  Homogeneous models only —
    a StepFn carries no per-level identity.
    """
    if costs.is_heterogeneous:
        raise ValueError("schedule_cost needs a homogeneous (scalar) CostModel")
    energy = costs.P * x.integral()
    up, down = x.switching()
    cost = energy + costs.beta_on * up + costs.beta_off * down
    if final_level is not None:
        last = x.values[-1]
        if last > final_level:
            cost += costs.beta_off * (last - final_level)
        elif last < final_level:
            cost += costs.beta_on * (final_level - last)
    return cost
