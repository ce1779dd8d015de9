"""Multi-pod dry-run: trace every (arch x shape x mesh) cell's step.

This proves the distribution config is coherent without hardware: a
sharding the rules cannot place, an operator DTensor cannot shard, and the
per-device memory of each step all surface here.  Roofline terms are
extracted from the trace (FLOPs and collectives counted per rank) and
written to reports/dryrun/.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-1b \\
      --shape train_4k [--multi-pod] [--both-meshes] [--all] [--out reports/dryrun]

The port of ``repro.launch.dryrun``.  Where the reference lowers and
compiles a cell's step on 256 or 512 host devices, :func:`run_cell` starts
a ``"fake"`` process group of 256 (512) ranks inside its own process,
builds the production mesh over it (of the CPU's device type), and
traces the full-depth step (:func:`~repro_torch.launch.steps.lower_step`:
each argument a ``DTensor`` whose local block is a meta tensor, nothing
allocated) as rank 0 sees it; the group is destroyed after, and importing
this module creates nothing.  The trace runs the plain route (the
reference's einsum attention, the path its dry-run lowers too).  Per rank,
every layer of every step is counted as it runs, so the full-depth trace
is exact and no depth extrapolation is needed (:func:`depth_period` and
:func:`with_depth` stay, for probes at a cut depth).  The one loop whose
body is traced once is sLSTM's over time (on meta tensors, a scan's body,
as the reference's cost analysis counts it):
:func:`~repro_torch.launch.roofline.slstm_correction_flops` adds its
recurrent product for every step, as the reference's table does.

* FLOPs: ``torch.utils.flop_counter``'s formulas on each local operation
  (the matrix products; elementwise work is not counted);
* collectives: the ``_c10d_functional`` operations DTensor issues, by kind
  (:func:`collective_bytes`);
* ``bytes_per_device``: ``argument`` and ``output`` are the rank's local
  blocks of the step's arguments and outputs; ``temp`` is the peak of the
  bytes allocated during the step and still live (the arguments excluded);
  ``generated_code`` is ``null``: the port compiles no program per step.

``hlo_bytes_per_device`` keeps the reference's key and is ``null``: no
trace of unfused traffic exists here, and ``launch/roofline.py`` models the
memory term (the reference reports XLA's unfused count only as an upper
bound).  The roofline constants are the H100's, named in
:mod:`repro_torch.launch.roofline`.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
import traceback
import weakref
from pathlib import Path

from ..configs import SHAPES, get_config, list_archs, runnable_cells
from .roofline import LINK_BW, PEAK_FLOPS_BF16

#: funcol operation -> the reference's collective kind (its HLO op names)
_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "broadcast",
}


def _op_name(op) -> str:
    """``_c10d_functional.all_reduce.default`` (or the op itself) ->
    ``all_reduce``."""
    name = op if isinstance(op, str) else str(op)
    name = name.split("::")[-1]
    parts = [p for p in name.split(".") if p and p not in ("default", "_c10d_functional")]
    return parts[0] if parts else name


def collective_bytes(records) -> dict[str, float]:
    """Sum the result bytes of every collective in ``records``, by kind.

    A record is ``(op, results)``: a ``_c10d_functional`` operation (or its
    name) and its result, a tensor or a list of them (a coalesced
    collective), or ``(shape, dtype)`` pairs standing for them.
    ``wait_tensor`` records are skipped, so an asynchronous collective and
    its wait are not double counted; operations that are not collectives
    count nothing.
    """
    import torch

    out: dict[str, float] = {}
    for op, results in records:
        kind = _KINDS.get(_op_name(op))
        if kind is None:
            continue
        if isinstance(results, torch.Tensor) or (
                isinstance(results, tuple) and len(results) == 2
                and isinstance(results[1], torch.dtype)):
            results = [results]
        total = 0.0
        for r in results:
            shape, dtype = (r.shape, r.dtype) if isinstance(r, torch.Tensor) else r
            total += torch.Size(shape).numel() * torch.empty((), dtype=dtype).element_size()
        out[kind] = out.get(kind, 0.0) + total
    return out


def collective_counts(records) -> dict[str, tuple[int, float]]:
    """``records``' collectives by kind: (how many, their result bytes)."""
    out: dict[str, tuple[int, float]] = {}
    for record in records:
        for kind, nbytes in collective_bytes([record]).items():
            n, total = out.get(kind, (0, 0.0))
            out[kind] = (n + 1, total + nbytes)
    return out


def depth_period(cfg) -> int:
    """Smallest layer block that repeats identically (xLSTM: sLSTM period)."""
    if cfg.family == "ssm" and cfg.slstm_every:
        return cfg.slstm_every
    return 1


def with_depth(cfg, k: int):
    if cfg.is_encdec:
        return cfg.replace(n_enc_layers=k, n_dec_layers=k, n_layers=2 * k)
    return cfg.replace(n_layers=k)


class StepCounters:
    """What a trace of a step does on one rank: FLOPs (``flops``), the
    collectives (``records``, for :func:`collective_bytes`) and the peak of
    live bytes allocated since entry (``peak_bytes``).  A dispatch mode that
    lets ``DTensor`` run first (it returns ``NotImplemented`` on a
    ``DTensor`` operation), so that it sees the local operations and
    collectives of each rank, not the global ones, and passes over the
    fake tensors DTensor infers shapes with."""

    def __init__(self):
        from torch.utils._python_dispatch import TorchDispatchMode
        from torch.utils.flop_counter import flop_registry

        counters = self

        class _Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                if any(getattr(t, "__name__", "") == "DTensor" for t in types):
                    return NotImplemented
                out = func(*args, **kwargs)
                if any(type(t).__name__ == "FakeTensor"
                       for t in (out if isinstance(out, (list, tuple)) else [out])):
                    return out          # DTensor's own shape inference, not the rank's work
                packet = getattr(func, "_overloadpacket", None)
                if packet in flop_registry:
                    counters.flops += flop_registry[packet](*args, **kwargs, out_val=out)
                if getattr(func, "namespace", "") == "_c10d_functional":
                    outs = out if isinstance(out, (list, tuple)) else [out]
                    counters.records.append(
                        (func.__name__, [(tuple(o.shape), o.dtype) for o in outs]))
                counters._track(out)
                return out

        self.flops = 0
        self.records: list = []
        self.live = self.peak_bytes = 0
        self._seen: set = set()
        self._mode = _Mode()

    def exclude(self, tree):
        """Count no storage of ``tree``'s local blocks (the arguments), nor of
        the views an operation makes of them."""
        from ..distributed.ctx import is_dtensor
        from ..utils.tree import tree_leaves

        for x in tree_leaves(tree):
            if is_dtensor(x):
                self._seen.add(id(x.to_local().untyped_storage()))

    def _track(self, out):
        import torch

        for t in out if isinstance(out, (list, tuple)) else [out]:
            if not isinstance(t, torch.Tensor) or type(t).__name__ == "DTensor":
                continue
            storage = t.untyped_storage()
            key = id(storage)
            if key in self._seen:
                continue
            self._seen.add(key)
            n = storage.nbytes()
            self.live += n
            self.peak_bytes = max(self.peak_bytes, self.live)
            weakref.finalize(storage, self._free, key, n)

    def _free(self, key, n):
        self._seen.discard(key)
        self.live -= n

    def __enter__(self):
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        return self._mode.__exit__(*exc)


def argument_bytes(bundle) -> int:
    """Bytes of this rank's blocks of the step's arguments, as
    ``in_shardings`` places them (the decode step's position too, which
    the trace passes as a number)."""
    import math

    from ..utils.tree import tree_leaves
    from .steps import _local_shape

    total = 0
    for args, shardings in zip(bundle.abstract_args, bundle.in_shardings):
        for x, s in zip(tree_leaves(args), tree_leaves(shardings)):
            total += math.prod(_local_shape(x, s)) * x.element_size()
    return total


def _local_bytes(tree) -> int:
    """Bytes of this rank's blocks of the tensors in ``tree``."""
    from ..distributed.ctx import is_dtensor
    from ..utils.tree import tree_leaves

    total = 0
    for x in tree_leaves(tree):
        if hasattr(x, "shape"):
            local = x.to_local() if is_dtensor(x) else x
            total += local.numel() * local.element_size()
    return total


@contextlib.contextmanager
def fake_world(world_size: int, rank: int = 0):
    """A ``"fake"`` process group of ``world_size`` ranks in this process,
    as rank ``rank``; destroyed on exit."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def trace_cell(cfg, shape, mesh) -> dict:
    """Trace ``cfg``'s step for ``shape`` on ``mesh`` (over a running
    group, fake as a rule) on the plain route: FLOPs, collectives and bytes
    per rank of the full-depth step, and the wall seconds of the trace."""
    from .steps import build_step, lower_step

    kw = {} if shape.kind == "train" else {"kernel": False}
    t0 = time.time()
    bundle = build_step(cfg, mesh, shape, **kw)
    counters = StepCounters()
    out, _ = lower_step(bundle, mesh, cur_len=shape.seq_len - 1,
                        observe=lambda args: (counters.exclude(args), counters)[1])
    coll = collective_bytes(counters.records)
    return {
        "seconds": time.time() - t0,
        "flops": float(counters.flops),
        "records": counters.records,
        "collectives": coll,
        "argument": argument_bytes(bundle),
        "output": _local_bytes(out),
        "temp": counters.peak_bytes,
    }


def run_cell(
    arch: str,
    shape_name: str,
    multi_pod: bool,
    out_dir: Path,
    overrides: dict | None = None,
    tag_suffix: str = "",
) -> dict:
    """One dry-run cell: a fake group of 256 (512) ranks, the production
    mesh over it, one trace of the full-depth step on the plain route;
    writes ``<arch>__<shape>__<mesh><tag_suffix>.json`` under ``out_dir``
    with the reference's keys and returns it."""
    from .mesh import make_production_mesh

    cfg = get_config(arch)
    if overrides:
        cfg = cfg.replace(**overrides)
    shape = SHAPES[shape_name]
    n_chips = 512 if multi_pod else 256

    with fake_world(n_chips):
        mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
        got = trace_cell(cfg, shape, mesh)

    flops = got["flops"]
    coll = got["collectives"]
    coll_total = sum(coll.values())
    report = {
        "arch": arch,
        "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "n_chips": n_chips,
        "compile_s": round(got["seconds"], 2),
        "depth_probe_s": 0.0,
        # per rank, from the trace
        "bytes_per_device": {
            "argument": got["argument"],
            "output": got["output"],
            "temp": got["temp"],
            "generated_code": None,
        },
        "hlo_flops_per_device": flops,
        "hlo_bytes_per_device": None,
        "collective_bytes_per_device": coll,
        "collective_total_per_device": coll_total,
        "roofline": {
            "compute_s": flops / PEAK_FLOPS_BF16,
            # no unfused byte count exists here: launch/roofline.py models
            # the memory term
            "memory_s_hlo_upper": None,
            "collective_s": coll_total / LINK_BW,
        },
    }
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = f"{arch}__{shape_name}__{report['mesh']}{tag_suffix}"
    (out_dir / f"{tag}.json").write_text(json.dumps(report, indent=2))
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true", help="every runnable cell")
    ap.add_argument("--out", default="reports/dryrun")
    args = ap.parse_args(argv)

    out_dir = Path(args.out)
    cells: list[tuple[str, str]]
    if args.all:
        cells = runnable_cells()
    else:
        archs = [args.arch] if args.arch else list_archs()
        shapes = [args.shape] if args.shape else list(SHAPES)
        cells = [
            (a, s)
            for a in archs
            for s in shapes
            if (a, s) in set(runnable_cells())
        ]

    meshes = [args.multi_pod] if not args.both_meshes else [False, True]
    failures = 0
    for arch, shape in cells:
        for mp in meshes:
            tag = f"{arch} x {shape} x {'2x16x16' if mp else '16x16'}"
            try:
                rep = run_cell(arch, shape, mp, out_dir)
                r = rep["roofline"]
                print(
                    f"OK   {tag}: trace={rep['compile_s']}s "
                    f"flops/dev={rep['hlo_flops_per_device']:.3e} "
                    f"compute={r['compute_s']:.4f}s "
                    f"coll={r['collective_s']:.4f}s",
                    flush=True,
                )
            except Exception as e:  # noqa: BLE001 — report and continue
                failures += 1
                print(f"FAIL {tag}: {type(e).__name__}: {e}", flush=True)
                traceback.print_exc()
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
