"""One run of one cell: set-up, the measured window, the traced sub-window,
and the check of what the timed path produced.

The entry under test is ``repro_torch.serving.InferenceEngine``, built as
``python -m repro_torch.launch.serve --real-tokens`` builds it (``kernel``
on, ``max_batch`` the cell's batch, ``max_seq`` the mix's longest prompt
plus its new tokens), and driven through ``generate``'s loop,
``InferenceEngine._generate(tokens, n_new, keep_logits=True)``, so that the
logits the timed path produced are the ones judged.  One client sends the
next batch when the last returns (a closed loop).

Set-up is: load K3 and K4 (built once per checkout into the port's
``build/repro_torch_kernels``), draw the weights, build the engine, and one
batch at the mix's longest prompt.  The window then runs whole rounds of
the mix (each round every prompt length once, in the seed's order) until
the first round that ends at or after ``seconds``; it runs from the
dispatch of its first batch to the return of its last, so every batch in it
is whole, and every seed's rounds hold the same work in another order.  While it runs, a reservoir keeps the logits of
``check_requests`` requests drawn from the seed, and those of the first
request at the longest prompt.
"""
from __future__ import annotations

import dataclasses
import math
import sys
import time

import numpy as np

from . import check, manifest, reference, trace, weights
from .traffic import Schedule

#: top-level module names a run may not load: JAX and the JAX package
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro"})
#: batches the traced run profiles after its window
TRACE_BATCHES = 3


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


@dataclasses.dataclass
class Batch:
    index: int
    length: int
    start: float                # host clock at its dispatch
    end: float                  # host clock when its tokens were on the host


@dataclasses.dataclass
class Window:
    opened: float               # host clock before the first batch was made
    batches: list

    @property
    def seconds(self) -> float:
        return self.batches[-1].end - self.opened


@dataclasses.dataclass
class Sample:
    batch: int
    row: int
    length: int
    token: int
    logits: object              # the program's float32 logits (V,), on its device


class Sampler:
    """A reservoir of ``k`` requests drawn uniformly from those offered,
    with the first request at the longest prompt kept beside it."""

    def __init__(self, k: int, rng: np.random.Generator):
        self.k, self.rng = k, rng
        self.kept: list[Sample] = []
        self.longest: Sample | None = None
        self.seen = 0

    def offer(self, batch: int, length: int, tokens: np.ndarray, logits) -> None:
        for row in range(tokens.shape[0]):
            slot = len(self.kept) if len(self.kept) < self.k else int(
                self.rng.integers(0, self.seen + 1))
            self.seen += 1
            longest = self.longest is None or length > self.longest.length
            if slot >= self.k and not longest:
                continue
            # a copy of the row, so that a kept row holds no whole batch alive
            s = Sample(batch, row, length, int(tokens[row, 0]), logits[row].clone())
            if longest:
                self.longest = s
            if slot < len(self.kept):
                self.kept[slot] = s
            elif slot < self.k:
                self.kept.append(s)

    def samples(self) -> list[Sample]:
        out = list(self.kept)
        if self.longest is not None and all(s is not self.longest for s in out):
            out.append(self.longest)
        return out


@dataclasses.dataclass
class RunData:
    """What a per-layer reader reads."""

    cell: manifest.Cell
    window: Window              # the measured window
    trace: trace.Trace | None
    kind: str                   # the card's name
    device: object


def port_config(conf: dict):
    """The port's ``ModelConfig`` of a configuration file: the registry's
    entry with the file's overrides, refused where any key of the file's
    ``model`` differs from it."""
    from repro_torch.configs import get_config

    cfg = get_config(conf["registry"]).replace(**conf["overrides"])
    for key, want in conf["model"].items():
        got = getattr(cfg, key)
        got = str(got).removeprefix("torch.") if key.endswith("dtype") else got
        if got != want:
            raise ValueError(f"{conf['name']}: the port's {key} is {got!r}, the "
                             f"configuration states {want!r}")
    return cfg


def closed_loop(engine, schedule: Schedule, seconds: float, first: int = 0,
                sampler: Sampler | None = None, batches: int | None = None) -> Window:
    """Batches from ``first`` on, each sent when the last returned, until a
    round of the mix ends ``seconds`` or more after the window opened (or
    ``batches`` of them)."""
    n_new, strata = schedule.traffic.n_new, len(schedule.traffic.lengths)
    out, i = [], first
    opened = time.perf_counter()
    while True:
        tokens = schedule.tokens(i)
        t0 = time.perf_counter()
        served, logits = engine._generate(tokens, n_new, keep_logits=True)
        t1 = time.perf_counter()
        out.append(Batch(i, tokens.shape[1], t0, t1))
        if sampler is not None:
            sampler.offer(i, tokens.shape[1], served, logits[0])
        i += 1
        if (batches is not None and len(out) >= batches) or (
                batches is None and t1 - opened >= seconds and i % strata == 0):
            return Window(opened, out)


def end_to_end(cell: manifest.Cell, window: Window, setup_s: float) -> dict:
    """The end-to-end metrics by name: prompt and new tokens per second over
    the window, the 95th percentile (nearest rank) of the requests'
    latencies from their batch's dispatch to its tokens on the host, and
    the set-up seconds."""
    n_new, B = cell.traffic.n_new, cell.batch
    latencies = sorted(b.end - b.start for b in window.batches for _ in range(B))
    return {
        "tokens_per_s": sum(B * (b.length + n_new) for b in window.batches) / window.seconds,
        "latency_p95_ms": latencies[math.ceil(0.95 * len(latencies)) - 1] * 1e3,
        "setup_s": setup_s,
    }


def loaded_forbidden(modules=None) -> list[str]:
    """The :data:`FORBIDDEN` top-level names among ``modules`` (the names
    loaded in this process by default), each compared whole."""
    names = list(sys.modules) if modules is None else modules
    return sorted({name.split(".")[0] for name in names} & FORBIDDEN)


def power_limit() -> str:
    import subprocess

    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"not read ({exc})"


def build(cell: manifest.Cell, seed: int, device):
    """Set-up's work but the warm-up: TF32 off, K3 and K4 loaded on the
    card, the weights drawn, the engine built.  Returns (weights, the
    run's schedule, the engine)."""
    import torch

    from repro_torch.serving import InferenceEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if device.type == "cuda":
        from repro_torch.kernels._build import load_attention

        load_attention()
    model, traffic = cell.model, cell.traffic
    params = weights.draw(model, seed, device)
    engine = InferenceEngine(port_config(cell.config), params, max_batch=cell.batch,
                             max_seq=traffic.longest + traffic.n_new, device=device,
                             kernel=True)
    return params, Schedule(traffic, cell.batch, model["vocab_size"], seed), engine


def prompts_of(samples: list, schedule: Schedule) -> list:
    """The sampled requests' prompts, made again from the seed."""
    return [schedule.tokens(s.batch)[s.row] for s in samples]


def run(cell: manifest.Cell, seed: int, seconds: float, traced: bool, device,
        started: float) -> dict:
    """One run; returns the result line's object."""
    import torch

    device = torch.device(device)
    cuda = device.type == "cuda"
    params, schedule, engine = build(cell, seed, device)
    engine._generate(schedule.warmup_tokens(), cell.traffic.n_new, keep_logits=True)
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - started
    log(f"setup: {setup_s:.3f} s")

    sampler = Sampler(cell.check_requests, schedule.sampler_rng())
    window = closed_loop(engine, schedule, seconds, sampler=sampler)
    n_window = len(window.batches)
    log(f"window: {n_window} batches, {n_window * cell.batch} requests in "
        f"{window.seconds:.3f} s")
    profiled = None
    if traced:
        profiled = trace.profile(lambda n: closed_loop(engine, schedule, 0.0, first=n_window,
                                                       batches=n), TRACE_BATCHES)
        log(f"trace: launch API records {profiled.launch_apis}; K3 kernel records "
            f"{profiled.k3_records} of {profiled.k3_launches} K3 launches counted by the port")
    kind = torch.cuda.get_device_name(device) if cuda else "cpu"
    out_device = {"platform": "gpu" if cuda else "cpu", "kind": kind, "count": cell.chips,
                  "memory_peak_bytes": torch.cuda.max_memory_allocated(device) if cuda else 0}
    if cuda:
        log(f"card: {power_limit()}")

    if traced:
        data = RunData(cell, window, profiled, kind, device)
        metrics = {}
        for m in cell.per_layer:
            value = manifest.reader(m["name"])(data)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        out_device["busy_s"], out_device["window_s"] = profiled.busy_s, profiled.window_s
    else:
        e2e = end_to_end(cell, window, setup_s)
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    del engine

    samples = sampler.samples()
    t0 = time.perf_counter()
    ref = reference.last_logits(params, cell.model, prompts_of(samples, schedule))
    found = check.numbers([s.logits for s in samples], [s.token for s in samples], ref)
    correct = check.verdict(found, cell.limits)
    log(f"numbers: {found}")
    log(f"check: {len(samples)} requests (longest prompt {max(s.length for s in samples)}) "
        f"against the reference in {time.perf_counter() - t0:.3f} s")

    result = {"correct": correct,
              "attempted": cell.batch * (n_window + (profiled.batches if traced else 0)),
              "failed": 0, "metrics": metrics, "device": out_device}
    if traced:
        result["breakdown"] = {"device_ops": [list(x) for x in profiled.device_ops[:10]],
                               "idle_gaps": [list(x) for x in profiled.idle_gaps[:10]]}
    result["checks"] = {k: {"value": found[k], "limit": v} for k, v in cell.limits.items()}
    return result
