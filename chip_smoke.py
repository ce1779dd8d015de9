#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one NVIDIA GPU and hold its
kernels to their plain versions.

    python3 chip_smoke.py          # from the root of a checkout, one CUDA card

The main paths are ``provision(ProvisionSpec(...))`` and
``provision_stream(ProvisionSpec(...))`` of ``repro_torch`` at the size of
the largest fleet of ``benchmarks/provision_bench.py``: N = 4096
levels (servers), T = 1008 ten-minute slots (one week), B = 8 synthetic
``msr_like_trace`` demand traces with mean N/4, windows 0..5 under the
paper's costs (Δ = 6): G = 48 (window, trace) cells per online policy.
Demand and random draws are made from ``SEED``.

Phases, one line or more each:

1. device — the card's name and power limit (``nvidia-smi``); no CUDA, no run;
2. build — kernels K1 and K2 (one library) and K3 and K4 (another) from
   ``src/repro_torch/kernels/csrc``, the two builds at once (timed); then
   the attention library's SASS (``cuobjdump --dump-sass``) must hold
   ``HGMMA`` in every instance of K3's tensor-core kernel
   ``flash_wgmma_kernel`` (bf16 and fp16), and ``UTMALDG`` (TMA) or
   ``LDGSTS`` (cp.async) in each of those and in every instance of K4's
   split pass;
3. kernel — K1 against its plain PyTorch version on the card, on the inputs
   the main path gives it (A1, A2, A3, delayedoff, A2 with decision
   counters and reason codes, and a typed two-group fleet with fractional
   Δ_l), and on straddling demand (A1, and A2 with codes) that sits on the
   first and last level of blocks of 128 and changes on the slot loop's
   32-slot sub-tile boundaries: the on-matrices, counters and codes must
   be equal bit for bit (the same input tensors, so no tolerance), and the
   straddling cases must take every path of the loop; then two peeks the
   loop does not tabulate (longer than its 64 slots): A2 with codes at Δ =
   100 over 300 slots, and A2 at the longest horizon the card takes (one
   more must be refused), held to the plain version peeking the whole
   trace; the share of sub-tiles each path took; K1's device time (the
   profiler's CUPTI records, mean of 20 launches), the wrapper call's time
   and the plain version's (CUDA events, medians of 20 and 3 calls), and
   the bound, whose operations count only the updates that are not in a
   steady state (the old bound, which counts every update, beside it);
4. provision — A1, A2 and offline end to end, each call counted on its
   own: one K2 launch per online call and no K1 launch; then A2 with
   ``record_decisions``: one K1 launch and no K2 launch.  ``x``,
   ``level_cost`` and ``cost`` must equal the plain route's on the card,
   and the recorded call's ``decisions`` and ``decision_counts`` too;
   offline must cost no more than any online policy on every trace and
   window, and the mean competitive ratio must meet the paper's bound
   (plus the eval harness's 0.05 tolerance); median wall time per call;
5. breakdown — one A1, one A2 and one recorded A2 call under
   ``torch.profiler``: device busy time, K1's and K2's share, and the
   kernels that take the most;
6. stream kernel — first the uniforms route's waits (the test-only probe
   ``_uniform_waits_probe``, K2's arithmetic on every entry) against
   PyTorch's ``log1p`` route on every entry of the A2, A3 and AQ-rand
   tables of the smoke inputs, which must be equal in every bit;
   then kernel K2 against its plain version on the card, on the inputs
   ``provision_stream()`` gives it, for the cases of phase 3 plus AQ-rand,
   the keyed policies on the uniforms route and on the table route, each
   at ``t_chunk`` 512 (which leaves a part tile at the end) and at
   ``t_chunk`` = T, plus one trace cut at slot 601 with the carry threaded
   into a second call, and the two untabulated peeks of phase 3 on A3's
   uniforms route: x, every per-lane total and the carry must be equal
   bit for bit; K2's device time on each route, call time, plain time,
   bound and path shares as in phase 3;
7. provision_stream — A1, A2 and A2 with decision counters end to end
   through K2: ``x``, ``level_cost``, ``cost`` and ``decision_counts`` must
   equal ``provision()``'s bit for bit, and ``x``, ``level_cost`` and
   ``cost`` the plain route's, with one K2 launch per call and no K1
   launch; median wall time and a ``torch.profiler`` breakdown;
8. year — ``provision_stream()`` over a year of ten-minute slots
   (T = 52,560) at B = 8: A1, delayedoff and A2 (the uniforms route: its
   uniforms take 13.8 GB where the table route's waits would take 41);
   wall time, K2 launches and peak device memory of each; the uniforms
   route against the table route over the year on two traces; three cells
   held to ``provision()`` run on that cell alone, every A1 cell's cost
   against offline's within 2 - α, and A2's mean ratio within its bound.

9. flash — kernel K3 through the public wrapper
   ``repro_torch.kernels.ops.flash_attention`` (default blocks 512/512) at
   the full attention widths of three models the repo supports: yi-9b
   causal (B 1, S 4096, H 32, KVH 4, hd 128) in bf16 and in float32,
   hymba-1.5b causal with its 2048-token window (S 4096, H 25, KVH 5, hd
   64) in bf16, llama3.2-1b non-causal (S 1024, H 32, KVH 8, hd 64) in
   float32; inputs from ``SEED``, q and k at std ``QK_STD`` so that each
   softmax is peaked.  The launch count of that run, then each output
   against K3's plain version on the same tensors: every element within
   the reference's tolerance (float32 2e-5, bf16 2e-2; no TF32 anywhere)
   and every row within that tolerance of its largest value; planted faults
   (zeros, the window or the causal mask ignored) must fail that check.
   K3's device time (of the kernel the type picks: ``flash_wgmma_kernel``
   for bf16, ``flash_kernel`` for float32), the call's, the plain
   version's, the bound and what sets it, and
   ``F.scaled_dot_product_attention(..., enable_gqa=True)`` on the same
   inputs as the library yardstick, with the TFLOP/s of both and K3's share
   of the bound; then seven instances the main
   path does not reach (a ragged last tile in fp16, head dim 256 in float32
   and in bf16, a window without the causal mask in float32 and in fp16,
   hymba's window in float32, a ragged S of 500 with a window in bf16),
   each held to the plain version;
10. decode — kernel K4 (its split pass and merge) through
   ``repro_torch.kernels.ops.decode_attention`` (block_k 1024): yi-9b at
   B 16, S 32,768 in bf16 with ragged lengths from ``SEED`` (one at S, one
   at 1), hymba-1.5b's long decode (B 1, S 524,288, length S) in bf16, and
   yi-9b at B 4, S 8192 in float32 with lengths [0, 1, 4097, 8192], where
   row 0 must be exactly zero; checked, timed and bounded as in phase 9
   (TB/s in place of TFLOP/s),
   the planted faults being zeros and the second half of each sequence
   dropped; then five instances (lengths below 0 and above S in fp16, a
   query-head group of 12, head dim 256, hymba's long decode in float32, a
   group of 32 in bf16), each held to the plain version.

The line before the last is a JSON object with K1's to K4's numbers; the
last is ``{"ok": true, "device": {...}}``.  Any failure exits non-zero
before them.
"""
from __future__ import annotations

import concurrent.futures
import importlib
import json
import math
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

N_LEVELS, N_SLOTS, N_TRACES = 4096, 1008, 8
WINDOWS = list(range(6))
YEAR_SLOTS = 52560               # a year of ten-minute slots
YEAR_TABLE_TRACES = 2            # the table route's (W*B, T, N) waits at B = 8: 41 GB
STRADDLE_BLOCKS = (0, 5, 17, 31) # level blocks whose edges the straddling demand sits on
STREAM_T_CHUNK = 512             # K2's default tile; 1008 = 512 + 496
CUT = 601                        # where the chained case splits the trace
LONG_WINDOWS = [70, 99]          # a peek of 100 slots, past the loop's 64-slot table
LONG_SLOTS, LIMIT_SLOTS = 300, 80  # slots of the long-peek and the longest-peek cases
SEED = 0
HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
FP32_OPS_PER_S = 67e12           # H100 SXM data sheet, float32 outside the tensor cores
BF16_OPS_PER_S = 989e12          # H100 SXM data sheet, dense bf16 and fp16 tensor cores
OPS_PER_UPDATE = 8               # compares and selects of one (cell, slot, level) update
KERNEL_REPS, PLAIN_REPS, PROVISION_REPS = 20, 3, 3
PROFILE_ATTEMPTS = 3


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def cuda_ms(fn, reps):
    """Median milliseconds of one ``fn()`` call over ``reps`` runs, each
    between its own pair of CUDA events, after a warm-up run."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def kernel_ms(fn, reps, name="grid_scan_kernel"):
    """Mean device milliseconds per ``fn()`` call of the kernel ``name`` (or
    of the kernels of a tuple of names, each launched once a call) over
    ``reps`` calls, from the profiler's CUPTI records: the kernels' own time
    on the card, without the wrapper's host work around it.

    Without a launch before them, the profiler on the card lost one record
    in most sessions, always of the kernel a call launches first (K3, K4's
    split pass, never its merge), so each session opens with one untimed
    fill before the ``reps`` calls.  It should then hold exactly ``reps``
    records of each kernel; a session that holds another number is profiled
    again, at most ``PROFILE_ATTEMPTS`` times.  If every session lost
    records (one in 20 of K3's, in three sessions of one run), the time is
    the mean over the records the last session kept, each kernel's own,
    provided it kept at least half of them; else the run fails."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    names = (name,) if isinstance(name, str) else tuple(name)
    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILE_ATTEMPTS):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.zeros(1, device="cuda")
            torch.cuda.synchronize()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        seen = {n: sum(e.count for e in events if n in e.key) for n in names}
        if all(seen[n] == reps for n in names):
            return sum(e.self_device_time_total for e in events
                       if any(n in e.key for n in names)) / 1e3 / reps
        print(f"profiler: kept {seen} of {reps} launches each; profiling again", flush=True)
    if all(2 * seen[n] >= reps for n in names):
        print(f"profiler: timed from the {seen} records kept", flush=True)
        return sum(sum(e.self_device_time_total for e in events if n in e.key) / seen[n]
                   for n in names) / 1e3
    raise SmokeFailure(f"profiler kept {seen} of {reps} launches each in "
                       f"{PROFILE_ATTEMPTS} sessions")


def bound_ms(inputs, record, ons, stream=False):
    """Least time for a scan kernel's work on these inputs: the bytes it must
    move over the memory rate, or its operations over the float32 rate,
    whichever is larger.  Outputs: K1's one-byte on-matrix (with the counters
    and the one-byte codes under record), or K2's x, per-lane totals and
    carry.  Each input row the cells use is counted once; of the waits only
    the entries this run's demand consumes (one per lane turning idle: busy
    at t - 1, not at t), each once however many cells read it (the windows
    of a trace read the same uniforms), as table entries or, on the
    uniforms route, as one or two uniforms each.  The operations are
    ``OPS_PER_UPDATE`` for each (cell, slot, level) update that is not in a
    steady state — the lane was on at t - 1 and is not busy at t — counted
    from ``ons``, the plain version's (G, T, N) on-matrix of the same
    inputs.  Returns the bound, what sets it, and the bound that counts all
    G·T·N updates (the one of earlier runs)."""
    import torch

    from repro_torch.core.torch_provision import UniformWaits

    a, thr, cells = inputs["traces"], inputs["thresholds"], inputs["cell_trace"]
    drawn = isinstance(thr, UniformWaits)
    G, T, N = cells.shape[0], a.shape[1], (thr.span if drawn else thr).shape[-1]

    def rows(c):
        return torch.unique(c).numel()

    if stream:          # x, run/up/down (+ 4 counters), carry r/on/wait
        base = G * T * 4 + G * (7 if record else 3) * N * 4 + G * N * 9
    else:               # on-matrix (+ 4 counters and the codes)
        base = G * T * N + (G * 4 * N * 4 + G * T * N if record else 0)
    base += rows(cells) * T * 4 + 4 * G * 4 + N * 4              # demand, cell maps, routes
    base += rows(inputs["cell_hor"]) * N * 4
    if inputs["horizon"]:
        base += rows(inputs["cell_pred"]) * T * 4
    busy = a[cells.long()][:, :, None] > inputs["routes"]        # (G, T, N)
    newly = busy[:, :-1] & ~busy[:, 1:]                          # newly idle at 1 .. T - 1

    def consumed(row_of_cell):
        """Entries of the wait rows the cells read, each counted once."""
        row_of_cell = row_of_cell.to(newly.device)
        return sum(int(newly[row_of_cell == r].any(dim=0).sum())
                   for r in torch.unique(row_of_cell))

    if drawn:           # the uniforms a lane consumes, and the span (and p0) rows
        per = 2 if thr.p0 is not None else 1
        needed = consumed(thr.cell) * 4 * per + rows(inputs["cell_thr"]) * N * 4 * per
    elif thr.shape[1] == 1:
        needed = rows(inputs["cell_thr"]) * N * 4
    else:
        needed = consumed(inputs["cell_thr"]) * 4
    updates = int((ons[:, :-1] & ~busy[:, 1:]).sum())
    del busy, newly
    by_bytes = (base + needed) / HBM_BYTES_PER_S * 1e3
    by_ops = updates * OPS_PER_UPDATE / FP32_OPS_PER_S * 1e3
    kind = "bytes" if by_bytes >= by_ops else "operations"
    old = max(by_bytes, G * T * N * OPS_PER_UPDATE / FP32_OPS_PER_S * 1e3)
    return max(by_bytes, by_ops), kind, old


def path_shares(paths):
    """The share of (level block, cell, sub-tile) triples that took each path
    of the slot loop, from a kernel's path counters."""
    n = [int(v) for v in paths.tolist()]
    total = max(sum(n), 1)
    return (f"paths of {sum(n)} (block, cell, sub-tile): step {n[0] / total:.1%}, "
            f"all busy {n[1] / total:.1%}, all idle {n[2] / total:.1%}")


def straddle_demand():
    """(8, T) demand rows that sit on the edges of a block of 128 levels: at
    its first level j0 (no lane busy), j0 + 1, its last level j0 + 127 (all
    but the last lane busy), j0 + 128 (every lane busy) and one either side,
    constant over each 32-slot sub-tile of the slot loop and changing on its
    boundaries, with single-slot dips and bumps at a sub-tile's last and
    first slot.  Rows 2i and 2i + 1 take block ``STRADDLE_BLOCKS[i]``; the
    odd rows are shifted by 16 slots, so that they change inside sub-tiles."""
    import numpy as np

    offsets = (128, 0, 0, 127, 128, 1, 0, 129, 128, -1, -1, 128, 127, 127, 0)
    rows = []
    for block in STRADDLE_BLOCKS:
        j0 = block * 128
        row = np.empty(N_SLOTS, np.int64)
        for s in range(0, N_SLOTS, 32):
            row[s:s + 32] = j0 + offsets[(s // 32) % len(offsets)]
            if (s // 32) % 7 == 3:
                row[min(s + 31, N_SLOTS - 1)] -= 1
            if (s // 32) % 7 == 5:
                row[s] += 1
        row = np.clip(row, 0, None)
        rows += [row, np.roll(row, 16)]
    return np.stack(rows).astype(np.int32)


# phase 9: (name, B, S, H, KVH, hd, causal, window, dtype name)
FLASH_CASES = (
    ("yi-9b causal bf16", 1, 4096, 32, 4, 128, True, 0, "bfloat16"),
    ("yi-9b causal f32", 1, 4096, 32, 4, 128, True, 0, "float32"),
    ("hymba-1.5b causal window 2048 bf16", 1, 4096, 25, 5, 64, True, 2048, "bfloat16"),
    ("llama3.2-1b non-causal f32", 1, 1024, 32, 8, 64, False, 0, "float32"),
)
# phase 10: (name, B, S, H, KVH, hd, lengths or None to draw, dtype name)
DECODE_CASES = (
    ("yi-9b bf16", 16, 32768, 32, 4, 128, None, "bfloat16"),
    ("hymba-1.5b long decode bf16", 1, 524288, 25, 5, 64, (524288,), "bfloat16"),
    ("yi-9b f32", 4, 8192, 32, 4, 128, (0, 1, 4097, 8192), "float32"),
)
# instances and edges the main path does not reach, each held to the plain version:
# (name, B, S, H, KVH, hd, causal, window, dtype name); S = 200 leaves a ragged tile
FLASH_EDGES = (
    ("ragged S, fp16", 2, 200, 6, 2, 64, True, 0, "float16"),
    ("hd 256, MQA", 1, 512, 8, 1, 256, True, 0, "float32"),
    ("window 70, non-causal", 1, 320, 4, 4, 128, False, 70, "float32"),
    ("hymba-1.5b window 2048, f32", 1, 4096, 25, 5, 64, True, 2048, "float32"),
)
# the tensor-core kernel's other instances: hd 256 (32-key tiles), a window
# without the causal mask, and several query blocks with a ragged tail; drawn
# from a generator of their own, so that phase 10's inputs stay those of runs
# before these were added
FLASH_TC_EDGES = (
    ("hd 256, MQA, bf16", 1, 512, 8, 1, 256, True, 0, "bfloat16"),
    ("window 70, non-causal, fp16", 1, 320, 4, 4, 128, False, 70, "float16"),
    ("ragged S 500, window 300, bf16", 2, 500, 10, 5, 128, True, 300, "bfloat16"),
)
# (name, B, S, H, KVH, hd, lengths, dtype name)
DECODE_EDGES = (
    ("negative and above-S lengths, fp16", 3, 2048, 8, 2, 64, (-3, 5000, 700), "float16"),
    ("group of 12 (command-r)", 2, 4096, 24, 2, 128, (4096, 65), "float32"),
    ("hd 256, MQA", 2, 1024, 8, 1, 256, (1024, 3), "bfloat16"),
    ("hymba-1.5b long decode, f32", 1, 524288, 25, 5, 64, (524288,), "float32"),
    # bf16 with two m-tiles of 16 heads (a group of 32 at hd 64)
    ("group of 32, bf16", 2, 2048, 32, 1, 64, (2048, 100), "bfloat16"),
)
ATTENTION_TOL = {"float32": 2e-5, "bfloat16": 2e-2, "float16": 2e-2}  # the reference's
# q and k are drawn at this standard deviation, v at 1: the scores then have
# a deviation of QK_STD ** 2, so that a few per cent of the keys carry each
# softmax and a missing key, tile or window moves the output by far more
# than the tolerance of the row-relative check (``compare``)
QK_STD = 1.5


def admitted_pairs(S, causal, window):
    """(query, key) pairs the attention mask admits: key j of query i when
    j <= i (causal) and j > i - window (window > 0)."""
    import torch

    i = torch.arange(S, dtype=torch.int64)
    lo = (i - window + 1).clamp(min=0) if window > 0 else torch.zeros_like(i)
    hi = i + 1 if causal else torch.full_like(i, S)
    return int((hi - lo).clamp(min=0).sum())


def attention_bound_ms(flops, nbytes, dtype_name):
    """Least time for an attention call: its flops over the card's peak for
    the inputs' type (bf16 on the tensor cores, float32 outside them) or its
    bytes over the memory rate, whichever is larger."""
    rate = FP32_OPS_PER_S if dtype_name == "float32" else BF16_OPS_PER_S
    by_ops, by_bytes = flops / rate * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return (by_ops, "operations") if by_ops >= by_bytes else (by_bytes, "bytes")


def sass_check(library):
    """The attention library as built: every instance of K3's tensor-core
    kernel must hold ``HGMMA`` (wgmma) in its SASS, and every instance of
    it and of K4's split pass an asynchronous load, ``UTMALDG`` (TMA) or
    ``LDGSTS`` (cp.async), or the run fails.  Returns the instances counted
    of each."""
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "--dump-sass", library], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    ops = {}
    name = None
    for line in sass.splitlines():
        if "Function : " in line:
            name = line.split("Function : ")[1].strip()
            ops[name] = set()
        elif name:
            ops[name].update(op for op in ("HGMMA", "LDGSTS", "UTMALDG") if op in line)
    flash = [n for n in ops if "flash_wgmma_kernel" in n]
    split = [n for n in ops if "decode_split" in n]
    check(len(flash) == 6, f"sass: {len(flash)} instances of flash_wgmma_kernel, expected 6 "
          "(bf16 and fp16 at head dims 64, 128, 256)")
    check(split, "sass: no instance of K4's split pass")
    for n in flash:
        check("HGMMA" in ops[n], f"sass: no HGMMA in {n}")
    for n in flash + split:
        check(ops[n] & {"LDGSTS", "UTMALDG"}, f"sass: no LDGSTS or UTMALDG in {n}")
    return len(flash), len(split)


def attention_phases(smi):
    """Phases 9 and 10: K3 and K4 driven through ``repro_torch.kernels.ops``
    with their launch counts, then held to their plain versions and timed;
    returns their entries of the kernels JSON line."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops

    flash = importlib.import_module("repro_torch.kernels.flash_attention")
    decode = importlib.import_module("repro_torch.kernels.decode_attention")
    # the plain versions and the yardstick compute float32 in float32 (no TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def qkv(q_shape, kv_shape, dtype, g=gen):
        """q, k and v from ``g``: q and k at ``QK_STD``, v at 1."""
        return tuple((torch.randn(*shape, generator=g, device=dev) * std)
                     .to(getattr(torch, dtype))
                     for shape, std in ((q_shape, QK_STD), (kv_shape, QK_STD), (kv_shape, 1.0)))

    def row_err(got, want):
        """Largest |got - want| of each output row (one query head) over that
        row's largest |want|."""
        err = (got.float() - want.float()).abs().amax(dim=-1)
        return err / want.float().abs().amax(dim=-1).clamp_min(1e-30)

    def compare(got, want, dtype, what):
        """Largest absolute and row-relative differences of ``got`` from
        ``want``.  Every element must be within the reference's tolerance
        (atol = rtol = tol), and every row within tol of its largest |want|,
        so that the check scales with what it compares: a row of zeros
        passes only where the kernel's is zero."""
        check(got.shape == want.shape and got.dtype == want.dtype, f"{what}: shape/dtype")
        check(bool(torch.isfinite(got).all()), f"{what}: not finite")
        err = (got.float() - want.float()).abs()
        tol = ATTENTION_TOL[dtype]
        check(bool((err <= tol + tol * want.float().abs()).all()),
              f"{what}: kernel and plain version differ by {float(err.max())}")
        rel = float(row_err(got, want).max())
        check(rel <= tol, f"{what}: a row differs by {rel:.3e} of its largest value, above {tol}")
        return float(err.max()), rel

    def rejects(faults, want, dtype, what):
        """The check must fail on each planted fault: names of the faults and
        the row-relative error of each."""
        seen = []
        for fault, bad in faults:
            try:
                compare(bad, want, dtype, f"{what} planted {fault}")
            except SmokeFailure:
                seen.append(f"{fault} ({float(row_err(bad, want).max()):.2e})")
                continue
            raise SmokeFailure(f"{what}: the check passed a planted fault ({fault})")
        return ", ".join(seen)

    # 9. K3 through the ops entry point: the main path, counted
    t_phase = time.perf_counter()
    inputs = [qkv((b, s, h, hd), (b, s, kvh, hd), dt)
              for _, b, s, h, kvh, hd, _, _, dt in FLASH_CASES]
    torch.cuda.synchronize()
    flash.flash_launches = 0
    outs = [ops.flash_attention(q, k, v, causal=causal, window=window)
            for (q, k, v), (_, _, _, _, _, _, causal, window, _) in zip(inputs, FLASH_CASES)]
    torch.cuda.synchronize()
    k3_launches = flash.flash_launches
    check(k3_launches == len(FLASH_CASES),
          f"flash: K3 launched {k3_launches} times for {len(FLASH_CASES)} calls")
    print(f"flash: main path ran {len(FLASH_CASES)} ops.flash_attention calls with K3 "
          f"launches={k3_launches}", flush=True)
    k3 = {}
    for (q, k, v), got, case in zip(inputs, outs, FLASH_CASES):
        name, b, s, h, kvh, hd, causal, window, dt = case
        want = flash.flash_attention_plain(q, k, v, causal=causal, window=window)
        err, rel = compare(got, want, dt, f"K3 {name}")
        faults = [("zeros", torch.zeros_like(want))]
        if window:
            faults.append(("window ignored", flash.flash_attention_plain(
                q, k, v, causal=causal, window=0)))
        elif causal:
            faults.append(("causal mask ignored", flash.flash_attention_plain(
                q, k, v, causal=False)))
        rejected = rejects(faults, want, dt, f"K3 {name}")
        del want, faults

        def run(q=q, k=k, v=v, causal=causal, window=window):
            return ops.flash_attention(q, k, v, causal=causal, window=window)

        def plain(q=q, k=k, v=v, causal=causal, window=window):
            return flash.flash_attention_plain(q, k, v, causal=causal, window=window)

        mask = None
        if window:
            i = torch.arange(s, device=dev)
            mask = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - window)

        def library(q=q, k=k, v=v, mask=mask, causal=causal):
            return F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), attn_mask=mask,
                is_causal=causal and mask is None, enable_gqa=True)

        ms = kernel_ms(run, KERNEL_REPS, name=flash.k3_instance(q.dtype, hd)[0])
        call, plain_ms = cuda_ms(run, KERNEL_REPS), cuda_ms(plain, PLAIN_REPS)
        lib_ms = cuda_ms(library, KERNEL_REPS)
        pairs = admitted_pairs(s, causal, window)
        nbytes = q.element_size() * 2 * b * s * (h + kvh) * hd       # q, k, v read; out written
        bound, bound_by = attention_bound_ms(4 * b * h * hd * pairs, nbytes, dt)
        k3[name] = dict(err=err, ms=ms, plain=plain_ms, library=lib_ms, bound=bound,
                        bound_by=bound_by)
        print(f"flash: K3 {name}: {4 * b * h * hd * pairs / ms / 1e9:.1f} TFLOP/s "
              f"({bound / ms:.1%} of the bound; SDPA "
              f"{4 * b * h * hd * pairs / lib_ms / 1e9:.1f} TFLOP/s) [{smi}]", flush=True)
        print(f"flash: K3 {name}: B={b} S={s} H={h} KVH={kvh} hd={hd} causal={causal} "
              f"window={window}: close=True max_abs_err={err:.3e} max_row_rel_err={rel:.3e} "
              f"(planted faults rejected: {rejected}) kernel_ms={ms:.4f} "
              f"call_ms={call:.4f} plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} "
              f"bound_ms={bound:.4f} ({bound_by}; {4 * b * h * hd * pairs / 1e9:.2f} GFLOP) "
              f"[{smi}]", flush=True)
    del inputs, outs
    tc_gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    for edges, g in ((FLASH_EDGES, gen), (FLASH_TC_EDGES, tc_gen)):
        for name, b, s, h, kvh, hd, causal, window, dt in edges:
            q, k, v = qkv((b, s, h, hd), (b, s, kvh, hd), dt, g)
            err, rel = compare(
                flash.flash_attention(q, k, v, causal=causal, window=window),
                flash.flash_attention_plain(q, k, v, causal=causal, window=window),
                dt, f"K3 {name}")
            print(f"flash: K3 edge {name}: B={b} S={s} H={h} KVH={kvh} hd={hd} "
                  f"causal={causal} window={window}: close=True max_abs_err={err:.3e} "
                  f"max_row_rel_err={rel:.3e}", flush=True)
    print(f"flash: phase 9 took {time.perf_counter() - t_phase:.1f} s", flush=True)

    # 10. K4 through the ops entry point: the main path, counted
    t_phase = time.perf_counter()
    inputs = []
    for _, b, s, h, kvh, hd, lens, dt in DECODE_CASES:
        if lens is None:          # ragged, with one sequence full and one of length 1
            lengths = torch.randint(1, s + 1, (b,), generator=gen, device=dev)
            lengths[0], lengths[1] = s, 1
        else:
            lengths = torch.tensor(lens, device=dev)
        inputs.append(qkv((b, h, hd), (b, s, kvh, hd), dt) + (lengths.to(torch.int32),))
    torch.cuda.synchronize()
    decode.decode_launches = 0
    outs = [ops.decode_attention(*args) for args in inputs]
    torch.cuda.synchronize()
    k4_launches = decode.decode_launches
    check(k4_launches == 2 * len(DECODE_CASES),
          f"decode: K4 launched {k4_launches} times for {len(DECODE_CASES)} calls")
    print(f"decode: main path ran {len(DECODE_CASES)} ops.decode_attention calls with K4 "
          f"launches={k4_launches} (split pass and merge)", flush=True)
    k4 = {}
    for args, got, case in zip(inputs, outs, DECODE_CASES):
        name, b, s, h, kvh, hd, lens, dt = case
        q, kc, vc, lengths = args
        want = decode.decode_attention_plain(*args)
        err, rel = compare(got, want, dt, f"K4 {name}")
        empty = (lengths <= 0).nonzero().flatten().tolist()
        check(all(not got[i].any() for i in empty), f"K4 {name}: a length-0 row is not zero")
        rejected = rejects(
            [("zeros", torch.zeros_like(want)),
             ("second half of each sequence dropped",
              decode.decode_attention_plain(q, kc, vc, (lengths + 1) // 2))],
            want, dt, f"K4 {name}")
        del want
        valid = int(lengths.clamp(0, s).sum())
        mask = (torch.arange(s, device=dev)[None, :] < lengths[:, None])[:, None, None, :]

        def library(q=q, kc=kc, vc=vc, mask=mask):
            return F.scaled_dot_product_attention(
                q[:, :, None], kc.transpose(1, 2), vc.transpose(1, 2), attn_mask=mask,
                enable_gqa=True)

        def run(args=args):
            return ops.decode_attention(*args)

        ms = kernel_ms(run, KERNEL_REPS, name=("decode_split", "decode_combine_kernel"))
        call = cuda_ms(run, KERNEL_REPS)
        plain_ms = cuda_ms(lambda args=args: decode.decode_attention_plain(*args), PLAIN_REPS)
        lib_ms = cuda_ms(library, KERNEL_REPS)
        nbytes = (q.element_size() * (2 * valid * kvh * hd + 2 * b * h * hd)  # cache rows, q, out
                  + 4 * b)
        bound, bound_by = attention_bound_ms(4 * h * hd * valid, nbytes, dt)
        k4[name] = dict(err=err, ms=ms, plain=plain_ms, library=lib_ms, bound=bound,
                        bound_by=bound_by)
        print(f"decode: K4 {name}: {nbytes / ms / 1e9:.3f} TB/s ({bound / ms:.1%} of the "
              f"bound; SDPA {nbytes / lib_ms / 1e9:.3f} TB/s) [{smi}]", flush=True)
        n_split, chunk = decode.splits(b, kvh, s, torch.cuda.get_device_properties(dev)
                                       .multi_processor_count)
        print(f"decode: K4 {name}: B={b} S={s} H={h} KVH={kvh} hd={hd} valid "
              f"positions={valid} (rows of length 0: {empty}) splits={n_split}x{chunk}: "
              f"close=True max_abs_err={err:.3e} max_row_rel_err={rel:.3e} (planted faults "
              f"rejected: {rejected}) kernel_ms={ms:.4f} call_ms={call:.4f} "
              f"plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} bound_ms={bound:.4f} "
              f"({bound_by}; {nbytes / 1e9:.3f} GB) [{smi}]", flush=True)
    del inputs, outs
    for name, b, s, h, kvh, hd, lens, dt in DECODE_EDGES:
        args = qkv((b, h, hd), (b, s, kvh, hd), dt) + (torch.tensor(lens, device=dev),)
        got = decode.decode_attention(*args)
        err, rel = compare(got, decode.decode_attention_plain(*args), dt, f"K4 {name}")
        check(all(not got[i].any() for i, n in enumerate(lens) if n <= 0),
              f"K4 {name}: a row of length <= 0 is not zero")
        print(f"decode: K4 edge {name}: B={b} S={s} H={h} KVH={kvh} hd={hd} lengths={lens}: "
              f"close=True max_abs_err={err:.3e} max_row_rel_err={rel:.3e}", flush=True)
    print(f"decode: phase 10 took {time.perf_counter() - t_phase:.1f} s", flush=True)

    def entry(name, source, replaces, launches, cases, headline):
        one = cases[headline]
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches, "max_abs_err": max(c["err"] for c in cases.values()),
                "ms": one["ms"], "plain_ms": one["plain"], "bound_ms": one["bound"],
                "bound_by": one["bound_by"], "library_ms": one["library"]}

    return [entry("flash_attention", "src/repro_torch/kernels/csrc/flash_attention.cu",
                  "src/repro/kernels/flash_attention.py:94", k3_launches, k3,
                  FLASH_CASES[0][0]),
            entry("decode_attention", "src/repro_torch/kernels/csrc/decode_attention.cu",
                  "src/repro/kernels/decode_attention.py:78", k4_launches, k4,
                  DECODE_CASES[0][0])]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    import numpy as np

    from repro_torch import (
        PAPER_COSTS,
        CostModel,
        PolicySpec,
        ProvisionSpec,
        ServerGroup,
        Workload,
        msr_like_trace,
        provision,
        provision_stream,
    )
    from repro_torch.core import torch_provision as engine
    from repro_torch.kernels import provision_scan as kernels
    from repro_torch.kernels._build import load_attention, load_provision_scan

    provision_module = importlib.import_module("repro_torch.core.provision")
    dev = torch.device("cuda")

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"device: {smi} (torch {torch.__version__}, CUDA {torch.version.cuda})", flush=True)

    # 2. build: both libraries at once, each one nvcc per source
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        for build in [pool.submit(load_provision_scan), pool.submit(load_attention)]:
            build.result()
    print(f"build: K1 and K2, and K3 and K4, built from source in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    n_flash, n_split = sass_check(load_attention()._name)
    print(f"build: SASS holds HGMMA and an asynchronous load in all {n_flash} instances of "
          f"K3's flash_wgmma_kernel, and an asynchronous load in all {n_split} of K4's split "
          "pass", flush=True)

    demand = np.stack([
        msr_like_trace(np.random.default_rng(SEED + b), n_slots=N_SLOTS,
                       mean_jobs=N_LEVELS / 4.0)
        for b in range(N_TRACES)
    ])
    ab = torch.as_tensor(demand, device=dev).to(torch.int32)
    straddle = torch.as_tensor(straddle_demand(), device=dev)

    def grid_inputs(policy, costs=PAPER_COSTS, a=ab, uniform_waits=False, windows=WINDOWS):
        delta = torch.as_tensor(costs.delta, dtype=torch.float32,
                                device=dev).broadcast_to((N_LEVELS,))
        uniforms = None
        if policy in engine.KEYED:
            gen = torch.Generator(device=dev).manual_seed(SEED)
            uniforms = engine._uniforms(gen, a.shape[0], a.shape[1], N_LEVELS, dev)
        inputs, _ = engine._grid_inputs(
            a, a[None], windows, delta, uniforms, n_levels=N_LEVELS,
            max_h=costs.delta_slots(), policy=policy, uniform_waits=uniform_waits,
        )
        return inputs

    def new_paths():
        return torch.zeros(3, dtype=torch.int32, device=dev)

    # 3. kernel against plain version
    typed = CostModel.from_groups(
        ServerGroup("efficient", N_LEVELS // 2, P=1.0, beta_on=1.25, beta_off=1.25),
        ServerGroup("legacy", N_LEVELS // 2, P=2.0, beta_on=3.0, beta_off=3.0),
    )
    # (name, policy, costs, record, demand); record also asks K1 for the codes
    cases = [
        ("A1", "A1", PAPER_COSTS, False, ab),
        ("A2", "A2", PAPER_COSTS, False, ab),
        ("A3", "A3", PAPER_COSTS, False, ab),
        ("delayedoff", "delayedoff", PAPER_COSTS, False, ab),
        ("A2+record", "A2", PAPER_COSTS, True, ab),
        ("typed A1, Δ 2.5/3.0", "A1", typed, False, ab),
        ("straddle A1", "A1", PAPER_COSTS, False, straddle),
        ("straddle A2+record", "A2", PAPER_COSTS, True, straddle),
    ]
    measured = {}
    max_err = 0
    plain_ons = {}              # the plain on-matrices, for the bounds of phase 6
    for name, policy, costs, record, a in cases:
        inputs = grid_inputs(policy, costs, a)
        launched_before = kernels.launches
        paths = new_paths()
        got = kernels.provision_scan_grid(**inputs, record=record, codes=record, paths=paths)
        want = kernels.provision_scan_grid_ref(**inputs, record=record, codes=record)
        torch.cuda.synchronize()
        got, want = (got, want) if record else ((got,), (want,))
        for g, w in zip(got, want):
            check(g.shape == w.shape and g.dtype == w.dtype, f"K1 {name}: shape/dtype differ")
            max_err = max(max_err, int((g.to(torch.int32) - w.to(torch.int32)).abs().max()))
            check(torch.equal(g, w), f"K1 {name}: kernel and plain version differ")
        check(got[0].any() and not got[0].all(), f"K1 {name}: degenerate on-matrix")
        G, T, N = got[0].shape
        plain_ons[name] = want[0]
        if a is straddle:       # the edges of both skips: each path taken, nothing timed
            check(all(int(v) > 0 for v in paths.tolist()),
                  f"K1 {name}: a path of the slot loop was never taken ({paths.tolist()})")
            print(f"kernel: K1 {name}: G={G} T={T} N={N} equal=True; {path_shares(paths)}",
                  flush=True)
            continue

        def k1(inputs=inputs, record=record):
            return kernels.provision_scan_grid(**inputs, record=record, codes=record)

        ms = kernel_ms(k1, KERNEL_REPS)
        call = cuda_ms(k1, KERNEL_REPS)
        plain = cuda_ms(lambda: kernels.provision_scan_grid_ref(
            **inputs, record=record, codes=record), PLAIN_REPS)
        bound, bound_by, bound_old = bound_ms(inputs, record, want[0])
        measured[name] = (ms, plain, bound, bound_by)
        print(f"kernel: K1 {name}: G={G} T={T} N={N} horizon={inputs['horizon']} "
              f"codes={record} equal=True kernel_ms={ms:.4f} call_ms={call:.4f} "
              f"plain_ms={plain:.2f} bound_ms={bound:.4f} ({bound_by}; {bound_old:.4f} "
              f"counting every update) launches={kernels.launches - launched_before} "
              f"(check and timing); {path_shares(paths)} [{smi}]", flush=True)
        del got, want

    # peeks the loop does not tabulate (the window walked, waits loaded on
    # the chain): a horizon past its 64-slot table, and the longest horizon
    # the card takes, held to the plain version peeking the rest of the
    # trace (past T the peek reads 0, so the two agree)
    long_costs = CostModel(P=1.0, beta_on=50.0, beta_off=50.0)         # Δ = 100 slots
    scan_lib = load_provision_scan()

    def whole_trace(inputs, horizon):
        """``inputs`` with every level peeking ``horizon`` slots, and the same
        inputs peeking exactly the rest of the trace."""
        far, whole = dict(inputs), dict(inputs)
        for d, h in ((far, horizon), (whole, inputs["traces"].shape[1])):
            d["horizon"] = h
            d["level_horizon"] = torch.full_like(inputs["level_horizon"], float(h))
            if "delta" in inputs:
                d["delta"] = h
        return far, whole

    k1_limit = scan_lib.repro_provision_scan_max_horizon()
    long_inputs = grid_inputs("A2", long_costs, ab[:, :LONG_SLOTS], windows=LONG_WINDOWS)
    far, whole = whole_trace(grid_inputs("A2", a=ab[:2, :LIMIT_SLOTS]), k1_limit)
    for name, got_in, want_in in (("peek 100 A2+record", long_inputs, long_inputs),
                                  ("peek at the limit A2+record", far, whole)):
        got = kernels.provision_scan_grid(**got_in, record=True, codes=True)
        want = kernels.provision_scan_grid_ref(**want_in, record=True, codes=True)
        for g, w in zip(got, want):
            max_err = max(max_err, int((g.to(torch.int32) - w.to(torch.int32)).abs().max()))
            check(torch.equal(g, w), f"K1 {name}: kernel and plain version differ")
        check(bool((got[2] & 4).any()), f"K1 {name}: no peek fired")
        print(f"kernel: K1 {name}: G={got[0].shape[0]} T={got[0].shape[1]} "
              f"horizon={got_in['horizon']} equal=True", flush=True)
    try:
        kernels.provision_scan_grid(**whole_trace(far, k1_limit + 1)[0])
    except ValueError:
        print(f"kernel: K1 takes peeks of up to {k1_limit} slots and refuses "
              f"{k1_limit + 1}", flush=True)
    else:
        raise SmokeFailure(f"K1 took a horizon of {k1_limit + 1}, past its limit")
    del long_inputs, far, whole, got, want

    # 4. provision() end to end: the main path, counted call by call
    def spec(policy):
        gen = torch.Generator(device=dev).manual_seed(SEED)
        return ProvisionSpec(
            costs=PAPER_COSTS, workload=Workload(demand=ab),
            policy=PolicySpec(policy, windows=WINDOWS, generator=gen),
            n_levels=N_LEVELS, device=dev,
        )

    def counted(fn):
        """``fn()`` with the launch counters set to 0 just before it and read
        just after: its result, K1's launches and K2's."""
        torch.cuda.synchronize()
        kernels.launches = kernels.stream_launches = 0
        out = fn()
        torch.cuda.synchronize()
        return out, kernels.launches, kernels.stream_launches

    policies = ("A1", "A2", "offline")
    results = {}
    main_k2 = 0
    for p in policies:
        results[p], n1, n2 = counted(lambda p=p: provision(spec(p)))
        want = (0, 0) if p == "offline" else (0, 1)
        check((n1, n2) == want, f"provision({p}): K1 launched {n1} times and K2 {n2}, "
              f"expected {want[0]} and {want[1]}")
        main_k2 += n2
    recorded, main_k1, n2 = counted(lambda: provision(spec("A2"), record_decisions=True))
    check((main_k1, n2) == (1, 0), f"provision(A2, record_decisions=True): K1 launched "
          f"{main_k1} times and K2 {n2}, expected 1 and 0")
    print(f"provision: main path ran A1, A2, offline with K2 launches={main_k2} (1 per "
          f"online call) and K1 launches=0; A2 with record_decisions with K1 "
          f"launches={main_k1} and K2 launches=0", flush=True)

    W, B = len(WINDOWS), N_TRACES
    plain_results = {}
    for p in policies:
        res = results[p]
        plain = provision_module._provision(spec(p), record_decisions=False, kernel=False)
        plain_results[p] = plain
        check(tuple(res.x.shape) == (W, B, N_SLOTS) and res.x.dtype == torch.int32,
              f"provision {p}: x shape {tuple(res.x.shape)}")
        check(bool(torch.isfinite(res.cost).all()), f"provision {p}: cost not finite")
        for field in ("x", "level_cost", "cost"):
            check(torch.equal(getattr(res, field), getattr(plain, field)),
                  f"provision {p}: {field} differs from plain route")
    plain_rec = provision_module._provision(spec("A2"), record_decisions=True, kernel=False)
    check(recorded.decisions is not None and recorded.decisions.dtype == torch.uint8
          and tuple(recorded.decisions.shape) == (W, B, N_SLOTS, N_LEVELS),
          "provision(record_decisions=True): no (W, B, T, N) uint8 decisions on the card")
    check(torch.equal(recorded.decisions, plain_rec.decisions),
          "provision(record_decisions=True): decisions differ from the plain route's")
    for k, v in plain_rec.decision_counts.items():
        check(torch.equal(recorded.decision_counts[k], v),
              f"provision(record_decisions=True): decision_counts[{k}] differs")
    for field in ("x", "level_cost", "cost"):
        check(torch.equal(getattr(recorded, field), getattr(plain_rec, field))
              and torch.equal(getattr(recorded, field), getattr(results["A2"], field)),
              f"provision(A2, record_decisions=True): {field} differs from the plain "
              "route's or from the K2 route's")
    print(f"provision: x, level_cost and cost equal the plain route's bit for bit for A1, "
          f"A2, offline; A2 with record_decisions: decisions "
          f"({int((recorded.decisions != 0).sum())} nonzero codes) and decision_counts "
          "equal the plain route's too", flush=True)
    del plain_rec
    off = results["offline"].cost
    for p in ("A1", "A2"):
        check(bool((off <= results[p].cost).all()),
              f"provision: offline costs more than {p} somewhere")

    def wall_ms(fn):
        fn()
        walls = []
        for _ in range(PROVISION_REPS):
            t0 = time.perf_counter()
            fn()
            walls.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(walls)

    for p in policies:
        wall = wall_ms(lambda p=p: provision(spec(p)).x.sum().item())
        print(f"provision: {p} median wall_ms={wall:.2f} per call (G={W * B} cells) [{smi}]",
              flush=True)
    wall = wall_ms(lambda: provision(spec("A2"), record_decisions=True).x.sum().item())
    print(f"provision: A2 record_decisions median wall_ms={wall:.2f} per call [{smi}]",
          flush=True)

    # 5. where the time goes in one provision() call (torch.profiler)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def breakdown(label, fn):
        fn()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
        rows = sorted((e for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
                      key=lambda e: -e.self_device_time_total)
        if not rows:
            print(f"breakdown: {label} device time not measured (the profiler saw no "
                  "device events)", flush=True)
            return
        busy = sum(e.self_device_time_total for e in rows) / 1e3
        k1_ms = sum(e.self_device_time_total for e in rows if "grid_scan" in e.key) / 1e3
        k2_ms = sum(e.self_device_time_total for e in rows if "stream_scan" in e.key) / 1e3
        print(f"breakdown: {label} device busy {busy:.3f} ms in {len(rows)} kernels, "
              f"K1 {k1_ms:.3f} ms, K2 {k2_ms:.3f} ms [{smi}]", flush=True)
        for e in rows[:6]:
            print(f"breakdown: {label}   {e.self_device_time_total / 1e3:8.3f} ms "
                  f"x{e.count:<4d} {e.key[:80]}", flush=True)

    for p in ("A1", "A2"):
        breakdown(f"provision {p}", lambda p=p: provision(spec(p)).x.sum().item())
    breakdown("provision A2 record_decisions",
              lambda: provision(spec("A2"), record_decisions=True).x.sum().item())

    delta = float(PAPER_COSTS.delta)
    for p, bound_of in (("A1", lambda a: 2.0 - a), ("A2", lambda a: (math.e - a) / (math.e - 1))):
        cr = (results[p].cost / off).cpu().numpy()                   # (W, B)
        for i, w in enumerate(WINDOWS):
            alpha = min(1.0, (w + 1) / delta)
            bound = bound_of(alpha)
            mean = float(cr[i].mean())
            print(f"provision: {p} window={w} mean_cr={mean:.4f} max_cr={cr[i].max():.4f} "
                  f"bound={bound:.4f}", flush=True)
            check(mean <= bound + 0.05, f"provision {p} window {w}: mean CR above bound")
            if p == "A1":     # deterministic: the bound holds trace by trace
                check(bool((cr[i] <= bound + 1e-6).all()), f"A1 window {w}: CR above bound")

    # 6. K2 against its plain version on the card
    # first the uniforms route's arithmetic: its waits against the table
    # route's (PyTorch's log1p) on every entry of the smoke tables
    gen = torch.Generator(device=dev).manual_seed(SEED)
    u0, u = engine._uniforms(gen, N_TRACES, N_SLOTS, N_LEVELS, dev)
    delta_lv = torch.as_tensor(PAPER_COSTS.delta, dtype=torch.float32,
                               device=dev).broadcast_to((N_LEVELS,))
    entries = differ = 0
    for policy in ("A2", "A3", "AQ-rand"):
        span, p0 = engine._wait_rows(policy, [0] if policy == "AQ-rand" else WINDOWS, delta_lv)
        for k in range(span.shape[0]):
            row0 = None if p0 is None else p0[k]
            want = engine._waits(u0 if p0 is not None else None, u, span[k], row0)
            got = kernels._uniform_waits_probe(u0 if p0 is not None else None, u, span[k],
                                               row0)
            torch.cuda.synchronize()
            entries += want.numel()
            differ += int((got.view(torch.int32) != want.view(torch.int32)).sum())
    del got, want, u0, u
    print(f"stream kernel: uniforms route: {entries} wait entries of the A2, A3 and AQ-rand "
          f"tables, {differ} differ in any bit from PyTorch's log1p route", flush=True)
    check(differ == 0, "the uniforms route's waits differ from the table route's")

    def stream_inputs(policy, costs=PAPER_COSTS, a=ab, uniform_waits=False, windows=WINDOWS):
        inputs = grid_inputs(policy, costs, a, uniform_waits, windows)
        del inputs["delta"]                 # K2 examines `horizon` slots, no more
        return inputs

    def stream_diff(got, want, what):
        """Largest difference of K2's outputs from the plain version's; they
        must be equal."""
        (gx, gacc, gcarry), (wx, wacc, wcarry) = got, want
        pairs = [("x", gx, wx)] + [(k, gacc[k], wacc[k]) for k in wacc] \
            + [(k, gcarry[k], wcarry[k]) for k in wcarry]
        err = 0.0
        for k, g, w in pairs:
            check(g.shape == w.shape and g.dtype == w.dtype, f"K2 {what}: {k} shape/dtype")
            err = max(err, float((g.to(torch.float64) - w.to(torch.float64)).abs().max()))
            check(torch.equal(g, w), f"K2 {what}: {k} differs from the plain version")
        return err

    def timed(fn):
        """``fn()`` and its milliseconds between two CUDA events."""
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        return out, start.elapsed_time(end)

    k2_err = 0.0
    k2_measured = {}
    stream_cases = cases[:6] + [("AQ-rand", "AQ-rand", PAPER_COSTS, False, ab)] + cases[6:]
    for name, policy, costs, record, a in stream_cases:
        table = stream_inputs(policy, costs, a)
        # the route the main path takes: the uniforms route for the keyed policies
        drawn = stream_inputs(policy, costs, a, uniform_waits=True) \
            if policy in engine.KEYED else table
        launched_before = kernels.stream_launches
        ons = plain_ons.get(name)
        if ons is None:
            ons = kernels.provision_scan_grid_ref(**grid_inputs(policy, costs, a))
        for t_chunk in (STREAM_T_CHUNK, N_SLOTS):
            def k2(route=drawn, t_chunk=t_chunk, paths=None):
                return kernels.provision_scan_stream(**route, t_chunk=t_chunk, record=record,
                                                     paths=paths)
            want, plain = timed(lambda: kernels.provision_scan_stream_ref(
                **table, t_chunk=t_chunk, record=record))
            paths = new_paths()
            k2_err = max(k2_err, stream_diff(k2(paths=paths), want,
                                             f"{name} t_chunk={t_chunk}"))
            if drawn is not table:
                k2_err = max(k2_err, stream_diff(k2(route=table), want,
                                                 f"{name} table route t_chunk={t_chunk}"))
            check(want[1]["up"].sum() > 0 and want[1]["down"].sum() > 0,
                  f"K2 {name}: no level toggled")
            if a is straddle:
                check(all(int(v) > 0 for v in paths.tolist()),
                      f"K2 {name}: a path of the slot loop was never taken ({paths.tolist()})")
                print(f"stream kernel: K2 {name} t_chunk={t_chunk}: equal=True; "
                      f"{path_shares(paths)}", flush=True)
                continue
            ms = kernel_ms(k2, KERNEL_REPS, name="stream_scan_kernel")
            extra = ""          # the table route to the same waits, timed beside it
            if drawn is not table:
                table_ms = kernel_ms(lambda: k2(table), KERNEL_REPS, name="stream_scan_kernel")
                extra = f" table_route_ms={table_ms:.4f}"
            call = cuda_ms(k2, KERNEL_REPS)
            bound, bound_by, bound_old = bound_ms(drawn, record, ons, stream=True)
            if t_chunk == STREAM_T_CHUNK:
                k2_measured[name] = (ms, plain, bound, bound_by)
            route = "uniforms" if drawn is not table else "table" \
                if table["thresholds"].shape[1] != 1 else "constant row"
            print(f"stream kernel: K2 {name} t_chunk={t_chunk} ({route} route): "
                  f"G={want[0].shape[0]} T={N_SLOTS} N={N_LEVELS} horizon={table['horizon']} "
                  f"equal=True kernel_ms={ms:.4f}{extra} call_ms={call:.4f} "
                  f"plain_ms={plain:.2f} bound_ms={bound:.4f} ({bound_by}; {bound_old:.4f} "
                  f"counting every update); {path_shares(paths)} [{smi}]", flush=True)
        print(f"stream kernel: K2 {name}: launches={kernels.stream_launches - launched_before} "
              "(check and timing)", flush=True)
        del table, drawn, ons, want
    del plain_ons

    # the chained case: a trace cut mid-tile and mid-wait, the carry threaded
    inputs = stream_inputs("A2")

    def halves(sl):
        part = dict(inputs)
        for k in ("traces", "predicted", "thresholds"):
            part[k] = inputs[k][:, sl]
        return part

    first, second = halves(slice(None, CUT)), halves(slice(CUT, None))
    chained = {}
    for route, fn in (("kernel", kernels.provision_scan_stream),
                      ("plain", kernels.provision_scan_stream_ref)):
        one = fn(**first, t_chunk=STREAM_T_CHUNK, record=True)
        two = fn(**second, t_chunk=STREAM_T_CHUNK, record=True, carry=one[2])
        chained[route] = (one, two)
    k2_err = max(k2_err, stream_diff(chained["kernel"][0], chained["plain"][0],
                                     f"chained first {CUT} slots"))
    k2_err = max(k2_err, stream_diff(chained["kernel"][1], chained["plain"][1],
                                     "chained rest"))
    mid = chained["kernel"][0][2]
    mid_wait = int((mid["on"] & (mid["r"] > 0)).sum())
    check(mid_wait > 0, "K2 chained: no lane is mid-wait at the cut")
    print(f"stream kernel: K2 A2+record cut at slot {CUT} (t_chunk={STREAM_T_CHUNK}), "
          f"carry threaded: equal=True, {mid_wait} lanes mid-wait at the cut", flush=True)

    # phase 3's untabulated peeks, on A3's uniforms route (two rings when
    # tabulated); the longest horizon is the largest with a tile of 1 slot
    lo, hi = 0, 1 << 22
    while hi - lo > 1:
        mid = (lo + hi) // 2
        fits = scan_lib.repro_provision_scan_stream_max_tile(mid, 3) >= 1
        lo, hi = (mid, hi) if fits else (lo, mid)
    k2_limit = lo
    long_drawn = stream_inputs("A3", long_costs, ab[:, :LONG_SLOTS], uniform_waits=True,
                               windows=LONG_WINDOWS)
    far, whole = whole_trace(stream_inputs("A3", a=ab[:2, :LIMIT_SLOTS], uniform_waits=True),
                             k2_limit)
    for name, got_in, want_in, t_chunk in (
            ("peek 100 A3+record", long_drawn, long_drawn, 128),
            ("peek at the limit A3+record", far, whole, LIMIT_SLOTS)):
        want = kernels.provision_scan_stream_ref(**want_in, t_chunk=t_chunk, record=True)
        k2_err = max(k2_err, stream_diff(
            kernels.provision_scan_stream(**got_in, t_chunk=t_chunk, record=True), want,
            f"{name} t_chunk={t_chunk}"))
        check(int(want[1]["peek_fired"].sum()) > 0, f"K2 {name}: no peek fired")
        print(f"stream kernel: K2 {name} t_chunk={t_chunk}: G={want[0].shape[0]} "
              f"T={want[0].shape[1]} horizon={got_in['horizon']} equal=True", flush=True)
    try:
        kernels.provision_scan_stream(**whole_trace(far, k2_limit + 1)[0])
    except ValueError:
        print(f"stream kernel: K2 takes peeks of up to {k2_limit} slots on A3's uniforms "
              f"route and refuses {k2_limit + 1}", flush=True)
    else:
        raise SmokeFailure(f"K2 took a horizon of {k2_limit + 1}, past its limit")
    del long_drawn, far, whole, want

    # 7. provision_stream() end to end: the main path, counted
    stream_runs = (("A1", False), ("A2", False), ("A2", True))
    want = {(p, rec): provision(spec(p), record_decisions=rec) for p, rec in stream_runs}
    got, k1_in_stream, stream_main_launches = counted(
        lambda: {(p, rec): provision_stream(spec(p), record_decisions=rec)
                 for p, rec in stream_runs})
    check(stream_main_launches == len(stream_runs) and k1_in_stream == 0,
          f"provision_stream(): K2 launched {stream_main_launches} times and K1 "
          f"{k1_in_stream}, expected {len(stream_runs)} and 0")
    print(f"provision_stream: main path ran A1, A2, A2+record with K2 launches="
          f"{stream_main_launches}, K1 launches={k1_in_stream}", flush=True)
    for (p, rec), res in got.items():
        for ref_res, what in ((want[(p, rec)], "provision()"),
                              (plain_results[p], "the plain route")):
            for field in ("x", "level_cost", "cost"):
                check(torch.equal(getattr(res, field), getattr(ref_res, field)),
                      f"provision_stream {p}: {field} differs from {what}")
        if rec:
            for k, v in want[(p, rec)].decision_counts.items():
                check(torch.equal(res.decision_counts[k], v),
                      f"provision_stream {p}: decision_counts[{k}] differs from provision()")
    print("provision_stream: x, level_cost, cost and decision_counts equal provision()'s "
          "(K1's with record_decisions) bit for bit, and x, level_cost and cost the plain "
          "route's", flush=True)

    for p in ("A1", "A2"):
        wall = wall_ms(lambda p=p: provision_stream(spec(p)).x.sum().item())
        print(f"provision_stream: {p} median wall_ms={wall:.2f} per call (G={W * B} cells) "
              f"[{smi}]", flush=True)
        breakdown(f"provision_stream {p}", lambda p=p: provision_stream(spec(p)).x.sum().item())

    # 8. a year of ten-minute slots through provision_stream()
    del want, got, results, plain_results, chained, first, second, inputs, recorded
    year = torch.as_tensor(np.stack([
        msr_like_trace(np.random.default_rng(SEED + b), n_slots=YEAR_SLOTS,
                       mean_jobs=N_LEVELS / 4.0)
        for b in range(N_TRACES)
    ]), device=dev).to(torch.int32)

    def year_spec(policy, demand, **pol):
        return ProvisionSpec(costs=PAPER_COSTS, workload=Workload(demand=demand),
                             policy=PolicySpec(policy, **pol), n_levels=N_LEVELS,
                             device=dev)

    year_res = {}
    for p in ("A1", "delayedoff", "A2"):
        if p == "A2":       # drawn here, so that the runs before do not hold them
            gen = torch.Generator(device=dev).manual_seed(SEED)
            u_year = engine._uniforms(gen, N_TRACES, YEAR_SLOTS, N_LEVELS, dev)
            sp = year_spec(p, year, windows=WINDOWS, uniforms=u_year)
        else:
            sp = year_spec(p, year, windows=WINDOWS)
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res, n1, n2 = counted(lambda sp=sp: provision_stream(sp))
        wall = time.perf_counter() - t0
        check(n2 == 1 and n1 == 0, f"year {p}: K2 launched {n2} times, K1 {n1}")
        check(bool(torch.isfinite(res.cost).all()) and res.x.shape[-1] == YEAR_SLOTS,
              f"year {p}: bad result")
        year_res[p] = res
        n_cells = N_TRACES * (1 if p == "delayedoff" else len(WINDOWS))
        print(f"year: {p} T={YEAR_SLOTS} B={N_TRACES} G={n_cells} N={N_LEVELS}: "
              f"wall_s={wall:.3f} K2 launches={n2} "
              f"max_memory_allocated_GB={torch.cuda.max_memory_allocated() / 1e9:.2f} "
              f"(of which held before the call: {held / 1e9:.2f}) [{smi}]",
              flush=True)

    # the uniforms route against the table route over the year, on the
    # traces whose (W*B, T, N) wait tables fit
    part = year[:YEAR_TABLE_TRACES]
    args = dict(delta=delta_lv, uniforms=tuple(v[:YEAR_TABLE_TRACES] for v in u_year),
                n_levels=N_LEVELS, max_h=PAPER_COSTS.delta_slots(), policy="A2")
    runs = {}
    for route in (True, False):
        inputs, _ = engine._grid_inputs(part, part[None], WINDOWS, args["delta"],
                                        args["uniforms"], n_levels=N_LEVELS,
                                        max_h=args["max_h"], policy="A2", uniform_waits=route)
        del inputs["delta"]
        paths = new_paths()
        runs[route] = kernels.provision_scan_stream(**inputs, t_chunk=STREAM_T_CHUNK,
                                                    record=True, paths=paths)
        torch.cuda.synchronize()
        if route:
            shares = path_shares(paths)
        del inputs
    k2_err = max(k2_err, stream_diff(runs[True], runs[False], "year, uniforms route"))
    print(f"year: A2 B={YEAR_TABLE_TRACES}: the uniforms route equals the table route bit for "
          f"bit (x, every total, the carry); {shares}", flush=True)
    del runs
    torch.cuda.empty_cache()

    # three cells held to provision() run on that cell alone
    cells = (("A1", 0, 0, {}), ("A1", len(WINDOWS) - 1, N_TRACES - 1, {}),
             ("A2", 3, 1, {"uniforms": tuple(u[1] for u in u_year)}))
    for p, w, b, pol in cells:
        one = provision(year_spec(p, year[b], window=WINDOWS[w], **pol))
        res = year_res[p]
        check(torch.equal(one.x, res.x[w, b]) and torch.equal(one.level_cost,
                                                              res.level_cost[w, b]),
              f"year {p} window {WINDOWS[w]} trace {b}: differs from provision() on the cell")
        print(f"year: {p} window={WINDOWS[w]} trace={b}: x and level_cost equal "
              f"provision() on that cell alone", flush=True)
    off = torch.stack([provision(year_spec("offline", year[b])).cost
                       for b in range(N_TRACES)])                 # (B,)
    cr = (year_res["A1"].cost / off).cpu().numpy()                # (W, B)
    for i, w in enumerate(WINDOWS):
        bound = 2.0 - min(1.0, (w + 1) / float(PAPER_COSTS.delta))
        check(bool((cr[i] <= bound + 1e-6).all()), f"year A1 window {w}: CR above 2 - alpha")
        print(f"year: A1 window={w} max_cr={cr[i].max():.4f} bound={bound:.4f}", flush=True)
    cr = (year_res["A2"].cost / off).cpu().numpy()
    for i, w in enumerate(WINDOWS):
        bound = (math.e - min(1.0, (w + 1) / float(PAPER_COSTS.delta))) / (math.e - 1)
        print(f"year: A2 window={w} mean_cr={cr[i].mean():.4f} bound={bound:.4f}", flush=True)
        check(float(cr[i].mean()) <= bound + 0.05, f"year A2 window {w}: mean CR above bound")
    del year_res, u_year, year
    torch.cuda.empty_cache()

    # 9 and 10. the attention kernels K3 and K4
    attention_entries = attention_phases(smi)

    ms, plain, bound, bound_by = measured["A2+record"]
    k2_ms_a2, k2_plain, k2_bound, k2_bound_by = k2_measured["A2"]
    print(f"device: {smi}")
    print(json.dumps({"kernels": [{
        "name": "provision_scan_grid",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/provision_scan.cu",
        "replaces": "src/repro/kernels/provision_scan.py:184",
        "launches": main_k1,
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain,
        "bound_ms": bound,
        "bound_by": bound_by,
        "library_ms": None,
    }, {
        "name": "provision_scan_stream",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/provision_scan_stream.cu",
        "replaces": "src/repro/kernels/provision_scan.py:460",
        "launches": main_k2 + stream_main_launches,
        "max_abs_err": k2_err,
        "ms": k2_ms_a2,
        "plain_ms": k2_plain,
        "bound_ms": k2_bound,
        "bound_by": k2_bound_by,
        "library_ms": None,
    }] + attention_entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
