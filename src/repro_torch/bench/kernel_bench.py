"""Kernel microbenchmarks on the port: each kernel against its plain version,
the H100 rooflines of the attention kernels, K2 at production lengths, and
the one timer of K1-K4.

The twin of ``benchmarks/kernel_bench.py``, with its function names, sizes
and row names, but for the route word (``provision_bench.ROUTE_WORDS``):

* :func:`flash_roofline` and :func:`decode_roofline` use the H100 constants
  of :mod:`repro_torch.launch.roofline`; the reference's ``vmem_bytes`` is
  ``smem_bytes`` here, the shared memory K3 allocates for that head dim;
* :func:`interpret_correctness` is K3 against its plain version (row
  ``flash_256``);
* :func:`provision_grid_vs_lax_scan` is K1 against its plain version on the
  reference's (S, W, B) grid, :func:`provision_grid_routed` K1's
  group-aligned routed layout against the contiguous one, both bit for bit;
* :func:`provision_stream_long` is K2 against K1 summed over levels at an
  overlapping size, bit for bit, then K2 alone at T = 10^6 slots and over
  a 10^4-lane fleet (``full=True``; CI sizes otherwise);
* :func:`kernel_held_times` (no counterpart in the reference) times each of
  K1-K4 with :func:`repro_torch.obs.torchwatch.held_ms` at the shapes of
  PERF.md's kernel table.

On the CPU every kernel call is its plain version, and the held timer,
which needs the card, reports its rows as skipped.  A failed check raises.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..kernels import ops
from ..kernels import provision_scan as _scans
from ..kernels.flash_attention import INSTANCES, flash_attention_plain
from ..launch.roofline import HBM_BW, PEAK_FLOPS_BF16
from ..obs.torchwatch import held_ms
from . import generator, mean_us
from .provision_bench import route_word

#: stages of K3's key/value ring on the tensor cores (``kTcStages`` of
#: ``csrc/flash_attention.cu``)
K3_STAGES = 3

#: the held timer's calls per kernel, as the kernel table's CUPTI means
HELD_REPS = 20


def smem_bytes(hd: int) -> int:
    """Dynamic shared memory of one bf16 K3 block at head dim ``hd``, as
    ``launch_tc`` of ``csrc/flash_attention.cu`` sizes it: 1024 bytes of
    alignment slack, the Q tile, the key and value tiles of each stage of
    the ring, and the ring's mbarriers."""
    bq, bk = INSTANCES[torch.bfloat16][1][hd]
    return 1024 + bq * hd * 2 + 2 * K3_STAGES * bk * hd * 2 + 16 * K3_STAGES + 8


def flash_roofline(rows: list[str]) -> None:
    """Analytic roofline of the causal flash kernel on the H100, with the
    shared memory of K3's tiling."""
    for s, hd in ((4096, 128), (32768, 128)):
        flops = 4 * s * s * hd / 2          # causal
        hbm = 3 * s * hd * 2 + s * hd * 2   # q,k,v read + o write (bf16)
        t_c = flops / PEAK_FLOPS_BF16
        t_m = hbm / HBM_BW
        ai = flops / hbm
        rows.append(
            f"flash_roofline_s{s},0.0,"
            f"ai={ai:.0f};compute_us={t_c * 1e6:.1f};mem_us={t_m * 1e6:.1f};"
            f"smem_bytes={smem_bytes(hd)};bound={'compute' if t_c > t_m else 'memory'}"
        )


def decode_roofline(rows: list[str]) -> None:
    for s, kvh, hd, b in ((32768, 8, 128, 128), (524288, 5, 64, 1)):
        cache_bytes = 2 * b * s * kvh * hd * 2
        flops = 4 * b * s * kvh * hd  # q.k + p.v per kv head group
        t_m = cache_bytes / HBM_BW
        t_c = flops / PEAK_FLOPS_BF16
        rows.append(
            f"decode_roofline_s{s},0.0,"
            f"cache_gb={cache_bytes / 1e9:.2f};mem_us={t_m * 1e6:.1f};"
            f"compute_us={t_c * 1e6:.1f};bound=memory"
        )


def provision_grid_vs_lax_scan(rows: list[str], *, device="cuda") -> None:
    """Batched (S, W, B) provisioning grid: K1 (one block per (cell, level
    block)) against its plain version, the engine's slot loop, on identical
    cells — same A1 thresholds, same per-window peek horizons, bit-identical
    output (checked)."""
    S, W, B, T, N = 2, 3, 2, 256, 128
    delta, max_w = 6, 2
    rng = np.random.default_rng(0)
    ab = torch.as_tensor(rng.integers(0, N, size=(B, T)), device=device).to(torch.int32)
    pred = torch.as_tensor(
        np.stack([rng.integers(0, N, size=(B, T)) for _ in range(S)]), device=device
    ).to(torch.int32).reshape(S * B, T)
    windows = torch.arange(W, dtype=torch.float32, device=device)
    thr = torch.clamp(float(delta) - windows - 1.0, min=0.0)[:, None, None] \
        .expand(W, 1, N).contiguous()                                   # (W, 1, N)
    hor = torch.clamp(windows + 1.0, max=float(delta))[:, None].expand(W, N).contiguous()
    s_ix, w_ix, b_ix = torch.meshgrid(torch.arange(S), torch.arange(W), torch.arange(B),
                                      indexing="ij")
    cells = (b_ix.reshape(-1), (s_ix * B + b_ix).reshape(-1),
             w_ix.reshape(-1), w_ix.reshape(-1))
    kw = dict(delta=delta, horizon=max_w + 1, level_horizon=hor)

    def kernel_fn():
        return _scans.provision_scan_grid(ab, pred, thr, *cells, **kw)

    def scan_fn():
        return _scans.provision_scan_grid_ref(ab, pred, thr, *cells, **kw)

    if not torch.equal(kernel_fn(), scan_fn()):
        raise AssertionError("grid kernel K1 != its plain version")
    cells_n = S * W * B * T * N
    for word, fn in (("pallas_tpu", kernel_fn), ("lax_scan", scan_fn)):
        us = mean_us(fn, 3, device)
        rows.append(
            f"provision_grid_{route_word(word, device)}_s{S}w{W}b{B}n{N},{us:.1f},"
            f"decisions_per_s={cells_n / (us / 1e6):.3e}"
        )


def provision_grid_routed(rows: list[str], *, device="cuda") -> None:
    """Typed-fleet block packing: the same (W, B) grid through K1's
    group-aligned routed layout (route lanes, pad lanes carrying the
    sentinel id) vs the contiguous single-type layout — the routing must be
    pure lane relabeling, bit-identical after compaction (checked)."""
    from ..core.torch_provision import _group_layout

    W, B, T = 2, 2, 256
    group_sizes = (24, 40)                        # d=2 typed fleet, n=64
    n = sum(group_sizes)
    delta, max_w = 6, 2
    rng = np.random.default_rng(1)
    ab = torch.as_tensor(rng.integers(0, n, size=(B, T)), device=device).to(torch.int32)
    windows = torch.arange(W, dtype=torch.float32, device=device)
    thr1 = torch.clamp(float(delta) - windows - 1.0, min=0.0)       # (W,)
    hor1 = torch.clamp(windows + 1.0, max=float(delta))             # (W,)
    w_ix, b_ix = torch.meshgrid(torch.arange(W), torch.arange(B), indexing="ij")
    cells = (b_ix.reshape(-1), b_ix.reshape(-1), w_ix.reshape(-1), w_ix.reshape(-1))

    route_np, sel_np, n_layout = _group_layout(n, group_sizes, 1)
    sel = torch.as_tensor(sel_np, device=device)
    thr_l = torch.zeros((W, 1, n_layout), device=device)
    thr_l[:, :, sel] = thr1[:, None, None].expand(W, 1, n)
    hor_l = torch.zeros((W, n_layout), device=device)
    hor_l[:, sel] = hor1[:, None].expand(W, n)
    routes = torch.as_tensor(route_np, device=device)

    def contig():
        return _scans.provision_scan_grid(
            ab, ab, thr1[:, None, None].expand(W, 1, n).contiguous(), *cells,
            delta=delta, horizon=max_w + 1,
            level_horizon=hor1[:, None].expand(W, n).contiguous())

    def routed():
        return _scans.provision_scan_grid(
            ab, ab, thr_l, *cells, delta=delta, horizon=max_w + 1, level_horizon=hor_l,
            routes=routes)

    if not torch.equal(routed()[..., sel], contig()):
        raise AssertionError("routed grid kernel != contiguous layout")
    cells_n = W * B * T
    mode = route_word("tpu", device)
    for tag, fn, lanes in ((f"contig_{mode}", contig, n),
                           (f"routed_{mode}", routed, n_layout)):
        us = mean_us(fn, 3, device)
        rows.append(
            f"provision_grid_{tag}_w{W}b{B}n{lanes},{us:.1f},"
            f"decisions_per_s={cells_n * lanes / (us / 1e6):.3e}"
        )


def interpret_correctness(rows: list[str], *, device="cuda") -> None:
    """K3 on a small causal GQA case against its plain version on the same
    tensors (on the CPU the call is the plain version itself)."""
    gen = generator(device, 0)
    q, k, v = (torch.randn(shape, generator=gen, device=device)
               for shape in ((1, 256, 4, 64), (1, 256, 2, 64), (1, 256, 2, 64)))

    def run():
        return ops.flash_attention(q, k, v, causal=True, block_q=128, block_k=128)

    us = mean_us(run, 1, device)
    err = float((run() - flash_attention_plain(q, k, v, causal=True)).abs().max())
    rows.append(f"flash_256,{us:.1f},max_err={err:.2e}")


def provision_stream_long(rows: list[str], *, full: bool = False, device="cuda") -> None:
    """Production-length traces through the streaming kernel K2.

    One row per (T, N, layout): ``us_per_call`` plus ``decisions_per_s``,
    per-slot latency ``slot_ns`` and the working-set estimates
    ``mem_stream_bytes`` (2 trace tiles x double buffer + per-level carry)
    vs ``mem_monolithic_bytes`` (the on-matrix layout's whole-trace
    residency) — O(T_chunk) against O(T).  At the overlapping size K1 and
    K2 both run, and K2's x must equal K1's on-matrix summed over levels,
    bit for bit, before they are timed.
    """
    t_chunk = 4096
    T_cmp = 65_536 if full else 8_192
    T_long = 1_000_000 if full else 65_536
    N_wide = 10_000 if full else 2_048
    N = 128
    delta, horizon = 6, 2
    mode = route_word("tpu", device)
    rng = np.random.default_rng(7)
    z = torch.zeros((1,), dtype=torch.int32, device=device)

    def mem(T, n, tc):
        # demand + predicted rows (int32): tiles x double buffer streaming,
        # whole-trace residency monolithic; carry is per-level either way
        return 2 * 2 * tc * 4 + 3 * n * 4, 2 * T * 4

    def stream_fn(a, thr, tc):
        return lambda: _scans.provision_scan_stream(a, a, thr, z, z, z, z, horizon=horizon,
                                                    t_chunk=tc)[0]

    def draw(T, n):
        a = torch.as_tensor(rng.integers(0, n, size=(1, T)), device=device).to(torch.int32)
        return a, torch.full((1, 1, n), float(delta) - 1.0, dtype=torch.float32, device=device)

    # --- overlapping size: monolithic vs streaming, bit-exact then timed
    a, thr = draw(T_cmp, N)

    def mono():
        return _scans.provision_scan_grid(a, a, thr, z, z, z, z, delta=delta, horizon=horizon)

    strm = stream_fn(a, thr, t_chunk)
    if not torch.equal(strm(), mono().sum(-1, dtype=torch.int32)):
        raise AssertionError("streaming kernel K2 != K1 summed over levels")
    m_s, m_m = mem(T_cmp, N, t_chunk)
    for tag, fn, m in ((f"mono_{mode}", mono, m_m), (f"stream_{mode}", strm, m_s)):
        us = mean_us(fn, 3, device)
        rows.append(
            f"provision_long_{tag}_t{T_cmp}n{N},{us:.1f},"
            f"decisions_per_s={T_cmp * N / (us / 1e6):.3e};"
            f"slot_ns={us * 1e3 / T_cmp:.1f};trace_bytes={m}"
        )

    # --- streaming-only sizes the monolithic layout cannot hold
    for tag, T, n in ((f"stream_{mode}_long", T_long, N),
                      (f"stream_{mode}_wide", 8_192, N_wide)):
        a, thr = draw(T, n)
        us = mean_us(stream_fn(a, thr, t_chunk), 1, device)
        m_s, m_m = mem(T, n, t_chunk)
        rows.append(
            f"provision_long_{tag}_t{T}n{n},{us:.1f},"
            f"decisions_per_s={T * n / (us / 1e6):.3e};"
            f"slot_ns={us * 1e3 / T:.1f};"
            f"mem_stream_bytes={m_s};mem_monolithic_bytes={m_m}"
        )


#: the kernel table's shapes: K1 and K2 at the smoke fleet (N 4096 levels,
#: T 1008 slots, B 8 traces, windows 0..5, A2), K3 and K4 at yi-9b bf16
HELD_FLEET = (4096, 1008, 8, tuple(range(6)))
HELD_FLASH = (1, 4096, 32, 4, 128)          # B, S, H, KVH, hd; causal
HELD_DECODE = (16, 32768, 32, 4, 128)       # B, S, H, KVH, hd; ragged lengths
QK_STD = 1.5                                # q and k's std: peaked softmax rows
#: the held rows' names for those shapes
HELD_SHAPES = {
    "K1": "A2_codes_g{}t{}n{}".format(HELD_FLEET[2] * len(HELD_FLEET[3]), *HELD_FLEET[1::-1]),
    "K2": "A2_uniforms_g{}t{}n{}".format(HELD_FLEET[2] * len(HELD_FLEET[3]),
                                         *HELD_FLEET[1::-1]),
    "K3": "yi9b_bf16_b{}s{}h{}kv{}d{}".format(*HELD_FLASH),
    "K4": "yi9b_bf16_b{}s{}h{}kv{}d{}".format(*HELD_DECODE),
}


def _held_inputs(device):
    """Each kernel's call at :data:`HELD_SHAPES`, from seeded draws:
    ``{name: fn}``."""
    from ..core import PAPER_COSTS, msr_like_trace
    from ..core import torch_provision as engine

    n, T, B, windows = HELD_FLEET
    ab = torch.as_tensor(np.stack([
        msr_like_trace(np.random.default_rng(b), n_slots=T, mean_jobs=n / 4.0)
        for b in range(B)]), device=device).to(torch.int32)
    delta = torch.full((n,), float(PAPER_COSTS.delta), dtype=torch.float32, device=device)
    uniforms = engine._uniforms(generator(device, 0), B, T, n, device)

    def grid(uniform_waits):
        inputs, _ = engine._grid_inputs(ab, ab[None], list(windows), delta, uniforms,
                                        n_levels=n, max_h=PAPER_COSTS.delta_slots(),
                                        policy="A2", uniform_waits=uniform_waits)
        return inputs

    k1_in = grid(False)
    k2_in = grid(True)
    del k2_in["delta"]
    gen = generator(device, 0)

    def qkv(q_shape, kv_shape):
        return tuple((torch.randn(shape, generator=gen, device=device) * std)
                     .to(torch.bfloat16)
                     for shape, std in ((q_shape, QK_STD), (kv_shape, QK_STD), (kv_shape, 1.0)))

    b, s, h, kvh, hd = HELD_FLASH
    q3, k3, v3 = qkv((b, s, h, hd), (b, s, kvh, hd))
    b, s, h, kvh, hd = HELD_DECODE
    q4, k4, v4 = qkv((b, h, hd), (b, s, kvh, hd))
    lengths = torch.randint(1, s + 1, (b,), generator=gen, device=device)
    lengths[0], lengths[1] = s, 1           # one sequence full, one of length 1
    lengths = lengths.to(torch.int32)
    return {
        "K1": lambda: _scans.provision_scan_grid(**k1_in, record=True, codes=True),
        "K2": lambda: _scans.provision_scan_stream(**k2_in, t_chunk=_scans.DEFAULT_T_CHUNK),
        "K3": lambda: ops.flash_attention(q3, k3, v3, causal=True),
        "K4": lambda: ops.decode_attention(q4, k4, v4, lengths),
    }


def kernel_held_times(rows: list[str], *, device="cuda") -> None:
    """K1-K4, each timed with :func:`repro_torch.obs.torchwatch.held_ms` (the
    median of ``HELD_REPS`` calls) at the kernel table's shapes: the one
    timer whose times compare across runs.  On the CPU, where there is no
    card to hold, the rows say so."""
    if torch.device(device).type != "cuda":
        for name, shape in HELD_SHAPES.items():
            rows.append(f"kernel_held_{name}_{shape},0.0,skipped=no_cuda")
        return
    for name, fn in _held_inputs(device).items():
        ms = held_ms(fn, HELD_REPS)
        rows.append(f"kernel_held_{name}_{HELD_SHAPES[name]},{ms * 1e3:.1f},held_ms={ms:.4f}")


def sections(*, long_full: bool = False, device="cuda") -> list:
    """``(name, fn(rows))`` of each benchmark of :func:`run`, in the
    reference's order, then the held timer's."""
    return [
        ("flash_roofline", flash_roofline),
        ("decode_roofline", decode_roofline),
        ("interpret_correctness", functools.partial(interpret_correctness, device=device)),
        ("provision_grid_vs_lax_scan",
         functools.partial(provision_grid_vs_lax_scan, device=device)),
        ("provision_grid_routed", functools.partial(provision_grid_routed, device=device)),
        ("provision_stream_long",
         functools.partial(provision_stream_long, full=long_full, device=device)),
        ("kernel_held_times", functools.partial(kernel_held_times, device=device)),
    ]


def run(rows: list[str], *, long_full: bool = False, device="cuda") -> None:
    for _, fn in sections(long_full=long_full, device=device):
        fn(rows)
