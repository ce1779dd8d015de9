"""``k3_roofline``: K3, as the model calls it
(``repro_torch.kernels.ops.flash_attention``, causal, the blocks the whole
sequence), at each (batch, prompt length) the measured window ran, timed
after the window on the held timer (:mod:`perfbench.timing`), against its
bound (:func:`perfbench.arith.attention_bound_s`), weighted by the calls
the window made: the bound's time over the kernel's (layer: the kernels).
None on a card the table of peaks lacks, or off the card."""
from collections import Counter

from perfbench import arith, timing

REPS = 10


def read(run):
    peak = arith.peaks(run.kind)
    if peak is None or run.device.type != "cuda":
        return None
    import torch

    from repro_torch.kernels import ops

    model, batch = run.cell.model, run.cell.batch
    H, KVH, hd = model["n_heads"], model["n_kv_heads"], model["head_dim"]
    calls = Counter(b.length for b in run.window.batches)
    g = torch.Generator(device=run.device)
    g.manual_seed(0)
    bound = spent = 0.0
    for seq, n in sorted(calls.items()):
        q = torch.randn((batch, seq, H, hd), generator=g, device=run.device, dtype=torch.bfloat16)
        k, v = (torch.randn((batch, seq, KVH, hd), generator=g, device=run.device,
                            dtype=torch.bfloat16) for _ in range(2))
        ms = timing.held_ms(lambda: ops.flash_attention(q, k, v, causal=True, block_q=seq,
                                                        block_k=seq), REPS)
        bound += n * arith.attention_bound_s(model, batch, seq, peak)
        spent += n * ms / 1e3
    return 100.0 * bound / spent
