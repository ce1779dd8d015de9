"""``mfu``: the useful operations of the measured window's batches
(:func:`perfbench.arith.prefill_flops`) over its seconds, as a share of
the card's bf16 peak (layer: the model's prefill step).  None on a card
the table of peaks lacks."""
from perfbench import arith


def read(run):
    peak = arith.peaks(run.kind)
    if peak is None:
        return None
    model, batch = run.cell.model, run.cell.batch
    flops = sum(arith.prefill_flops(model, batch, b.length) for b in run.window.batches)
    return 100.0 * flops / run.window.seconds / peak["bf16_flops"]
