"""RPT002 fixture: host syncs on a declared launch path."""
# repro-torch-lint: launch-path=step
import torch


def _count(mask):
    return int(mask.sum())


def step(x, lengths, cfg):
    n = _count(lengths > 0)
    if x.max() > 0:
        x = x - 1
    total = x.sum()
    while total > 10:
        total = total / 2
    assert lengths.all()
    last = lengths[-1].item()
    torch.cuda.synchronize()
    return x[:n], last, float(total)
