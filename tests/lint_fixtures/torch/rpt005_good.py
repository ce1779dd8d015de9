"""RPT005 fixture: every factory on the launch path names its device; off
the path a host tensor is fine."""
# repro-torch-lint: launch-path=step
import torch


def step(x):
    pos = torch.arange(x.shape[1], device=x.device)
    out = torch.zeros_like(x)
    return out + pos + torch.full((1,), 2.0, dtype=x.dtype, device=x.device)


def table(n):
    return torch.arange(n)
