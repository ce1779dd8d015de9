"""RPT005 fixture: tensor factories without a device on a declared launch
path."""
# repro-torch-lint: launch-path=step
import torch


def _mask(s):
    return torch.ones((s, s), dtype=torch.bool)


def step(x):
    pos = torch.arange(x.shape[1])
    return x * _mask(x.shape[1])[0] + pos
