"""Suppression fixture: each violation here is covered by a
`# repro-torch-lint: disable=...` comment (trailing and standalone-above
forms; the file-level form has its own fixture)."""
import torch

from repro_torch.kernels import provision_scan as kernels


def noise(shape):
    return torch.randn(shape)  # repro-torch-lint: disable=RPT001


def bump():
    # repro-torch-lint: disable=RPT006
    kernels.stream_launches += 1
