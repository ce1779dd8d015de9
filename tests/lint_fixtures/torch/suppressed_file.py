"""File-level suppression fixture."""
# repro-torch-lint: disable-file=RPT001
import torch


def a(shape):
    return torch.randn(shape)


def b(shape):
    return torch.rand(shape)
