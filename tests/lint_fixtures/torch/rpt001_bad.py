"""RPT001 fixture: draws from the global generator, and one generator
re-seeded with the same seed between two draws."""
import torch


def noise(shape):
    return torch.randn(shape)


def waits(x):
    return x.uniform_()


def twice(shape, seed):
    g = torch.Generator()
    g.manual_seed(seed)
    a = torch.rand(shape, generator=g)
    g.manual_seed(seed)
    b = torch.rand(shape, generator=g)
    return a, b
