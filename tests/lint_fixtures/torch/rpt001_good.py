"""RPT001 fixture: every draw names its generator; a re-seed uses a new
seed, and a fresh generator may repeat a seed on purpose."""
import torch


def noise(shape, generator):
    return torch.randn(shape, generator=generator, device=generator.device)


def waits(x, generator):
    return x.uniform_(generator=generator)


def per_slot(shape, seed, n):
    g = torch.Generator()
    out = []
    for t in range(n):
        g.manual_seed(seed + t)
        out.append(torch.rand(shape, generator=g))
    return out


def repeat(shape, seed):
    a = torch.rand(shape, generator=torch.Generator().manual_seed(seed))
    g = torch.Generator()
    g.manual_seed(seed)
    b = torch.rand(shape, generator=g)
    return a, b
