"""Prefix fixture: the reference's `# repro-lint:` comments are not read
by the port's lint, so this finding stays active (and the reference's
lint, for its part, ignores `# repro-torch-lint:` comments)."""
import torch


def noise(shape):
    return torch.rand(shape)  # repro-lint: disable=RPT001
