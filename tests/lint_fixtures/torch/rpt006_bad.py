"""RPT006 fixture: counters written outside the modules that own them."""
import importlib

from repro_torch.kernels import _build
from repro_torch.kernels import provision_scan as kernels

flash = importlib.import_module("repro_torch.kernels.flash_attention")


def fake_launch():
    flash.flash_launches += 1
    kernels.launches = 5


def fake_build(name):
    _build.builds[name] += 1
