"""RPT006 fixture: a caller reads the counters and resets them to 0."""
import importlib

from repro_torch.kernels import provision_scan as kernels

flash = importlib.import_module("repro_torch.kernels.flash_attention")
decode = importlib.import_module("repro_torch.kernels.decode_attention")


def counted(fn):
    flash.flash_launches = decode.decode_launches = 0
    kernels.launches = kernels.stream_launches = 0
    fn()
    return flash.flash_launches, decode.decode_launches, kernels.stream_launches


class Tally:
    def __init__(self):
        self.launches = 0

    def add(self):
        self.launches += 1
