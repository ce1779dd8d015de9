"""RPT007 fixture: a refused call is checked to raise, and an error off the
kernel route may be handled."""
import json

from repro_torch.kernels import ops


def refused(q, k, v):
    try:
        ops.flash_attention(q, k, v, window=-1)
    except ValueError as err:
        return str(err)
    raise AssertionError("the kernel took a bad window")


def config(path):
    try:
        with open(path) as fh:
            return json.load(fh)
    except OSError:
        return {}
