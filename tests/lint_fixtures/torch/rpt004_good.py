"""RPT004 fixture: numpy dtype metadata on the launch path; host work in a
function off it."""
# repro-torch-lint: launch-path=step
import time

import numpy as np
import torch


def step(x):
    limit = np.iinfo(np.int32).max
    return torch.clamp(x, max=limit)


def timed(x):
    t0 = time.perf_counter()
    y = step(x)
    return y, time.perf_counter() - t0
