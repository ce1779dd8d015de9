"""RPT004 fixture: host library calls on a declared launch path."""
# repro-torch-lint: launch-path=step
import random
import time

import numpy as np
import torch


def step(x):
    t0 = time.perf_counter()
    jitter = random.random()
    host = np.cumsum(np.arange(4))
    return torch.as_tensor(host, device=x.device) + x * jitter, t0
