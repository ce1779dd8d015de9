"""RPT002 fixture: a launch path that branches on host metadata and host
arguments only, and keeps data-dependent choices on the device."""
# repro-torch-lint: launch-path=step
import torch


def _ptrs(ts):
    return [t.data_ptr() for t in ts]


def step(x, lengths, cfg, window: int = 0, kernel: bool = True):
    b, s = x.shape[0], x.shape[1]
    if x.numel() == 0 or x.ndim != 2:
        return x
    if window > 0 and s > window:
        x = x[:, -window:]
    if kernel and x.device.type == "cuda" and lengths is not None:
        x = torch.where(lengths[:, None] > 0, x, torch.zeros_like(x))
    if "scale" in cfg:
        x = x * cfg["scale"]
    if isinstance(lengths, torch.Tensor) and len(_ptrs([x, lengths])) == 2:
        x = x + 0
    return x.reshape(b, -1)
