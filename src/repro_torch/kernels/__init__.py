"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version.  :mod:`repro_torch.kernels.provision_scan` holds K1, the fused
provisioning scan, and K2, its streaming twin;
:mod:`repro_torch.kernels.flash_attention` holds K3 and
:mod:`repro_torch.kernels.decode_attention` K4, behind the public wrappers
of :mod:`repro_torch.kernels.ops`.  As ``repro.kernels`` does, the package
re-exports the two attention wrappers and the provisioning scans (not
``provision_scan``, which here names the module).  Sources live in
``csrc/`` and are built at first use (:mod:`repro_torch.kernels._build`)."""
from .ops import decode_attention, flash_attention
from .provision_scan import provision_scan_grid, provision_scan_stream

__all__ = [
    "decode_attention",
    "flash_attention",
    "provision_scan_grid",
    "provision_scan_stream",
]
