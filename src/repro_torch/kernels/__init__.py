"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version.  :mod:`repro_torch.kernels.provision_scan` holds K1, the fused
provisioning scan, and K2, its streaming twin; sources live in ``csrc/``
and are built at first use (:mod:`repro_torch.kernels._build`)."""
