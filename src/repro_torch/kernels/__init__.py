"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version.  K1 (:mod:`repro_torch.kernels.provision_scan`) is the fused
provisioning scan; sources live in ``csrc/`` and are built at first use
(:mod:`repro_torch.kernels._build`)."""
