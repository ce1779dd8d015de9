"""Launchers of the port: serving (``python -m repro_torch.launch.serve``)
and training (``python -m repro_torch.launch.train``), and the one-device
mesh stub (:mod:`repro_torch.launch.mesh`).  The dry-run launcher and the
pjit step builders of ``repro.launch.steps`` wait for the multi-device
route (ROADMAP.md, Queue 1 item F)."""
