"""Launchers of the port: serving (``python -m repro_torch.launch.serve``)
and training (``python -m repro_torch.launch.train``), and mesh
construction (:mod:`repro_torch.launch.mesh`).  The dry-run launcher and
the sharded step builders of ``repro.launch.steps`` wait for ROADMAP.md's
Queue 1 item F2."""
