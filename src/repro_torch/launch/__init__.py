"""Launchers of the port: the serving launcher (``python -m
repro_torch.launch.serve``).  The dry-run, training and mesh launchers are
not ported yet (ROADMAP.md, Queue 1 item 12)."""
