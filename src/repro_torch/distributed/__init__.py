"""Distributed support of the port: int8 gradient compression with error
feedback, preemption and straggler handling, and :mod:`.world`, which runs
a function on every rank of a world of local processes (the provisioning
engine's mesh route is ``ProvisionSpec(mesh=...)``).  Sharding, the
collective context and elastic restore wait for the sharded step builders
(ROADMAP.md, Queue 1 item F)."""
