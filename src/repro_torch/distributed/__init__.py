"""Distributed support of the port: int8 gradient compression with error
feedback, preemption and straggler handling, the sharding rules as DTensor
placements (:mod:`.sharding`), the sharding context of model code
(:mod:`.ctx`), elastic restore onto any mesh (:mod:`.elastic`), and
:mod:`.world`, which runs a function on every rank of a world of local
processes (the provisioning engine's mesh route is
``ProvisionSpec(mesh=...)``).  The sharded step builders wait for the
dry-run launcher (ROADMAP.md, Queue 1 item F2)."""
