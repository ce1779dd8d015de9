"""Distributed-training support of the port: int8 gradient compression with
error feedback, and preemption and straggler handling.  Sharding, the
collective context and elastic restore wait for the multi-device route
(ROADMAP.md, Queue 1 item F)."""
