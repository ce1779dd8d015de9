"""Data pipelines of the port: the session generators that drive the
serving cluster.  ``repro.data.tokens`` (the training token streams) is
not ported yet (ROADMAP.md, Queue 1 item 11)."""
from .requests import Session, SessionTrace, generate_sessions

__all__ = [
    "Session",
    "SessionTrace",
    "generate_sessions",
]
