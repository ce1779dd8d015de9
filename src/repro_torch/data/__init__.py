"""Data pipelines of the port: synthetic token streams (training) and
request/session generators (serving), both deterministic and shardable."""
from .requests import Session, SessionTrace, generate_sessions
from .tokens import TokenPipeline, make_token_batch

__all__ = [
    "TokenPipeline",
    "make_token_batch",
    "Session",
    "SessionTrace",
    "generate_sessions",
]
