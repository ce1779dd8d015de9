"""Competitive-ratio evaluation harness over the scenario library.

The PyTorch port of ``repro.eval``.  ``evaluate(EvalGrid(...)) ->
EvalReport``: empirical CR of every policy × scenario × noise-std × window
cell — plus the typed-fleet and deferral blocks — against the offline
optimum, checked against the paper's bounds, on the card by default.  The
report has the reference's schema (``repro.eval/v5``);
``python -m repro_torch.eval`` writes it.  ``evaluate(grid,
draws=ReferenceDraws(...))`` draws the reference's own random streams
(:mod:`.reference_draws`), so a report can equal the reference's cell for
cell.
"""
from .harness import TYPED_POLICIES, Draws, EvalGrid, evaluate
from .reference_draws import ReferenceDraws
from .report import (
    CR_QUANTILES,
    SCHEMA,
    SCHEMA_V1,
    SCHEMA_V2,
    SCHEMA_V3,
    SCHEMA_V4,
    CellResult,
    EvalReport,
    StreamingRow,
)

__all__ = [
    "CR_QUANTILES",
    "SCHEMA",
    "SCHEMA_V1",
    "SCHEMA_V2",
    "SCHEMA_V3",
    "SCHEMA_V4",
    "TYPED_POLICIES",
    "CellResult",
    "Draws",
    "EvalGrid",
    "EvalReport",
    "ReferenceDraws",
    "StreamingRow",
    "evaluate",
]
