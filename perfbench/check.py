"""The comparison that decides ``correct``.

After the window, the reference (:mod:`perfbench.reference`) runs once
over the prompt of each sampled request.  Per request, from the float32
logits of its last position (the program's and the reference's):

* the relative distance ``||program - reference||_2 / ||reference||_2``;
* the gap by which the served token's reference logit lies below the
  reference's best, in units of the standard deviation of that request's
  reference logits;
* the excess of that gap over twice the largest distance of any one logit,
  ``max |program - reference|``, in the same units: a token that is the
  greedy pick of logits within ``d`` of the reference's lies at most ``2 d``
  below the reference's best, so this is never above 0 for a sound run,
  whatever the near-ties, and a token altered where it is made shows here.

The numbers compared are read over the sampled requests: ``logit_err``
the widest distance, ``logit_err_p75`` the distance at the 75th
percentile (nearest rank), ``token_gap`` the widest gap and
``token_excess`` the widest excess.  A cell compares the numbers its file
(``cells/<workload>.json``) gives limits for, each set from readings of
sound runs of the program and of the control (:mod:`perfbench.readings`);
``token_excess`` is exact, its limit 0.  A request is served one token
(``n_new`` 1), so each sampled request gives one served token beside its
whole row of logits.
"""
from __future__ import annotations

import math

import torch

from . import reference

NUMBERS = ("logit_err", "logit_err_p75", "token_gap", "token_excess")


def per_row(logits, tokens, ref) -> dict:
    """Each row's distance, gap and excess (lists by name), computed in
    float64; a value that is not finite counts as inf."""
    out = {"err": [], "gap": [], "excess": []}
    for row, token, want in zip(logits, tokens, ref):
        got, want = row.to(want.device, torch.float64), want.double()
        sd = want.std()
        gap = (want.max() - want[int(token)]) / sd
        out["err"].append(_finite(torch.linalg.vector_norm(got - want)
                                  / torch.linalg.vector_norm(want)))
        out["gap"].append(_finite(gap))
        out["excess"].append(_finite(gap - 2 * (got - want).abs().max() / sd))
    return out


def numbers(logits, tokens, ref) -> dict:
    """The numbers of the rows ``logits`` with served ``tokens`` against
    the reference rows ``ref``, by name."""
    rows = per_row(logits, tokens, ref)
    errs = sorted(rows["err"])
    return {"logit_err": errs[-1],
            "logit_err_p75": errs[math.ceil(0.75 * len(errs)) - 1],
            "token_gap": max(rows["gap"]),
            "token_excess": max(rows["excess"])}


def _finite(x) -> float:
    x = float(x)
    return x if math.isfinite(x) else math.inf


def verdict(found: dict, limits: dict) -> bool:
    """Every number the cell compares within its limit (one that is not
    finite fails)."""
    if not limits or not set(limits) <= set(NUMBERS):
        raise ValueError(f"a cell compares some of {NUMBERS}, got {sorted(limits)}")
    return all(found[k] <= limits[k] for k in limits)


def control(params: dict, model: dict, prompts) -> tuple[list, list]:
    """The control's logits and served tokens: the reference computed with
    float8 products (:mod:`perfbench.reference`'s ``lowp``) in the
    program's place, its own first token served."""
    rows = reference.last_logits(params, model, prompts, lowp=True)
    return rows, [int(r.argmax()) for r in rows]
