"""The one traffic generator: a mix is a data file of parameters
(``traffic/<name>.json``) that this module reads.

A mix states its loop (``"closed"``: one client sends its next batch when
the last one returns), its prompt lengths (log-uniform between ``min`` and
``max``, rounded down to a multiple of ``multiple``), how many strata a
round of batches has, and the new tokens per request.  Every seed gets the
same set of lengths: a round is the ``strata`` quantiles of the length
distribution, ends included, and each round plays them in an order drawn
from the seed.  So two seeds send the same work in another order, and a
window of whole rounds holds the same mix whatever the seed.  Token ids
are uniform over the vocabulary and drawn from the seed and the batch's
index, so any batch can be made again after the window.
"""
from __future__ import annotations

import dataclasses
import json
import math
import pathlib

import numpy as np

LOOPS = ("closed",)
SPREADS = ("log-uniform",)

#: stream tags of the seed's draws, so that no two draws share a stream
ORDER, TOKENS, WARMUP, SAMPLE = 0, 1, 2, 3


@dataclasses.dataclass(frozen=True)
class Traffic:
    name: str
    lengths: tuple[int, ...]        # one round's prompt lengths, in stratum order
    n_new: int

    @property
    def longest(self) -> int:
        return max(self.lengths)

    @classmethod
    def from_file(cls, path) -> "Traffic":
        spec = json.loads(pathlib.Path(path).read_text())
        if spec.get("loop") not in LOOPS or spec.get("clients") != 1:
            raise ValueError(f"{path}: the generator runs a closed loop of one client, "
                             f"not loop={spec.get('loop')!r}, clients={spec.get('clients')!r}")
        prompt = spec["prompt"]
        if prompt.get("spread") not in SPREADS:
            raise ValueError(f"{path}: prompt spread {prompt.get('spread')!r} is not one "
                             f"of {SPREADS}")
        lo, hi, mult, strata = prompt["min"], prompt["max"], prompt["multiple"], spec["strata"]
        if not (0 < mult <= lo <= hi) or strata < 2 or spec["n_new"] < 1:
            raise ValueError(f"{path}: need 0 < multiple <= min <= max, strata >= 2 and "
                             f"n_new >= 1")
        return cls(spec["name"], log_uniform_strata(lo, hi, mult, strata), spec["n_new"])


def log_uniform_strata(lo: int, hi: int, multiple: int, strata: int) -> tuple[int, ...]:
    """``strata`` quantiles of the log-uniform law on [lo, hi], ends
    included, each rounded down to a multiple of ``multiple``."""
    span = math.log(hi) - math.log(lo)
    points = (math.exp(math.log(lo) + span * k / (strata - 1)) for k in range(strata))
    # the small nudge keeps a quantile that lands on a multiple from rounding below it
    return tuple(max(multiple, int(x * (1 + 1e-12)) // multiple * multiple) for x in points)


def _rng(seed: int, *stream: int) -> np.random.Generator:
    if seed < 0:
        raise ValueError(f"the seed is a whole number >= 0, got {seed}")
    return np.random.default_rng(np.random.SeedSequence([seed, *stream]))


class Schedule:
    """The batches of one run: batch ``i``'s prompt length and tokens."""

    def __init__(self, traffic: Traffic, batch: int, vocab: int, seed: int):
        self.traffic, self.batch, self.vocab, self.seed = traffic, batch, vocab, seed
        self._orders: dict[int, np.ndarray] = {}

    def length(self, i: int) -> int:
        strata = len(self.traffic.lengths)
        r = i // strata
        if r not in self._orders:
            self._orders[r] = _rng(self.seed, ORDER, r).permutation(strata)
        return self.traffic.lengths[self._orders[r][i % strata]]

    def tokens(self, i: int) -> np.ndarray:
        """Batch ``i``'s prompts, (batch, length) int32."""
        return _rng(self.seed, TOKENS, i).integers(
            0, self.vocab, (self.batch, self.length(i)), dtype=np.int32)

    def warmup_tokens(self) -> np.ndarray:
        """The set-up's batch, at the longest prompt of the mix."""
        return _rng(self.seed, WARMUP).integers(
            0, self.vocab, (self.batch, self.traffic.longest), dtype=np.int32)

    def sampler_rng(self) -> np.random.Generator:
        return _rng(self.seed, SAMPLE)
