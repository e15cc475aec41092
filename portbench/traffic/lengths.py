"""Length sets for the traffic generators.

A mix states each length as a distribution (`lognormal` by its median and
sigma, or `uniform`), clipped to [min, max]. A generator draws no length at
random: it takes the distribution's quantiles at (i + 0.5) / n, a fixed set
for a given n, in an order that the mix's `schedule_seed` fixes. So every
run's seed offers the same work, and two seeds differ no more than two runs
of one.
"""

from __future__ import annotations

import math
from statistics import NormalDist

import numpy as np


def quantiles(spec: dict, n: int) -> np.ndarray:
    """n lengths at the quantiles (i + 0.5) / n of `spec`, clipped and
    rounded to whole tokens."""
    p = (np.arange(n) + 0.5) / n
    if spec["dist"] == "lognormal":
        z = np.array([NormalDist().inv_cdf(x) for x in p])
        x = spec["median"] * np.exp(spec["sigma"] * z)
    elif spec["dist"] == "uniform":
        x = spec["min"] + p * (spec["max"] - spec["min"])
    else:
        raise ValueError(f"unknown length distribution {spec['dist']!r}")
    return np.clip(np.rint(x), spec["min"], spec["max"]).astype(np.int64)


def exponential_gaps(rate: float, n: int, span: float) -> np.ndarray:
    """n gaps at the quantiles of an exponential of `rate`, scaled to sum
    to `span` seconds: a Poisson process's gaps, with the count fixed."""
    p = (np.arange(n) + 0.5) / n
    g = np.array([-math.log1p(-x) for x in p]) / rate
    return g * (span / g.sum())


def prompt_ids(rng: np.random.Generator, n: int, vocab: int) -> list:
    """n random token ids, none below 3 (the special ids of the family)."""
    return rng.integers(3, vocab, n).tolist()
