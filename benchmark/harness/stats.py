"""The arithmetic every cell shares: open-loop schedules, latencies
from the due time, percentiles and rates."""

from __future__ import annotations

import math
import time
from typing import Dict, List, Sequence

import numpy as np


def rng_of(seed: int, stream: int = 0) -> np.random.Generator:
    """A generator for one purpose of one run: the same seed and stream
    give the same draws. Any integer seed, however large, is taken."""
    return np.random.default_rng([abs(int(seed)), int(seed < 0), stream])


def shuffled_quantiles(n: int, rng) -> np.ndarray:
    """The n mid-quantiles (i + 0.5) / n, in an order drawn from
    ``rng``: every seed gets the same set of draws in another order,
    so seeds change the arrangement of the work and not its size."""
    return rng.permutation((np.arange(n) + 0.5) / n)


def poisson_due(rate: float, seconds: float, rng) -> np.ndarray:
    """Due times of an open loop of ``rate`` requests a second over
    ``seconds``: round(rate * seconds) exponential gaps, the same set
    for every seed in a seeded order, scaled so that they sum to the
    window: the first request is due at 0, the rate is exact."""
    n = max(1, int(round(rate * seconds)))
    gaps = -np.log1p(-shuffled_quantiles(n, rng))
    return (np.cumsum(gaps) - gaps) * (seconds / gaps.sum())


def poisson_mix(rate: float, seconds: float, shares, rng):
    """An open loop of ``rate`` requests a second over ``seconds`` whose
    kinds 0, 1, ... take the ``shares`` of it: each kind its own
    :func:`poisson_due` stream at ``rate * share`` (the superposition
    of Poisson streams is Poisson at the sum), merged in due order.
    Every seed gets the same gaps between requests of one kind, so a
    seed moves neither how many writes arrive nor how closely they
    follow one another, only their arrangement. Returns (due, kind)."""
    due, kind = [], []
    for k, share in enumerate(shares):
        if share > 0:
            d = poisson_due(rate * share, seconds, rng)
            due.append(d)
            kind.append(np.full(len(d), k, np.int64))
    due, kind = np.concatenate(due), np.concatenate(kind)
    order = np.argsort(due, kind="stable")
    return due[order], kind[order]


def zipf_ranks(n: int, items: int, theta: float, rng) -> np.ndarray:
    """n ranks in 1..items with P(rank) proportional to rank^-theta
    (YCSB's zipfian), by the inverse CDF at shuffled mid-quantiles."""
    w = np.arange(1, items + 1, dtype=np.float64) ** -theta
    cdf = np.cumsum(w) / w.sum()
    return np.searchsorted(cdf, shuffled_quantiles(n, rng)) + 1


def percentile(values: Sequence[float], q: float) -> float:
    """The nearest-rank ``q``-th percentile (0 < q <= 100): the smallest
    value that at least q% of the values do not exceed."""
    v = sorted(values)
    if not v:
        raise ValueError("no values")
    return v[max(0, math.ceil(q / 100.0 * len(v)) - 1)]


def wait_until(t: float) -> None:
    """Sleep until perf_counter() reaches ``t`` (the last half
    millisecond spun, so a request starts on time)."""
    while True:
        left = t - time.perf_counter()
        if left <= 0:
            return
        time.sleep(left - 5e-4 if left > 1e-3 else 0)


def summary(values: List[float]) -> Dict[str, float]:
    return {"n": len(values), "p50": percentile(values, 50),
            "p95": percentile(values, 95), "max": max(values)}
