"""The paper's NREP estimation (§4.2, Eq. 1) and RSE stopping rule.

"The idea is to estimate the number of repetitions for each case by measuring
the latency of MPI functions with a 1 Byte message … batches grow
exponentially … for larger sizes take b1 (+ b2) samples, use the minimum, and
set  nrep_m = max(ceil(t1_nrep / t_m_min), K)."
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Sequence

Sampler = Callable[[int, int], Sequence[float]]   # (msize_bytes, count) -> latencies


def rse(samples: Sequence[float]) -> float:
    """Relative standard error of the mean."""
    n = len(samples)
    if n < 2:
        return math.inf
    mean = sum(samples) / n
    if mean == 0:
        return math.inf
    var = sum((s - mean) ** 2 for s in samples) / (n - 1)
    return math.sqrt(var / n) / mean


@dataclasses.dataclass
class OneByteEstimate:
    nrep: int            # samples taken until RSE < threshold
    total_time: float    # the paper's t1^nrep (sum of all 1-byte latencies)
    final_rse: float
    batches: int


def estimate_1byte(sampler: Sampler, *, rse_threshold: float = 0.01,
                   batch0: int = 10, growth: float = 2.0,
                   max_samples: int = 100_000) -> OneByteEstimate:
    """Exponentially growing batches of 1-byte measurements until the RSE of
    the accumulated sample set drops below ``rse_threshold`` (paper: 1%)."""
    samples: list[float] = []
    batch = batch0
    batches = 0
    while True:
        samples.extend(sampler(1, int(batch)))
        batches += 1
        r = rse(samples)
        if r < rse_threshold or len(samples) >= max_samples:
            return OneByteEstimate(nrep=len(samples),
                                   total_time=sum(samples),
                                   final_rse=r, batches=batches)
        batch = math.ceil(batch * growth)


def estimate_nrep(sampler: Sampler, msize: int, one_byte: OneByteEstimate, *,
                  b1: int = 5, b2: int = 5, rse_threshold: float = 0.05,
                  K: int = 10) -> int:
    """Eq. (1): nrep_m = max(ceil(t1_nrep / t_m_min), K).

    Takes b1 samples; if their RSE exceeds ``rse_threshold`` (a *different*
    threshold than the 1-byte one, per the paper) takes another b2.
    ``t_m_min`` is the minimum of the b1(+b2) latencies.
    """
    samples = list(sampler(msize, b1))
    if rse(samples) > rse_threshold:
        samples += list(sampler(msize, b2))
    t_min = min(samples)
    if t_min <= 0:
        return K
    return max(math.ceil(one_byte.total_time / t_min), K)
