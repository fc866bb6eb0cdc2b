"""Verification math: LogitComparer + MetricsAggregator.

Faithful re-implementation of the reference's comparison semantics
(reference llama/LogitComparer.cpp):

  * top1Match: first entry of each (descending-sorted) top-K list agrees
  * distance: | ||a||² − ||b||² | / max(||a||², ||b||²) over the first
    min(len) entries (energy distance, LogitComparer.cpp:43-47,106-115)
  * jsd: Jensen–Shannon divergence over softmaxed top-K maps, where the
    softmax subtracts entry 0's logit (assumes sorted input) and the average
    distribution is built over the token intersection (LogitComparer.cpp:8-28,
    82-104)
  * aggregate score: mean over steps of 0.5·(1−distance) + 0.5·(1−jsd)
    (LogitComparer.cpp:117-128)

These formulas are part of the wire contract (a prover scored by a different
verifier implementation must agree), so quirks of the reference — softmax max
taken from data[0] rather than a true max, intersection-only JSD — are
preserved deliberately.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

from .token_data import TokenData, TokenDataVector


@dataclass
class ComparisonMetrics:
    top1_match: float
    distance: float
    jsd: float


def _softmax_map(data: TokenDataVector) -> dict[int, float]:
    # NB: subtracts data[0].logit as "max" — correct only for sorted input,
    # preserved from the reference (LogitComparer.cpp:12-13)
    max_logit = data[0].logit
    result = {}
    sum_exp = 0.0
    for td in data:
        p = math.exp(td.logit - max_logit)
        result[td.token] = p
        sum_exp += p
    return {t: p / sum_exp for t, p in result.items()}


def _energy(data: TokenDataVector, n: int) -> float:
    return float(sum(td.logit * td.logit for td in data[:n]))


def _jsd(p1: dict[int, float], p2: dict[int, float]) -> float:
    avg = {t: (p + p2[t]) / 2.0 for t, p in p1.items() if t in p2}

    def kl(P: dict[int, float], Q: dict[int, float]) -> float:
        total = 0.0
        for t, p in P.items():
            q = Q.get(t, 0.0)
            if p > 0.0 and q > 0.0:
                total += p * math.log(p / q)
        return total

    return (kl(p1, avg) + kl(p2, avg)) / 2.0


class LogitComparer:
    @staticmethod
    def compare(data1: TokenDataVector, data2: TokenDataVector) -> ComparisonMetrics:
        top1 = 1.0 if data1[0].token == data2[0].token else 0.0
        n = min(len(data1), len(data2))
        e1 = _energy(data1, n)
        e2 = _energy(data2, n)
        distance = abs(e1 - e2) / max(e1, e2) if max(e1, e2) > 0 else 0.0
        jsd = _jsd(_softmax_map(data1), _softmax_map(data2))
        return ComparisonMetrics(top1, distance, jsd)

    @staticmethod
    def logit_similarity(data1: TokenDataVector, data2: TokenDataVector) -> float:
        """Weighted per-token similarity (LogitComparer.cpp:57-80)."""
        l2 = {td.token: td.logit for td in data2}
        weighted = 0.0
        total = 0.0
        for td in data1:
            weight = abs(td.logit)
            sim = 0.0
            if td.token in l2:
                other = l2[td.token]
                denom = abs(max(td.logit, other))
                sim = 1.0 - (abs(td.logit - other) / denom) if denom > 0 else 1.0
            weighted += weight * sim
            total += weight
        return weighted / total if total > 0.0 else 0.0


class MetricsAggregator:
    """Accumulates per-step metrics into a single score (LogitComparer.cpp:117-128)."""

    def __init__(self):
        self.metrics: list[ComparisonMetrics] = []

    def push_and_verify(self, ms: list[ComparisonMetrics] | ComparisonMetrics) -> float:
        if isinstance(ms, ComparisonMetrics):
            ms = [ms]
        self.metrics.extend(ms)
        total = sum(0.5 * (1.0 - m.distance) + 0.5 * (1.0 - m.jsd) for m in self.metrics)
        return float(total / len(self.metrics))
