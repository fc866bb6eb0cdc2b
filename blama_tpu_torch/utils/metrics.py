"""Step timing + throughput metrics.

Closes the reference's observability gap: llama.cpp perf counters are reset
but never read or reported (SURVEY.md §5.1 — Session.cpp:55,
Sampler.cpp:180-184). Here prefill/decode timings, TTFT, and tokens/s are
first-class and queryable.
"""

from __future__ import annotations

import time
from collections import defaultdict
from dataclasses import dataclass, field


@dataclass
class Counter:
    count: int = 0
    total_s: float = 0.0
    min_s: float = float("inf")
    max_s: float = 0.0

    def add(self, dt: float) -> None:
        self.count += 1
        self.total_s += dt
        self.min_s = min(self.min_s, dt)
        self.max_s = max(self.max_s, dt)

    @property
    def mean_s(self) -> float:
        return self.total_s / self.count if self.count else 0.0


class Metrics:
    """Per-instance metrics registry: counters + token accounting."""

    def __init__(self):
        self.counters: dict[str, Counter] = defaultdict(Counter)
        self.tokens_prefilled = 0
        self.tokens_decoded = 0
        self._start = time.monotonic()

    def timer(self, name: str):
        return _Timer(self, name)

    def record(self, name: str, dt: float) -> None:
        self.counters[name].add(dt)

    def tokens_per_sec(self) -> float:
        # decode time: per-token steps, plus the scheduler's horizon loops
        total = sum(self.counters[k].total_s
                    for k in ("decode_step", "decode_horizon") if k in self.counters)
        return self.tokens_decoded / total if total else 0.0

    def ttft_s(self) -> float:
        c = self.counters.get("prefill")
        return c.mean_s if c else 0.0

    def snapshot(self) -> dict:
        return {
            "uptime_s": round(time.monotonic() - self._start, 3),
            "tokens_prefilled": self.tokens_prefilled,
            "tokens_decoded": self.tokens_decoded,
            "decode_tokens_per_sec": round(self.tokens_per_sec(), 2),
            "ttft_mean_s": round(self.ttft_s(), 4),
            "timers": {
                k: {"count": c.count, "mean_ms": round(c.mean_s * 1e3, 3),
                    "total_s": round(c.total_s, 3)}
                for k, c in self.counters.items()
            },
        }

    def reset(self) -> None:
        self.counters.clear()
        self.tokens_prefilled = 0
        self.tokens_decoded = 0
        self._start = time.monotonic()


class _Timer:
    def __init__(self, metrics: Metrics, name: str):
        self._m = metrics
        self._name = name

    def __enter__(self):
        self._t0 = time.monotonic()
        return self

    def __exit__(self, *exc):
        self._m.record(self._name, time.monotonic() - self._t0)
