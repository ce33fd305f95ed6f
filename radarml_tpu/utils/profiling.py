"""Tracing and per-stage timing for the scan pipelines.

The reference's only timing signal is log-line timestamps (SURVEY.md
§5: "no tracing/profiling"); this module is the greenfield
observability layer: lightweight per-stage wall timers around the
capture/predict loops, throughput counters with EMA rates, and an
optional `jax.profiler` trace context that captures device timelines
viewable in TensorBoard/Perfetto.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import subprocess
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional

logger = logging.getLogger(__name__)

__all__ = ["StageTimer", "RateMeter", "device_trace"]


@dataclasses.dataclass
class _Stat:
    count: int = 0
    total: float = 0.0
    best: float = float("inf")
    worst: float = 0.0

    def add(self, dt: float):
        self.count += 1
        self.total += dt
        self.best = min(self.best, dt)
        self.worst = max(self.worst, dt)


class StageTimer:
    """Accumulating wall-clock timers keyed by stage name.

    Usage:
        timer = StageTimer()
        with timer("trigger"):
            radar.trigger()
        with timer("classify"):
            predictor(...)
        timer.log_summary()
    """

    def __init__(self):
        self._stats: Dict[str, _Stat] = defaultdict(_Stat)

    @contextlib.contextmanager
    def __call__(self, stage: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._stats[stage].add(time.perf_counter() - t0)

    def summary(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name, s in self._stats.items():
            if not s.count:
                continue
            out[name] = {
                "count": s.count,
                "total_s": s.total,
                "mean_ms": 1e3 * s.total / s.count,
                "min_ms": 1e3 * s.best,
                "max_ms": 1e3 * s.worst,
            }
        return out

    def log_summary(self, level: int = logging.INFO):
        for name, row in sorted(
            self.summary().items(), key=lambda kv: -kv[1]["total_s"]
        ):
            logger.log(
                level,
                "stage %-16s n=%-6d mean=%8.3fms min=%8.3fms max=%8.3fms",
                name, row["count"], row["mean_ms"], row["min_ms"],
                row["max_ms"],
            )

    def reset(self):
        self._stats.clear()


class RateMeter:
    """Exponential-moving-average event rate (scans/s, samples/s)."""

    def __init__(self, alpha: float = 0.1):
        self.alpha = alpha
        self._last: Optional[float] = None
        self.rate: float = 0.0
        self.count: int = 0

    def tick(self, n: int = 1) -> float:
        now = time.perf_counter()
        self.count += n
        if self._last is not None:
            dt = now - self._last
            if dt > 0:
                inst = n / dt
                self.rate = (
                    inst
                    if self.rate == 0.0
                    else (1 - self.alpha) * self.rate + self.alpha * inst
                )
        self._last = now
        return self.rate


@contextlib.contextmanager
def device_trace(log_dir: Optional[str]) -> Iterator[None]:
    """jax.profiler trace scope; no-op when log_dir is falsy."""
    if not log_dir:
        yield
        return
    import jax

    with jax.profiler.trace(log_dir):
        yield
    logger.info("device trace written to %s", log_dir)


def card_name_and_power_limit() -> str:
    """`nvidia-smi`'s name and power limit of the GPU, e.g.
    "NVIDIA H100 80GB HBM3, 700.00 W" — every device number is kept
    beside it, since a card below its top power limit runs slower. A
    child process that never touches JAX; raises if the tool fails."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
