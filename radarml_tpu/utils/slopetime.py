"""Slope timing: the repo's one benchmarking methodology.

Every rate is a SLOPE: run K_lo and K_hi back-to-back dispatches, force
completion with a device→host fetch of a tiny output slice, and divide
the time difference by (K_hi - K_lo), so fixed per-call overhead
(dispatch, the fetch round trip) cancels and what remains is device
time per call.

Two details make the estimator robust to host-side jitter:

1. ADAPTIVE K_hi: if the measured (t_hi - t_lo) signal is smaller than
   `min_signal_s`, K_hi escalates (x4, capped at `max_k`) until the
   device work between the two points dominates per-fetch jitter.
   Slow programs (one call >> jitter) never escalate, so probes of
   expensive modes stay cheap.
2. PAIRED slopes: each rep measures (K_lo, K_hi) back-to-back and
   takes the pair's own slope; the median over pairs absorbs jitter
   episodes that land between pairs (min-over-reps at each K
   separately can return a negative slope). A non-positive median
   triggers one escalated retry; the final fallback returns the
   smallest positive pair rather than a negative time.

Shared by bench.py and the benchmarks/ scripts so a methodology fix
lands once.
"""

from __future__ import annotations

import time
from typing import Callable


def _run(call, fetch, k: int) -> float:
    t0 = time.perf_counter()
    out = None
    for _ in range(k):
        out = call()
    fetch(out)
    return time.perf_counter() - t0


def slope_time(
    call: Callable[[], object],
    fetch: Callable[[object], object],
    k_lo: int = 2,
    k_hi: int = 12,
    reps: int = 3,
    min_signal_s: float = 0.05,
    max_k: int = 256,
) -> float:
    """Seconds per `call()` via paired two-point slopes with forced
    completion.

    `call` dispatches the program under test and returns its output;
    `fetch` forces completion (fetch a tiny slice device→host).
    Returns the median of `reps` paired slopes, escalating K_hi until
    the timed signal exceeds `min_signal_s` (see module docstring).
    """
    pairs = []  # (slope, t_lo, t_hi)

    def measure_pair(k):
        t_lo = _run(call, fetch, k_lo)
        t_hi = _run(call, fetch, k)
        return (t_hi - t_lo) / (k - k_lo), t_lo, t_hi

    # Escalate K_hi until the inter-point signal dominates jitter (or
    # the cap): cheap for slow programs, decisive for fast ones.
    while True:
        s, t_lo, t_hi = measure_pair(k_hi)
        if t_hi - t_lo >= min_signal_s or k_hi >= max_k:
            break
        k_hi = min(max_k, k_hi * 4)
    pairs.append(s)
    for _ in range(reps - 1):
        pairs.append(measure_pair(k_hi)[0])

    pairs.sort()
    med = pairs[len(pairs) // 2]
    if med > 0:
        return med
    # A drift episode straddled the pairs: retry once with a larger
    # signal window before falling back to the best positive pair.
    if k_hi < max_k:
        return slope_time(
            call,
            fetch,
            k_lo=k_lo,
            k_hi=min(max_k, k_hi * 4),
            reps=reps,
            min_signal_s=min_signal_s,
            max_k=max_k,
        )
    positive = [p for p in pairs if p > 0]
    if positive:
        return positive[0]
    # Pathological (every pair non-positive at max_k): report the
    # magnitude rather than a negative time.
    return abs(med) or 1e-12
