"""Tracing and profiling utilities (counterpart of
``aspire_tpu/profiling.py``): phase wall-clock timers feeding
particles/s and ESS/s metrics, and a context manager around
``torch.profiler`` for device traces.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import time
from collections import defaultdict

import torch

logger = logging.getLogger("aspire_tpu_torch")


@dataclasses.dataclass
class PhaseStats:
    total_s: float = 0.0
    count: int = 0

    @property
    def mean_s(self) -> float:
        return self.total_s / max(self.count, 1)


class Profiler:
    """Phase wall-clock accumulator. With ``block_until_ready`` a phase
    waits for the card's queued work (``torch.cuda.synchronize``) at its
    start and end, so its time is the work it launched.

    Usage::

        prof = Profiler()
        with prof.phase("mutate"):
            ...
        prof.summary()  # dict of phase -> {total_s, count, mean_s}
    """

    def __init__(self, block_until_ready: bool = True):
        self.phases: dict[str, PhaseStats] = defaultdict(PhaseStats)
        self.block_until_ready = block_until_ready
        self._counters: dict[str, float] = defaultdict(float)

    def _sync(self) -> None:
        if self.block_until_ready and torch.cuda.is_available():
            torch.cuda.synchronize()

    @contextlib.contextmanager
    def phase(self, name: str, result_getter=None):
        self._sync()
        t0 = time.perf_counter()
        try:
            yield self
        finally:
            self._sync()
            elapsed = time.perf_counter() - t0
            stats = self.phases[name]
            stats.total_s += elapsed
            stats.count += 1

    def add(self, counter: str, value: float) -> None:
        """Accumulate a throughput counter (e.g. particle-steps)."""
        self._counters[counter] += value

    def rate(self, counter: str, phase: str) -> float:
        """counter units per second of the given phase."""
        total = self.phases[phase].total_s
        return self._counters[counter] / total if total > 0 else 0.0

    def summary(self) -> dict:
        out = {
            name: {
                "total_s": stats.total_s,
                "count": stats.count,
                "mean_s": stats.mean_s,
            }
            for name, stats in self.phases.items()
        }
        out["counters"] = dict(self._counters)
        return out

    def log_summary(self) -> None:
        for name, stats in sorted(self.phases.items()):
            logger.info(
                "phase %-20s total %8.3fs  n=%4d  mean %8.4fs",
                name,
                stats.total_s,
                stats.count,
                stats.mean_s,
            )


@contextlib.contextmanager
def device_trace(log_dir: str):
    """A ``torch.profiler`` trace of the block (CPU, and CUDA where there
    is a card), written to ``log_dir`` as a Chrome trace (view in
    TensorBoard or Perfetto); yields the profiler (``key_averages()``)."""
    import os

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    logger.info("Device trace written to %s", path)
