"""Stage timing instrumentation.

The reference keeps manual per-stage wall-clock accumulators
(HippoRAG.py:184-186, 444-489). We generalize that into a tiny stage-timer
registry.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict


class StageTimers:
    """Accumulates wall-clock seconds per named stage."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def track(self, stage: str):
        start = time.perf_counter()
        try:
            yield
        finally:
            self.totals[stage] += time.perf_counter() - start
            self.counts[stage] += 1

    def add(self, stage: str, seconds: float):
        self.totals[stage] += seconds
        self.counts[stage] += 1

    def reset(self):
        self.totals.clear()
        self.counts.clear()

    def summary(self) -> Dict[str, float]:
        return dict(self.totals)
