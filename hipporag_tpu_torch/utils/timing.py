"""Stage timing instrumentation.

The reference keeps manual per-stage wall-clock accumulators
(HippoRAG.py:184-186, 444-489). We generalize that into a tiny stage-timer
registry, and ``device_profile`` traces a block with ``torch.profiler``.
"""

from __future__ import annotations

import contextlib
import os
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


@contextlib.contextmanager
def device_profile(log_dir: str | None, device=None):
    """Optionally trace a block with ``torch.profiler`` and write a Chrome
    trace, ``trace-<pid>-<ns>.json``, into ``log_dir``. CPU activity is
    always recorded, CUDA activity (kernels, copies) when ``device`` is a
    CUDA device."""
    if not log_dir:
        yield
        return
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if device is not None and torch.device(device).type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, f"trace-{os.getpid()}-{time.time_ns()}.json"))
