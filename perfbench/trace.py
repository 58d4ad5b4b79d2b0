"""A bounded ``torch.profiler`` window and what the per-layer metrics read
from it.

The trace is written to a temporary file, read back and reduced in the
same process, then deleted. From it come the device's busy time (the union
of kernel, copy and set intervals), the longest device operations, the idle
gaps labelled by the innermost host operation running across them, the
kernels launched inside each ``retrieve/graph_search`` range, and, for
every ``retrieve/*`` range name, the device seconds of the kernels
launched inside ranges of that name (``range_device_s``). A kernel belongs
to a range when the runtime call that launched it (matched by its
correlation id) ran inside the range on the same host thread; it counts in
every range that encloses its launch.
"""

from __future__ import annotations

import heapq
import json
import os
import tempfile
import time
from collections import defaultdict

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")
GRAPH_SEARCH = "retrieve/graph_search"
STAGE_PREFIX = "retrieve/"


def merged(intervals):
    """Union of (start, end) intervals as a sorted list of disjoint ones."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class Window:
    """``start()`` and ``stop()`` bracket the profiled sub-window; call both
    from the thread whose host operations should be seen."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.prof = None
        self.host_s = None

    @property
    def active(self) -> bool:
        return self.prof is not None and self.host_s is None

    def _profiler(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        return torch.profiler.profile(activities=acts)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def warm(self) -> None:
        """Start and stop the profiler once, in set-up, so that its own
        start-up (CUPTI) stays out of the window."""
        with self._profiler():
            torch.ones(1, device=self.device).add_(1)
            self._sync()

    def start(self) -> None:
        self.prof = self._profiler()
        self._sync()
        self.prof.start()
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        self._sync()
        self.host_s = time.perf_counter() - self._t0
        self.prof.stop()

    def reduce(self, top: int = 10) -> dict:
        fd, path = tempfile.mkstemp(suffix=".json", prefix="perfbench-trace-")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as fh:
                events = [e for e in json.load(fh)["traceEvents"] if e.get("ph") == "X"]
        finally:
            os.remove(path)
        self.prof = None
        return reduce_events(events, self.host_s, top)


def reduce_events(events, window_s: float, top: int = 10) -> dict:
    dev = [e for e in events if e.get("cat") in DEVICE_CATS]
    busy = merged((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in dev)
    by_name = defaultdict(float)
    for e in dev:
        by_name[e["name"]] += float(e["dur"]) * 1e-6

    ranges = defaultdict(list)
    stages = defaultdict(list)  # host thread -> (start, end, name) of its retrieve/* ranges
    for e in events:
        if e.get("cat") == "user_annotation" and str(e.get("name", "")).startswith(STAGE_PREFIX):
            span = (float(e["ts"]), float(e["ts"]) + float(e["dur"]))
            stages[e.get("tid")].append((*span, e["name"]))
            if e["name"] == GRAPH_SEARCH:
                ranges[e.get("tid")].append(span)
    launches = {}
    for e in events:
        corr = (e.get("args") or {}).get("correlation")
        if corr is not None and e.get("cat") in ("cuda_runtime", "cuda_driver"):
            launches[corr] = (e.get("tid"), float(e["ts"]))

    def in_range(kernel) -> bool:
        launch = launches.get((kernel.get("args") or {}).get("correlation"))
        return launch is not None and any(s <= launch[1] <= t for s, t in ranges.get(launch[0], ()))

    kernels = [(e["name"], float(e["dur"]) * 1e-6, in_range(e)) for e in dev if e.get("cat") == "kernel"]

    range_device = defaultdict(float)
    for e in dev:
        launch = launches.get((e.get("args") or {}).get("correlation"))
        if e.get("cat") != "kernel" or launch is None:
            continue
        for name in {n for s, t, n in stages.get(launch[0], ()) if s <= launch[1] <= t}:
            range_device[name] += float(e["dur"]) * 1e-6

    host = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]) for e in events
                  if e.get("cat") in HOST_CATS)
    gaps = defaultdict(float)
    active, at = [], 0  # heap of (end, start, name) of host operations begun by now
    for (_s0, e0), (s1, _e1) in zip(busy, busy[1:]):
        mid = 0.5 * (e0 + s1)
        while at < len(host) and host[at][0] <= mid:
            heapq.heappush(active, (host[at][1], host[at][0], host[at][2]))
            at += 1
        while active and active[0][0] < mid:
            heapq.heappop(active)
        label = min(active, key=lambda h: h[0] - h[1])[2] if active else "(no host operation)"
        gaps[label] += (s1 - e0) * 1e-6

    def ranked(d):
        return [[name, seconds] for name, seconds in sorted(d.items(), key=lambda kv: -kv[1])[:top]]

    return {
        "busy_s": sum(e - s for s, e in busy) * 1e-6,
        "window_s": window_s,
        "device_ops": ranked(by_name),
        "idle_gaps": ranked(gaps),
        "kernels": kernels,
        "graph_search_ranges_s": [(t - s) * 1e-6 for rs in ranges.values() for s, t in rs],
        "range_device_s": dict(range_device),
    }
