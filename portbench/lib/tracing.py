"""The traced stretch of a window: ``torch.profiler`` (CUPTI) over a run
of consecutive requests, reduced to what the per-layer readers take.

Widened from ``chip_smoke.profile_solve``: the union of the CUDA
activities over the stretch's host wall is the busy time; device time by
operation name; and every idle gap between device activities is named by
the host operation open over its midpoint (outermost > innermost, on the
thread that issued the work), so idle time can be summed by what the host
was doing.
"""
from __future__ import annotations

import re
import time
from collections import defaultdict

import torch


def _key(name):
    key = re.sub(r"\(anonymous namespace\)::|^void ", "", name)
    return key.split("(")[0].replace(" ", "") if "Memcpy" not in key \
        else key


class Stretch:
    """Starts the profiler before request ``skip`` is handed to the
    program and stops it, after a synchronise, before request
    ``skip + count`` is handed."""

    def __init__(self, skip, count):
        self.skip, self.count = int(skip), int(count)
        self.prof = None
        self.summary = None
        self.t0 = self.t1 = None

    def before(self, k):
        if k == self.skip:
            from torch.profiler import ProfilerActivity, profile
            torch.cuda.synchronize()
            self.prof = profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA])
            self.prof.start()
            self.t0 = time.perf_counter()
        elif k == self.skip + self.count:
            self.finish(k)

    def finish(self, handed):
        """Stop the profiler (if it runs) with ``handed`` requests handed
        so far, and summarise the stretch."""
        if self.prof is None:
            return
        torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.prof.stop()
        t = time.perf_counter()
        self.summary = summarise(self.prof, self.t1 - self.t0,
                                 min(self.count, handed - self.skip))
        self.summary["read_s"] = time.perf_counter() - t
        self.prof = None


def summarise(prof, wall, requests):
    """Reads the profiler's raw events (times in ns), without building
    ``prof.events()``'s tree, which takes minutes over a stretch of many
    small operations."""
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        a, b = e.start_ns() / 1e3, e.end_ns() / 1e3
        if "CUDA" in str(e.device_type()):
            dev.append((a, b, _key(e.name())))
        elif not e.name().startswith(("PyTorch Profiler", "ProfilerStep")):
            host.append((a, b, e.name(), e.start_thread_id()))
    s = {"wall_s": wall, "requests": requests, "device_ops": len(dev),
         "by_name": defaultdict(float), "count_by_name": defaultdict(int),
         "idle_by_host": defaultdict(float),
         "htod_s": 0.0, "dtoh_s": 0.0, "busy_s": 0.0}
    for a, b, k in dev:
        s["by_name"][k] += (b - a) / 1e6
        s["count_by_name"][k] += 1
        if "HtoD" in k:
            s["htod_s"] += (b - a) / 1e6
        elif "DtoH" in k:
            s["dtoh_s"] += (b - a) / 1e6
    if not dev:
        return s
    merged = []
    for a, b, _ in sorted(dev):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    s["busy_s"] = sum(b - a for a, b in merged) / 1e6
    gaps = [(merged[i][1], merged[i + 1][0]) for i in range(len(merged) - 1)
            if merged[i + 1][0] > merged[i][1]]
    s["idle_by_host"] = _name_gaps(gaps, host)
    return s


def _name_gaps(gaps, host):
    """Idle seconds summed by the host operation open over each gap's
    midpoint, on the busiest host thread (the one that issued the work)."""
    by_thread = defaultdict(list)
    for a, b, name, th in host:
        by_thread[th].append((a, b, name))
    out = defaultdict(float)
    if not by_thread:
        for a, b in gaps:
            out["unknown"] += (b - a) / 1e6
        return out
    events = sorted(max(by_thread.values(), key=len),
                    key=lambda e: (e[0], -e[1]))
    stack, i = [], 0
    for a, b in sorted(gaps, key=lambda g: g[0] + g[1]):
        mid = (a + b) / 2
        while i < len(events) and events[i][0] <= mid:
            while stack and stack[-1][1] <= events[i][0]:
                stack.pop()
            stack.append(events[i])
            i += 1
        while stack and stack[-1][1] <= mid:
            stack.pop()
        open_ = [e for e in stack if e[1] > mid]
        if not open_:
            name = "host between operations"
        elif len(open_) == 1:
            name = open_[0][2]
        else:
            name = f"{open_[0][2]} > {open_[-1][2]}"
        out[name] += (b - a) / 1e6
    return out


def breakdown(summary, top=10):
    ops = sorted(summary["by_name"].items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(summary["idle_by_host"].items(), key=lambda kv: -kv[1])
    return {"device_ops": [[k, v] for k, v in ops],
            "idle_gaps": [[k, v] for k, v in gaps[:top]]}
