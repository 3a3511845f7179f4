"""The device trace of a traced window: ``torch.profiler``, exported as a
Chrome trace into ``TMPDIR`` and read back into plain lists (the file is
removed).

``Window(host=False)`` traces the card alone (CUPTI's activity records),
which costs the host little; it gives the device metrics.
``Window(host=True)`` also records the host's operators, which slows the
host several times over on a launch-bound stretch; it serves only to say
what the host was doing in each idle stretch.

``Window.kernels`` holds every device operation (kernels, copies, sets)
as ``(name, start_s, dur_s)`` within the window; ``busy_s`` is the length
of their union, ``window_s`` the window's (the host's clock from the
profiler's start to the card's synchronisation at the end);
``breakdown()`` the device operations that took most time and the
longest idle stretches by what the host was doing when each began (the
innermost host event covering its start)."""
from __future__ import annotations

import bisect
import json
import os
import tempfile
import time
from collections import defaultdict
from typing import Dict, List, Tuple

import torch
from torch.profiler import ProfilerActivity, profile, record_function

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation",
             "python_function")
MARK = "bench.traced_window"
TOP = 10


def warm_profiler() -> None:
    """Start and stop the profiler once on a trivial op, so that starting it
    again later does not set up its tracer inside a run's window."""
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()


class Window:
    def __init__(self, host: bool = False):
        self.host_events = host
        self._prof = None
        self._mark = None
        self.kernels: List[Tuple[str, float, float]] = []
        self.host: List[Tuple[str, float, float]] = []
        self.window_s = 0.0
        self.busy_s = 0.0
        self.gaps: List[Tuple[float, float]] = []

    def __enter__(self):
        acts = [ProfilerActivity.CUDA]
        if self.host_events:
            acts.append(ProfilerActivity.CPU)
        torch.cuda.synchronize()
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._mark = record_function(MARK)
        self._mark.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self._t0
        self._mark.__exit__(*exc)
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self._read()

    def _read(self) -> None:
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.remove(path)
        mark = [e for e in events if e.get("name") == MARK
                and e.get("ph") == "X" and e.get("cat") == "user_annotation"]
        dev = [e for e in events if e.get("cat") in DEVICE_CATS
               and e.get("ph") == "X"]
        if mark:
            t0 = float(mark[0]["ts"])
        else:       # the card alone: the window starts at its first event
            t0 = min((float(e["ts"]) for e in dev), default=0.0)
        t1 = t0 + self.window_s * 1e6
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            start, end = float(e["ts"]), float(e["ts"]) + float(e["dur"])
            if end <= t0 or start >= t1:
                continue
            item = (e["name"], (max(start, t0) - t0) * 1e-6,
                    (min(end, t1) - max(start, t0)) * 1e-6)
            if e.get("cat") in DEVICE_CATS:
                self.kernels.append(item)
            elif e.get("cat") in HOST_CATS and e["name"] != MARK:
                self.host.append(item)
        self._union()

    def _union(self) -> None:
        busy, last = 0.0, 0.0
        for _, s, d in sorted(self.kernels, key=lambda k: k[1]):
            e = s + d
            if s > last:
                self.gaps.append((last, s))
            if e > last:
                busy += e - max(s, last)
                last = e
        if last < self.window_s:
            self.gaps.append((last, self.window_s))
        self.busy_s = busy

    def time_of(self, pred) -> Tuple[int, float]:
        """(launches, device seconds) of the operations whose name
        satisfies ``pred``."""
        sel = [d for n, _, d in self.kernels if pred(n)]
        return len(sel), float(sum(sel))

    def device_ops(self) -> List:
        ops: Dict[str, float] = defaultdict(float)
        for n, _, d in self.kernels:
            ops[n[:160]] += d
        return _top(ops)

    def idle_gaps(self) -> List:
        host = sorted(self.host, key=lambda h: h[1])
        starts = [s for _, s, _ in host]
        idle: Dict[str, float] = defaultdict(float)
        for g0, g1 in self.gaps:
            label = "no host event"
            # the latest-starting host event that covers the gap's start
            for j in range(bisect.bisect_right(starts, g0) - 1,
                           max(-1, bisect.bisect_right(starts, g0) - 4097),
                           -1):
                n, s, d = host[j]
                if s + d >= g0:
                    label = n[:160]
                    break
            idle[label] += g1 - g0
        return _top(idle)


def _top(d: Dict[str, float]) -> List:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]


def breakdown(device: Window, host: Window) -> Dict:
    """The device operations that took most time in the card-alone window,
    and the longest idle stretches of the host-traced one by what the host
    was doing."""
    return {"device_ops": device.device_ops(), "idle_gaps": host.idle_gaps()}
