"""The device trace of a ``--trace 1`` run: ``torch.profiler`` (CUPTI)
over a stretch of the window, reduced to what the per-layer readers
need: every device activity's interval and name, the union of busy
time, kernel counts by name, and the device's idle gaps attributed to
what the host was doing (the driver's host phases, on the same clock).
"""

from __future__ import annotations

import collections
import json
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

MARK_CYCLES = 1000


class DeviceTrace:
    """CUDA activity only (a CPU activity would record every thread's
    operator calls and slow the host many times over). The trace's
    clock is tied to the host's monotonic clock by markers: a short
    sleep kernel launched on a stream of its own while the host reads
    its clock, once after the capture starts and once before it stops
    (the first can be lost while the capture comes up)."""

    def __init__(self, workdir: str):
        import torch
        from torch.profiler import ProfilerActivity, profile
        self._torch = torch
        self._path = os.path.join(workdir, "device_trace.json")
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self.t0 = self.t1 = 0.0       # host monotonic bounds of the capture
        self.offset_s = 0.0           # trace clock - host monotonic
        self.aligned_by = ""
        self.events: List[Tuple[str, float, float]] = []

    def _marker(self) -> float:
        with self._torch.cuda.stream(self._side):
            t = time.monotonic()
            self._torch.cuda._sleep(MARK_CYCLES)
        return t

    def start(self) -> None:
        self._side = self._torch.cuda.Stream()
        self._prof.__enter__()
        self._mark0 = self._marker()
        self.t0 = time.monotonic()

    def stop(self) -> None:
        self.t1 = time.monotonic()
        self._mark1 = self._marker()
        self._torch.cuda.synchronize()
        self._prof.__exit__(None, None, None)
        self._prof.export_chrome_trace(self._path)
        with open(self._path) as f:
            doc = json.load(f)
        os.unlink(self._path)
        dev, marks = [], []
        for e in doc.get("traceEvents", []):
            if e.get("cat") not in DEVICE_CATS or "dur" not in e:
                continue
            a = float(e["ts"]) * 1e-6
            name = str(e.get("name", ""))
            if "sleep" in name.lower() or "spin" in name.lower():
                marks.append(a)
                continue
            dev.append((name, a, a + float(e["dur"]) * 1e-6))
        self.offset_s, self.aligned_by = _offset(marks, dev, self._mark0,
                                                 self._mark1, self.t0)
        self.events = sorted(
            ((n, a - self.offset_s, b - self.offset_s) for n, a, b in dev),
            key=lambda x: x[1])

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0


DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _offset(marks: List[float], dev: List[Tuple[str, float, float]],
            host0: float, host1: float, t0: float) -> Tuple[float, str]:
    """Trace clock minus host clock, from the markers found: the first
    marker where it lies before most of the activity, else the last;
    with neither, the first activity is taken to start at ``t0``."""
    if marks:
        mid = (sorted(a for _n, a, _b in dev)[len(dev) // 2] if dev
               else max(marks))
        first, last = min(marks), max(marks)
        if first < mid:
            return first - host0, "start marker"
        return last - host1, "end marker"
    if dev:
        return min(a for _n, a, _b in dev) - t0, "first activity"
    return 0.0, "none"


def warm_profiler() -> None:
    """Start and stop one short capture, so that the first capture's
    start-up (CUPTI's) is paid in set-up and not inside the window."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]):
        torch.cuda._sleep(MARK_CYCLES)
        torch.cuda.synchronize()


def is_kernel(name: str) -> bool:
    return not (name.startswith("Memcpy") or name.startswith("Memset"))


def busy_intervals(events: Sequence[Tuple[str, float, float]],
                   t0: float, t1: float) -> List[Tuple[float, float]]:
    """Union of the device's activity, clipped to ``[t0, t1]``."""
    out: List[Tuple[float, float]] = []
    for _n, a, b in sorted(events, key=lambda x: x[1]):
        a, b = max(a, t0), min(b, t1)
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def gaps(busy: List[Tuple[float, float]], t0: float, t1: float
         ) -> List[Tuple[float, float]]:
    out, cur = [], t0
    for a, b in busy:
        if a > cur:
            out.append((cur, a))
        cur = max(cur, b)
    if cur < t1:
        out.append((cur, t1))
    return out


def _union(iv: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def _overlap(a: List[Tuple[float, float]],
             b: List[Tuple[float, float]]) -> float:
    i = j = 0
    tot = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            tot += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return tot


def idle_by_phase(idle: List[Tuple[float, float]],
                  phases: Sequence[Tuple[str, float, float]]
                  ) -> List[Tuple[str, float]]:
    """Seconds of device idleness during each host phase (phases run on
    two threads, so a gap can count under two of them), and the idle
    time during none (``no_phase``); longest first."""
    by: Dict[str, list] = collections.defaultdict(list)
    for name, a, b in phases:
        by[name].append((a, b))
    out = {n: _overlap(idle, _union(iv)) for n, iv in by.items()}
    covered = _union([iv for ivs in by.values() for iv in ivs])
    out["no_phase"] = sum(b - a for a, b in idle) - _overlap(idle, covered)
    return sorted(((n, s) for n, s in out.items() if s > 0),
                  key=lambda x: -x[1])


def top_ops(events: Sequence[Tuple[str, float, float]],
            k: int = 10) -> List[Tuple[str, float]]:
    tot: Dict[str, float] = collections.defaultdict(float)
    for n, a, b in events:
        tot[n[:64]] += b - a
    return sorted(tot.items(), key=lambda x: -x[1])[:k]


def kernel_times(events: Sequence[Tuple[str, float, float]], needle: str
                 ) -> Optional[Tuple[int, float]]:
    """(count, mean seconds) of the kernels whose name holds ``needle``."""
    d = [b - a for n, a, b in events if needle in n]
    return (len(d), sum(d) / len(d)) if d else None
