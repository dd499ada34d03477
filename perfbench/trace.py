"""The device trace of a traced run: ``torch.profiler`` over a slice of the
window, reduced to kernel intervals, the harness's annotations, the busy
time (the union of kernel intervals) and the breakdown the result line
carries.

The harness wraps each prefill and megastep call in a
``record_function`` named ``pb.<layer>:<shape>`` so that a kernel can be
laid against the call that launched it: both come back on the profiler's
one clock.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import torch

#: The profiler starts this many seconds before the window closes (its own
#: start takes some of them) and records until it closes.
SLICE_S = 10.0


@dataclasses.dataclass
class Interval:
    name: str
    start: float        # seconds on the profiler's clock
    end: float


@dataclasses.dataclass
class TraceData:
    """What a traced slice leaves: kernels, annotations, and the slice's
    host-clock length."""
    kernels: List[Interval]
    annotations: List[Interval]
    window_s: float

    def busy_s(self) -> float:
        """Seconds in which at least one kernel ran."""
        busy, end = 0.0, -float("inf")
        for k in sorted(self.kernels, key=lambda k: k.start):
            if k.end <= end:
                continue
            busy += k.end - max(k.start, end)
            end = k.end
        return busy

    def kernels_named(self, *parts: str) -> List[Interval]:
        return [k for k in self.kernels if any(p in k.name for p in parts)]

    def within(self, kernels: List[Interval], a: Interval) -> List[Interval]:
        """The kernels that started inside annotation ``a``."""
        return [k for k in kernels if a.start <= k.start < a.end]

    def annotated(self, prefix: str) -> List[Interval]:
        return [a for a in self.annotations if a.name.startswith(prefix)]

    def device_ops(self, top: int = 10) -> List[Tuple[str, float]]:
        """The kernels that took most time, by name, in seconds."""
        total: Dict[str, float] = {}
        for k in self.kernels:
            total[k.name] = total.get(k.name, 0.0) + (k.end - k.start)
        return sorted(total.items(), key=lambda kv: -kv[1])[:top]

    def idle_gaps(self, top: int = 10) -> List[Tuple[str, float]]:
        """The longest gaps between kernels, each named by the annotation
        the host was inside at the gap's middle."""
        gaps = []
        end = None
        for k in sorted(self.kernels, key=lambda k: k.start):
            if end is not None and k.start > end:
                mid = (k.start + end) / 2
                where = [a.name.split(":")[0] for a in self.annotations
                         if a.start <= mid < a.end]
                gaps.append((where[-1] if where else "host: engine and harness",
                             k.start - end))
            end = k.end if end is None else max(end, k.end)
        return sorted(gaps, key=lambda g: -g[1])[:top]


class Slice:
    """The profiler over one slice of the window."""

    def __init__(self, cuda: bool = True):
        from torch.profiler import ProfilerActivity, profile
        self._cuda = cuda
        self._prof = profile(activities=[ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if cuda else []))
        self._t0 = self._t1 = None

    def _sync(self) -> None:
        if self._cuda:
            torch.cuda.synchronize()

    def start(self) -> None:
        self._sync()
        self._prof.__enter__()
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        self._t1 = time.perf_counter()
        self._sync()
        self._prof.__exit__(None, None, None)

    @property
    def started(self) -> Optional[float]:
        """When the slice started (host clock), or None."""
        return self._t0

    @property
    def fresh(self) -> bool:
        """Not started yet."""
        return self._t0 is None

    @property
    def running(self) -> bool:
        return self._t0 is not None and self._t1 is None

    def data(self) -> Optional[TraceData]:
        if self._t1 is None:
            return None
        kernels, notes = [], []
        for e in self._prof.profiler.kineto_results.events():
            start = e.start_ns() * 1e-9
            iv = Interval(e.name(), start, start + e.duration_ns() * 1e-9)
            if e.name().startswith("pb."):
                if "CUDA" not in str(e.device_type()):
                    notes.append(iv)         # the host's side of the call
            elif "CUDA" in str(e.device_type()):
                kernels.append(iv)
        return TraceData(kernels, notes, self._t1 - self._t0)
