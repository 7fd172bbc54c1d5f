"""The ``--trace 1`` run: ``torch.profiler`` around the window,
reduced to the device's busy time, the device time of named kernels or
of the kernels launched under named spans, kernel launches, and the
breakdown of device operations and idle gaps.

The window is the host span ``bench.window``. Device activity is clipped
to it; the spans' own ranges on the device timeline (user annotations)
are not activity. A kernel belongs to a span when the runtime call that
launched it (same correlation id) started inside the span on the host.
"""

from __future__ import annotations

import bisect
import re
from typing import Dict, Iterable, List, Optional, Tuple

import torch

WINDOW_SPAN = "bench.window"
TOP = 10


def profiler():
    """A profiler of CPU activity and, where there is a card, CUDA."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


def window_span():
    return torch.profiler.record_function(WINDOW_SPAN)


def _merge(intervals: Iterable[Tuple[float, float]]) -> List[List[float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def is_kernel(name: str) -> bool:
    return not name.startswith(("Memcpy", "Memset"))


class Trace:
    """The reduced profile of one traced window (times in seconds)."""

    def __init__(self, events):
        from torch.autograd import DeviceType
        cpu = [e for e in events if e.device_type == DeviceType.CPU]
        marks = {e.name for e in cpu if e.is_user_annotation}
        window = [e for e in cpu if e.name == WINDOW_SPAN]
        if len(window) != 1:
            raise RuntimeError(f"the trace holds {len(window)} "
                               f"{WINDOW_SPAN} spans, not one")
        self._t0 = window[0].time_range.start
        self._t1 = window[0].time_range.end
        self.window_s = (self._t1 - self._t0) / 1e6
        self.device = []
        for e in events:
            if (e.device_type == DeviceType.CUDA and not e.is_user_annotation
                    and e.name not in marks):
                a = max(e.time_range.start, self._t0)
                b = min(e.time_range.end, self._t1)
                if b > a:
                    self.device.append((e, a, b))
        self._busy = _merge((a, b) for _, a, b in self.device)
        self.busy_s = sum(b - a for a, b in self._busy) / 1e6
        self._cpu = sorted((e for e in cpu if e.name != WINDOW_SPAN),
                           key=lambda e: e.time_range.start)
        self._starts = [e.time_range.start for e in self._cpu]
        self._spans = self._span_names(cpu)

    @staticmethod
    def _span_names(cpu) -> Dict[int, frozenset]:
        """Correlation id -> names of the spans open when the runtime
        call with that id started."""
        edges = []
        for e in cpu:
            if e.is_user_annotation and e.name != WINDOW_SPAN:
                edges.append((e.time_range.start, 0, e.name))
                edges.append((e.time_range.end, 2, e.name))
            elif e.id and e.name.startswith(("cuda", "cu")):
                edges.append((e.time_range.start, 1, e.id))
        open_count: Dict[str, int] = {}
        out: Dict[int, frozenset] = {}
        for _, kind, what in sorted(edges, key=lambda x: (x[0], x[1])):
            if kind == 0:
                open_count[what] = open_count.get(what, 0) + 1
            elif kind == 2:
                open_count[what] -= 1
            else:
                out[what] = frozenset(n for n, c in open_count.items() if c)
        return out

    def select(self, match: str, names: List[str]):
        """Device activity of kernels whose name matches one of the
        regular expressions ``names`` (``match`` "kernels"), or launched
        under a span named one of ``names`` (``match`` "spans")."""
        if match == "kernels":
            pats = [re.compile(n) for n in names]
            return [(e, a, b) for e, a, b in self.device
                    if any(p.search(e.name) for p in pats)]
        if match == "spans":
            want = set(names)
            return [(e, a, b) for e, a, b in self.device
                    if want & self._spans.get(e.id, frozenset())]
        raise ValueError(f"unknown match {match!r}")

    def seconds(self, match: str, names: List[str]) -> float:
        return sum(b - a for _, a, b in self.select(match, names)) / 1e6

    def kernel_launches(self) -> int:
        return sum(1 for e, _, _ in self.device if is_kernel(e.name))

    def _host_at(self, t: float) -> str:
        """The innermost host event running at time ``t``."""
        i = bisect.bisect_right(self._starts, t)
        for e in reversed(self._cpu[max(0, i - 500):i]):
            if e.time_range.end >= t:
                return e.name
        return "(no host event)"

    def breakdown(self) -> Optional[dict]:
        if not self.device:
            return None
        ops: Dict[str, float] = {}
        for e, a, b in self.device:
            ops[e.name] = ops.get(e.name, 0.0) + (b - a) / 1e6
        gaps: Dict[str, float] = {}
        edges = [self._t0] + [x for ab in self._busy for x in ab] + [self._t1]
        for a, b in zip(edges[0::2], edges[1::2]):
            if b > a:
                name = self._host_at((a + b) / 2)
                gaps[name] = gaps.get(name, 0.0) + (b - a) / 1e6

        def top(d):
            return [[k, v] for k, v in sorted(d.items(),
                                              key=lambda kv: -kv[1])[:TOP]]
        return {"device_ops": top(ops), "idle_gaps": top(gaps)}
