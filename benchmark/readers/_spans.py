"""What the program's spans say in a traced window, for the readers
that split a reading by layer.

A program span is a user annotation of the trace other than the
window's own (``bench.window``): the program's ``utils.profiling``
spans. The innermost program span at a time is the open one that
started latest, on any thread (a training step's backward runs on the
autograd thread). A launch is under a span as ``Trace`` has it: the
span was open on the host when the runtime call that launched the work
began. Times are the trace's microseconds.
"""

from __future__ import annotations

import heapq
import re
from typing import Callable, Iterable, List, Optional, Tuple


def matcher(patterns: Iterable[str]) -> Callable[[str], bool]:
    """Whether a name matches one of the regular expressions
    ``patterns`` whole."""
    compiled = [re.compile(p) for p in patterns]
    return lambda name: any(p.fullmatch(name) for p in compiled)


def program_spans(trace) -> list:
    """The program's spans (host events), by start."""
    return [e for e in trace._cpu if e.is_user_annotation]


def in_window(trace, t: float) -> bool:
    return trace._t0 <= t <= trace._t1


def innermost(trace, times: List[float]) -> List[Optional[str]]:
    """The name of the innermost program span open at each of the
    ascending ``times`` (None where none is open)."""
    spans = program_spans(trace)
    heap: List[Tuple[float, int]] = []
    out: List[Optional[str]] = []
    i = 0
    for t in times:
        while i < len(spans) and spans[i].time_range.start <= t:
            heapq.heappush(heap, (-spans[i].time_range.start, i))
            i += 1
        # A span closed before t is closed for every later time too.
        while heap and spans[heap[0][1]].time_range.end < t:
            heapq.heappop(heap)
        out.append(spans[heap[0][1]].name if heap else None)
    return out


def idle_by_span(trace) -> List[Tuple[float, Optional[str]]]:
    """(microseconds, innermost program span at the gap's midpoint) of
    each interval of the window with no device activity: together the
    idle time of ``idle_pct``, window minus busy."""
    edges = [trace._t0] + [x for ab in trace._busy for x in ab] + [trace._t1]
    gaps = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
    names = innermost(trace, [(a + b) / 2 for a, b in gaps])
    return [(b - a, name) for (a, b), name in zip(gaps, names)]


def launch_spans(trace) -> List[frozenset]:
    """The names of the spans each kernel launch of the window (as the
    ``launches`` reader counts them) was issued under."""
    from benchmark.tracing import is_kernel
    return [trace._spans.get(e.id, frozenset())
            for e, _, _ in trace.device if is_kernel(e.name)]
