"""The measured window: a closed loop of one client, and the seeded
sample of its answers that the reference judges afterwards."""

from __future__ import annotations

import dataclasses
import math
import random
import time
from typing import Callable, List


class Reservoir:
    """A uniform sample of ``k`` items of a stream of unknown length
    (Vitter's algorithm R), drawn from ``seed``."""

    def __init__(self, k: int, seed: int):
        self.k, self.seen, self.items = k, 0, []
        self._rng = random.Random(seed)

    def offer(self, item) -> None:
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = self._rng.randrange(self.seen + 1)
            if j < self.k:
                self.items[j] = item
        self.seen += 1


@dataclasses.dataclass
class Window:
    calls: int
    seconds: float
    latencies: List[float]


def run(call: Callable[[int], object], waited: bool, seconds: float,
        keep: Reservoir, sync: Callable[[], None]) -> Window:
    """Calls ``call(0)``, ``call(1)``, ... until ``seconds`` have passed.

    ``waited``: each call is synchronised and its latency kept, as a
    caller that waits for each answer. Otherwise the calls are dispatched
    ahead and the window ends with one synchronisation, so it spans all
    the work it issued. Each answer is offered to ``keep``."""
    latencies: List[float] = []
    i = 0
    start = time.perf_counter()
    while True:
        t0 = time.perf_counter()
        out = call(i)
        if waited:
            sync()
            t1 = time.perf_counter()
            latencies.append(t1 - t0)
        else:
            t1 = time.perf_counter()
        keep.offer((i, out))
        i += 1
        if t1 - start >= seconds:
            break
    sync()
    return Window(i, time.perf_counter() - start, latencies)


def percentile(values: List[float], q: float) -> float:
    """The nearest-rank ``q``-th percentile of all ``values``."""
    ordered = sorted(values)
    return ordered[max(0, math.ceil(q / 100.0 * len(ordered)) - 1)]
