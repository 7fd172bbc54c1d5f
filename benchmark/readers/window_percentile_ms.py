"""The ``q``-th percentile of the latencies of all calls in the window,
in milliseconds (for entries whose caller waits for each answer)."""

from benchmark.window import percentile


def read(definition, run):
    if not run.window.latencies:
        return None
    return {"value": 1e3 * percentile(run.window.latencies,
                                      definition["q"])}
