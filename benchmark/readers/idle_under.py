"""Device-idle milliseconds per call that fall to one layer: the idle
gaps of the traced window (as ``idle_pct`` counts them) whose midpoint
lies where the innermost program span is named by one of the regular
expressions ``names``. Gaps split this way add up, with those under no
program span, to the window's idle time."""

from benchmark.readers import _spans


def read(definition, run):
    if run.trace is None:
        return None
    want = _spans.matcher(definition["names"])
    us = sum(gap for gap, name in _spans.idle_by_span(run.trace)
             if name is not None and want(name))
    return {"value": us / 1e3 / run.window.calls}
