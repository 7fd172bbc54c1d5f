"""Program spans per call that start in the traced window and are named
by one of the regular expressions ``names``: how often the program
entered that step."""

from benchmark.readers import _spans


def read(definition, run):
    if run.trace is None:
        return None
    want = _spans.matcher(definition["names"])
    count = sum(1 for e in _spans.program_spans(run.trace)
                if want(e.name) and _spans.in_window(run.trace,
                                                     e.time_range.start))
    return {"value": count / run.window.calls}
