"""Host runtime calls per call that start in the traced window, under a
program span, and are named by one of the regular expressions
``names`` (such as the blocking ``cudaStreamSynchronize``). Calls under
no program span, as the window's own closing synchronisation, are not
counted."""

from benchmark.readers import _spans


def read(definition, run):
    if run.trace is None:
        return None
    want = _spans.matcher(definition["names"])
    starts = [e.time_range.start for e in run.trace._cpu
              if not e.is_user_annotation and want(e.name)
              and _spans.in_window(run.trace, e.time_range.start)]
    count = sum(1 for name in _spans.innermost(run.trace, starts)
                if name is not None)
    return {"value": count / run.window.calls}
