"""Kernel launches per call (device kernels, not copies or fills, as
``launches`` counts them) issued under a span named by one of the
regular expressions ``under`` and under none named by ``not_under``."""

from benchmark.readers import _spans


def read(definition, run):
    if run.trace is None:
        return None
    under = _spans.matcher(definition["under"])
    not_under = _spans.matcher(definition.get("not_under", []))
    count = sum(1 for names in _spans.launch_spans(run.trace)
                if any(map(under, names)) and not any(map(not_under, names)))
    return {"value": count / run.window.calls}
