"""Device milliseconds per call of the kernels a metric names: by name
(``match`` "kernels", ``names`` regular expressions) or by the spans
they were launched under (``match`` "spans")."""


def read(definition, run):
    if run.trace is None:
        return None
    seconds = run.trace.seconds(definition["match"], definition["names"])
    if seconds <= 0:
        return None
    return {"value": 1e3 * seconds / run.window.calls}
