"""The device's idle share of the traced window: 100 (1 - busy / window),
busy being the union of the intervals in which a device operation ran."""


def read(definition, run):
    if run.trace is None or not run.trace.device:
        return None
    return {"value": 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)}
