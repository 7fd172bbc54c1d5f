"""A stage's share of its roofline: the least time the card could take
for the stage's work in the traced window (``roofline.least_time`` of
the entry's ``stages[definition["stage"]]``, counted from the problem
alone, times the calls), over the device time of the kernels the metric
names (as ``device_ms``), in percent. ``binds`` says which bound binds."""

from benchmark import roofline


def read(definition, run):
    if run.trace is None:
        return None
    stages = run.cell.stages.get(definition["stage"])
    seconds = run.trace.seconds(definition["match"], definition["names"])
    if not stages or seconds <= 0:
        return None
    least, binds = roofline.least_time(stages)
    return {"value": 100.0 * least * run.window.calls / seconds,
            "binds": binds}
