"""Work completed per second over the whole window: the window's calls
times the work of one call (``definition["work"]``, a count the entry
states, such as nonuniform points times transforms), over the window's
seconds, which end when the device has finished all the work issued."""


def read(definition, run):
    work = run.cell.work[definition["work"]]
    return {"value": run.window.calls * work / run.window.seconds}
