"""The window's milliseconds over the count of calls completed in it."""


def read(definition, run):
    return {"value": 1e3 * run.window.seconds / run.window.calls}
