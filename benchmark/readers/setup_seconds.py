"""Seconds from the start of the process to the start of the window:
imports, the card's context, inputs, the program's set-up and warm-up
(and the kernels' build on the first run of a checkout)."""


def read(definition, run):
    return {"value": run.setup_s}
