"""Kernel launches per call in the traced window (device kernels, not
copies or fills)."""


def read(definition, run):
    if run.trace is None or not run.trace.device:
        return None
    return {"value": run.trace.kernel_launches() / run.window.calls}
