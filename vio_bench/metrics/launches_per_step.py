"""Kernels run on the device per batched step in the traced window (one per
launch, by the runtime or the driver API)."""


def read(ctx):
    t = ctx.trace
    if t is None or not t.kernels:
        return None
    return len(t.kernels) / t.steps
