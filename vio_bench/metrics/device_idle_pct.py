"""The device's idle share of the traced window: 100 x (1 - the union of the
device operations' intervals / the window's length on the host clock)."""


def read(ctx):
    t = ctx.trace
    if t is None or not t.ops or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
