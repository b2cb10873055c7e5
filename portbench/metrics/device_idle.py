"""Share (%) of the traced slice in which no operation ran on the device
(the union of the trace's device intervals against the slice's host-clock
length). Layer: device."""


def read(ctx):
    if ctx.slice.window_s <= 0 or ctx.slice.busy_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.slice.busy_s / ctx.slice.window_s)
