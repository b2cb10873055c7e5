"""Host milliseconds a ``step()`` call: the mean over the calls that
started in the window before the profiler first started (its start and
its callbacks slow the host). Layer: engine, step loop."""


def read(ctx):
    n = len(ctx.window_steps)
    return ctx.window_s * 1e3 / n if n else None
