"""95th percentile of every gap (ms) between consecutive tokens of the
requests that the window's time to first token covers, on the benchmark's
clock. Layer: engine, step loop."""


def read(ctx):
    return ctx.e2e_extra.get("itl_p95_ms")
