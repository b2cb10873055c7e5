"""95th percentile of time to first token (ms) over the requests the
window covers, timed from when each was sent (due), on the benchmark's
clock. Layer: engine, step loop."""


def read(ctx):
    return ctx.e2e_extra.get("ttft_p95_ms")
