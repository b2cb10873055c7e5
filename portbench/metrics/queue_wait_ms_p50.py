"""Median queue wait (ms): enqueue to the first prefill chunk, from the
server's own reservoir (``metrics_summary()["queue_wait"]``; a median is
sound there, a tail is not). Layer: engine, admission."""


def read(ctx):
    qw = ctx.summary.get("queue_wait")
    return qw["p50_ms"] if qw and qw.get("count") else None
