"""The port of ``kubetpu.jobs``: model, sampling, KV quantization, cached
decode, paged continuous-batching serving, and single-card training
(loss tail, optimizer, train step, synthetic data)."""
