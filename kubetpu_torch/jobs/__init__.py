"""The port of ``kubetpu.jobs``: model, sampling, KV quantization, cached
decode and paged continuous-batching serving."""
