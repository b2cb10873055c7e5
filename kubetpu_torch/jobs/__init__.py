"""The port of ``kubetpu.jobs``: model, sampling, KV quantization, cached
decode, paged continuous-batching serving (with shared-prefix reuse, the
host DRAM tier and windowed ring tables), and single-card training (loss
tail, optimizer, train step, synthetic data)."""
