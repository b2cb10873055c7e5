"""The port of ``kubetpu.jobs``: model, sampling, KV quantization, the dense
KV-cache decode path (``make_generate``), continuous-batching servers over a
dense cache (``DecodeServer``) and a paged one (``PagedDecodeServer``, with
shared-prefix reuse, the host DRAM tier and windowed ring tables), both with
the ``overlap`` pipeline, speculative decoding (``speculative``, and the
dense and paged speculative servers of ``spec_serving``), multi-LoRA
serving (``multi_lora``), single-card training (loss tail, optimizer,
train step, synthetic data, LoRA fine-tuning in ``lora``), and the model's
lifecycle around them: the byte and BPE tokenizers (``data``,
``tokenizer``), the native token-file loader (``native_data``), checkpoint
and resume (``checkpoint``), the HF llama importer (``hf_import``) and
draft distillation (``distill``)."""
