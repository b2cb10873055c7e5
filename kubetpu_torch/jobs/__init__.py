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
draft distillation (``distill``); and the multi-device training path: the
DeviceMesh (``meshjob``), the gang launch (``launch``), the collectives
(``collectives``), ring attention (``ring_attention``), the sharded step
(``train``) and the GPipe pipeline (``pipeline``).

Submodules, imported by users:
  ``beam`` (beam search over the dense KV cache),
  ``profiling`` (``StepTimer``, ``marginal_ms``, ``torch.profiler`` traces),
  ``encoder`` (the bidirectional masked-LM family),
  ``vision`` (the ViT classification family),
  ``seq2seq`` (the encoder-decoder family, cached greedy generate),
  ``decode``, ``serving``, ``paged``, ``spec_serving``, ``speculative``,
  ``multi_lora``, ``lora``, ``train``, ``data``, ``tokenizer``,
  ``native_data``, ``checkpoint``, ``hf_import``, ``distill``, ``quant``,
  ``sampling``, ``convert`` (weights across from the JAX package's trees),
  ``meshjob``, ``launch``, ``collectives``, ``ring_attention``,
  ``pipeline``."""
