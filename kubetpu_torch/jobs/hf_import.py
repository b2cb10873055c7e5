"""HuggingFace llama-family checkpoint import (port of
``kubetpu/jobs/hf_import.py``).

Load a pretrained ``LlamaForCausalLM`` (or its state dict) into the port's
``Transformer`` and every downstream path — training, LoRA, the servers,
speculation — consumes it unchanged. The conversion is pure layout: the
port's block math (half-split RoPE with ``theta^(-i/(d/2))`` frequencies,
f32 RMSNorm at eps 1e-6, SiLU gate MLP, pre-norm residuals, hd^-0.5
attention scale) is the llama recipe, so converted logits match the torch
reference to float tolerance.

The module imports no ``transformers``: it reads attributes of any config
object (a ``transformers`` config, or a ``types.SimpleNamespace`` with the
same fields) and the ``state_dict()`` of any model, or takes a dict of
tensors (torch or numpy) with a ``cfg``. Each tensor goes straight to the
target device in the target dtype and is laid out there, one at a time —
no f32 host copy of the whole checkpoint is made.

Layout mapping (torch Linear stores (out, in); the port keeps head
structure explicit, one ``Block`` a layer):

    embed_tokens.weight   (V, D)      -> embed            (V, D)
    q_proj.weight         (H*hd, D)   -> wq = W.T reshaped (D, H, hd)
    k/v_proj.weight       (KV*hd, D)  -> wk/wv            (D, KV, hd)
    o_proj.weight         (D, H*hd)   -> wo = W.T reshaped (H, hd, D)
    gate/up_proj.weight   (F, D)      -> w_gate/w_up      (D, F)
    down_proj.weight      (D, F)      -> w_down           (F, D)
    input_layernorm       (D,)        -> ln1
    post_attention_layernorm (D,)     -> ln2
    model.norm.weight     (D,)        -> ln_f
    lm_head.weight        (V, D)      -> head = W.T        (D, V)
                                         (embed.T when weights are tied)
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from kubetpu_torch.jobs.model import ModelConfig, Transformer, resolve_device


def config_from_hf(hf_config, **overrides) -> ModelConfig:
    """``ModelConfig`` from a llama config (any object with its fields).

    Checkpoint features the port's block math does not reproduce are
    REFUSED, not silently dropped — a conversion that succeeds is one
    whose logits match the torch reference. Llama-3.1-style
    ``rope_scaling`` (type 'llama3') IS reproduced (translated to
    ``ModelConfig.rope_llama3_scaling``); other scaling types and
    attention/MLP biases refuse. RMSNorm eps is fixed at 1e-6; a
    checkpoint trained at another eps converts with a warning."""
    if getattr(hf_config, "model_type", "llama") != "llama":
        raise ValueError(
            f"unsupported model_type {hf_config.model_type!r}; the importer "
            f"maps the llama family"
        )
    scaling = getattr(hf_config, "rope_scaling", None)
    llama3 = None
    if scaling:
        rope_type = scaling.get("rope_type", scaling.get("type"))
        if rope_type == "llama3":
            llama3 = (
                float(scaling["factor"]),
                float(scaling["low_freq_factor"]),
                float(scaling["high_freq_factor"]),
                int(scaling["original_max_position_embeddings"]),
            )
        elif rope_type != "default":
            raise ValueError(
                f"rope_scaling type {rope_type!r} is not supported (only "
                f"'llama3' and 'default'): converting would produce "
                f"silently wrong logits"
            )
    if getattr(hf_config, "attention_bias", False) or getattr(
            hf_config, "mlp_bias", False):
        raise ValueError(
            "attention_bias/mlp_bias checkpoints are not supported: the "
            "port's projections are bias-free, so the bias terms would "
            "be silently dropped"
        )
    eps = float(getattr(hf_config, "rms_norm_eps", 1e-6))
    if abs(eps - 1e-6) > 0:
        warnings.warn(
            f"checkpoint rms_norm_eps={eps:g} != the port's fixed 1e-6; "
            f"converted logits will differ at the ~{eps:g} level",
            stacklevel=2,
        )
    explicit_hd = getattr(hf_config, "head_dim", None)
    derived_hd = hf_config.hidden_size // hf_config.num_attention_heads
    if explicit_hd is not None and int(explicit_hd) != derived_hd:
        raise ValueError(
            f"head_dim={explicit_hd} != hidden_size/num_attention_heads="
            f"{derived_hd}: the port's blocks derive head_dim, so this "
            f"checkpoint cannot be mapped faithfully"
        )
    kw = dict(
        vocab=hf_config.vocab_size,
        d_model=hf_config.hidden_size,
        n_layers=hf_config.num_hidden_layers,
        n_heads=hf_config.num_attention_heads,
        d_ff=hf_config.intermediate_size,
        max_seq=hf_config.max_position_embeddings,
        rope_theta=float(getattr(hf_config, "rope_theta", 10000.0)),
    )
    if llama3 is not None:
        kw["rope_llama3_scaling"] = llama3
    n_kv = getattr(hf_config, "num_key_value_heads", None) or kw["n_heads"]
    if n_kv != kw["n_heads"]:
        kw["n_kv_heads"] = n_kv
    kw.update(overrides)
    return ModelConfig(**kw)


def params_from_hf(model_or_state_dict, cfg: Optional[ModelConfig] = None,
                   dtype: Optional[torch.dtype] = None,
                   device=None) -> Tuple[Transformer, ModelConfig]:
    """Convert a llama model (anything with ``.config`` and
    ``.state_dict()``) or a state dict into ``(model, cfg)`` on *device*
    (the card by default). ``dtype`` overrides the parameter dtype (e.g.
    ``torch.bfloat16`` for serving); it defaults to ``cfg.dtype``, and the
    returned cfg carries the dtype the weights have."""
    if hasattr(model_or_state_dict, "state_dict"):
        if cfg is None:
            cfg = config_from_hf(model_or_state_dict.config)
        sd = model_or_state_dict.state_dict()
    else:
        sd = dict(model_or_state_dict)
        if cfg is None:
            raise ValueError("pass cfg when converting a bare state_dict")
    if cfg.n_experts > 0:
        raise ValueError("the importer maps dense llama; MoE configs don't")
    device = resolve_device(device)
    dtype = dtype or cfg.dtype
    if dtype != cfg.dtype:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    d, h, hd, kv, f = (cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.kv_heads,
                       cfg.d_ff)

    consumed = set()

    def key_of(name):
        key = f"model.{name}" if f"model.{name}" in sd else name
        if key not in sd:
            raise KeyError(f"checkpoint is missing {name!r}")
        return key

    def tensor(key):
        t = sd[key]
        if not torch.is_tensor(t):
            t = torch.from_numpy(np.ascontiguousarray(t))
        out = t.detach().to(device=device, dtype=dtype)
        # already on the device in the dtype: copy, so that training the
        # converted model never writes into the caller's checkpoint
        return out.clone() if out.data_ptr() == t.data_ptr() else out

    def get(name):
        key = key_of(name)
        consumed.add(key)
        return tensor(key)

    def put(module, attr, value, what):
        want = tuple(getattr(module, attr).shape)
        if tuple(value.shape) != want:
            raise ValueError(
                f"{what}: checkpoint shape {tuple(value.shape)} != config "
                f"{want} — config/checkpoint mismatch")
        delattr(module, attr)
        setattr(module, attr, nn.Parameter(value.contiguous(),
                                           requires_grad=False))

    def linear(name, *shape, out_first=False):
        """A torch Linear's (out, in) weight -> the port's (in, *shape), or
        with *out_first* (*shape, out)."""
        w = get(name).t()
        try:
            return (w.reshape(*shape, w.shape[1]) if out_first
                    else w.reshape(w.shape[0], *shape))
        except RuntimeError as e:
            raise ValueError(f"{name}: checkpoint shape {tuple(w.t().shape)} "
                             f"does not fit the config — config/checkpoint "
                             f"mismatch") from e

    model = Transformer(cfg, torch.device("meta"))
    for i, blk in enumerate(model.blocks):
        p = f"layers.{i}."
        for attr, value in (
                ("ln1", get(p + "input_layernorm.weight")),
                ("ln2", get(p + "post_attention_layernorm.weight")),
                ("wq", linear(p + "self_attn.q_proj.weight", h, hd)),
                ("wk", linear(p + "self_attn.k_proj.weight", kv, hd)),
                ("wv", linear(p + "self_attn.v_proj.weight", kv, hd)),
                ("wo", linear(p + "self_attn.o_proj.weight", h, hd,
                              out_first=True)),
                ("w_gate", linear(p + "mlp.gate_proj.weight", f)),
                ("w_up", linear(p + "mlp.up_proj.weight", f)),
                ("w_down", linear(p + "mlp.down_proj.weight", d))):
            put(blk, attr, value, f"layers.{i}.{attr}")
    embed = get("embed_tokens.weight")
    put(model, "embed", embed, "embed")
    if "lm_head.weight" in sd:
        head = tensor("lm_head.weight").t()
    else:  # tied embeddings
        head = embed.t()
    put(model, "head", head, "head")
    put(model, "ln_f", get("norm.weight"), "ln_f")
    consumed.add("lm_head.weight")
    # Anything left unmapped means the converted model would NOT reproduce
    # the reference (dropped bias terms, extra adapters, ...). Rotary
    # inv_freq buffers are the one benign legacy leftover.
    leftover = sorted(
        k for k in sd
        if k not in consumed and "rotary_emb.inv_freq" not in k
    )
    if leftover:
        raise ValueError(
            f"checkpoint has {len(leftover)} unmapped tensor(s) the "
            f"conversion would silently drop: {leftover[:6]}"
            f"{'...' if len(leftover) > 6 else ''}"
        )
    return model, cfg
