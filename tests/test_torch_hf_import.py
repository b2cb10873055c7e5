"""The port's HuggingFace llama importer (``kubetpu_torch/jobs/
hf_import.py``) on randomly initialised small ``LlamaForCausalLM``s: the
converted model's logits against the HF torch forward (rtol 2e-3, atol
2e-4, the JAX importer's own tolerance) and against the JAX importer's
converted model through the JAX forward (f32 on both sides, atol 1e-4:
summation order only), greedy decoding against HF ``generate`` exactly,
and the same refusals as the JAX importer. The module never imports
``transformers``; here ``transformers`` only builds the oracles."""

import dataclasses
import types
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from kubetpu.jobs import forward as jforward  # noqa: E402
from kubetpu.jobs import hf_import as jhf  # noqa: E402
from kubetpu_torch.jobs import hf_import as thf  # noqa: E402
from kubetpu_torch.jobs import model as tmodel  # noqa: E402
from kubetpu_torch.jobs.decode import make_generate  # noqa: E402

torch.set_num_threads(1)

IDS = np.array([[1, 5, 9, 2, 30, 7], [3, 3, 60, 4, 11, 0]], np.int64)
BASE = dict(vocab_size=64, hidden_size=32, intermediate_size=64,
            num_hidden_layers=2, num_attention_heads=4,
            max_position_embeddings=128, rms_norm_eps=1e-6,
            rope_theta=10000.0, attention_bias=False, mlp_bias=False)


def _hf(seed=0, **over):
    from transformers import LlamaConfig, LlamaForCausalLM

    torch.manual_seed(seed)
    cfg = LlamaConfig(**{**BASE, "num_key_value_heads": 4, **over})
    return LlamaForCausalLM(cfg).eval()


def _hf_logits(model, ids):
    with torch.no_grad():
        return model(torch.tensor(ids)).logits.float().numpy()


def _port_logits(model, cfg, ids):
    return tmodel.forward(model, torch.tensor(ids), cfg).float().numpy()


CASES = {
    "mha": dict(seed=0),
    "gqa": dict(seed=1, num_key_value_heads=2),
    "tied": dict(seed=2, tie_word_embeddings=True),
    "llama3_rope": dict(
        seed=5, num_key_value_heads=2, max_position_embeddings=256,
        rope_scaling={"rope_type": "llama3", "factor": 8.0,
                      "low_freq_factor": 1.0, "high_freq_factor": 4.0,
                      "original_max_position_embeddings": 32}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_logits_match_hf_and_the_jax_import(case):
    over = dict(CASES[case])
    hf = _hf(over.pop("seed"), **over)
    # long positions exercise the warped band of the llama3 case
    ids = (np.arange(1, 49, dtype=np.int64)[None] % 64
           if case == "llama3_rope" else IDS)
    model, cfg = thf.params_from_hf(hf, device="cpu")
    jparams, jcfg = jhf.params_from_hf(hf)
    for f in ("vocab", "d_model", "n_layers", "n_heads", "n_kv_heads",
              "d_ff", "max_seq", "rope_theta", "rope_llama3_scaling"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    got = _port_logits(model, cfg, ids)
    np.testing.assert_allclose(got, _hf_logits(hf, ids), rtol=2e-3,
                               atol=2e-4)
    want = np.asarray(jforward(jparams, jnp.asarray(ids, jnp.int32), jcfg))
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    if case == "tied":
        assert torch.equal(model.head, model.embed.t())
        assert model.head.data_ptr() != model.embed.data_ptr()
    if case == "llama3_rope":
        assert cfg.rope_llama3_scaling == (8.0, 1.0, 4.0, 32)


@pytest.mark.parametrize("case", ["mha", "llama3_rope"])
def test_greedy_generate_matches_hf(case):
    over = dict(CASES[case])
    hf = _hf(over.pop("seed"), **over)
    model, cfg = thf.params_from_hf(hf, device="cpu")
    prompt = torch.tensor([[1, 5, 9, 2, 7, 3, 30, 8]])
    with torch.no_grad():
        want = hf.generate(prompt, max_new_tokens=8, do_sample=False,
                           pad_token_id=0)
    got = make_generate(cfg)(model, prompt, 0, 8)
    assert torch.equal(got, want)


def test_state_dict_with_a_namespace_config():
    """What the card sees: a dict of tensors (torch or numpy) and a plain
    namespace config, no ``transformers`` object."""
    hf = _hf(1, num_key_value_heads=2)
    ns = types.SimpleNamespace(**{**BASE, "num_key_value_heads": 2,
                                  "model_type": "llama"})
    cfg = thf.config_from_hf(ns)
    assert cfg == thf.config_from_hf(hf.config)
    sd = hf.state_dict()
    model, cfg2 = thf.params_from_hf(sd, cfg=cfg, device="cpu")
    np_sd = {k: v.numpy() for k, v in sd.items()}
    model_np, _ = thf.params_from_hf(np_sd, cfg=cfg, device="cpu")
    want = _hf_logits(hf, IDS)
    for m in (model, model_np):
        np.testing.assert_allclose(_port_logits(m, cfg2, IDS), want,
                                   rtol=2e-3, atol=2e-4)
    # the converted weights own their storage: the checkpoint is untouched
    before = sd["model.embed_tokens.weight"].clone()
    with torch.no_grad():
        model.embed.add_(1.0)
    assert torch.equal(sd["model.embed_tokens.weight"], before)


def test_bf16_override():
    hf = _hf(0)
    model, cfg = thf.params_from_hf(hf, dtype=torch.bfloat16, device="cpu")
    assert cfg.dtype == torch.bfloat16
    assert all(p.dtype == torch.bfloat16 for p in model.parameters())
    assert model.blocks[0].wq.shape == (32, 4, 8)
    jparams, _ = jhf.params_from_hf(hf, dtype=jnp.bfloat16)
    assert jparams["blocks"]["wq"].dtype == jnp.bfloat16
    # the same bf16 weights as the JAX importer's
    np.testing.assert_array_equal(
        model.blocks[1].w_down.float().numpy(),
        np.asarray(jparams["blocks"]["w_down"][1], np.float32))
    np.testing.assert_allclose(_port_logits(model, cfg, IDS),
                               _hf_logits(hf, IDS), atol=0.05)


def test_refusals_match_the_jax_importer():
    from transformers import LlamaConfig

    base = {**BASE, "num_key_value_heads": 4}
    for bad in (dict(rope_scaling={"rope_type": "yarn", "factor": 8.0}),
                dict(attention_bias=True), dict(mlp_bias=True),
                dict(head_dim=16)):
        hf_cfg = LlamaConfig(**{**base, **bad})
        with pytest.raises(ValueError):
            jhf.config_from_hf(hf_cfg)
        with pytest.raises(ValueError):
            thf.config_from_hf(hf_cfg)
    for mod in (jhf, thf):
        with pytest.raises(ValueError, match="model_type"):
            mod.config_from_hf(types.SimpleNamespace(model_type="gpt2"))
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            mod.config_from_hf(LlamaConfig(**{**base, "rms_norm_eps": 1e-5}))
        assert any("rms_norm_eps" in str(x.message) for x in w)

    hf = _hf(4)
    cfg = thf.config_from_hf(hf.config)
    sd = dict(hf.state_dict())
    with pytest.raises(ValueError, match="pass cfg"):
        thf.params_from_hf(sd, device="cpu")
    missing = {k: v for k, v in sd.items() if "embed_tokens" not in k}
    with pytest.raises(KeyError):
        thf.params_from_hf(missing, cfg=cfg, device="cpu")
    extra = {**sd, "model.layers.0.self_attn.q_proj.bias": torch.zeros(32)}
    with pytest.raises(ValueError, match="unmapped"):
        thf.params_from_hf(extra, cfg=cfg, device="cpu")
    with pytest.raises(ValueError, match="mismatch"):
        thf.params_from_hf(sd, cfg=dataclasses.replace(cfg, vocab=128),
                           device="cpu")
    with pytest.raises(ValueError, match="mismatch"):
        thf.params_from_hf(sd, cfg=dataclasses.replace(cfg, d_ff=48),
                           device="cpu")
    with pytest.raises(ValueError, match="MoE"):
        thf.params_from_hf(sd, cfg=dataclasses.replace(cfg, n_experts=2),
                           device="cpu")
    # the rotary inv_freq buffer is the one leftover that is accepted
    legacy = {**sd, "model.layers.0.self_attn.rotary_emb.inv_freq":
              torch.zeros(4)}
    thf.params_from_hf(legacy, cfg=cfg, device="cpu")
