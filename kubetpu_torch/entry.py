"""The port's counterpart of the JAX package's ``entry()``
(``__graft_entry__.py``): the tiny flagship config's forward, on the card
unless the caller names another device.

    fn, args = entry()            # fn(*args) -> logits (2, 32, 128) f32
"""

from __future__ import annotations

import torch

from kubetpu_torch.jobs.model import (ModelConfig, forward, init_params,
                                      resolve_device)


def tiny_config() -> ModelConfig:
    """``__graft_entry__._cfg()``'s tiny config: vocab 128, d 64, 2 layers,
    4 heads, d_ff 128, max_seq 128, f32."""
    return ModelConfig(vocab=128, d_model=64, n_layers=2, n_heads=4,
                       d_ff=128, max_seq=128)


def entry(device=None):
    """-> (fn, example_args): ``fn(params, tokens)`` is the tiny config's
    forward (logits (B, S, V)); the example is random weights from seed 0
    and a (2, 32) batch of tokens from seed 1, on *device* (the card by
    default; raises without CUDA unless *device* names another)."""
    device = resolve_device(device)
    cfg = tiny_config()
    params = init_params(torch.Generator(device=device).manual_seed(0), cfg,
                         device=device)
    tokens = torch.randint(0, cfg.vocab, (2, 32), device=device,
                           generator=torch.Generator(device=device)
                           .manual_seed(1))

    def fn(params, tokens):
        return forward(params, tokens, cfg)

    return fn, (params, tokens)
