"""Parameter conversion from the JAX package's tree to the port's module.

The JAX tree stacks every per-layer weight on a leading ``L`` axis
(``{"embed", "blocks": {"wq": (L, d, H, hd), ...}, "ln_f", "head"}``); the
port holds one ``Block`` per layer. ``params_from_numpy`` takes that tree
already turned into numpy arrays (``jax.tree.map(np.asarray, params)``) —
so this module needs no JAX — and un-stacks the layer axis;
``params_to_numpy`` goes the other way, so that tests can hold trained
weights against the JAX package's. ``lora_from_numpy`` / ``lora_to_numpy``
carry a LoRA adapter tree (``{"blocks": {leaf: (L, ...)}}``, the layer axis
kept: the port's adapters are stacked like the reference's) the same way.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

import numpy as np
import torch

from kubetpu_torch.jobs.model import ModelConfig, Transformer, resolve_device

_BLOCK_LEAVES = ("ln1", "ln2", "wq", "wk", "wv", "wo", "w_gate", "w_up",
                 "w_down")


def params_from_numpy(np_tree: Mapping, cfg: ModelConfig, device=None,
                      dtype: Optional[torch.dtype] = None) -> Transformer:
    """The port's ``Transformer`` with the weights of *np_tree*, on
    *device* (the card by default), in *dtype* (``cfg.dtype`` by default).
    Raises on a missing leaf or a shape that disagrees with *cfg*."""
    device = resolve_device(device)
    if dtype is not None and dtype != cfg.dtype:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    model = Transformer(cfg, device)

    def put(param: torch.Tensor, arr, name: str) -> None:
        arr = np.asarray(arr)
        if tuple(arr.shape) != tuple(param.shape):
            raise ValueError(f"{name}: shape {arr.shape} does not match "
                             f"the config's {tuple(param.shape)}")
        # through float32: numpy has no bfloat16, and every dtype the
        # model uses round-trips through it exactly
        param.copy_(torch.from_numpy(arr.astype(np.float32)).to(device))

    blocks = np_tree["blocks"]
    with torch.no_grad():
        put(model.embed, np_tree["embed"], "embed")
        put(model.ln_f, np_tree["ln_f"], "ln_f")
        put(model.head, np_tree["head"], "head")
        for name in _BLOCK_LEAVES:
            stacked = np.asarray(blocks[name])
            if stacked.shape[0] != cfg.n_layers:
                raise ValueError(f"blocks.{name}: {stacked.shape[0]} layers, "
                                 f"config has {cfg.n_layers}")
            for i, blk in enumerate(model.blocks):
                put(getattr(blk, name), stacked[i], f"blocks.{name}[{i}]")
    return model


def params_to_numpy(model: Transformer) -> dict:
    """The weights of *model* as the JAX package's tree of numpy arrays:
    ``{"embed", "blocks": {leaf: (L, ...)}, "ln_f", "head"}``, in float32
    (numpy has no bfloat16)."""
    def arr(t: torch.Tensor) -> np.ndarray:
        return t.detach().float().cpu().numpy()

    return {
        "embed": arr(model.embed),
        "blocks": {name: np.stack([arr(getattr(blk, name))
                                   for blk in model.blocks])
                   for name in _BLOCK_LEAVES},
        "ln_f": arr(model.ln_f),
        "head": arr(model.head),
    }


def lora_from_numpy(np_tree: Mapping, device=None,
                    dtype: torch.dtype = torch.float32) -> dict:
    """The port's adapter tree of the JAX package's (numpy arrays, e.g.
    ``jax.tree.map(np.asarray, lora)``), on *device* (the card by default)
    in *dtype*, leaves in the tree's key order."""
    device = resolve_device(device)
    return {"blocks": {
        k: torch.from_numpy(np.asarray(v).astype(np.float32)).to(
            device=device, dtype=dtype)
        for k, v in np_tree["blocks"].items()}}


def lora_to_numpy(lora: Mapping) -> dict:
    """An adapter tree as the JAX package's tree of numpy arrays, in
    float32 (numpy has no bfloat16)."""
    return {"blocks": {k: v.detach().float().cpu().numpy()
                       for k, v in lora["blocks"].items()}}
