"""Parameter conversion from the JAX package's tree to the port's module.

The JAX tree stacks every per-layer weight on a leading ``L`` axis
(``{"embed", "blocks": {"wq": (L, d, H, hd), ...}, "ln_f", "head"}``); the
port holds one ``Block`` per layer. ``params_from_numpy`` takes that tree
already turned into numpy arrays (``jax.tree.map(np.asarray, params)``) —
so this module needs no JAX — and un-stacks the layer axis;
``params_to_numpy`` goes the other way, so that tests can hold trained
weights against the JAX package's. Mixture-of-experts leaves (``moe_router``
and the experts' ``w_gate``/``w_up``/``w_down``) cross both ways. A
quantized JAX tree (``jax.tree.map(np.asarray, quantize_params(p))``) comes
across too: its ``QTensor`` leaves, read by duck typing (``.q``,
``.scale``), become the port's ``quant.QTensor``s, one layer's slice each,
dequantizing to the config's dtype. ``lora_from_numpy`` / ``lora_to_numpy``
carry a LoRA adapter tree (``{"blocks": {leaf: (L, ...)}}``, the layer axis
kept: the port's adapters are stacked like the reference's) the same way.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

import numpy as np
import torch
from torch import nn

from kubetpu_torch.jobs.model import (ModelConfig, Transformer, block_leaves,
                                      resolve_device)
from kubetpu_torch.jobs.quant import QTensor, require_unquantized


def _is_qtensor(leaf) -> bool:
    return hasattr(leaf, "q") and hasattr(leaf, "scale")


def params_from_numpy(np_tree: Mapping, cfg: ModelConfig, device=None,
                      dtype: Optional[torch.dtype] = None) -> Transformer:
    """The port's ``Transformer`` with the weights of *np_tree*, on
    *device* (the card by default), in *dtype* (``cfg.dtype`` by default).
    Raises on a missing leaf or a shape that disagrees with *cfg*."""
    device = resolve_device(device)
    if dtype is not None and dtype != cfg.dtype:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    model = Transformer(cfg, torch.device("meta"))

    def tensor(arr, dtype=None) -> torch.Tensor:
        arr = np.asarray(arr)
        if dtype is None:      # through float32: numpy has no bfloat16, and
            arr = arr.astype(np.float32)     # every model dtype round-trips
        return torch.from_numpy(np.array(arr)).to(     # a writable copy
            device=device, dtype=dtype or cfg.dtype)

    def put(module: nn.Module, name: str, leaf, index, what: str) -> None:
        want = tuple(getattr(module, name).shape)
        if _is_qtensor(leaf):
            q, scale = np.asarray(leaf.q), np.asarray(leaf.scale)
            if index is not None:
                q, scale = q[index], scale[index]
            value = QTensor(tensor(q, torch.int8),
                            tensor(scale, torch.float32), cfg.dtype)
        else:
            arr = np.asarray(leaf)
            value = nn.Parameter(tensor(arr if index is None else arr[index]),
                                 requires_grad=False)
        if tuple(value.shape) != want:
            raise ValueError(f"{what}: shape {tuple(value.shape)} does not "
                             f"match the config's {want}")
        delattr(module, name)
        setattr(module, name, value)

    blocks = np_tree["blocks"]
    for name in ("embed", "ln_f", "head"):
        put(model, name, np_tree[name], None, name)
    for name in block_leaves(cfg):
        leaf = blocks[name]
        layers = (np.asarray(leaf.q) if _is_qtensor(leaf)
                  else np.asarray(leaf)).shape[0]
        if layers != cfg.n_layers:
            raise ValueError(f"blocks.{name}: {layers} layers, config has "
                             f"{cfg.n_layers}")
        for i, blk in enumerate(model.blocks):
            put(blk, name, leaf, i, f"blocks.{name}[{i}]")
    return model


def params_to_numpy(model: Transformer) -> dict:
    """The weights of *model* as the JAX package's tree of numpy arrays:
    ``{"embed", "blocks": {leaf: (L, ...)}, "ln_f", "head"}``, in float32
    (numpy has no bfloat16). An int8 model is refused: dequantize it
    first."""
    require_unquantized(model, "params_to_numpy")

    def arr(t: torch.Tensor) -> np.ndarray:
        return t.detach().float().cpu().numpy()

    return {
        "embed": arr(model.embed),
        "blocks": {name: np.stack([arr(getattr(blk, name))
                                   for blk in model.blocks])
                   for name in block_leaves(model.cfg)},
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
