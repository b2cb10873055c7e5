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
``shard_params`` / ``gather_params`` carry the tree to and from one
rank's shard on a mesh (``train.param_specs``).
``vit_params_from_numpy`` / ``vit_params_to_numpy`` and
``seq2seq_params_from_numpy`` / ``seq2seq_params_to_numpy`` carry the ViT
and encoder-decoder trees, un-stacking their blocks as above.
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
from kubetpu_torch.jobs.seq2seq import CROSS_LEAVES, Seq2Seq
from kubetpu_torch.jobs.vision import VisionTransformer, VitConfig


def _is_qtensor(leaf) -> bool:
    return hasattr(leaf, "q") and hasattr(leaf, "scale")


def _put(module: nn.Module, name: str, leaf, index, cfg: ModelConfig,
         device, what: str) -> None:
    """Replace parameter *name* of *module* with *leaf* (its slice *index*
    of the layer axis, when given) on *device* in ``cfg.dtype``; a quantized
    leaf becomes a ``QTensor``. Raises on a shape that disagrees."""
    def tensor(arr, dtype=None) -> torch.Tensor:
        arr = np.asarray(arr)
        if dtype is None:      # through float32: numpy has no bfloat16, and
            arr = arr.astype(np.float32)     # every model dtype round-trips
        return torch.from_numpy(np.array(arr)).to(     # a writable copy
            device=device, dtype=dtype or cfg.dtype)

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


def _put_all(module: nn.Module, np_tree: Mapping, top, leaves,
             cfg: ModelConfig, device, prefix: str = "") -> None:
    """*module*'s leaves *top* from the tree's top level and, for each of
    its blocks, the leaves *leaves* from ``np_tree["blocks"]``, un-stacking
    the layer axis. Raises ``KeyError`` on a missing leaf, ``ValueError`` on
    a layer count or a shape that disagrees with *cfg*."""
    def get(tree, name, where):
        if name not in tree:
            raise KeyError(f"{prefix}{where}{name}: missing from the tree")
        return tree[name]

    for name in top:
        _put(module, name, get(np_tree, name, ""), None, cfg, device,
             prefix + name)
    blocks = get(np_tree, "blocks", "")
    for name in leaves:
        leaf = get(blocks, name, "blocks.")
        layers = (np.asarray(leaf.q) if _is_qtensor(leaf)
                  else np.asarray(leaf)).shape[0]
        if layers != len(module.blocks):
            raise ValueError(f"{prefix}blocks.{name}: {layers} layers, "
                             f"config has {len(module.blocks)}")
        for i, blk in enumerate(module.blocks):
            _put(blk, name, leaf, i, cfg, device,
                 f"{prefix}blocks.{name}[{i}]")


def _numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def _to_tree(module: nn.Module, top, leaves) -> dict:
    """*module*'s weights as the JAX package's tree: the *top* leaves, and
    ``blocks`` with each of *leaves* stacked on a leading layer axis."""
    tree = {name: _numpy(getattr(module, name)) for name in top}
    tree["blocks"] = {name: np.stack([_numpy(getattr(blk, name))
                                      for blk in module.blocks])
                      for name in leaves}
    return tree


def params_from_numpy(np_tree: Mapping, cfg: ModelConfig, device=None,
                      dtype: Optional[torch.dtype] = None) -> Transformer:
    """The port's ``Transformer`` with the weights of *np_tree*, on
    *device* (the card by default), in *dtype* (``cfg.dtype`` by default).
    Raises on a missing leaf or a shape that disagrees with *cfg*."""
    device = resolve_device(device)
    if dtype is not None and dtype != cfg.dtype:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    model = Transformer(cfg, torch.device("meta"))
    _put_all(model, np_tree, ("embed", "ln_f", "head"), block_leaves(cfg),
             cfg, device)
    return model


def params_to_numpy(model: Transformer) -> dict:
    """The weights of *model* as the JAX package's tree of numpy arrays:
    ``{"embed", "blocks": {leaf: (L, ...)}, "ln_f", "head"}``, in float32
    (numpy has no bfloat16). An int8 model is refused: dequantize it
    first."""
    require_unquantized(model, "params_to_numpy")
    return _to_tree(model, ("embed", "ln_f", "head"),
                    block_leaves(model.cfg))


def shard_params(np_tree: Mapping, cfg: ModelConfig, mesh, device=None,
                 pp: bool = False) -> Transformer:
    """This rank's shard of the JAX package's numpy tree on *mesh*
    (``train.param_specs``: heads, ff and vocab cut over tp, experts over
    ep; under *pp* the stage's layers), as a ``Transformer`` of local
    shapes on *device* (the card by default) carrying its ``ModelShard``,
    gradients off."""
    from kubetpu_torch.jobs import train as train_lib

    device = resolve_device(device)
    train_lib.check_mesh(cfg, mesh, pp)
    specs = train_lib.param_specs(cfg, pp)
    top = ("embed", "ln_f", "head")
    local = {name: train_lib._take(np.asarray(np_tree[name]), specs[name],
                                   mesh) for name in top}
    local["blocks"] = {
        name: train_lib._take(np.asarray(np_tree["blocks"][name]), spec,
                              mesh)
        for name, spec in specs["blocks"].items()}
    from kubetpu_torch.jobs import collectives as col

    model = train_lib.local_model(cfg, mesh, torch.device("meta"), pp)
    _put_all(model, local, top, block_leaves(cfg), cfg, device)
    model.shard = col.model_shard(mesh, moe=cfg.n_experts > 0)
    return model


def gather_params(model: Transformer, cfg: ModelConfig, mesh,
                  pp: bool = False) -> dict:
    """The inverse of ``shard_params``: every rank's shards of *model*
    gathered into the whole model's numpy tree (float32), on every rank."""
    from kubetpu_torch.jobs import collectives as col
    from kubetpu_torch.jobs import train as train_lib

    specs = train_lib.param_specs(cfg, pp)

    def whole(t, spec):
        t = t.detach()
        for dim, entry in enumerate(spec):
            if isinstance(entry, str):
                t = col.all_gather(t, col.group_of(mesh, entry), "gather",
                                   dim)
        return t.float().cpu().numpy()

    tree = {name: whole(getattr(model, name), specs[name])
            for name in ("embed", "ln_f", "head")}
    tree["blocks"] = {
        name: whole(torch.stack([getattr(blk, name) for blk in
                                 model.blocks]), spec)
        for name, spec in specs["blocks"].items()}
    return tree


_VIT_TOP = ("patch_proj", "pos_embed", "ln_f", "head_cls")


def vit_params_from_numpy(np_tree: Mapping, cfg: VitConfig, device=None,
                          dtype: Optional[torch.dtype] = None
                          ) -> VisionTransformer:
    """The port's ``VisionTransformer`` with the weights of the JAX
    package's ViT tree (``{"patch_proj", "pos_embed", "blocks", "ln_f",
    "head_cls"}`` as numpy arrays), on *device* (the card by default), in
    *dtype* (``cfg.model.dtype`` by default). Raises on a missing leaf or a
    shape that disagrees with *cfg*."""
    device = resolve_device(device)
    if dtype is not None and dtype != cfg.model.dtype:
        cfg = dataclasses.replace(
            cfg, model=dataclasses.replace(cfg.model, dtype=dtype))
    model = VisionTransformer(cfg, torch.device("meta"))
    _put_all(model, np_tree, _VIT_TOP, block_leaves(cfg.model), cfg.model,
             device)
    return model


def vit_params_to_numpy(model: VisionTransformer) -> dict:
    """A ``VisionTransformer``'s weights as the JAX package's ViT tree of
    float32 numpy arrays."""
    return _to_tree(model, _VIT_TOP, block_leaves(model.cfg.model))


def seq2seq_params_from_numpy(np_tree: Mapping, cfg: ModelConfig,
                              device=None,
                              dtype: Optional[torch.dtype] = None) -> Seq2Seq:
    """The port's ``Seq2Seq`` with the weights of the JAX package's tree
    (``{"encoder": {"embed", "blocks", "ln_f"}, "decoder": {"embed",
    "blocks" with the cross leaves, "ln_f", "head"}}`` as numpy arrays), on
    *device* (the card by default), in *dtype* (``cfg.dtype`` by default).
    Raises on a missing leaf or a shape that disagrees with *cfg*."""
    device = resolve_device(device)
    if dtype is not None and dtype != cfg.dtype:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    model = Seq2Seq(cfg, torch.device("meta"))
    for name in ("encoder", "decoder"):
        if name not in np_tree:
            raise KeyError(f"{name}: missing from the tree")
    _put_all(model.encoder, np_tree["encoder"], ("embed", "ln_f"),
             block_leaves(cfg), cfg, device, "encoder.")
    _put_all(model.decoder, np_tree["decoder"], ("embed", "ln_f", "head"),
             block_leaves(cfg) + CROSS_LEAVES, cfg, device, "decoder.")
    return model


def seq2seq_params_to_numpy(model: Seq2Seq) -> dict:
    """A ``Seq2Seq``'s weights as the JAX package's tree of float32 numpy
    arrays."""
    leaves = block_leaves(model.cfg)
    return {"encoder": _to_tree(model.encoder, ("embed", "ln_f"), leaves),
            "decoder": _to_tree(model.decoder, ("embed", "ln_f", "head"),
                                leaves + CROSS_LEAVES)}


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
