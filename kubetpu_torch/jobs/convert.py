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
and encoder-decoder trees, un-stacking their blocks as above, and
``shard_vit_params`` / ``gather_vit_params`` and ``shard_seq2seq_params`` /
``gather_seq2seq_params`` carry them to and from a rank's shard
(``vision.vit_param_specs``, ``seq2seq.seq2seq_param_specs``).
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
    from kubetpu_torch.jobs import collectives as col
    from kubetpu_torch.jobs import train as train_lib

    device = resolve_device(device)
    train_lib.check_mesh(cfg, mesh, pp)
    model = train_lib.local_model(cfg, mesh, torch.device("meta"), pp)
    specs = train_lib.param_specs(cfg, pp)
    _shard_module(model, np_tree, specs, mesh, cfg.dtype, device,
                  train_lib.stage_layers(cfg, mesh).start)
    model.shard = col.model_shard(mesh, specs, moe=cfg.n_experts > 0, pp=pp)
    return model


def gather_params(model: Transformer, cfg: ModelConfig, mesh,
                  pp: bool = False) -> dict:
    """The inverse of ``shard_params``: every rank's shards of *model*
    gathered into the whole model's numpy tree (float32), on every rank."""
    from kubetpu_torch.jobs import train as train_lib

    return _gather_module(model, train_lib.param_specs(cfg, pp), mesh)


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


def _tree_leaf(np_tree: Mapping, name: str):
    """The numpy leaf of parameter *name* (a whole model's
    ``named_parameters`` name): a block leaf's one layer of the stacked
    array."""
    node, layer = np_tree, None
    for part in name.split("."):
        if part.isdigit():
            layer = int(part)
        else:
            if part not in node:
                raise KeyError(f"{name}: missing from the tree")
            node = node[part]
    arr = np.asarray(node)
    return arr if layer is None else arr[layer]


def _shard_module(local: nn.Module, np_tree: Mapping, specs: dict, mesh,
                  dtype: torch.dtype, device, first_layer: int = 0) -> None:
    """Fill the meta-device shard *local* with this rank's slice of every
    leaf of the whole model's numpy tree (its spec in *specs*; a pipeline
    stage's blocks are layers *first_layer* on)."""
    from kubetpu_torch.jobs import train as train_lib

    for name, p in list(local.named_parameters()):
        arr = train_lib._take(
            _tree_leaf(np_tree, train_lib.global_name(name, first_layer)),
            train_lib.local_spec(specs, name), mesh)
        if tuple(arr.shape) != tuple(p.shape):
            raise ValueError(f"{name}: shape {tuple(arr.shape)} does not "
                             f"match the shard's {tuple(p.shape)}")
        train_lib.set_param(local, name, torch.from_numpy(np.array(
            arr, dtype=np.float32)).to(device=device, dtype=dtype))


def _gather_module(model: nn.Module, specs: dict, mesh) -> dict:
    """Every rank's shards of *model* gathered into the whole model's
    numpy tree (float32, blocks stacked on the layer axis), on every
    rank."""
    from kubetpu_torch.jobs import collectives as col
    from kubetpu_torch.jobs import train as train_lib

    stacks: dict = {}
    tree: dict = {}
    for name, p in model.named_parameters():
        parts = name.split(".")
        if "blocks" in parts:
            i = parts.index("blocks")
            key = tuple(parts[:i + 1]) + (parts[-1],)
            stacks.setdefault(key, (name, []))[1].append(p.detach())
            continue
        node = tree
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = (name, p.detach())

    def whole(name, t):
        for dim, entry in enumerate(train_lib.leaf_spec(specs, name)):
            if isinstance(entry, str):
                t = col.all_gather(t, col.group_of(mesh, entry), "gather",
                                   dim)
        return t.float().cpu().numpy()

    def walk(node):
        return {k: walk(v) if isinstance(v, dict) else whole(*v)
                for k, v in node.items()}

    out = walk(tree)
    for key, (name, layers) in stacks.items():
        node = out
        for part in key[:-1]:
            node = node.setdefault(part, {})
        node[key[-1]] = whole(name, torch.stack(layers))
    return out


def shard_vit_params(np_tree: Mapping, cfg: VitConfig, mesh,
                     device=None) -> VisionTransformer:
    """This rank's shard of the JAX package's ViT tree on *mesh*
    (``vision.vit_param_specs``), on *device* (the card by default),
    carrying its ``ModelShard``, gradients off."""
    from kubetpu_torch.jobs import collectives as col
    from kubetpu_torch.jobs import train as train_lib
    from kubetpu_torch.jobs.vision import vit_param_specs

    device = resolve_device(device)
    train_lib.check_mesh(cfg.model, mesh, vocab=False)
    local = VisionTransformer(cfg, torch.device("meta"),
                              tp=col.axis_size(mesh, "tp"),
                              ep=col.axis_size(mesh, "ep"))
    specs = vit_param_specs(cfg)
    _shard_module(local, np_tree, specs, mesh, cfg.model.dtype, device)
    local.shard = col.model_shard(mesh, specs,
                                  moe=cfg.model.n_experts > 0)
    return local


def gather_vit_params(model: VisionTransformer, cfg: VitConfig,
                      mesh) -> dict:
    """The inverse of ``shard_vit_params``, on every rank."""
    from kubetpu_torch.jobs.vision import vit_param_specs

    return _gather_module(model, vit_param_specs(cfg), mesh)


def shard_seq2seq_params(np_tree: Mapping, cfg: ModelConfig, mesh,
                         device=None) -> Seq2Seq:
    """This rank's shard of the JAX package's seq2seq tree on *mesh*
    (``seq2seq.seq2seq_param_specs``), on *device* (the card by default),
    carrying its ``ModelShard``, gradients off."""
    from kubetpu_torch.jobs import collectives as col
    from kubetpu_torch.jobs import train as train_lib
    from kubetpu_torch.jobs.seq2seq import seq2seq_param_specs

    device = resolve_device(device)
    train_lib.check_mesh(cfg, mesh)
    local = Seq2Seq(cfg, torch.device("meta"), tp=col.axis_size(mesh, "tp"),
                    ep=col.axis_size(mesh, "ep"))
    specs = seq2seq_param_specs(cfg)
    _shard_module(local, np_tree, specs, mesh, cfg.dtype, device)
    local.shard = col.model_shard(mesh, specs, moe=cfg.n_experts > 0)
    return local


def gather_seq2seq_params(model: Seq2Seq, cfg: ModelConfig, mesh) -> dict:
    """The inverse of ``shard_seq2seq_params``, on every rank."""
    from kubetpu_torch.jobs.seq2seq import seq2seq_param_specs

    return _gather_module(model, seq2seq_param_specs(cfg), mesh)
