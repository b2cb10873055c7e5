"""The system under test, built from a configuration file's ``model`` block
and the seed's weights: ``kubetpu_torch``'s ``ModelConfig`` and a
``Transformer`` whose parameters are the views ``inputs.make_weights``
drew (no second copy of the weights is made)."""

from __future__ import annotations

from typing import Dict

import torch

from kubetpu_torch.jobs.model import ModelConfig, Transformer
from kubetpu_torch.jobs.train import set_param

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def model_config(m: dict) -> ModelConfig:
    """The port's ``ModelConfig`` of model sizes *m*."""
    if m["head_dim"] * m["n_heads"] != m["d_model"]:
        raise ValueError("the port derives head_dim as d_model / n_heads")
    return ModelConfig(
        vocab=m["vocab"], d_model=m["d_model"], n_layers=m["n_layers"],
        n_heads=m["n_heads"], n_kv_heads=m["n_kv_heads"], d_ff=m["d_ff"],
        max_seq=m["max_seq"], rope_theta=float(m["rope_theta"]),
        dtype=_DTYPES[m["dtype"]], n_experts=m.get("n_experts", 0),
        moe_top_k=m.get("moe_top_k", 1),
        moe_capacity_factor=float(m.get("moe_capacity_factor", 0.0)))


def transformer(cfg: ModelConfig, weights: Dict[str, torch.Tensor]
                ) -> Transformer:
    """A ``Transformer`` holding *weights* (name -> tensor on the card)."""
    model = Transformer(cfg, "meta")
    names = {n for n, _ in model.named_parameters()}
    if names != set(weights):
        raise ValueError(f"weights and model differ: "
                         f"{sorted(names ^ set(weights))[:6]}")
    for name, value in weights.items():
        set_param(model, name, value)
    return model
