"""int8 KV-cache quantization (port of ``kubetpu.jobs.quant.quantize_kv_chunk``).

Weight-only int8 (``QTensor``, ``quantize_params``) is not ported yet.
"""

from __future__ import annotations

from typing import Tuple

import torch


def quantize_kv_chunk(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-token, per-head symmetric int8: x (..., H_kv, D) -> (int8
    values, f32 scales (..., H_kv, 1)) with scale ``max|x| / 127`` (1 for an
    all-zero vector, which stays zero). ``torch.round`` rounds half to even
    like ``jnp.round``, so values and scales are byte-identical to the JAX
    package's."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(xf / scale), -127, 127)
    return q.to(torch.int8), scale
