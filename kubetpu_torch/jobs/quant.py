"""Weight-only int8 quantization and int8 KV-cache entries (port of
``kubetpu/jobs/quant.py``).

Decode reads every weight once a step, so storing the matmul weights as
int8 with a per-output-channel f32 scale nearly halves the resident weight
bytes. Dequantization happens one layer at a time inside the layer loops
(``maybe_dequantize`` on a ``Block``) and per use for the head, never as a
whole-model copy: a whole-model copy would hold a full set of weights in
``cfg.dtype`` beside the int8 ones and cost more memory than not
quantizing.

Granularity is the JAX package's, defined on its STACKED layout: a leaf
``(L, ...)`` of ndim >= 3 keeps its leading (layer) axis and its last axis
and reduces the axes between; a 2-D leaf (the head) reduces axis 0. The port
holds one ``Block`` per layer, whose slice of a stacked leaf has one axis
fewer, so per layer the rule reads: reduce every axis but the last (MoE
experts ``(E, d, f)`` share one scale per output channel across experts, as
the stacked ``(L, E, d, f)`` leaf's ``(L, 1, 1, f)`` scale does). The
embedding, the norm gains and every 1-D tensor stay raw.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Tuple

import torch
from torch import nn


class QTensor(nn.Module):
    """int8 values ``q`` and broadcastable f32 scales ``scale`` (the
    reduced axes kept as size 1), restored to ``dtype`` on dequantize.
    ``q`` and ``scale`` are buffers, so ``.to(device)`` moves them."""

    def __init__(self, q: torch.Tensor, scale: torch.Tensor,
                 dtype: torch.dtype) -> None:
        super().__init__()
        self.register_buffer("q", q)
        self.register_buffer("scale", scale)
        self.dtype = dtype

    def dequantize(self) -> torch.Tensor:
        """``(q.float() * scale).to(dtype)`` in one elementwise kernel:
        the product in f32, rounded once to ``dtype``."""
        out = torch.empty(self.q.shape, dtype=self.dtype,
                          device=self.q.device)
        return torch.mul(self.q, self.scale, out=out)

    @property
    def shape(self) -> torch.Size:
        return self.q.shape

    @property
    def nbytes(self) -> int:
        return self.q.numel() + 4 * self.scale.numel()

    def extra_repr(self) -> str:
        return f"shape={tuple(self.q.shape)}, dtype={self.dtype}"


def _symmetric_int8(w: torch.Tensor, dims):
    """(int8 values, f32 scales) of *w* reduced over *dims*: scale =
    max|w| / 127 (1 for an all-zero channel, which stays zero).
    ``torch.round`` rounds half to even like ``jnp.round``."""
    wf = w.float()
    amax = wf.abs().amax(dim=dims, keepdim=True)
    # a tensor divisor: PyTorch's CUDA division by a Python scalar
    # multiplies by its reciprocal, which is not ``amax / 127`` in every bit
    scale = torch.where(amax > 0, amax / amax.new_tensor(127.0),
                        torch.ones_like(amax))
    q = torch.clamp(torch.round(wf / scale), -127, 127)
    return q.to(torch.int8), scale


def _quantize(w: torch.Tensor, dims) -> QTensor:
    return QTensor(*_symmetric_int8(w, dims), w.dtype)


def quantize_tensor(w: torch.Tensor) -> QTensor:
    """The JAX package's ``quantize_tensor`` on a stacked or 2-D tensor:
    per output channel for 2-D ``(in, out)``; for ndim >= 3 the leading and
    last axes are kept and the axes between reduced."""
    dims = (0,) if w.dim() == 2 else tuple(range(1, w.dim() - 1))
    return _quantize(w, dims)


def quantize_channels(w: torch.Tensor) -> QTensor:
    """One layer's slice of a stacked leaf (or the 2-D head): every axis but
    the last reduced, the stacked rule's scale for that layer."""
    return _quantize(w, tuple(range(w.dim() - 1)))


def _raw_leaves(block: nn.Module):
    """(name, tensor or QTensor) of a block's weights, in registration
    order."""
    for name, p in block.named_parameters(recurse=False):
        yield name, p
    for name, m in block.named_children():
        yield name, m


def is_quantized(model: nn.Module) -> bool:
    """Whether *model* (a ``Transformer`` or a ``Block``) holds any
    ``QTensor``."""
    return any(isinstance(m, QTensor) for m in model.modules())


def require_unquantized(model: nn.Module, what: str) -> None:
    """Refuse an int8-weight model where the JAX package has no such path
    (training, LoRA merging, export): arithmetic on int8 values is never
    silently right."""
    if is_quantized(model):
        raise ValueError(
            f"{what} needs full-precision weights; this model holds int8 "
            "QTensors (quantize_params) — dequantize it first "
            "(maybe_dequantize) or use the original weights")


@torch.no_grad()
def quantize_params(model: nn.Module) -> nn.Module:
    """A new ``Transformer`` with every matmul weight of every block (``wq``,
    ``wk``, ``wv``, ``wo``, the MLP or expert weights, ``moe_router``) and
    the head as ``QTensor``s; ``embed``, ``ln1``/``ln2`` and ``ln_f`` stay
    raw and are shared with *model*, not copied. *model* is left as it
    was."""
    from kubetpu_torch.jobs.model import Transformer

    out = Transformer(model.cfg, torch.device("meta"))

    def share(p):
        return nn.Parameter(p.detach(), requires_grad=False)

    out.embed = share(model.embed)
    out.ln_f = share(model.ln_f)
    del out.head
    out.head = quantize_channels(model.head)
    for src, dst in zip(model.blocks, out.blocks):
        for name, p in _raw_leaves(src):
            delattr(dst, name)
            if isinstance(p, QTensor):
                setattr(dst, name, p)
            elif p.dim() < 2:
                setattr(dst, name, share(p))
            else:
                setattr(dst, name, quantize_channels(p))
    return out


def maybe_dequantize(x):
    """Full-precision weights wherever *x* holds ``QTensor``s, and *x*
    itself where it holds none (a no-op for raw weights):

    - a ``QTensor``: its dequantized tensor;
    - a ``Block``: a namespace of its leaves with each ``QTensor``
      dequantized — the per-layer temporary of the layer loops;
    - a ``Transformer``: a new ``Transformer`` of dequantized weights (a
      whole-model copy, for tests and gates; the serving legs never make
      one);
    - anything else: unchanged."""
    if isinstance(x, QTensor):
        return x.dequantize()
    if not isinstance(x, nn.Module) or not x._modules:
        return x                  # a tensor, or a raw block: no children
    if hasattr(x, "blocks"):
        return _dequantized_model(x) if is_quantized(x) else x
    return SimpleNamespace(**{
        name: maybe_dequantize(v) for name, v in _raw_leaves(x)})


@torch.no_grad()
def _dequantized_model(x: nn.Module) -> nn.Module:
    from kubetpu_torch.jobs.model import Transformer

    out = Transformer(x.cfg, torch.device("meta"))
    out.embed, out.ln_f = x.embed, x.ln_f
    out.head = nn.Parameter(maybe_dequantize(x.head), requires_grad=False)
    for src, dst in zip(x.blocks, out.blocks):
        for name, v in _raw_leaves(src):
            setattr(dst, name, nn.Parameter(maybe_dequantize(v),
                                            requires_grad=False))
    return out


def param_bytes(model: nn.Module) -> int:
    """Resident bytes of a (possibly quantized) model: raw tensors at their
    size, a ``QTensor`` as ``q.numel() + 4 * scale.numel()``."""
    total = sum(m.nbytes for m in model.modules() if isinstance(m, QTensor))
    return total + sum(p.numel() * p.element_size()
                       for p in model.parameters())


def quantize_kv_chunk(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-token, per-head symmetric int8: x (..., H_kv, D) -> (int8
    values, f32 scales (..., H_kv, 1)) with scale ``max|x| / 127`` (1 for an
    all-zero vector, which stays zero). ``torch.round`` rounds half to even
    like ``jnp.round``, so values and scales are byte-identical to the JAX
    package's."""
    return _symmetric_int8(x, (-1,))
