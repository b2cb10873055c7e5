"""Flagship model: a decoder-only transformer (port of
``kubetpu/jobs/model.py``).

Llama-style block: RMSNorm, rotary embeddings (with the optional Llama-3.1
frequency warp), grouped-query attention and a SwiGLU MLP. Weights keep the
JAX package's layouts (``wq`` is ``(d, H, hd)``, ``wo`` is ``(H, hd, d)``,
``head`` is ``(d, V)``) so a parameter tree converts one leaf at a time
(``convert.params_from_numpy``). Where the JAX package stacks the layers on a
leading axis and runs one ``lax.scan``, the port holds one ``Block`` module
per layer and loops over them in Python.

The MLP branch (``_mlp``) is the reference's three-way one: dense SwiGLU,
top-1 mixture-of-experts with dense one-hot dispatch (``_moe_mlp``), or
top-k mixture-of-experts with capacity dispatch (``_moe_mlp_capacity``,
``cfg.moe_capacity_factor > 0``), plus the switch-transformer load-balance
term (``_moe_aux_from_probs``). The training forward, prefill, the dense
decode path and the paged serving legs all reach MoE through ``_mlp`` and
nowhere else. Capacity dispatch makes a token's output depend on the rows
of the call (N and their order), so every leg feeds it the rows the JAX
package's leg feeds: inactive slots and pad tokens included.

A block or a head holding int8 ``quant.QTensor`` weights is dequantized
where it is used, one layer at a time (``quant.maybe_dequantize``).

On a mesh a rank holds its shard (``train.shard_model``), which carries its
``collectives.ModelShard``: the block runs tensor-parallel (``copy_to``
before q/k/v and the MLP, ``reduce_from`` after ``wo`` and the MLP), a MoE
MLP runs the rank's experts (``ep``) on its ff shard and sums its partial
combine over tp x ep, a capacity dispatch counts slots over the global
batch (``ModelShard.data``), and the head's vocab shards are gathered into
whole logits. Tokens are replicated over ``ep``, as the JAX package's
``batch_spec`` leaves them, so the expert exchange is that sum.

Training: ``forward_hidden`` rematerializes each block under
``cfg.remat`` (``torch.utils.checkpoint``), and ``next_token_loss`` ends in
the shared loss tail (``lm_loss_tail``: materialized or chunked logits,
label smoothing, z-loss, per-position weights) plus ``moe_aux_coeff`` times
the summed aux term. ``forward`` alone runs without gradients.
"""

from __future__ import annotations

import dataclasses
import math
from functools import partial
from typing import Callable, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint, noop_context_fn

from kubetpu_torch.jobs import collectives as col
from kubetpu_torch.jobs.quant import maybe_dequantize

# attention core signature: (q, k, v) with shapes (B, S, H, D) -> (B, S, H, D)
AttnFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]

NEG_INF = -1e30


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller names
    another. With no ``device`` and no CUDA this raises — the port never
    drops to the CPU on its own."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port's plain PyTorch path on the CPU")
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not "
                           "available")
    return device


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    vocab: int = 256
    d_model: int = 128
    n_layers: int = 2
    n_heads: int = 4
    d_ff: int = 512
    max_seq: int = 1024
    rope_theta: float = 10000.0
    dtype: torch.dtype = torch.float32
    # recompute each block's forward during backward (torch.utils.checkpoint)
    remat: bool = False
    # what remat saves: "full" saves nothing inside a block; "dots" saves
    # every matmul output and recomputes only the elementwise and norm ops
    remat_policy: str = "full"
    # 0 = materialize the (B, S, V) logits at the loss; > 0 = stream the LM
    # head and cross-entropy over sequence chunks of this size (must divide S)
    loss_chunk: int = 0
    # uniform label smoothing mass: (1-e)*nll - e*mean(logp) (0 = off)
    label_smoothing: float = 0.0
    # PaLM-style z-loss coefficient: + z * logsumexp(logits)^2 (0 = off)
    z_loss: float = 0.0
    # sliding-window attention: each position sees the previous `window`
    # positions including itself (0 = full causal)
    window: int = 0
    # Llama-3.1 RoPE warp: (factor, low_freq_factor, high_freq_factor,
    # original_max_position_embeddings) or None
    rope_llama3_scaling: Optional[tuple] = None
    # grouped-query attention: K/V heads (0 = n_heads)
    n_kv_heads: int = 0
    # 0 = dense SwiGLU; > 0 = a mixture-of-experts MLP in every block
    n_experts: int = 0
    # 0.0 = top-1 dense one-hot dispatch; > 0 = capacity dispatch: each
    # expert takes at most int(capacity_factor * N / E) token-choices of a
    # call of N rows, the rest ride the residual
    moe_capacity_factor: float = 0.0
    # switch-transformer load-balance coefficient: next_token_loss adds
    # coeff * E * sum_e(frac_e * mean_prob_e) (0 = off)
    moe_aux_coeff: float = 0.0
    # experts a token on the capacity path (gate weights: the raw router
    # probabilities; primary choices claim capacity before secondary ones)
    moe_top_k: int = 1

    def __post_init__(self):
        if self.moe_top_k < 1 or (self.n_experts
                                  and self.moe_top_k > self.n_experts):
            raise ValueError(
                f"moe_top_k ({self.moe_top_k}) must be in [1, n_experts]")
        if (self.moe_top_k > 1 and self.n_experts > 0
                and self.moe_capacity_factor <= 0):
            raise ValueError(
                "moe_top_k > 1 requires the capacity dispatch path "
                "(set moe_capacity_factor > 0)")
        if self.loss_chunk < 0:
            raise ValueError(f"loss_chunk must be >= 0, got {self.loss_chunk}")
        if not 0.0 <= self.label_smoothing < 1.0:
            raise ValueError(
                f"label_smoothing must be in [0, 1), got {self.label_smoothing}")
        if self.z_loss < 0:
            raise ValueError(f"z_loss must be >= 0, got {self.z_loss}")
        if self.window < 0:
            raise ValueError(f"window must be >= 0, got {self.window}")
        if self.rope_llama3_scaling is not None:
            s = self.rope_llama3_scaling
            if (not isinstance(s, tuple) or len(s) != 4
                    or not all(isinstance(x, (int, float)) for x in s)):
                raise ValueError(
                    "rope_llama3_scaling must be a (factor, low_freq_factor, "
                    "high_freq_factor, original_max_position_embeddings) "
                    f"tuple, got {s!r}")
            if s[1] == s[2]:
                raise ValueError(
                    "rope_llama3_scaling low_freq_factor == high_freq_factor "
                    "divides by zero in the smoothing band")
        if self.remat_policy not in ("full", "dots"):
            raise ValueError(f"remat_policy must be 'full' or 'dots', got "
                             f"{self.remat_policy!r}")
        if self.n_kv_heads and self.n_heads % self.n_kv_heads:
            raise ValueError(
                f"n_kv_heads ({self.n_kv_heads}) must divide "
                f"n_heads ({self.n_heads})")

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads or self.n_heads



# The JAX package's ModelConfig, field by field in its order
# (kubetpu/jobs/model.py:33-105), and its dtypes as that dataclass prints
# them: a migration snapshot carries the config in that form, so both
# packages' servers compare one string.
_REFERENCE_FIELDS = (
    "vocab", "d_model", "n_layers", "n_heads", "d_ff", "max_seq",
    "rope_theta", "dtype", "remat", "remat_policy", "n_experts",
    "moe_capacity_factor", "moe_aux_coeff", "moe_top_k", "loss_chunk",
    "label_smoothing", "z_loss", "window", "rope_llama3_scaling",
    "n_kv_heads")
_REFERENCE_DTYPES = {torch.float32: "float32", torch.bfloat16: "bfloat16",
                     torch.float16: "float16"}


def reference_config_repr(cfg: ModelConfig) -> str:
    """``repr(kubetpu.jobs.model.ModelConfig(...))`` of the same
    configuration: the ``cfg_fp`` a migration snapshot carries, which a
    restore on either package's server compares with its own."""
    parts = []
    for name in _REFERENCE_FIELDS:
        if name == "dtype":
            text = (f"<class 'jax.numpy."
                    f"{_REFERENCE_DTYPES[cfg.dtype]}'>")
        else:
            text = repr(getattr(cfg, name))
        parts.append(f"{name}={text}")
    return f"ModelConfig({', '.join(parts)})"


def _param(shape, cfg: ModelConfig, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=cfg.dtype, device=device),
                        requires_grad=False)


def block_leaves(cfg: ModelConfig):
    """A block's weight names, in the JAX package's ``blocks`` keys: the
    MoE router joins the attention and MLP leaves when ``n_experts > 0``."""
    moe = ("moe_router",) if cfg.n_experts > 0 else ()
    return ("ln1", "ln2", "wq", "wk", "wv", "wo") + moe + (
        "w_gate", "w_up", "w_down")


class Block(nn.Module):
    """One transformer layer's weights, in the JAX package's layouts: the
    MLP's ``w_gate``/``w_up (d, f)`` and ``w_down (f, d)``, or with
    ``n_experts = E`` the router ``moe_router (d, E)`` and the experts'
    ``w_gate``/``w_up (E, d, f)`` and ``w_down (E, f, d)``. With ``tp > 1``
    it holds one tensor-parallel rank's shard: ``H/tp`` heads (and
    ``H_kv/tp`` K/V heads) and ``d_ff/tp`` of the MLP; with ``ep > 1``
    ``E/ep`` of the experts (the router keeps all ``E``)."""

    def __init__(self, cfg: ModelConfig, device, tp: int = 1,
                 ep: int = 1) -> None:
        super().__init__()
        d, h, hd, f, kv = (cfg.d_model, cfg.n_heads // tp, cfg.head_dim,
                           cfg.d_ff // tp, cfg.kv_heads // tp)
        e = (cfg.n_experts // ep,) if cfg.n_experts > 0 else ()
        self.ln1 = _param((d,), cfg, device)
        self.ln2 = _param((d,), cfg, device)
        self.wq = _param((d, h, hd), cfg, device)
        self.wk = _param((d, kv, hd), cfg, device)
        self.wv = _param((d, kv, hd), cfg, device)
        self.wo = _param((h, hd, d), cfg, device)
        if e:
            self.moe_router = _param((d, cfg.n_experts), cfg, device)
        self.w_gate = _param(e + (d, f), cfg, device)
        self.w_up = _param(e + (d, f), cfg, device)
        self.w_down = _param(e + (f, d), cfg, device)


class Transformer(nn.Module):
    """The whole model: ``embed (V, d)``, one ``Block`` per layer,
    ``ln_f (d,)`` and ``head (d, V)``. Constructed with uninitialized
    weights; ``init_params`` or ``convert.params_from_numpy`` fill them.
    On a mesh a rank holds its shard (``train.shard_model``): *tp* splits
    every block (``Block``) and the head's vocab, *ep* the experts, and a
    pipeline stage holds *layers* of the ``n_layers`` blocks; ``shard`` is
    then the ``collectives.ModelShard`` its forward reduces over (None for
    a whole model)."""

    shard: Optional[col.ModelShard] = None

    def __init__(self, cfg: ModelConfig, device, tp: int = 1,
                 layers: Optional[int] = None, ep: int = 1) -> None:
        super().__init__()
        self.cfg = cfg
        self.embed = _param((cfg.vocab, cfg.d_model), cfg, device)
        self.blocks = nn.ModuleList(
            [Block(cfg, device, tp, ep) for _ in range(
                cfg.n_layers if layers is None else layers)])
        self.ln_f = _param((cfg.d_model,), cfg, device)
        self.head = _param((cfg.d_model, cfg.vocab // tp), cfg, device)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return forward(self, tokens, self.cfg)


def init_params(generator: torch.Generator, cfg: ModelConfig,
                device=None) -> Transformer:
    """Random weights with ``kubetpu.jobs.model.init_params``'s shapes and
    scale rule (normal draws in ``cfg.dtype`` times ``d**-0.5``,
    ``(H*hd)**-0.5`` for ``wo``, ``d_ff**-0.5`` for ``w_down``; norms at 1;
    the MoE router and experts by the same rule, the router drawn last in
    each block so that a dense config's draws do not move),
    drawn from *generator*, which must live on *device*, in
    ``model_plan``'s order. The numbers differ from ``jax.random``'s; tests
    that compare the two packages convert one tree with
    ``params_from_numpy`` instead."""
    device = resolve_device(device)
    model = Transformer(cfg, device)
    fill_plan(model_plan(model), normal_filler(generator, cfg.dtype, device))
    return model


def normal_draw(generator: torch.Generator, dtype: torch.dtype, device):
    """``draw(shape, s)``: a new tensor of normal draws from *generator*
    (which must live on *device*) in *dtype*, times *s*: the one rule every
    random init draws by, whole (``normal_filler``) or leaf by leaf into a
    shard (``train.draw_shard``)."""
    device = torch.device(device)
    if generator.device.type != device.type:
        raise ValueError(f"generator lives on {generator.device}, weights "
                         f"on {device}")

    def draw(shape, s: float) -> torch.Tensor:
        return torch.randn(shape, generator=generator, device=device,
                           dtype=dtype).mul_(s)

    return draw


def normal_filler(generator: torch.Generator, dtype: torch.dtype, device):
    """``normal_(p, s)``: fill *p* in place with ``normal_draw``'s draws."""
    draw = normal_draw(generator, dtype, device)

    def normal_(p: torch.Tensor, s: float) -> None:
        p.copy_(draw(p.shape, s))

    return normal_


def blocks_plan(blocks, cfg: ModelConfig):
    """``init_params``'s rule for each block, in its draw order: (leaf,
    scale), scale None for a norm at 1; the projections and the MLP
    normal, the MoE router drawn last."""
    d, h, hd, f = cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.d_ff
    scale = d ** -0.5
    for blk in blocks:
        yield from ((blk.ln1, None), (blk.ln2, None), (blk.wq, scale),
                    (blk.wk, scale), (blk.wv, scale),
                    (blk.wo, (h * hd) ** -0.5), (blk.w_gate, scale),
                    (blk.w_up, scale), (blk.w_down, f ** -0.5))
        if cfg.n_experts > 0:
            yield blk.moe_router, scale


def model_plan(model: Transformer):
    """Every leaf of a whole *model* with its scale, in ``init_params``'
    draw order: the blocks, then embed, ln_f and head."""
    scale = model.cfg.d_model ** -0.5
    yield from blocks_plan(model.blocks, model.cfg)
    yield from ((model.embed, scale), (model.ln_f, None),
                (model.head, scale))


def fill_plan(plan, normal_) -> None:
    """Fill every (leaf, scale) of *plan* in its order: normal draws times
    the scale, or ones where the scale is None."""
    with torch.no_grad():
        for p, scale in plan:
            if scale is None:
                p.fill_(1.0)
            else:
                normal_(p, scale)


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    var = x.float().square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps).to(x.dtype)) * scale


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
         llama3_scaling=None) -> torch.Tensor:
    """Rotary position embedding. x: (B, S, H, D); positions: (S,) or
    (B, S). ``llama3_scaling`` is the Llama-3.1 frequency warp (long
    wavelengths divide by *factor*, short ones pass, the band between
    interpolates)."""
    d_half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(0, d_half, dtype=torch.float32,
                                    device=x.device) / d_half)
    if llama3_scaling is not None:
        factor, lo, hi, old_len = llama3_scaling
        wavelen = 2.0 * math.pi / freqs
        scaled = torch.where(wavelen > old_len / lo, freqs / factor, freqs)
        smooth = (old_len / wavelen - lo) / (hi - lo)
        smoothed = (1.0 - smooth) * scaled / factor + smooth * scaled
        medium = (wavelen >= old_len / hi) & (wavelen <= old_len / lo)
        freqs = torch.where(medium, smoothed, scaled)
    angles = positions.float()[..., None] * freqs   # (..., S, d_half)
    if angles.ndim == 2:
        angles = angles[None]
    cos = torch.cos(angles)[:, :, None, :].to(x.dtype)
    sin = torch.sin(angles)[:, :, None, :].to(x.dtype)
    x1, x2 = x[..., :d_half], x[..., d_half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(..., H_kv, D) -> (..., H_kv * n_rep, D); identity for MHA."""
    if n_rep == 1:
        return x
    return torch.repeat_interleave(x, n_rep, dim=2)


def dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """Reference attention core, (B, S, H, D) in and out: f32 scores and
    softmax, causal (optionally banded to ``window``) or bidirectional."""
    if window > 0 and not causal:
        raise ValueError("window > 0 requires causal attention")
    scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    if causal:
        s = q.shape[1]
        mask = torch.tril(torch.ones((s, s), dtype=torch.bool,
                                     device=q.device))
        if window > 0:
            pos = torch.arange(s, device=q.device)
            mask &= pos[:, None] - pos[None, :] < window
        scores = scores.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def default_attn_fn(cfg: ModelConfig) -> AttnFn:
    """The default attention core for a config (banded when windowed)."""
    return partial(dense_attention, causal=True, window=cfg.window)


def _top_k(probs: torch.Tensor, k: int):
    """(values, indices) of the k largest entries along the last axis, the
    lower index first among equal values (``jax.lax.top_k``'s order; a
    stable descending sort, since ``torch.topk`` promises no order on
    ties)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _moe_aux_from_probs(probs: torch.Tensor, top_k: int = 1,
                        data=None) -> torch.Tensor:
    """Switch-transformer load-balance term from router probs (..., E):
    E * sum_e(f_e * P_e), 1 when routing is uniform. f_e, the share of
    token-assignments routed to e over all k choices, carries no gradient;
    P_e, the mean router probability, does. With *data* (a group over the
    data axes, each rank holding an equal block of the batch) both means
    run over the global batch, as the JAX package computes them."""
    probs = probs.reshape(-1, probs.shape[-1])
    e = probs.shape[-1]
    _, topk_idx = _top_k(probs, top_k)
    if data is None:
        frac = torch.nn.functional.one_hot(topk_idx, e).float().mean(
            dim=(0, 1))
        return e * (frac.detach() * probs.mean(dim=0)).sum()
    n = probs.shape[0] * col.group_size(data)
    counts = torch.nn.functional.one_hot(topk_idx, e).float().sum(
        dim=(0, 1))
    counts = col.all_reduce_(counts.detach().contiguous(), data, "moe")
    p_sum = col.reduce_from(probs.sum(dim=0), data, "moe")
    return e * ((counts / (n * top_k)) * (p_sum / n)).sum()


def _experts_of(layer, shard) -> tuple:
    """(first expert, experts) this rank holds: all of them without an
    ``ep`` shard."""
    el = layer.w_gate.shape[0]
    return (0 if shard is None else shard.ep_index * el), el


def _moe_mlp(h: torch.Tensor, layer, shard=None):
    """Top-1 mixture-of-experts SwiGLU with dense one-hot dispatch: every
    expert runs over every row (zeros off its route) and the one-hot
    combine picks each row's expert, weighted by its router probability
    -> (out (B, S, D), probs (B, S, E) f32). On a *shard* the rank runs
    its experts on its ff shard and the partial combine is summed over tp
    x ep."""
    moe = None if shard is None else shard.moe
    router = torch.einsum("bsd,de->bse", h, layer.moe_router).float()
    probs = torch.softmax(router, dim=-1)
    one_hot = torch.nn.functional.one_hot(
        torch.argmax(probs, dim=-1), probs.shape[-1]).to(h.dtype)
    weight = (probs * one_hot).sum(dim=-1, keepdim=True).to(h.dtype)
    e0, el = _experts_of(layer, shard)
    one_hot = one_hot[..., e0:e0 + el]
    expert_in = torch.einsum("bse,bsd->ebsd", one_hot, col.copy_to(h, moe))
    gate = torch.nn.functional.silu(
        torch.einsum("ebsd,edf->ebsf", expert_in, layer.w_gate))
    up = torch.einsum("ebsd,edf->ebsf", expert_in, layer.w_up)
    out = torch.einsum("ebsf,efd->ebsd", gate * up, layer.w_down)
    out = (torch.einsum("ebsd,bse->bsd", out, one_hot)
           * col.copy_to(weight, moe))
    return col.reduce_from(out, moe), probs


def _capacity_slots(expert: torch.Tensor, e: int) -> torch.Tensor:
    """Each choice's 0-based slot in its expert's buffer: *expert* (G,
    K*N) rank-major choices (every row's primary choice before any
    secondary one), counted in order within each call."""
    flat = torch.nn.functional.one_hot(expert, e).float()     # (G, K*N, E)
    return (torch.cumsum(flat, dim=1) * flat).sum(dim=-1).long() - 1


def _global_slots(topi: torch.Tensor, b: int, s: int, e: int, shard):
    """(slots of this rank's choices (1, K*N) rank-major, capacity rows N
    of the call) when one capacity dispatch spans the data group's global
    batch: the group's choices are gathered (its ranks batch block-major,
    each an equal (B, S) block), slots counted over the global order, and
    this rank's picked out."""
    import torch.distributed as dist

    data = shard.data
    nb, ns = shard.data_blocks
    k = topi.shape[-1]
    me = dist.get_group_rank(data, dist.get_rank())
    bi, si = divmod(me, ns)
    # expert ids as f32 (exact below 2**24): the dtypes gloo takes on CUDA
    every = col.all_gather(topi.reshape(1, b, s, k).float(), data, "moe")
    every = every.view(nb, ns, b, s, k).permute(0, 2, 1, 3, 4)
    n_all = nb * b * ns * s
    expert = every.reshape(n_all, k).long().t().reshape(1, k * n_all)
    slot = _capacity_slots(expert, e)
    rows = ((bi * b + torch.arange(b, device=topi.device))[:, None]
            * (ns * s) + si * s + torch.arange(s, device=topi.device))
    pick = (torch.arange(k, device=topi.device)[:, None] * n_all
            + rows.reshape(1, -1)).reshape(1, -1)
    return torch.gather(slot, 1, pick), n_all


def _moe_mlp_capacity(h: torch.Tensor, layer, capacity_factor: float,
                      top_k: int = 1, per_row: bool = False, shard=None):
    """Top-k mixture-of-experts with capacity dispatch -> (out (B, S, D),
    probs (B*S, E) f32), the reference's ``_moe_mlp_capacity`` with its
    one-hot dispatch and combine products done as gathers.

    Of a call's N rows, each (row, rank) choice takes the next slot of its
    expert's buffer of ``capacity = max(1, int(cf * N / E))`` slots,
    counted rank-major (every row's primary choice before any secondary
    one); a choice past capacity is dropped and the row keeps its residual.
    The call is the whole (B, S) chunk (N = B*S), or with *per_row* each of
    the B rows apart (N = S: the reference's legs that vmap over the
    batch). The experts run on their (E, C, D) buffers in ``h.dtype`` (a
    slot holds one row, so the gather equals the one-hot product exactly);
    the combine sums each row's kept choices' outputs times the raw router
    probability (no renormalisation) in f32.

    On a *shard* the rank runs its ``E/ep`` experts on its ff shard over
    its own rows' choices (the others' slots stay empty), the partial
    combine is summed over tp x ep, and with ``shard.data`` the slots and
    the capacity are those of the global batch."""
    b, s, d = h.shape
    g = b if per_row else 1                    # independent calls
    n = b * s // g                             # rows a call
    e = layer.moe_router.shape[-1]
    k = top_k
    moe = None if shard is None else shard.moe
    tokens = h.reshape(g * n, d)
    probs = torch.softmax((tokens @ layer.moe_router).float(), dim=-1)
    gate_w, topi = _top_k(probs.view(g, n, e), k)              # (G, N, K)
    # rank-major within a call: choice r = rank * N + row
    expert = topi.transpose(1, 2).reshape(g, k * n)            # (G, K*N)
    if shard is not None and shard.data is not None and not per_row:
        slot, n_cap = _global_slots(topi, b, s, e, shard)
    else:
        slot, n_cap = _capacity_slots(expert, e), n
    c = max(1, int(capacity_factor * n_cap / e))
    e0, el = _experts_of(layer, shard)
    call = torch.arange(g, device=h.device)[:, None]
    mine = (expert >= e0) & (expert < e0 + el) & (slot < c)
    dest = torch.where(mine, (call * el + expert - e0) * c + slot,
                       torch.full_like(slot, g * el * c))      # drop: past
    row = call * n + torch.arange(k * n, device=h.device) % n
    # each expert slot's source row (g*n = a zero row for an empty slot)
    src = torch.full((g * el * c + 1,), g * n, dtype=torch.long,
                     device=h.device)
    src[dest.reshape(-1)] = row.reshape(-1)
    x = col.copy_to(tokens, moe)
    padded = torch.cat([x, x.new_zeros(1, d)])
    expert_in = padded[src[:-1]].view(g, el, c, d).transpose(0, 1)
    expert_in = expert_in.reshape(el, g * c, d)                # (E, G*C, D)
    gate = torch.nn.functional.silu(torch.bmm(expert_in, layer.w_gate))
    up = torch.bmm(expert_in, layer.w_up)
    out = torch.bmm(gate * up, layer.w_down)                   # (E, G*C, D)
    out = out.view(el, g, c, d).transpose(0, 1).reshape(g * el * c, d)
    out = torch.cat([out.float(), out.new_zeros(1, d, dtype=torch.float32)])
    picked = out[dest].view(g, k, n, d)
    gate_w = col.copy_to(gate_w, moe)
    combined = (picked * gate_w.transpose(1, 2)[..., None]).sum(dim=1)
    combined = col.reduce_from(combined, moe)
    return combined.to(h.dtype).view(b, s, d), probs


def _mlp(cfg: ModelConfig, h: torch.Tensor, layer, per_row: bool = False,
         shard=None):
    """The block's MLP branch -> (residual delta, aux term): dense SwiGLU,
    top-1 dense-dispatch MoE, or capacity-dispatch MoE (*per_row*: each
    batch row is its own dispatch, as under the reference's vmap); the aux
    term is ``_moe_aux_from_probs`` when ``moe_aux_coeff > 0`` and 0.0
    otherwise. The one site every leg's MLP goes through. On a *shard* the
    input is ``copy_to``'d and the output ``reduce_from``'d over the
    rank's group (tp; tp x ep for experts); the router runs replicated,
    outside that pair."""
    if cfg.n_experts > 0 and cfg.moe_capacity_factor > 0:
        out, probs = _moe_mlp_capacity(h, layer, cfg.moe_capacity_factor,
                                       cfg.moe_top_k, per_row, shard)
    elif cfg.n_experts > 0:
        out, probs = _moe_mlp(h, layer, shard)
    else:
        tp = None if shard is None else shard.tp
        h = col.copy_to(h, tp)
        gate = torch.nn.functional.silu(h @ layer.w_gate)
        return col.reduce_from((gate * (h @ layer.w_up)) @ layer.w_down,
                               tp), 0.0
    if cfg.moe_aux_coeff > 0:
        data = None if shard is None or per_row else shard.data
        return out, _moe_aux_from_probs(probs, cfg.moe_top_k, data)
    return out, 0.0


def _block_with_aux(cfg: ModelConfig, attn_fn: AttnFn,
                    positions: torch.Tensor, x: torch.Tensor, layer: Block,
                    shard=None):
    """One transformer block -> (x, aux, k, v): the MoE aux term (0.0 when
    off) and the rotary-embedded K/V at kv-head width, which is what a KV
    cache stores. An int8 block dequantizes here, for this layer only. On
    a *shard* the rank's heads run behind ``copy_to`` and ``wo``'s partial
    sums meet in ``reduce_from`` (its K/V are its heads')."""
    tp = None if shard is None else shard.tp
    layer = maybe_dequantize(layer)
    h = col.copy_to(rms_norm(x, layer.ln1), tp)
    q = torch.einsum("bsd,dhk->bshk", h, layer.wq)
    k = torch.einsum("bsd,dhk->bshk", h, layer.wk)
    v = torch.einsum("bsd,dhk->bshk", h, layer.wv)
    q = rope(q, positions, cfg.rope_theta, cfg.rope_llama3_scaling)
    k = rope(k, positions, cfg.rope_theta, cfg.rope_llama3_scaling)
    n_rep = cfg.n_heads // cfg.kv_heads
    attn = attn_fn(q, repeat_kv(k, n_rep), repeat_kv(v, n_rep))
    x = x + col.reduce_from(torch.einsum("bshk,hkd->bsd", attn, layer.wo),
                            tp)
    delta, aux = _mlp(cfg, rms_norm(x, layer.ln2), layer, shard=shard)
    return x + delta, aux, k, v


def _block_output(cfg, attn_fn, positions, x, layer, shard=None):
    """(x, aux) of one block: what crosses a remat boundary."""
    return _block_with_aux(cfg, attn_fn, positions, x, layer, shard)[:2]


def shard_logits(logits: torch.Tensor, shard) -> torch.Tensor:
    """Whole-vocabulary logits from a rank's vocab shard (..., V/tp): the
    tp group's shards gathered along the last axis (identity without a
    shard)."""
    if shard is None:
        return logits
    return col.all_gather(logits, shard.tp, "tp_logits", dim=-1)


def _remat_context_fn(cfg: ModelConfig):
    """``checkpoint``'s ``context_fn`` for ``cfg.remat_policy``: the
    default (save nothing inside the block) for "full"; for "dots", a
    selective-checkpoint policy that saves every matmul output and
    recomputes the rest (the counterpart of XLA's
    ``dots_with_no_batch_dims_saveable``)."""
    if cfg.remat_policy == "full":
        return noop_context_fn
    try:
        from torch.utils.checkpoint import (
            CheckpointPolicy, create_selective_checkpoint_contexts)
    except ImportError as e:
        raise NotImplementedError(
            "remat_policy='dots' needs torch.utils.checkpoint's selective "
            "checkpointing (create_selective_checkpoint_contexts)") from e
    aten = torch.ops.aten
    dots = {aten.mm.default, aten.bmm.default, aten.addmm.default,
            aten.baddbmm.default}

    def policy(_ctx, op, *_args, **_kwargs):
        return (CheckpointPolicy.MUST_SAVE if op in dots
                else CheckpointPolicy.PREFER_RECOMPUTE)

    return partial(create_selective_checkpoint_contexts, policy)


def forward_hidden(params: Transformer, tokens: torch.Tensor,
                   cfg: ModelConfig, attn_fn: Optional[AttnFn] = None,
                   positions: Optional[torch.Tensor] = None):
    """The block stack without the LM head -> (final-norm hidden states
    (B, S, D), summed MoE aux term); a shard's blocks through its
    collectives."""
    if attn_fn is None:
        attn_fn = default_attn_fn(cfg)
    if positions is None:
        positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                                 device=tokens.device)
    x, aux = run_blocks(cfg, attn_fn, positions, params.embed[tokens],
                        params.blocks,
                        body=partial(_block_output,
                                     shard=getattr(params, "shard", None)))
    return rms_norm(x, params.ln_f), aux


def run_blocks(cfg: ModelConfig, attn_fn: AttnFn, positions: torch.Tensor,
               x: torch.Tensor, blocks, body=_block_output):
    """x (B, S, D) through every block -> (x, summed MoE aux term). Each
    block is ``body(cfg, attn_fn, positions, x, layer) -> (x, aux)``,
    recomputed in the backward under ``cfg.remat`` (``_remat_context_fn``)
    when gradients are on."""
    aux = 0.0
    remat = cfg.remat and torch.is_grad_enabled()
    for layer in blocks:
        if remat:
            x, a = checkpoint(body, cfg, attn_fn, positions, x, layer,
                              use_reentrant=False,
                              context_fn=_remat_context_fn(cfg))
        else:
            x, a = body(cfg, attn_fn, positions, x, layer)
        aux = aux + a
    return x, aux


@torch.no_grad()
def forward(params: Transformer, tokens: torch.Tensor, cfg: ModelConfig,
            attn_fn: Optional[AttnFn] = None,
            positions: Optional[torch.Tensor] = None,
            return_aux: bool = False):
    """Next-token logits: tokens (B, S) int -> (B, S, V); with
    ``return_aux`` also the summed MoE load-balance term."""
    x, aux = forward_hidden(params, tokens, cfg, attn_fn, positions)
    logits = shard_logits(
        torch.einsum("bsd,dv->bsv", x, maybe_dequantize(params.head)),
        getattr(params, "shard", None))
    return (logits, aux) if return_aux else logits


@torch.no_grad()
def forward_with_kv(params: Transformer, tokens: torch.Tensor,
                    cfg: ModelConfig, attn_fn: Optional[AttnFn] = None,
                    shard=None):
    """The batched forward that also returns every layer's rotary-embedded
    K/V: the prefill of the dense decode cache (the same block as
    training, so prefill cannot drift from the trained model) -> (last
    position's logits (B, V) f32, ks (L, B, S, H_kv, D), vs likewise).
    *shard* defaults to the model's own (``Transformer.shard``): a shard's
    K/V are its heads', its logits the whole vocabulary's."""
    if shard is None:
        shard = getattr(params, "shard", None)
    if attn_fn is None:
        attn_fn = default_attn_fn(cfg)
    positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                             device=tokens.device)
    x = params.embed[tokens]
    ks, vs = [], []
    for layer in params.blocks:
        x, _aux, k, v = _block_with_aux(cfg, attn_fn, positions, x, layer,
                                        shard)
        ks.append(k)
        vs.append(v)
    x = rms_norm(x, params.ln_f)
    logits = torch.einsum("bsd,dv->bsv", x,
                          maybe_dequantize(params.head))[:, -1]
    return (shard_logits(logits.float(), shard), torch.stack(ks),
            torch.stack(vs))


def _position_losses(logits, targets, label_smoothing: float,
                     z_loss: float) -> torch.Tensor:
    """Per-position loss in f32 from raw logits, the formula both loss tails
    share: cross-entropy, label-smoothed as ``(1-e)*nll - e*mean(logp)``,
    plus the z-loss ``z * logsumexp(logits)^2``."""
    f32 = logits.float()
    lse = torch.logsumexp(f32, dim=-1)
    logp = f32 - lse[..., None]
    nll = -torch.gather(logp, -1, targets[..., None].long())[..., 0]
    if label_smoothing > 0:
        nll = ((1.0 - label_smoothing) * nll
               - label_smoothing * logp.mean(dim=-1))
    if z_loss > 0:
        nll = nll + z_loss * lse.square()
    return nll


def token_cross_entropy(logits, targets, weights=None,
                        label_smoothing: float = 0.0,
                        z_loss: float = 0.0) -> torch.Tensor:
    """Token-level cross-entropy in f32: the unweighted mean, or with
    *weights* (targets' shape) the weighted mean over nonzero weights."""
    nll = _position_losses(logits, targets, label_smoothing, z_loss)
    if weights is None:
        return nll.mean()
    w = weights.float()
    return (nll * w).sum() / torch.clamp(w.sum(), min=1.0)


def _chunk_loss(xi, head, ti, wi, label_smoothing, z_loss):
    logits = torch.einsum("bcd,dv->bcv", xi, head)
    nll = _position_losses(logits, ti, label_smoothing, z_loss)
    return (nll * wi).sum(), wi.sum()


def chunked_token_cross_entropy(x, head, targets, chunk: int, weights=None,
                                label_smoothing: float = 0.0,
                                z_loss: float = 0.0) -> torch.Tensor:
    """Cross-entropy from hidden states (B, S, D) without the full
    (B, S, V) logits: one (B, chunk, V) head product and log-softmax per
    sequence chunk, each checkpointed so that backward recomputes one
    chunk's logits at a time. ``chunk`` must divide S."""
    b, s, _d = x.shape
    if s % chunk:
        raise ValueError(f"chunk ({chunk}) must divide sequence length ({s})")
    if weights is None:
        weights = torch.ones((b, s), dtype=torch.float32, device=x.device)
    weights = weights.float()
    nll_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    w_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    for c0 in range(0, s, chunk):
        args = (x[:, c0:c0 + chunk], head, targets[:, c0:c0 + chunk],
                weights[:, c0:c0 + chunk], label_smoothing, z_loss)
        if torch.is_grad_enabled():
            n, w = checkpoint(_chunk_loss, *args, use_reentrant=False)
        else:
            n, w = _chunk_loss(*args)
        nll_sum, w_sum = nll_sum + n, w_sum + w
    return nll_sum / torch.clamp(w_sum, min=1.0)


def lm_loss_tail(x, head, targets, cfg: ModelConfig,
                 weights=None) -> torch.Tensor:
    """The loss tail: final-norm hidden states -> mean cross-entropy, as one
    materialized (B, S, V) logits tensor or the chunked stream
    (``cfg.loss_chunk``), with the config's label smoothing and z-loss."""
    if cfg.loss_chunk > 0:
        return chunked_token_cross_entropy(
            x, head, targets, cfg.loss_chunk, weights,
            label_smoothing=cfg.label_smoothing, z_loss=cfg.z_loss)
    logits = torch.einsum("bsd,dv->bsv", x, head)
    return token_cross_entropy(logits, targets, weights,
                               label_smoothing=cfg.label_smoothing,
                               z_loss=cfg.z_loss)


def next_token_loss(params: Transformer, tokens: torch.Tensor,
                    targets: torch.Tensor, cfg: ModelConfig,
                    attn_fn: Optional[AttnFn] = None,
                    positions: Optional[torch.Tensor] = None,
                    weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean causal LM cross-entropy, differentiable (it does not pass
    through the gradient-free ``forward``). ``targets`` is ``tokens``
    shifted by one (the data pipeline's job); ``weights`` (B, S) masks
    positions out of the mean (pad positions of packed batches). A MoE
    config adds ``moe_aux_coeff`` times the summed load-balance term."""
    x, aux = forward_hidden(params, tokens, cfg, attn_fn, positions)
    loss = lm_loss_tail(x, params.head, targets, cfg, weights)
    if cfg.n_experts > 0 and cfg.moe_aux_coeff > 0:
        loss = loss + cfg.moe_aux_coeff * aux
    return loss
