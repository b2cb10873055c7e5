"""Plain float32 forward pass of a Llama-style decoder, dense or with a
mixture of experts, from a dict of weights in the layouts of
``portbench.inputs`` (``wq (d, H, hd)``, ``wo (H, hd, d)``, ``w_gate (E, d,
f)``, ``head (d, V)``).

The block: RMSNorm (``x * rsqrt(mean(x^2) + eps) * g``), rotary embeddings
(the rotate-half form, frequencies ``theta ** (-i / (hd/2))``), causal
grouped-query attention with softmax scale ``hd ** -0.5``, and a SwiGLU MLP
``(silu(h Wg) * (h Wu)) Wd``. A mixture-of-experts block routes each token
by ``softmax(h R)`` to its ``top_k`` experts and sums their SwiGLU outputs
weighted by those probabilities (``renormalize`` divides by their sum, as
published Mixtral does; the configuration says which). No token is ever
dropped. Everything is computed in float32 with TF32 off, one layer's
weights upcast at a time, attention in blocks of queries, so that a 47 GB
bf16 model fits beside its own activations.

``precision="fp8"`` is the control: every matrix product of the block and
the head takes its weight quantized to float8 e4m3 per output channel and
its input quantized to e4m3 per row, as an fp8 GEMM with scaled operands
would, and is otherwise the same code.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

_Q_BLOCK = 1024          # queries an attention block
_E4M3_MAX = 448.0


def no_tf32() -> None:
    """float32 matrix products in float32, never TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """*x* rounded through float8 e4m3 with one scale per slice along
    *dim* (amax to 448), back in float32."""
    amax = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12)
    scale = _E4M3_MAX / amax
    return (x * scale).to(torch.float8_e4m3fn).float() / scale


class _Mm:
    """``x @ w`` (x (..., K), w (K, N)) in float32, or through fp8
    operands: the weight scaled per output column, the input per row."""

    def __init__(self, precision: str) -> None:
        if precision not in ("f32", "fp8"):
            raise ValueError(f"unknown precision {precision!r}")
        self.fp8 = precision == "fp8"

    def weight(self, w: torch.Tensor) -> torch.Tensor:
        """A (K, N) weight as this precision holds it."""
        w = w.float()
        return _fp8(w, 0) if self.fp8 else w

    def __call__(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        if self.fp8:
            x = _fp8(x, -1)
        return x @ w


def rms_norm(x: torch.Tensor, g: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * g


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (S, H, hd) at positions 0..S-1."""
    s, _, hd = x.shape
    half = hd // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float64,
                                    device=x.device) / half)
    ang = torch.arange(s, dtype=torch.float64, device=x.device)[:, None] * freqs
    cos = torch.cos(ang).float()[:, None, :]
    sin = torch.sin(ang).float()[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
              ) -> torch.Tensor:
    """Causal attention, q (S, H, hd), k/v (S, Hkv, hd) -> (S, H, hd), in
    blocks of queries."""
    s, h, hd = q.shape
    rep = h // k.shape[1]
    k = k.repeat_interleave(rep, dim=1).transpose(0, 1)       # (H, S, hd)
    v = v.repeat_interleave(rep, dim=1).transpose(0, 1)
    out = torch.empty_like(q)
    keys = torch.arange(s, device=q.device)
    for q0 in range(0, s, _Q_BLOCK):
        q1 = min(s, q0 + _Q_BLOCK)
        qb = q[q0:q1].transpose(0, 1)                           # (H, b, hd)
        sc = (qb @ k[:, :q1].transpose(1, 2)) * hd ** -0.5     # (H, b, q1)
        mask = keys[None, :q1] > torch.arange(q0, q1,
                                              device=q.device)[:, None]
        sc.masked_fill_(mask, float("-inf"))
        out[q0:q1] = (torch.softmax(sc, -1) @ v[:, :q1]).transpose(0, 1)
    return out


def _swiglu(h, wg, wu, wd, mm: _Mm):
    return mm(torch.nn.functional.silu(mm(h, wg)) * mm(h, wu), wd)


def moe(h: torch.Tensor, w: Dict[str, torch.Tensor], top_k: int,
        renormalize: bool, mm: _Mm, routes: Optional[list] = None
        ) -> torch.Tensor:
    """Dropless top-k mixture of experts over h (S, d). With *routes* (a
    list) appends each token's chosen experts (S, top_k) and its routing
    margin (S,): the router logit of its last chosen expert less that of
    the best expert it did not choose."""
    router = mm(h, mm.weight(w["moe_router"]))
    probs = torch.softmax(router, dim=-1)
    gate, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, idx = gate[:, :top_k], idx[:, :top_k]
    if renormalize:
        gate = gate / gate.sum(-1, keepdim=True)
    if routes is not None:
        top = torch.sort(router, dim=-1, descending=True).values
        routes.append((idx.cpu(), (top[:, top_k - 1] - top[:, top_k]).cpu()))
    out = torch.zeros_like(h)
    for e in range(probs.shape[-1]):
        rows, slot = torch.nonzero(idx == e, as_tuple=True)
        if rows.numel() == 0:
            continue
        y = _swiglu(h[rows], mm.weight(w["w_gate"][e]),
                    mm.weight(w["w_up"][e]),
                    mm.weight(w["w_down"][e]), mm)
        out.index_add_(0, rows, y * gate[rows, slot][:, None])
    return out


def block(x: torch.Tensor, w: Dict[str, torch.Tensor], m: dict, mm: _Mm,
          routes: Optional[list] = None) -> torch.Tensor:
    """One decoder block over x (S, d) in float32."""
    s, d = x.shape
    h_, kv, hd = m["n_heads"], m["n_kv_heads"], m["head_dim"]
    eps = m["rms_norm_eps"]
    h = rms_norm(x, w["ln1"].float(), eps)
    q = mm(h, mm.weight(w["wq"].reshape(d, h_ * hd))).view(s, h_, hd)
    k = mm(h, mm.weight(w["wk"].reshape(d, kv * hd))).view(s, kv, hd)
    v = mm(h, mm.weight(w["wv"].reshape(d, kv * hd))).view(s, kv, hd)
    theta = m["rope_theta"]
    a = attention(rope(q, theta), rope(k, theta), v)
    x = x + mm(a.reshape(s, h_ * hd), mm.weight(w["wo"].reshape(h_ * hd, d)))
    h = rms_norm(x, w["ln2"].float(), eps)
    if m.get("n_experts", 0):
        return x + moe(h, w, m["moe_top_k"], m["moe_renormalize"], mm, routes)
    return x + _swiglu(h, mm.weight(w["w_gate"]), mm.weight(w["w_up"]),
                       mm.weight(w["w_down"]), mm)


def layer_weights(weights: Dict[str, torch.Tensor], i: int
                  ) -> Dict[str, torch.Tensor]:
    pre = f"blocks.{i}."
    return {k[len(pre):]: v for k, v in weights.items() if k.startswith(pre)}


@torch.no_grad()
def logits(weights: Dict[str, torch.Tensor], m: dict, tokens: torch.Tensor,
           rows: torch.Tensor, precision: str = "f32",
           routes: Optional[list] = None) -> torch.Tensor:
    """Next-token logits (len(rows), V) in float32 at positions *rows* of
    the sequence *tokens* (S,), computed over the whole sequence."""
    mm = _Mm(precision)
    x = weights["embed"][tokens].float()
    for i in range(m["n_layers"]):
        x = block(x, layer_weights(weights, i), m, mm, routes)
    x = rms_norm(x[rows], weights["ln_f"].float(), m["rms_norm_eps"])
    return mm(x, mm.weight(weights["head"]))
