"""Flash attention: the wrappers of the hand-written CUDA kernels
(``csrc/flash_attention.cu``, which replace the TPU kernels
``kubetpu/ops/flash_attention.py::_flash_kernel``, ``_flash_bwd_dq_kernel``
and ``_flash_bwd_dkv_kernel``), their plain PyTorch versions, and the
``torch.autograd.Function`` that joins them.

Layouts are the JAX package's: q, k, v, out and the cotangent are
``(B, S, H, D)`` with K/V already expanded to H heads (``repeat_kv``); the
per-row log-sum-exp is ``(B*H, S, 1)`` float32, the backward residual and
the merge weight of ring attention. ``causal=False`` is full visibility;
``window > 0`` (causal only) lets each row see the previous ``window``
positions including itself.

A CUDA tensor launches the kernels or raises; only CPU tensors take the
plain versions. ``flash_forward.launches``, ``flash_backward.dq_launches``
and ``flash_backward.dkv_launches`` count kernel launches; the plain
versions add nothing to them.

Routes. Each of the three kernels has two sets of instances, chosen by
``_route(dtype, head_dim)``: "wgmma" (tensor cores, bf16/f16 operands with
f32 sums; bf16 and f16 at D 64 or 128) and "simt" (f32 CUDA-core math;
f32, where TF32 stays off for parity, and the other head dims).
``flash_forward.wgmma_launches``, ``flash_backward.dq_wgmma_launches`` and
``flash_backward.dkv_wgmma_launches`` count the wgmma launches among the
totals. The route is dispatch, not a fallback: a wgmma instance that fails
raises.
"""

from __future__ import annotations

import ctypes

import torch

NEG_INF = -1e30
_DTYPE_CODE = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
_MAX_HEAD_DIM = 256
_ROUTE_CODE = {"simt": 0, "wgmma": 1}


def _route(dtype: torch.dtype, d: int) -> str:
    """The instances that run the three kernels for *dtype* at head dim *d*:
    "wgmma" for bf16/f16 at D 64 or 128, else "simt"."""
    if dtype in (torch.bfloat16, torch.float16) and d in (64, 128):
        return "wgmma"
    return "simt"


def _check_window(causal: bool, window: int) -> None:
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if window > 0 and not causal:
        raise ValueError("window > 0 requires causal attention")


def _check(q, *others) -> None:
    """Raise on any input the kernels do not take: every tensor (B, S, H, D)
    in one supported dtype, on one device, contiguous."""
    if q.dim() != 4:
        raise ValueError(f"q must be (B, S, H, D), got {tuple(q.shape)}")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"q dtype {q.dtype} not in {list(_DTYPE_CODE)}")
    if q.shape[3] > _MAX_HEAD_DIM:
        raise ValueError(f"head dim {q.shape[3]} > {_MAX_HEAD_DIM}")
    for x in (q, *others):
        if x.shape != q.shape:
            raise ValueError(f"shape {tuple(x.shape)} differs from q's "
                             f"{tuple(q.shape)}")
        if x.dtype != q.dtype:
            raise TypeError(f"dtype {x.dtype} differs from q's {q.dtype}")
        if x.device != q.device:
            raise ValueError(f"all inputs must be on {q.device}, got "
                             f"{x.device}")
        if not x.is_contiguous():
            raise ValueError("all inputs must be contiguous")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash attention runs on cuda or cpu, not "
                         f"{q.device}")


def _check_lse(lse, q) -> None:
    b, s, h, _ = q.shape
    if (lse.dtype != torch.float32 or tuple(lse.shape) != (b * h, s, 1)
            or lse.device != q.device or not lse.is_contiguous()):
        raise TypeError(f"lse must be contiguous float32 ({b * h}, {s}, 1) "
                        f"on {q.device}")


def _heads(x: torch.Tensor) -> torch.Tensor:
    """(B, S, H, D) -> (B*H, S, D) in f32, one row of the grid per head."""
    b, s, h, d = x.shape
    return x.float().permute(0, 2, 1, 3).reshape(b * h, s, d)


def _back(x: torch.Tensor, shape, dtype) -> torch.Tensor:
    b, s, h, d = shape
    return x.reshape(b, h, s, d).permute(0, 2, 1, 3).contiguous().to(dtype)


def _visible(s: int, causal: bool, window: int, device) -> torch.Tensor:
    """(S, S) bool: key k visible to query row r."""
    pos = torch.arange(s, device=device)
    if not causal:
        return torch.ones((s, s), dtype=torch.bool, device=device)
    vis = pos[:, None] >= pos[None, :]
    if window > 0:
        vis &= pos[:, None] - pos[None, :] < window
    return vis


def _delta(out, g) -> torch.Tensor:
    """Per-row softmax correction rowsum(dO * O) in f32, (B*H, S, 1)."""
    return (_heads(g) * _heads(out)).sum(dim=-1, keepdim=True)


def flash_forward_reference(q, k, v, causal: bool = True, window: int = 0):
    """The plain PyTorch version of the forward kernel -> (out (B, S, H, D)
    in q's dtype, lse (B*H, S, 1) f32): the Pallas kernel's formulas on the
    whole score matrix — q scaled before the product, f32 math, masked
    scores at -1e30, ``o = acc / l`` and ``lse = m + log(l)``."""
    _check_window(causal, window)
    d = q.shape[3]
    qh, kh, vh = _heads(q) * d ** -0.5, _heads(k), _heads(v)
    vis = _visible(q.shape[1], causal, window, q.device)
    s = torch.where(vis, qh @ kh.transpose(1, 2), NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(vis, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    out = (p @ vh) / l
    return _back(out, q.shape, q.dtype), m + torch.log(l)


def flash_backward_reference(q, k, v, out, lse, g, causal: bool = True,
                             window: int = 0):
    """The plain PyTorch version of the two backward kernels -> (dq, dk, dv)
    in q's dtype: P = exp(min(s*scale - lse, 0)) on visible keys (the clamp
    keeps ring attention's invisible steps finite), dS = P * (dO V^T - D),
    dQ = dS K * scale, dK = dS^T Q * scale, dV = P^T dO, with
    D = rowsum(dO * O). *out*, *lse* and *g* may be the global ones of a
    ring step."""
    _check_window(causal, window)
    d = q.shape[3]
    scale = d ** -0.5
    qh, kh, vh, gh = _heads(q), _heads(k), _heads(v), _heads(g)
    vis = _visible(q.shape[1], causal, window, q.device)
    s = (qh @ kh.transpose(1, 2)) * scale
    p = torch.where(vis, torch.exp(torch.clamp(s - lse, max=0.0)), 0.0)
    ds = p * (gh @ vh.transpose(1, 2) - _delta(out, g))
    dq = (ds @ kh) * scale
    dk = (ds.transpose(1, 2) @ qh) * scale
    dv = p.transpose(1, 2) @ gh
    return tuple(_back(x, q.shape, q.dtype) for x in (dq, dk, dv))


def _lib():
    from kubetpu_torch.ops import _build

    lib = _build.load("flash_attention")
    if not getattr(lib, "_kubetpu_bound", False):
        common = [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_int,
                                       ctypes.c_void_p]
        routed = common + [ctypes.c_int]
        lib.kubetpu_flash_forward.argtypes = [ctypes.c_void_p] * 5 + routed
        lib.kubetpu_flash_backward_dq.argtypes = [ctypes.c_void_p] * 7 + routed
        lib.kubetpu_flash_backward_dkv.argtypes = ([ctypes.c_void_p] * 8
                                                   + routed)
        lib.kubetpu_flash_smem_bytes.argtypes = [ctypes.c_int] * 3
        for fn in (lib.kubetpu_flash_forward, lib.kubetpu_flash_backward_dq,
                   lib.kubetpu_flash_backward_dkv,
                   lib.kubetpu_flash_smem_bytes):
            fn.restype = ctypes.c_int
        lib._kubetpu_bound = True
    return lib


def _dims(q, causal, window):
    b, s, h, d = q.shape
    return (b, s, h, d, int(causal), int(window), float(d ** -0.5),
            _DTYPE_CODE[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"flash attention {what} kernel launch failed: "
                           f"CUDA error {rc}")


def flash_forward(q, k, v, causal: bool = True, window: int = 0):
    """(out (B, S, H, D) in q's dtype, lse (B*H, S, 1) f32): the forward
    kernel for CUDA tensors, the plain version for CPU tensors."""
    _check_window(causal, window)
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_forward_reference(q, k, v, causal, window)
    b, s, h, d = q.shape
    route = _route(q.dtype, d)
    out = torch.empty_like(q)
    lse = torch.empty((b * h, s, 1), dtype=torch.float32, device=q.device)
    rc = _lib().kubetpu_flash_forward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), *_dims(q, causal, window), _ROUTE_CODE[route])
    _raise_on(rc, f"forward ({route})")
    flash_forward.launches += 1
    flash_forward.wgmma_launches += route == "wgmma"
    return out, lse


def _launch_dq(q, k, v, g, lse, delta, causal: bool, window: int):
    """dQ from the dQ kernel (CUDA tensors only)."""
    route = _route(q.dtype, q.shape[3])
    dq = torch.empty_like(q)
    rc = _lib().kubetpu_flash_backward_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        *_dims(q, causal, window), _ROUTE_CODE[route])
    _raise_on(rc, f"dQ ({route})")
    flash_backward.dq_launches += 1
    flash_backward.dq_wgmma_launches += route == "wgmma"
    return dq


def _launch_dkv(q, k, v, g, lse, delta, causal: bool, window: int):
    """(dK, dV) from the dK/dV kernel (CUDA tensors only)."""
    route = _route(q.dtype, q.shape[3])
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    rc = _lib().kubetpu_flash_backward_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        *_dims(q, causal, window), _ROUTE_CODE[route])
    _raise_on(rc, f"dK/dV ({route})")
    flash_backward.dkv_launches += 1
    flash_backward.dkv_wgmma_launches += route == "wgmma"
    return dk, dv


def flash_backward(q, k, v, out, lse, g, causal: bool = True,
                   window: int = 0):
    """(dq, dk, dv) in q's dtype: the dQ kernel and the dK/dV kernel for
    CUDA tensors (D = rowsum(dO * O) is one PyTorch reduction before them),
    the plain version for CPU tensors."""
    _check_window(causal, window)
    _check(q, k, v, out, g)
    _check_lse(lse, q)
    if q.device.type == "cpu":
        return flash_backward_reference(q, k, v, out, lse, g, causal, window)
    delta = _delta(out, g)
    dq = _launch_dq(q, k, v, g, lse, delta, causal, window)
    return (dq, *_launch_dkv(q, k, v, g, lse, delta, causal, window))


flash_forward.launches = 0
flash_forward.wgmma_launches = 0
flash_backward.dq_launches = 0
flash_backward.dq_wgmma_launches = 0
flash_backward.dkv_launches = 0
flash_backward.dkv_wgmma_launches = 0


class _FlashAttention(torch.autograd.Function):
    """The counterpart of the JAX package's ``custom_vjp``: the forward
    saves (q, k, v, out, lse), the backward runs the two backward kernels
    on them."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        out, lse = flash_forward(q, k, v, causal, window)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_backward(q, k, v, out, lse,
                                    g.to(q.dtype).contiguous(), ctx.causal,
                                    ctx.window)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal: bool = True, window: int = 0):
    """Flash attention (B, S, H, D) -> (B, S, H, D), a drop-in attention
    core for ``model.forward_hidden``'s ``attn_fn``, differentiable through
    the backward kernels. Causal by default; ``causal=False`` is full
    visibility; ``window > 0`` (causal only) is sliding-window attention."""
    _check_window(causal, window)
    return _FlashAttention.apply(q, k, v, causal, window)
