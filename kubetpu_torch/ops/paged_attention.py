"""Paged attention: the wrapper of the hand-written CUDA kernel
(``csrc/paged_attention.cu``, which replaces the TPU kernel
``kubetpu/ops/paged_attention.py::_paged_attn_kernel``) and its plain
PyTorch version.

One kernel serves both forms, like the one Pallas kernel does:
``paged_attention`` (one query token per slot, optional sliding ``window``;
the decode step) and ``paged_attention_chunk`` (T causal queries per slot;
every prefill chunk). Layouts and argument order are the JAX package's:
q ``(B, [T,] H, D)``; pages ``(P, ps, H_kv, D)`` in q's dtype, or an int8
``(values, scales (P, ps, H_kv, 1) f32)`` pair; table ``(B, max_pages)``
int32 with -1 for unmapped pages; pos ``(B,)`` int32, the position of the
first query.

A CUDA tensor launches the kernel or raises; only CPU tensors take the plain
version (``paged_attention_reference``). ``paged_attention.launches``
counts kernel launches, the plain version adds nothing to it.
"""

from __future__ import annotations

import ctypes

import torch

NEG_INF = -1e30
_DTYPE_CODE = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
_MAX_HEAD_DIM = 256


def _pages(pages_l):
    """(values, scales-or-None) of a dense or int8 page pool layer."""
    if isinstance(pages_l, tuple):
        return pages_l
    return pages_l, None


def _check(q, k_pages_l, v_pages_l, table, pos) -> None:
    """Raise on any input the kernel does not take."""
    if q.dim() != 4:
        raise ValueError(f"q must be (B, T, H, D), got {tuple(q.shape)}")
    b, t, h, d = q.shape
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"q dtype {q.dtype} not in {list(_DTYPE_CODE)}")
    if d > _MAX_HEAD_DIM:
        raise ValueError(f"head dim {d} > {_MAX_HEAD_DIM}")
    kv, ksc = _pages(k_pages_l)
    vv, vsc = _pages(v_pages_l)
    if (ksc is None) != (vsc is None):
        raise TypeError("K and V pools must both be int8 pairs or both dense")
    if kv.dim() != 4 or kv.shape != vv.shape or kv.shape[3] != d:
        raise ValueError(f"pages must be (P, ps, H_kv, {d}), got "
                         f"{tuple(kv.shape)} and {tuple(vv.shape)}")
    h_kv = kv.shape[2]
    if h % h_kv:
        raise ValueError(f"H ({h}) is not a multiple of H_kv ({h_kv})")
    tensors = [q, kv, vv, table, pos]
    if ksc is None:
        if kv.dtype != q.dtype or vv.dtype != q.dtype:
            raise TypeError(f"dense pages must be {q.dtype}, got {kv.dtype}")
    else:
        if kv.dtype != torch.int8 or vv.dtype != torch.int8:
            raise TypeError("int8 pool values must be torch.int8")
        for sc in (ksc, vsc):
            if sc.dtype != torch.float32 or sc.shape != kv.shape[:3] + (1,):
                raise TypeError("int8 pool scales must be float32 "
                                f"{tuple(kv.shape[:3]) + (1,)}")
        tensors += [ksc, vsc]
    if table.dtype != torch.int32 or table.dim() != 2 or table.shape[0] != b:
        raise TypeError(f"table must be int32 ({b}, max_pages)")
    if pos.dtype != torch.int32 or tuple(pos.shape) != (b,):
        raise TypeError(f"pos must be int32 ({b},)")
    for x in tensors:
        if x.device != q.device:
            raise ValueError(f"all inputs must be on {q.device}, got "
                             f"{x.device}")
        if not x.is_contiguous():
            raise ValueError("all inputs must be contiguous")


def _gather(pages_l, safe):
    """A slot's pages in logical order, dequantized to f32 for int8."""
    vals, sc = _pages(pages_l)
    if sc is None:
        return vals[safe].float()
    return vals[safe].float() * sc[safe]


def paged_attention_reference(q, k_pages_l, v_pages_l, table, pos,
                              window: int = 0):
    """The plain PyTorch version of the kernel, q (B, T, H, D) -> (B, T, H,
    D): the same masks and the same softmax as the kernel's online one over
    the gathered pages (f32 math; ``exp(min(s - m, 0))`` on visible keys;
    ``acc / max(l, 1e-30)``), so a row that sees no key is 0."""
    b, t, h, d = q.shape
    vals, _ = _pages(k_pages_l)
    ps, h_kv = vals.shape[1], vals.shape[2]
    g = h // h_kv
    max_pages = table.shape[1]
    safe = torch.clamp(table, min=0).long()
    k = _gather(k_pages_l, safe).reshape(b, max_pages * ps, h_kv, d)
    v = _gather(v_pages_l, safe).reshape(b, max_pages * ps, h_kv, d)
    qg = q.float().reshape(b, t, h_kv, g, d) * (d ** -0.5)
    s = torch.einsum("btkgd,bskd->bkgts", qg, k)
    k_pos = torch.arange(max_pages * ps, device=q.device)
    q_pos = pos.long()[:, None] + torch.arange(t, device=q.device)   # (B, T)
    vis = k_pos[None, None, :] <= q_pos[:, :, None]                  # (B, T, S)
    if window > 0:
        vis = vis & (q_pos[:, :, None] - k_pos[None, None, :] < window)
    mapped = torch.repeat_interleave(table >= 0, ps, dim=1)           # (B, S)
    vis = (vis & mapped[:, None, :])[:, None, None]                   # (B,1,1,T,S)
    s = torch.where(vis, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(vis, torch.exp(torch.clamp(s - m, max=0.0)),
                    torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bkgts,bskd->bkgtd", p, v) / torch.clamp(l, min=1e-30)
    return o.permute(0, 3, 1, 2, 4).reshape(b, t, h, d).to(q.dtype)


def _kernel(q, k_pages_l, v_pages_l, table, pos, window: int):
    from kubetpu_torch.ops import _build

    lib = _build.load("paged_attention")
    fn = lib.kubetpu_paged_attention
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 8
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    kv, ksc = _pages(k_pages_l)
    vv, vsc = _pages(v_pages_l)
    b, t, h, d = q.shape
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = fn(q.data_ptr(), kv.data_ptr(), vv.data_ptr(),
            ksc.data_ptr() if ksc is not None else None,
            vsc.data_ptr() if vsc is not None else None,
            table.data_ptr(), pos.data_ptr(), out.data_ptr(),
            b, t, h, kv.shape[2], d, kv.shape[1], table.shape[1],
            int(window), float(d ** -0.5), _DTYPE_CODE[q.dtype],
            int(ksc is not None), stream)
    if rc != 0:
        raise RuntimeError(f"paged attention kernel launch failed: CUDA "
                           f"error {rc}")
    paged_attention.launches += 1
    return out


def _call(q, k_pages_l, v_pages_l, table, pos, window: int):
    _check(q, k_pages_l, v_pages_l, table, pos)
    if q.device.type == "cpu":
        return paged_attention_reference(q, k_pages_l, v_pages_l, table, pos,
                                         window)
    if q.device.type != "cuda":
        raise ValueError(f"paged attention runs on cuda or cpu, not "
                         f"{q.device}")
    return _kernel(q, k_pages_l, v_pages_l, table, pos, window)


def paged_attention(q, k_pages_l, v_pages_l, table, pos, window: int = 0):
    """One query token per slot: q (B, H, D) -> (B, H, D). ``window > 0``
    bands the keys to the previous ``window`` positions."""
    return _call(q[:, None], k_pages_l, v_pages_l, table, pos, window)[:, 0]


def paged_attention_chunk(q, k_pages_l, v_pages_l, table, pos):
    """T causal queries per slot at ``pos..pos+T-1``: q (B, T, H, D) ->
    (B, T, H, D). No window, as in the JAX package."""
    return _call(q, k_pages_l, v_pages_l, table, pos, 0)


paged_attention.launches = 0
