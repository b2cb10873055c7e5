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
counts attention calls that ran on the card; the plain version adds nothing
to it.

Routes, chosen by ``_route(q, k_pages_l, t, window)``:

- "split" (the decode form, T = 1: every dtype, int8 pages, windows; head
  dims that are multiples of 16): the keys are cut into spans of
  ``_SPLIT_KEYS``; one kernel writes each span's unnormalised partial into
  scratch, a second one merges them per row.
  ``paged_attention.split_launches`` and ``.combine_launches`` count the
  two. ``paged_attention_split_reference`` is its plain version, for the
  tests.
- "wgmma" (the chunk form, T > 1 without a window, bf16/f16 q at D 64 or
  128, over dense pages in q's dtype or int8 pages): the tensor-core chunk
  kernel; ``paged_attention.wgmma_launches`` counts its dense instances,
  ``.wgmma_int8_launches`` its int8 ones (which convert the int8 tiles to
  q's dtype in shared memory and apply the scales to the f32 scores and
  weights). Where its 64-row blocks would leave SMs idle it cuts each
  row's keys into up to 4 shares (``_chunk_splits``) and the combine
  kernel merges them.
- "rows" (the speculative verify chunk where it is the fastest:
  ``_ROWS_ROUTE``): the split route over a chunk's B*T queries as
  one-query rows (each slot's table row repeated T times, row (b, t) at
  pos[b] + t), exact because the chunk's K/V are written before the call;
  it counts as split and combine launches.
- "simt" (every other call: chunks at f32 q or at head dims other than
  64/128, and decode at head dims that are not multiples of 16): the f32
  CUDA-core kernel; ``paged_attention.simt_launches`` counts it. The
  chunk entry point passes no window, so windowed chunks reach no
  kernel.

The route is dispatch, not a fallback: an instance that refuses a call
raises, and nothing retries it on another route.
"""

from __future__ import annotations

import ctypes

import torch

NEG_INF = -1e30
_DTYPE_CODE = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
_MAX_HEAD_DIM = 256
# keys per span of the split route: 16 spans at the flagship's 2048-token
# table; a ~300-token context is 3 spans of at most 4 key tiles each
_SPLIT_KEYS = 128


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


# The speculative verify chunk (T = gamma + 1 <= 9 queries a slot) timed on
# the three routes at B = 8, g = 1, D = 128 (chip_smoke.py phase 3,
# ``verify_route`` lines): the wgmma chunk is fastest at every T over bf16
# pages and at T 3-9 over int8 pages; at T = 2 over int8 pages the split
# route over the B*T queries as one-query rows is. (T, int8 pages) pairs
# that take "rows" at g = 1, D = 128:
_ROWS_ROUTE = {(2, True)}


def _route(q, k_pages_l, t: int, window: int) -> str:
    """The instances that run a call with *t* queries per slot: "split" for
    one query (T = 1) at a head dim that is a multiple of 16; for T > 1
    without a window at bf16/f16 q and D 64 or 128, "rows" where
    ``_ROWS_ROUTE`` names (T, int8 pages) at g = 1 and D = 128, else
    "wgmma" over dense or int8 pages (*k_pages_l* picks the instance);
    else "simt"."""
    d = q.shape[-1]
    if t == 1:
        return "split" if d % 16 == 0 else "simt"
    if (window == 0 and q.dtype in (torch.bfloat16, torch.float16)
            and d in (64, 128)):
        int8 = isinstance(k_pages_l, tuple)
        g = q.shape[2] // _pages(k_pages_l)[0].shape[2]
        if d == 128 and g == 1 and (t, int8) in _ROWS_ROUTE:
            return "rows"
        return "wgmma"
    return "simt"


def _scores(q, k_pages_l, v_pages_l, table, pos, window):
    """(s (B, H_kv, g, T, S) f32, vis broadcastable to s, v (B, S, H_kv, D)
    f32) over the gathered pages: q scaled before the product, key k
    visible iff its page is mapped, k <= the query's position and, with a
    window, position - k < window."""
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
    return s, vis, v


def paged_attention_reference(q, k_pages_l, v_pages_l, table, pos,
                              window: int = 0):
    """The plain PyTorch version of the kernels, q (B, T, H, D) -> (B, T, H,
    D): the same masks and the same softmax as the kernels' online one over
    the gathered pages (f32 math; ``exp(min(s - m, 0))`` on visible keys;
    ``acc / max(l, 1e-30)``), so a row that sees no key is 0."""
    s, vis, v = _scores(q, k_pages_l, v_pages_l, table, pos, window)
    s = torch.where(vis, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(vis, torch.exp(torch.clamp(s - m, max=0.0)),
                    torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bkgts,bskd->bkgtd", p, v) / torch.clamp(l, min=1e-30)
    b, t, h, d = q.shape
    return o.permute(0, 3, 1, 2, 4).reshape(b, t, h, d).to(q.dtype)


def _split_partials(q, k_pages_l, v_pages_l, table, pos, window: int,
                    split_keys: int):
    """(part (B, T, H, n, D), ml (B, T, H, n, 2)) f32, n = ceil(max_pages *
    ps / split_keys): per span of *split_keys* keys the unnormalised partial
    of the visible keys, m_i = their max score (-1e30 for none),
    l_i = sum exp(min(s - m_i, 0)) and acc_i = sum p v — the plain version
    of the split kernel (whose part and ml are these at T = 1)."""
    s, vis, v = _scores(q, k_pages_l, v_pages_l, table, pos, window)
    b, h_kv, g, t, n_keys = s.shape
    n = -(-n_keys // split_keys)
    pad = n * split_keys - n_keys
    vis = vis.expand_as(s)
    s = torch.nn.functional.pad(s, (0, pad)).reshape(b, h_kv, g, t, n,
                                                     split_keys)
    vis = torch.nn.functional.pad(vis, (0, pad)).reshape(s.shape)
    v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad)).reshape(
        b, n, split_keys, h_kv, v.shape[-1])
    s = torch.where(vis, s, torch.full_like(s, NEG_INF))
    m_i = s.amax(dim=-1)                                    # (B,k,g,T,n)
    p = torch.where(vis, torch.exp(torch.clamp(s - m_i[..., None], max=0.0)),
                    torch.zeros_like(s))
    acc_i = torch.einsum("bkgtnj,bnjkd->bkgtnd", p, v)
    ml = torch.stack([m_i, p.sum(dim=-1)], dim=-1)
    return tuple(x.permute(0, 3, 1, 2, 4, 5).reshape(b, t, h_kv * g, n, -1)
                 for x in (acc_i, ml))


def _merge_partials(part, ml):
    """out (..., D) f32 from partials (..., n, D) and (..., n, 2), as the
    combine kernel merges them: m = max m_i, l = sum l_i e^(m_i - m),
    acc = sum acc_i e^(m_i - m) over the spans with l_i > 0 (an empty
    span's acc is never read), out = acc / max(l, 1e-30)."""
    m_i, l_i = ml[..., 0], ml[..., 1]
    w = torch.exp(m_i - m_i.amax(dim=-1, keepdim=True))
    l = (l_i * w).sum(dim=-1)
    acc = torch.where((l_i > 0)[..., None], part * w[..., None],
                      torch.zeros_like(part)).sum(dim=-2)
    return acc / torch.clamp(l, min=1e-30)[..., None]


def paged_attention_split_reference(q, k_pages_l, v_pages_l, table, pos,
                                    window: int = 0,
                                    split_keys: int = _SPLIT_KEYS):
    """The plain PyTorch version of the split route, q (B, T, H, D) ->
    (B, T, H, D): the spans' partials (``_split_partials``) merged as the
    combine kernel merges them (``_merge_partials``). Equal to
    ``paged_attention_reference`` up to summation order; a row whose spans
    are all empty is 0 (weights e^0 = 1 times l_i = 0 and no acc). For the
    tests; nothing on the main path calls it."""
    part, ml = _split_partials(q, k_pages_l, v_pages_l, table, pos, window,
                               split_keys)
    return _merge_partials(part, ml).to(q.dtype)


def _lib():
    from kubetpu_torch.ops import _build

    lib = _build.load("paged_attention")
    if not getattr(lib, "_kubetpu_bound", False):
        ptr, i = ctypes.c_void_p, ctypes.c_int
        lib.kubetpu_paged_attention.argtypes = (
            [ptr] * 8 + [i] * 8 + [ctypes.c_float, i, i, ptr])
        lib.kubetpu_paged_chunk_wgmma.argtypes = (
            [ptr] * 10 + [i] * 8 + [ctypes.c_float, i, i, ptr])
        lib.kubetpu_paged_split.argtypes = (
            [ptr] * 9 + [i] * 7 + [ctypes.c_float, i, i, i, ptr])
        lib.kubetpu_paged_combine.argtypes = [ptr] * 3 + [i] * 4 + [ptr]
        lib.kubetpu_paged_smem_bytes.argtypes = [i] * 7
        for fn in (lib.kubetpu_paged_attention, lib.kubetpu_paged_chunk_wgmma,
                   lib.kubetpu_paged_split, lib.kubetpu_paged_combine,
                   lib.kubetpu_paged_smem_bytes):
            fn.restype = i
        lib._kubetpu_bound = True
    return lib


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"paged attention {what} kernel launch failed: "
                           f"CUDA error {rc}")


def _n_splits(table, ps: int) -> int:
    """Spans of the split route: from the table's width, never from pos,
    so that no host sync is needed."""
    return -(-table.shape[1] * ps // _SPLIT_KEYS)


_SM_COUNT = {}


def _chunk_splits(q, h_kv: int) -> int:
    """Key shares of the wgmma chunk kernel for q (B, T, H, D): 1 where its
    64-row blocks already give two blocks an SM, else up to 4, so that
    they do."""
    b, t, h, _ = q.shape
    blocks = -(-t * (h // h_kv) // 64) * h_kv * b
    dev = q.device.index or 0
    if dev not in _SM_COUNT:
        _SM_COUNT[dev] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    return max(1, min(4, 2 * _SM_COUNT[dev] // blocks))


def _launch_chunk(q, k_pages_l, v_pages_l, table, pos):
    """out (B, T, H, D): the wgmma chunk kernel (its int8 instance over an
    int8 pool), and with a key split the combine kernel after it (CUDA
    tensors only)."""
    kv, ksc = _pages(k_pages_l)
    vv, vsc = _pages(v_pages_l)
    b, t, h, d = q.shape
    h_kv = kv.shape[2]
    n = _chunk_splits(q, h_kv)
    out = torch.empty_like(q)
    part = ml = None
    if n > 1:
        part = torch.empty((b, t, h, n, d), dtype=torch.float32,
                           device=q.device)
        ml = torch.empty((b, t, h, n, 2), dtype=torch.float32,
                         device=q.device)
    rc = _lib().kubetpu_paged_chunk_wgmma(
        q.data_ptr(), kv.data_ptr(), vv.data_ptr(),
        ksc.data_ptr() if ksc is not None else None,
        vsc.data_ptr() if vsc is not None else None,
        table.data_ptr(), pos.data_ptr(), out.data_ptr(),
        part.data_ptr() if n > 1 else None, ml.data_ptr() if n > 1 else None,
        b, t, h, h_kv, d, kv.shape[1], table.shape[1], n,
        float(d ** -0.5), _DTYPE_CODE[q.dtype], int(ksc is not None),
        torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(rc, "(wgmma)")
    if ksc is None:
        paged_attention.wgmma_launches += 1
    else:
        paged_attention.wgmma_int8_launches += 1
    if n > 1:
        _launch_combine(part, ml, out)
    return out


def _launch_split(q, k_pages_l, v_pages_l, table, pos, window: int):
    """(part (B, H, n_splits, D), ml (B, H, n_splits, 2)) f32: the split
    kernel's partials for q (B, 1, H, D) (CUDA tensors only)."""
    kv, ksc = _pages(k_pages_l)
    vv, vsc = _pages(v_pages_l)
    b, _, h, d = q.shape
    ps = kv.shape[1]
    n = _n_splits(table, ps)
    part = torch.empty((b, h, n, d), dtype=torch.float32, device=q.device)
    ml = torch.empty((b, h, n, 2), dtype=torch.float32, device=q.device)
    rc = _lib().kubetpu_paged_split(
        q.data_ptr(), kv.data_ptr(), vv.data_ptr(),
        ksc.data_ptr() if ksc is not None else None,
        vsc.data_ptr() if vsc is not None else None,
        table.data_ptr(), pos.data_ptr(), part.data_ptr(), ml.data_ptr(),
        b, h, kv.shape[2], d, ps, table.shape[1], int(window),
        float(d ** -0.5), _SPLIT_KEYS, _DTYPE_CODE[q.dtype],
        int(ksc is not None), torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(rc, "split")
    paged_attention.split_launches += 1
    return part, ml


def _launch_combine(part, ml, out):
    """Merges the partials (..., n, D) and (..., n, 2) into *out* (the
    rows of ``part`` times D, in out's dtype) and returns it."""
    n, d = part.shape[-2:]
    rc = _lib().kubetpu_paged_combine(
        part.data_ptr(), ml.data_ptr(), out.data_ptr(), part.numel() // (n * d),
        n, d, _DTYPE_CODE[out.dtype],
        torch.cuda.current_stream(part.device).cuda_stream)
    _raise_on(rc, "combine")
    paged_attention.combine_launches += 1
    return out


def _launch_rows(q, k_pages_l, v_pages_l, table, pos):
    """The split route over a chunk's B*T queries as B*T one-query rows
    (CUDA tensors only): q (B, T, H, D) viewed as (B*T, 1, H, D), each
    slot's table row repeated T times and row (b, t) at position
    pos[b] + t. Exact for a chunk whose K/V the caller committed before the
    call: each row sees the keys its causal mask allows. Each slot's keys
    are read T times."""
    b, t, h, d = q.shape
    rows_q = q.reshape(b * t, 1, h, d)
    rows_table = table[:, None].expand(b, t, table.shape[1]).reshape(b * t,
                                                                    -1)
    rows_pos = (pos[:, None] + torch.arange(t, dtype=torch.int32,
                                            device=pos.device)).reshape(-1)
    out = _launch_combine(
        *_launch_split(rows_q, k_pages_l, v_pages_l, rows_table, rows_pos,
                       0),
        torch.empty_like(rows_q))
    return out.reshape(b, t, h, d)


def _kernel(q, k_pages_l, v_pages_l, table, pos, window: int, route=None):
    """Launch *route* (``_route``'s choice when None) for the call."""
    if route is None:
        route = _route(q, k_pages_l, q.shape[1], window)
    if route == "rows":
        out = _launch_rows(q, k_pages_l, v_pages_l, table, pos)
    elif route == "split":
        out = _launch_combine(
            *_launch_split(q, k_pages_l, v_pages_l, table, pos, window),
            torch.empty_like(q))
    elif route == "wgmma":
        out = _launch_chunk(q, k_pages_l, v_pages_l, table, pos)
    else:
        kv, ksc = _pages(k_pages_l)
        vv, vsc = _pages(v_pages_l)
        b, t, h, d = q.shape
        out = torch.empty_like(q)
        rc = _lib().kubetpu_paged_attention(
            q.data_ptr(), kv.data_ptr(), vv.data_ptr(),
            ksc.data_ptr() if ksc is not None else None,
            vsc.data_ptr() if vsc is not None else None,
            table.data_ptr(), pos.data_ptr(), out.data_ptr(),
            b, t, h, kv.shape[2], d, kv.shape[1], table.shape[1],
            int(window), float(d ** -0.5), _DTYPE_CODE[q.dtype],
            int(ksc is not None),
            torch.cuda.current_stream(q.device).cuda_stream)
        _raise_on(rc, "(simt)")
        paged_attention.simt_launches += 1
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
paged_attention.split_launches = 0
paged_attention.combine_launches = 0
paged_attention.wgmma_launches = 0
paged_attention.wgmma_int8_launches = 0
paged_attention.simt_launches = 0
