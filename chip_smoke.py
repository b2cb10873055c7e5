"""Drive the PyTorch port (``kubetpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--record PATH]

Phases, one line each, any failure exits non-zero:

1. device: the card's name, and ``nvidia-smi``'s name and power limit;
2. build: every CUDA kernel of the port, compiled from ``kubetpu_torch/ops/
   csrc`` with ``nvcc`` (all sources at once);
3. kernels: the paged-attention kernels at the flagship serving shapes,
   each case's route, grid and splits — decode (bf16, int8, window 256) on
   the split route, whose split kernel (partials) and combine kernel are
   each held against their plain versions, and the T=256 chunk on the
   wgmma route; every call against the plain attention, with its time (a
   replayed CUDA graph of 20 calls: device time without the host's
   enqueue; the eager calls' time beside it), the
   plain version's, the least time the card could take (bytes over 3.35
   TB/s or operations over 989 TFLOP/s, whichever is larger) and one
   PyTorch library call's time as a yardstick; registers, spills and shared
   memory of the instances (a spill in the wgmma chunk instance fails);
4. flash: the forward, dQ and dK/dV kernels at the flagship training shape
   (B=4, S=2048, H=16, D=128, bf16; causal, causal with window 256, and
   non-causal), each against its plain version, with the same timings
   (SDPA forward and SDPA backward as the library yardsticks), the route
   that ran (the wgmma or SIMT instances), achieved TFLOP/s, and the
   instance's registers, spill bytes (``nvcc -Xptxas -v``) and shared
   memory; a spill in a bf16 D=128 wgmma instance fails the phase;
5. parity: a small f32 model served by the port on the CPU (plain version)
   and on the card (kernel) — prefill logits within 1e-3, greedy tokens
   equal;
6. serve: the flagship decoder (vocab 32000, d 2048, 12 layers, 16 heads,
   d_ff 5632, bf16, random weights from a seed) behind ``PagedDecodeServer``
   with staggered requests; every launch counter is zeroed just before and
   read just after: 12 split and combine launches per decode step, 12
   wgmma chunk launches (and a combine where a chunk splits its keys) per
   prefill chunk, and nothing on SIMT;
7. profile: ``torch.profiler`` over ten decode steps of eight slots — step
   time, device busy time, idle share, the top kernels;
8. train parity: the small f32 model trained three steps on the CPU (plain
   versions) and on the card (flash kernels) from the same weights and
   batches — first-step gradients and per-step losses agree;
9. train: the flagship at full width (max_seq 2048), batch 4 x seq 2048,
   full remat, flash attention, AdamW: one warm-up step, five timed steps
   (step time, tokens/s, MFU, peak memory; the flash launch counters are
   zeroed just before and must read 24 / 12 / 12 per step just after, and
   the wgmma counters 24 forward, 12 dQ and 12 dK/dV),
   then ten steps on one repeated batch, whose loss must fall;
10. train profile: ``torch.profiler`` over one training step — device busy
   time, idle share, the attention kernels' share, the top kernels;
11. the ``kernels`` JSON line, then the result line.

Nothing of JAX or of the ``kubetpu`` package is imported. ``--record PATH``
also writes every measured number as one JSON file.
"""

from __future__ import annotations

import copy
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_S = 3.35e12          # H100 SXM device memory rate
BF16_FLOP_S = 989e12           # H100 SXM dense bf16 tensor-core rate
BF16_TOL = 2e-2                # bf16 output: a few roundings of |o| < 1
F32_TOL = 1e-3


def line(tag: str, **kv) -> None:
    print(f"{tag}: " + json.dumps(kv, sort_keys=True), flush=True)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() in ms, from CUDA events around *iters*
    back-to-back calls after *warmup* calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int = 20) -> float:
    """Device time of fn() in ms without the host's enqueue time: *iters*
    calls captured in one CUDA graph (after three eager warm-up calls),
    replayed, and timed with CUDA events. For the paged calls, whose
    kernels are shorter than the host's Python work per call."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (5 * iters)


def phase_device() -> dict:
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    line("device", name=name, count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda)
    print(smi, flush=True)
    return {"name": name, "nvidia_smi": smi}


def phase_build() -> dict:
    from kubetpu_torch.ops import _build

    t0 = time.perf_counter()
    names = ["paged_attention", "flash_attention"]
    _build.build_all(names)
    secs = time.perf_counter() - t0
    ptxas = [ln.strip() for log in _build.BUILD_LOGS.values()
             for ln in log.splitlines() if "registers" in ln or "spill" in ln]
    # the instances that spill: the mangled name of the "Function
    # properties" line above each spill report that is not all zeros
    spills = []
    for log in _build.BUILD_LOGS.values():
        lines = log.splitlines()
        for i, ln in enumerate(lines):
            if ("bytes spill stores" in ln and not (
                    ", 0 bytes spill stores" in ln
                    and ", 0 bytes spill loads" in ln)):
                name = lines[i - 1].split("for ")[-1].strip() if i else ""
                at = name.find("_kernel")
                name = name[max(0, name.rfind("_", 0, max(at - 12, 0))):][:80]
                spills.append(f"{name}: {ln.strip()}")
    line("build", seconds=round(secs, 3), kernels=names,
         ptxas_lines=len(ptxas), instances_with_spills=spills)
    return {"seconds": secs, "ptxas": ptxas, "spills": spills}


# -- phase 3: paged attention against its plain version ---------------------

def _paged_case(gen, ctx_end, t, window, int8, dtype, h=16, h_kv=16, d=128,
                ps=16):
    """Random pages scattered over a shuffled pool; slot b's queries sit at
    positions ctx_end[b]-t .. ctx_end[b]-1."""
    from kubetpu_torch.jobs.quant import quantize_kv_chunk

    dev = "cuda"
    b = len(ctx_end)
    pages = [(c + ps - 1) // ps for c in ctx_end]
    max_pages = max(pages)
    n_pool = sum(pages) + 1
    perm = torch.randperm(n_pool, generator=gen, device=dev).cpu().numpy()
    table = np.full((b, max_pages), -1, np.int32)
    used = 0
    for i, n in enumerate(pages):
        table[i, :n] = perm[used:used + n]
        used += n
    pos = np.array([c - t for c in ctx_end], np.int32)

    def randn(*shape, dt=dtype):
        return torch.randn(shape, generator=gen, device=dev, dtype=dt)

    q = randn(b, t, h, d)
    if int8:
        kp = quantize_kv_chunk(randn(n_pool, ps, h_kv, d, dt=torch.float32))
        vp = quantize_kv_chunk(randn(n_pool, ps, h_kv, d, dt=torch.float32))
    else:
        kp, vp = randn(n_pool, ps, h_kv, d), randn(n_pool, ps, h_kv, d)
    return (q, kp, vp, torch.from_numpy(table).to(dev),
            torch.from_numpy(pos).to(dev), window)


def _visible(pos, t, window, s_max):
    """(B, T, S) bool: key k visible to query t of slot b."""
    k = torch.arange(s_max, device=pos.device)
    qp = pos.long()[:, None] + torch.arange(t, device=pos.device)
    vis = k[None, None, :] <= qp[:, :, None]
    if window > 0:
        vis &= qp[:, :, None] - k[None, None, :] < window
    return vis


def _bound(case):
    """Least time for the function on this data: every input byte it needs
    (q, the visible keys' K and V rows — and scales for int8 —, table,
    pos) read once and the output written once, against its operations
    (4 * D flops per query head per visible key) at the bf16 peak."""
    q, kp, vp, table, pos, window = case
    b, t, h, d = q.shape
    int8 = isinstance(kp, tuple)
    vals = kp[0] if int8 else kp
    ps, h_kv = vals.shape[1], vals.shape[2]
    vis = _visible(pos, t, window, table.shape[1] * ps)
    keys_any = int(vis.any(dim=1).sum())           # key rows some query needs
    row_bytes = h_kv * d * vals.element_size() + (h_kv * 4 if int8 else 0)
    nbytes = (2 * keys_any * row_bytes + 2 * q.numel() * q.element_size()
              + table.numel() * 4 + pos.numel() * 4)
    flops = 4 * d * h * int(vis.sum())
    t_bytes, t_ops = nbytes / HBM_BYTES_S, flops / BF16_FLOP_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes, flops)


def _library(case):
    """One PyTorch call computing the same function: SDPA over the K/V
    already gathered into contiguous (B, H, S, D) with the visibility
    mask. Timed only; the port never calls it."""
    import torch.nn.functional as F

    from kubetpu_torch.ops.paged_attention import _gather

    q, kp, vp, table, pos, window = case
    b, t, h, d = q.shape
    safe = torch.clamp(table, min=0).long()
    k = _gather(kp, safe).to(q.dtype)
    v = _gather(vp, safe).to(q.dtype)
    g = h // k.shape[-2]           # GQA: expand K/V heads up front
    k = k.reshape(b, -1, k.shape[-2], d).repeat_interleave(g, dim=2)
    v = v.reshape(b, -1, v.shape[-2], d).repeat_interleave(g, dim=2)
    k, v = k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()
    mask = _visible(pos, t, window, k.shape[2])[:, None]
    qh = q.transpose(1, 2).contiguous()
    return lambda: F.scaled_dot_product_attention(qh, k, v, attn_mask=mask)


def _live_spans(case):
    """(spans, live spans, live key rows) of the split route on this case's
    data: a span is live when one of its keys is visible to its slot's
    query (mapped, at or before pos, inside the band)."""
    from kubetpu_torch.ops import paged_attention as pa

    q, kp, vp, table, pos, window = case
    ps = (kp[0] if isinstance(kp, tuple) else kp).shape[1]
    n = pa._n_splits(table, ps)
    vis = _visible(pos, 1, window, table.shape[1] * ps)[:, 0]     # (B, S)
    vis &= torch.repeat_interleave(table >= 0, ps, dim=1)
    vis = torch.nn.functional.pad(vis, (0, n * pa._SPLIT_KEYS - vis.shape[1]))
    live = int(vis.reshape(vis.shape[0], n, -1).any(dim=-1).sum())
    return n, live


def _split_bytes(case):
    """Bytes the split and the combine kernels must move on this data:
    (split: q, the visible K/V rows, table, pos, and the partials it writes
    — acc and (m, l) of the live spans, (m, l) of the empty ones; combine:
    every span's (m, l), the live spans' acc, and the output)."""
    q = case[0]
    b, _, h, d = q.shape
    n, live = _live_spans(case)
    _, _, fn_bytes, flops = _bound(case)
    out_bytes = q.numel() * q.element_size()
    ml_bytes = b * h * n * 8
    acc_bytes = live * h * d * 4     # live (slot, span) pairs, every head
    split_bytes = fn_bytes - out_bytes + acc_bytes + ml_bytes
    combine_bytes = ml_bytes + acc_bytes + out_bytes
    return split_bytes, combine_bytes, flops


def _bytes_bound(nbytes, flops=0):
    t_bytes, t_ops = nbytes / HBM_BYTES_S, flops / BF16_FLOP_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


# the paged instances phase 3 runs (bf16 q, D = 128): mangled-name
# fragments of the split kernel over dense and int8 pages (one row a block:
# the flagship is MHA) and of the wgmma chunk kernel
_PAGED_INSTANCES = {
    "split": "paged_split_kernelI13__nv_bfloat16S1_Lb0ELi1ELi1EE",
    "int8": "paged_split_kernelI13__nv_bfloat16aLb1ELi1ELi1EE",
    "wgmma": "paged_chunk_wgmma_kernelI13__nv_bfloat16Li128E",
}
_PAGED_COUNTERS = ("launches", "split_launches", "combine_launches",
                   "wgmma_launches")
# kernel names in profiler keys: every instance of the paged kernels
_PAGED_KERNELS = ("paged_attn_kernel", "paged_split_kernel",
                  "paged_combine_kernel", "paged_chunk_wgmma_kernel")


def _paged_builds(cases) -> dict:
    """Registers, spills and shared memory of the paged instances at the
    cases' shapes; a spill in the bf16 D=128 wgmma chunk instance fails."""
    from kubetpu_torch.ops import paged_attention as pa

    builds = {}
    for name, (q, kp, _, table, _, window) in cases:
        key = ("int8" if isinstance(kp, tuple)
               else pa._route(q, kp, q.shape[1], window))
        vals = kp[0] if isinstance(kp, tuple) else kp
        build = _ptxas(_PAGED_INSTANCES[key], "paged_attention")
        build["dynamic_smem"] = pa._lib().kubetpu_paged_smem_bytes(
            1 if key == "wgmma" else 2, vals.shape[3], vals.element_size(),
            vals.shape[1], table.shape[1], pa._SPLIT_KEYS,
            q.shape[2] // vals.shape[2])
        builds[name] = build
        if key == "wgmma" and (build["spill_stores"] or build["spill_loads"]):
            raise SystemExit(f"paged {name}: the bf16 wgmma chunk instance "
                             f"spills: {build}")
    return builds


def phase_kernels() -> list:
    """The paged kernels at the flagship serving shapes: the decode cases
    on the split route (the split kernel and the combine kernel each
    against its plain version, and the call against the plain attention),
    the chunk case on the wgmma route."""
    from kubetpu_torch.ops import paged_attention as pa

    gen = torch.Generator(device="cuda").manual_seed(1234)
    ragged = [2048, 1717, 1403, 1111, 877, 530, 301, 96]
    cases = [
        ("decode_bf16", _paged_case(gen, ragged, 1, 0, False, torch.bfloat16)),
        ("decode_int8", _paged_case(gen, ragged, 1, 0, True, torch.bfloat16)),
        ("decode_window256",
         _paged_case(gen, ragged, 1, 256, False, torch.bfloat16)),
        ("chunk_bf16_T256", _paged_case(gen, [1024], 256, 0, False,
                                        torch.bfloat16)),
    ]
    builds = _paged_builds(cases)
    rows = []
    for name, case in cases:
        q, kp, vp, table, pos, window = case
        b, t, h, d = q.shape
        h_kv = (kp[0] if isinstance(kp, tuple) else kp).shape[2]
        route = pa._route(q, kp, t, window)
        expected = "split" if t == 1 else "wgmma"
        if route != expected:
            raise SystemExit(f"paged_attention {name}: route {route}, not "
                             f"{expected}")
        counts = (pa.paged_attention.split_launches,
                  pa.paged_attention.wgmma_launches)
        if t == 1:
            run = lambda: pa.paged_attention(q[:, 0], kp, vp, table, pos,
                                             window=window)
            out = run()[:, None]
        else:
            run = lambda: pa.paged_attention_chunk(q, kp, vp, table, pos)
            out = run()
        torch.cuda.synchronize()
        moved = (pa.paged_attention.split_launches - counts[0],
                 pa.paged_attention.wgmma_launches - counts[1])
        if moved != ((1, 0) if t == 1 else (0, 1)):
            raise SystemExit(f"paged_attention {name}: the {route} route did "
                             f"not run ({moved})")
        ref = pa.paged_attention_reference(q, kp, vp, table, pos, window)
        err = float((out.float() - ref.float()).abs().max())
        ok = bool(torch.isfinite(out).all()) and err <= BF16_TOL
        ms = graph_ms(run)
        eager_ms = cuda_ms(run)
        plain_ms = cuda_ms(lambda: pa.paged_attention_reference(
            q, kp, vp, table, pos, window), iters=5, warmup=1)
        library_ms = cuda_ms(_library(case))
        bound_ms, bound_by, nbytes, flops = _bound(case)
        row = dict(case=name, route=route,
                   build=builds[name],
                   max_abs_err=err, tol=BF16_TOL,
                   ok=ok, ms=ms, eager_ms=eager_ms, plain_ms=plain_ms,
                   bound_ms=bound_ms,
                   bound_by=bound_by, library_ms=library_ms, bytes=nbytes,
                   flops=flops,
                   shape=dict(B=b, T=t, H=h, H_kv=h_kv, D=d, window=window,
                              int8=isinstance(kp, tuple)))
        if t == 1:
            row.update(_split_parts(case))
            row["ok"] = ok and row.pop("ok_parts")
        else:
            n = pa._chunk_splits(q, h_kv)
            row.update(grid=[-(-t * (h // h_kv) // 64), h_kv, b * n],
                       key_splits=n)
        line("kernel", **row)
        rows.append(row)
        if not row["ok"]:
            raise SystemExit(f"paged_attention {name}: disagrees with its "
                             f"plain version: {row}")
    return rows


def _split_parts(case) -> dict:
    """The split route's two kernels on *case*, each against its plain
    version on the same inputs and timed alone: the split kernel's
    partials against ``_split_partials`` (m and l of every span, acc of the
    live ones: f32 from the same values, within F32_TOL), the combine
    kernel's output against ``_merge_partials`` of the same partials
    (within BF16_TOL: one rounding to bf16)."""
    from kubetpu_torch.ops import paged_attention as pa

    q, kp, vp, table, pos, window = case
    b, _, h, d = q.shape
    h_kv = (kp[0] if isinstance(kp, tuple) else kp).shape[2]
    n, live = _live_spans(case)
    part, ml = pa._launch_split(q, kp, vp, table, pos, window)
    out = pa._launch_combine(part, ml, torch.empty_like(q))
    torch.cuda.synchronize()
    ref_part, ref_ml = (x[:, 0] for x in pa._split_partials(
        q, kp, vp, table, pos, window, pa._SPLIT_KEYS))
    used = ref_ml[..., 1] > 0
    if not torch.equal(ml[..., 1] > 0, used):
        raise SystemExit("paged split: live spans differ from the plain "
                         "version's")
    split_err, split_ok = _err_ok(
        torch.cat([ml[used], part[used]], dim=-1),
        torch.cat([ref_ml[used], ref_part[used]], dim=-1), F32_TOL)
    empty_ok = bool((ml[~used][:, 0] == -1e30).all()
                    and (ml[~used][:, 1] == 0).all())
    comb_err, comb_ok = _err_ok(out[:, 0],
                                pa._merge_partials(part, ml), BF16_TOL)
    split_ms = graph_ms(lambda: pa._launch_split(q, kp, vp, table, pos,
                                                 window))
    combine_ms = graph_ms(lambda: pa._launch_combine(part, ml, out))
    split_plain_ms = cuda_ms(lambda: pa._split_partials(
        q, kp, vp, table, pos, window, pa._SPLIT_KEYS), iters=5, warmup=1)
    combine_plain_ms = cuda_ms(lambda: pa._merge_partials(part, ml), iters=5,
                               warmup=1)
    split_bytes, combine_bytes, flops = _split_bytes(case)
    s_bound, s_by = _bytes_bound(split_bytes, flops)
    c_bound, c_by = _bytes_bound(combine_bytes)
    return dict(grid=[n, h_kv * -(-(h // h_kv) // 16), b], splits=n,
                live_splits=live, ok_parts=split_ok and empty_ok and comb_ok,
                split=dict(max_err=split_err, tol=F32_TOL, ms=split_ms,
                           plain_ms=split_plain_ms, bound_ms=s_bound,
                           bound_by=s_by, bytes=split_bytes),
                combine=dict(max_abs_err=comb_err, tol=BF16_TOL,
                             ms=combine_ms, plain_ms=combine_plain_ms,
                             bound_ms=c_bound, bound_by=c_by,
                             bytes=combine_bytes))


# -- phase 4: the flash kernels against their plain versions -----------------

FLASH_SHAPE = dict(B=4, S=2048, H=16, D=128)


def _visible_pairs(s: int, causal: bool, window: int) -> int:
    """(query, key) pairs one head computes: the causal half, the band, or
    every pair."""
    if not causal:
        return s * s
    if window <= 0:
        return s * (s + 1) // 2
    return sum(min(r + 1, window) for r in range(s))


def _flash_bound(kind: str, causal: bool, window: int, itemsize: int):
    """Least time for one call at FLASH_SHAPE: its operations (2 flops per
    multiply-add, D per visible pair for each product recomputed: 2 in the
    forward, 3 in dQ, 4 in dK/dV) against its bytes (every (B, S, H, D)
    input read once and output written once, and the f32 lse / delta rows)."""
    b, s, h, d = (FLASH_SHAPE[x] for x in "BSHD")
    products = {"forward": 2, "dq": 3, "dkv": 4}[kind]
    flops = 2 * d * products * b * h * _visible_pairs(s, causal, window)
    # forward: q k v out, lse; dQ: q k v dO dq, lse delta; dK/dV: q k v dO
    # dk dv, lse delta
    tensors = {"forward": 4, "dq": 5, "dkv": 6}[kind]
    rows = {"forward": 1, "dq": 2, "dkv": 2}[kind]
    nbytes = tensors * b * s * h * d * itemsize + rows * b * h * s * 4
    t_bytes, t_ops = nbytes / HBM_BYTES_S, flops / BF16_FLOP_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes, flops)


def _ptxas(fragment: str, lib: str = "flash_attention") -> dict:
    """Registers, spill bytes and static shared memory that ``ptxas -v``
    reported for the one kernel instance of library *lib* whose mangled
    name holds *fragment*."""
    import re

    from kubetpu_torch.ops import _build

    lines = _build.BUILD_LOGS.get(lib, "").splitlines()
    for i, ln in enumerate(lines):
        if "Function properties for" in ln and fragment in ln:
            text = " ".join(lines[i + 1:i + 3])
            nums = {key: re.search(rf"(\d+) {pat}", text)
                    for key, pat in (("spill_stores", "bytes spill stores"),
                                     ("spill_loads", "bytes spill loads"),
                                     ("registers", "registers"),
                                     ("static_smem", "bytes smem"))}
            return {k: int(m.group(1)) if m else 0 for k, m in nums.items()}
    raise SystemExit(f"ptxas: no report for {fragment}")


# the instances phase 4 runs at FLASH_SHAPE, bf16 at D = 128: (route,
# mangled-name fragment, kernel code of kubetpu_flash_smem_bytes)
_INSTANCES = {
    "forward": ("wgmma", "flash_fwd_wgmma_kernelI13__nv_bfloat16Li128E", 0),
    "dq": ("wgmma", "flash_bwd_dq_wgmma_kernelI13__nv_bfloat16Li128E", 1),
    "dkv": ("wgmma", "flash_bwd_dkv_wgmma_kernelI13__nv_bfloat16Li128E", 2),
}


def _err_ok(x, ref, tol):
    """(max |x - ref|, every element within tol + tol * |ref|)."""
    diff = (x.float() - ref.float()).abs()
    return (float(diff.max()),
            bool(torch.isfinite(x).all()
                 and (diff <= tol + tol * ref.float().abs()).all()))


def phase_flash() -> list:
    import torch.nn.functional as F

    from kubetpu_torch.ops import flash_attention as fa

    b, s, h, d = (FLASH_SHAPE[x] for x in "BSHD")
    gen = torch.Generator(device="cuda").manual_seed(4321)
    q, k, v, g = (torch.randn((b, s, h, d), generator=gen, device="cuda",
                              dtype=torch.bfloat16) for _ in range(4))
    # SDPA's (B, H, S, D) layout, timed only; the port never calls it
    qt, kt, vt, gt = (x.transpose(1, 2).contiguous() for x in (q, k, v, g))
    rows = []
    if fa._route(q.dtype, d) != "wgmma":
        raise SystemExit("flash: the flagship shape must take the wgmma "
                         "route")
    builds = {}
    for kind, (route, fragment, code) in _INSTANCES.items():
        build = _ptxas(fragment)
        build["dynamic_smem"] = fa._lib().kubetpu_flash_smem_bytes(
            code, d, fa._ROUTE_CODE[route])
        builds[kind] = build
        if route == "wgmma" and (build["spill_stores"]
                                 or build["spill_loads"]):
            raise SystemExit(f"flash {kind}: the bf16 D={d} wgmma instance "
                             f"spills: {build}")
    for case, causal, window in (("causal", True, 0),
                                 ("window256", True, 256),
                                 ("noncausal", False, 0)):
        before = (fa.flash_forward.wgmma_launches,
                  fa.flash_backward.dq_wgmma_launches,
                  fa.flash_backward.dkv_wgmma_launches)
        out, lse = fa.flash_forward(q, k, v, causal, window)
        delta = fa._delta(out, g)
        dq = fa._launch_dq(q, k, v, g, lse, delta, causal, window)
        dk, dv = fa._launch_dkv(q, k, v, g, lse, delta, causal, window)
        torch.cuda.synchronize()
        if (fa.flash_forward.wgmma_launches - before[0],
                fa.flash_backward.dq_wgmma_launches - before[1],
                fa.flash_backward.dkv_wgmma_launches - before[2]) != (1, 1, 1):
            raise SystemExit(f"flash {case}: the wgmma route did not run")
        ref_out, ref_lse = fa.flash_forward_reference(q, k, v, causal, window)
        refs = fa.flash_backward_reference(q, k, v, out, lse, g, causal,
                                           window)
        errs = {"forward": [_err_ok(out, ref_out, BF16_TOL),
                            _err_ok(lse, ref_lse, F32_TOL)],
                "dq": [_err_ok(dq, refs[0], BF16_TOL)],
                "dkv": [_err_ok(dk, refs[1], BF16_TOL),
                        _err_ok(dv, refs[2], BF16_TOL)]}
        del ref_out, ref_lse, refs

        mask = None
        if window > 0:
            pos = torch.arange(s, device="cuda")
            mask = ((pos[:, None] >= pos[None, :])
                    & (pos[:, None] - pos[None, :] < window))

        def sdpa(x, y, z):
            if mask is not None:
                return F.scaled_dot_product_attention(x, y, z, attn_mask=mask)
            return F.scaled_dot_product_attention(x, y, z, is_causal=causal)

        lib_fwd = cuda_ms(lambda: sdpa(qt, kt, vt))
        leaves = [x.detach().requires_grad_(True) for x in (qt, kt, vt)]
        lib_out = sdpa(*leaves)
        lib_bwd = cuda_ms(lambda: torch.autograd.grad(
            lib_out, leaves, gt, retain_graph=True))
        del lib_out, leaves
        plain_fwd = cuda_ms(lambda: fa.flash_forward_reference(
            q, k, v, causal, window), iters=3, warmup=1)
        plain_bwd = cuda_ms(lambda: fa.flash_backward_reference(
            q, k, v, out, lse, g, causal, window), iters=3, warmup=1)
        timed = {
            "forward": (lambda: fa.flash_forward(q, k, v, causal, window),
                        plain_fwd, lib_fwd),
            "dq": (lambda: fa._launch_dq(q, k, v, g, lse, delta, causal,
                                         window), plain_bwd, lib_bwd),
            "dkv": (lambda: fa._launch_dkv(q, k, v, g, lse, delta, causal,
                                           window), plain_bwd, lib_bwd),
        }
        for kind, (run, plain_ms, library_ms) in timed.items():
            bound_ms, bound_by, nbytes, flops = _flash_bound(
                kind, causal, window, q.element_size())
            ms = cuda_ms(run, iters=10, warmup=2)
            row = dict(kernel=kind, case=case, route=_INSTANCES[kind][0],
                       build=builds[kind],
                       max_abs_err=max(e for e, _ in errs[kind]),
                       tol=BF16_TOL, ok=all(o for _, o in errs[kind]),
                       ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                       bound_by=bound_by, library_ms=library_ms,
                       bytes=nbytes, flops=flops,
                       tflop_s=flops / ms / 1e9,
                       shape=dict(FLASH_SHAPE, causal=causal, window=window,
                                  dtype="bf16"))
            line("flash", **row)
            rows.append(row)
        torch.cuda.empty_cache()
    bad = [(r["kernel"], r["case"], r["max_abs_err"]) for r in rows
           if not r["ok"]]
    if bad:
        raise SystemExit(f"flash kernels disagree with their plain versions: "
                         f"{bad}")
    return rows


# -- phase 5: CPU plain version vs the card's kernel, same small model ------

def phase_parity() -> dict:
    from kubetpu_torch.jobs import model as model_lib
    from kubetpu_torch.jobs.decode import forward_chunk_io
    from kubetpu_torch.jobs.paged import (PagedDecodeServer,
                                          _paged_prefill_io, init_page_pool)
    from kubetpu_torch.ops.paged_attention import paged_attention_chunk

    cfg = model_lib.ModelConfig(vocab=512, d_model=256, n_layers=2,
                                n_heads=4, n_kv_heads=2, d_ff=512,
                                max_seq=256)
    cpu_model = model_lib.init_params(torch.Generator().manual_seed(7), cfg,
                                      device="cpu")
    models = {"cpu": cpu_model, "cuda": copy.deepcopy(cpu_model).to("cuda")}
    rng = np.random.default_rng(7)
    prompt = rng.integers(0, cfg.vocab, 64)

    logits = {}
    for dev, model in models.items():
        pools = init_page_pool(cfg, 8, 16, device=dev)
        row = torch.tensor([3, 1, 6, 0], dtype=torch.int32, device=dev)
        io = _paged_prefill_io(torch.tensor([3, 1, 6, 0]), row, 16, 0,
                               attend_chunk=paged_attention_chunk)
        tokens = torch.from_numpy(prompt[None]).to(dev)
        logits[dev] = forward_chunk_io(cfg, model, tokens, pools, 0,
                                       io)[0].cpu()
    logit_err = float((logits["cpu"] - logits["cuda"]).abs().max())
    if logit_err > F32_TOL:
        raise SystemExit(f"parity: prefill logits differ by {logit_err}")

    prompts = [rng.integers(0, cfg.vocab, n).tolist() for n in (5, 40, 23,
                                                                 70)]
    mismatches = []
    out = {}
    for kv_int8 in (False, True):
        tokens = {}
        for dev, model in models.items():
            server = PagedDecodeServer(cfg, model, n_slots=3, max_seq=256,
                                       max_new_tokens=16, page_size=16,
                                       prefill_budget=32, kv_int8=kv_int8,
                                       device=dev)
            rids = [server.enqueue(prompts[0])]
            server.step()
            rids += [server.enqueue(p) for p in prompts[1:]]
            server.drain()
            server.check_invariants()
            tokens[dev] = [server.result(r) for r in rids]
        for a, b in zip(tokens["cpu"], tokens["cuda"]):
            if a == b:
                continue
            i = next(j for j, (x, y) in enumerate(zip(a, b)) if x != y)
            top2 = torch.topk(model_lib.forward(
                cpu_model, torch.tensor([a[:i]]), cfg)[0, -1], 2).values
            gap = float(top2[0] - top2[1])
            mismatches.append({"kv_int8": kv_int8, "step": i, "gap": gap})
        out["kv_int8" if kv_int8 else "f32"] = tokens["cuda"]
    line("parity", prefill_logit_max_err=logit_err, tol=F32_TOL,
         requests=2 * len(prompts), token_mismatches=mismatches)
    # a differing greedy token is a fault unless the two top logits tie
    # within the logits tolerance there
    bad = [m for m in mismatches if m["gap"] > F32_TOL]
    if bad:
        raise SystemExit(f"parity: greedy tokens differ at {bad}")
    return {"prefill_logit_max_err": logit_err, "mismatches": mismatches}


# -- phase 6: the flagship behind the paged server ---------------------------

def phase_serve(smi: str) -> dict:
    from kubetpu_torch.jobs import model as model_lib
    from kubetpu_torch.jobs.paged import PagedDecodeServer
    from kubetpu_torch.ops import paged_attention as pa

    cfg = model_lib.ModelConfig(vocab=32000, d_model=2048, n_layers=12,
                                n_heads=16, d_ff=5632, max_seq=2048,
                                dtype=torch.bfloat16)
    model = model_lib.init_params(
        torch.Generator(device="cuda").manual_seed(0), cfg, device="cuda")
    server = PagedDecodeServer(cfg, model, n_slots=8, max_seq=2048,
                               max_new_tokens=32, page_size=16,
                               prefill_budget=256, device="cuda")
    counts = {"steps": 0, "chunks": 0}
    step_leg, chunk_leg = server._device_step, server._prefill_chunk_device

    def counted_step():
        counts["steps"] += 1
        return step_leg()

    def counted_chunk(*args):
        res = chunk_leg(*args)
        counts["chunks"] += res is not None
        return res

    server._device_step = counted_step
    server._prefill_chunk_device = counted_chunk

    rng = np.random.default_rng(0)
    # warm-up request (cuBLAS handles, allocator), outside the counted run
    server.enqueue(rng.integers(0, cfg.vocab, 40).tolist())
    server.drain()

    lengths = [128, 1024, 256, 896, 384, 768, 512, 640]
    prompts = [rng.integers(0, cfg.vocab, n).tolist() for n in lengths]
    counts.update(steps=0, chunks=0)
    for c in _PAGED_COUNTERS:                  # zero just before the path
        setattr(pa.paged_attention, c, 0)
    torch.cuda.synchronize()
    arrive, first, rids = {}, {}, []
    decode_s, decode_tokens, decode_steps, steps = 0.0, 0, 0, 0
    t_start = time.perf_counter()
    pending = list(prompts)
    while pending or not server._idle():
        if pending and (steps % 4 == 0):          # staggered admission
            for p in pending[:2]:
                rid = server.enqueue(p)
                rids.append(rid)
                arrive[rid] = time.perf_counter()
            pending = pending[2:]
        chunks_before = counts["chunks"]
        t0 = time.perf_counter()
        out = server.step()                        # routing syncs the device
        dt = time.perf_counter() - t0
        now = time.perf_counter()
        for rid in out:
            first.setdefault(rid, now)
        if counts["chunks"] == chunks_before and out:
            decode_s += dt
            decode_tokens += sum(len(v) for v in out.values())
            decode_steps += 1
        steps += 1
        if steps > 10_000:
            raise SystemExit("serve: did not converge")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_start
    launches = {c: getattr(pa.paged_attention, c)   # read just after
                for c in _PAGED_COUNTERS}
    results = [server.result(r) for r in rids]
    ok_tokens = all(
        server.finished(r) and len(res) == n + 32
        and all(0 <= x < cfg.vocab for x in res[n:])
        for r, res, n in zip(rids, results, lengths))
    if not ok_tokens:
        raise SystemExit("serve: a request did not finish with 32 tokens")
    # one attention call per layer and step or chunk: decode steps on the
    # split route (split + combine), prefill chunks on the wgmma route (a
    # combine after each chunk that took a key split)
    n_dec, n_chunk = (cfg.n_layers * counts[k] for k in ("steps", "chunks"))
    expected = dict(launches=n_dec + n_chunk, split_launches=n_dec,
                    wgmma_launches=n_chunk)
    if (n_dec <= 0 or n_chunk <= 0
            or {k: launches[k] for k in expected} != expected
            or not n_dec <= launches["combine_launches"] <= n_dec + n_chunk):
        raise SystemExit(f"serve: paged launches {launches}, expected "
                         f"{expected} and {n_dec}..{n_dec + n_chunk} combine")
    server.check_invariants()

    # the served first token against a dense forward of the same prompt:
    # its dense logit must sit within bf16 noise of the dense maximum
    i = lengths.index(1024)
    with torch.no_grad():
        dense = model_lib.forward(
            model, torch.tensor([prompts[i]], device="cuda"), cfg)[0, -1]
    served = results[i][lengths[i]]
    first_gap = float(dense.float().max() - dense.float()[served])
    finite = bool(torch.isfinite(dense.float()).all())
    if not finite or first_gap > 0.25:
        raise SystemExit(f"serve: first token {served} is {first_gap} below "
                         f"the dense forward's best logit")
    ttft = sorted((first[r] - arrive[r]) * 1e3 for r in rids)
    row = dict(card=torch.cuda.get_device_name(0), nvidia_smi=smi,
               requests=len(rids), prompt_tokens=sum(lengths),
               new_tokens=32 * len(rids), steps=counts["steps"],
               prefill_chunks=counts["chunks"], paged_launches=launches,
               decode_toks_s=decode_tokens / decode_s if decode_s else None,
               decode_steps=decode_steps,
               ttft_ms_p50=ttft[len(ttft) // 2], ttft_ms_max=ttft[-1],
               wall_s=wall, first_token_dense_gap=first_gap,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    line("serve", **row)
    return row, server


def _profiled(run):
    """(wall us, {kernel name: device self time us}) of run() under
    torch.profiler. Only device-side events are summed (CPU ops would count
    twice); on one stream kernels never overlap, so their sum is the device
    busy time and 1 - busy / wall the idle share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = {}
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0.0))
        kernels[ev.key] = kernels.get(ev.key, 0.0) + us
    return wall_us, kernels


def phase_profile(server) -> dict:
    """Where a decode step's time goes: torch.profiler over 10 steps of 8
    active slots (256-token prompts), after the counted run."""
    rng = np.random.default_rng(1)
    vocab = server.cfg.vocab
    for _ in range(server.n_slots):
        server.enqueue(rng.integers(0, vocab, 256).tolist())
    while server._queue or server._prefills:
        server.step()
    for _ in range(3):
        server.step()
    active = int(server.active.sum())

    def ten_steps():
        for _ in range(10):
            server.step()

    wall_us, kernels = _profiled(ten_steps)
    busy = sum(kernels.values())
    attn = sum(v for k, v in kernels.items()
               if any(n in k for n in _PAGED_KERNELS))
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    row = dict(active_slots=active, steps=10, step_ms=wall_us / 10 / 1e3,
               device_busy_ms_per_step=busy / 10 / 1e3,
               idle_share=(1.0 - busy / wall_us) if busy else None,
               paged_attention_share_of_busy=(attn / busy) if busy else None,
               kernel_kinds=len(kernels),
               top_kernels_ms_per_step=[(k[:60], v / 10 / 1e3)
                                        for k, v in top])
    line("profile", **row)
    server.drain()
    return row


# -- phase 8: the training step, CPU plain versions vs the card's kernels ----

TRAIN_TOL = 1e-4     # f32 on both sides: summation order only


def _small_cfg(**over):
    from kubetpu_torch.jobs import model as model_lib

    return model_lib.ModelConfig(vocab=512, d_model=256, n_layers=2,
                                 n_heads=4, n_kv_heads=2, d_ff=512,
                                 max_seq=256, **over)


def phase_train_parity() -> dict:
    """Three steps of ``make_train_step(attention="flash")`` on the CPU and
    on the card, from the same weights and ``SyntheticCorpus`` batches:
    first-step gradients within TRAIN_TOL of the largest gradient of each
    leaf, per-step losses within TRAIN_TOL relative."""
    from kubetpu_torch.jobs import model as model_lib
    from kubetpu_torch.jobs import train as train_lib
    from kubetpu_torch.jobs.data import SyntheticCorpus

    cfg = _small_cfg()
    cpu_state, _ = train_lib.init_state(torch.Generator().manual_seed(11),
                                        cfg, device="cpu")
    it = SyntheticCorpus(cfg.vocab, seed=1).batches(2, 200, seed=2)
    batches = [next(it) for _ in range(3)]   # S = 200: a ragged last tile
    models = {"cpu": cpu_state.params,
              "cuda": copy.deepcopy(cpu_state.params).to("cuda")}
    attn = train_lib._resolve_attention("flash", cfg.window)
    grads, losses = {}, {}
    for dev, model in models.items():
        tokens, targets = (torch.from_numpy(x).long().to(dev)
                           for x in batches[0])
        loss = model_lib.next_token_loss(model, tokens, targets, cfg, attn)
        grads[dev] = [x.cpu() for x in torch.autograd.grad(
            loss, list(model.parameters()))]
        opt = train_lib.make_optimizer()
        state = train_lib.state_from_params(model, opt)
        step = train_lib.make_train_step(cfg, opt, device=dev)
        losses[dev] = []
        for tokens, targets in batches:
            state, loss = step(state, tokens, targets)
            losses[dev].append(float(loss))
    grad_err = max(float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))
                   for a, b in zip(grads["cuda"], grads["cpu"]))
    loss_err = max(abs(a - b) / abs(b)
                   for a, b in zip(losses["cuda"], losses["cpu"]))
    row = dict(cfg="vocab 512, d 256, 2 layers, 4 heads / 2 kv, f32",
               batch=2, seq=200, steps=3, losses_cpu=losses["cpu"],
               losses_cuda=losses["cuda"], loss_rel_err=loss_err,
               grad_rel_err=grad_err, tol=TRAIN_TOL)
    line("train_parity", **row)
    if not grad_err <= TRAIN_TOL or not loss_err <= TRAIN_TOL:
        raise SystemExit(f"train parity: gradients {grad_err}, losses "
                         f"{loss_err} above {TRAIN_TOL}")
    return row


# -- phase 9: the flagship's training step -----------------------------------

def _flagship_train_cfg():
    from kubetpu_torch.jobs import model as model_lib

    # bench_model.py's flagship; max_seq 2048 (4096 there) is the only cut
    return model_lib.ModelConfig(vocab=32000, d_model=2048, n_layers=12,
                                 n_heads=16, d_ff=5632, max_seq=2048,
                                 dtype=torch.bfloat16, remat=True,
                                 remat_policy="full")


def _flash_counts():
    from kubetpu_torch.ops import flash_attention as fa

    return (fa.flash_forward.launches, fa.flash_backward.dq_launches,
            fa.flash_backward.dkv_launches, fa.flash_forward.wgmma_launches,
            fa.flash_backward.dq_wgmma_launches,
            fa.flash_backward.dkv_wgmma_launches)


def _zero_flash_counts():
    from kubetpu_torch.ops import flash_attention as fa

    fa.flash_forward.launches = 0
    fa.flash_backward.dq_launches = 0
    fa.flash_backward.dkv_launches = 0
    fa.flash_forward.wgmma_launches = 0
    fa.flash_backward.dq_wgmma_launches = 0
    fa.flash_backward.dkv_wgmma_launches = 0


def phase_train(smi: str):
    from kubetpu_torch.jobs import train as train_lib
    from kubetpu_torch.jobs.data import SyntheticCorpus

    cfg = _flagship_train_cfg()
    batch, seq, timed = 4, 2048, 5
    state, opt = train_lib.init_state(
        torch.Generator(device="cuda").manual_seed(0), cfg, device="cuda")
    n_params = sum(p.numel() for p in state.params.parameters())
    step = train_lib.make_train_step(cfg, opt, attention="flash",
                                     device="cuda")
    it = SyntheticCorpus(cfg.vocab, seed=0).batches(batch, seq, seed=1)
    batches = [next(it) for _ in range(timed + 1)]
    state, loss = step(state, *batches[0])           # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_flash_counts()                             # zero just before
    t0 = time.perf_counter()
    losses = []
    for b in batches[1:]:
        state, loss = step(state, *b)
        losses.append(loss)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _flash_counts()                         # read just after
    losses = [float(x) for x in losses]
    # forward x2 under full remat, dQ, dK/dV per layer; all three through
    # the wgmma instances
    expected = (2 * cfg.n_layers * timed, cfg.n_layers * timed,
                cfg.n_layers * timed, 2 * cfg.n_layers * timed,
                cfg.n_layers * timed, cfg.n_layers * timed)
    if counts != expected:
        raise SystemExit(f"train: flash launches (forward, dq, dkv, "
                         f"forward wgmma, dq wgmma, dkv wgmma) {counts} != "
                         f"{expected}")
    if not all(np.isfinite(losses)):
        raise SystemExit(f"train: non-finite losses {losses}")
    step_s = wall / timed
    tokens_s = batch * seq / step_s
    flops_per_token = 6 * n_params + 12 * cfg.n_layers * cfg.d_model * seq
    peak_mem = torch.cuda.max_memory_allocated() / 1e9

    repeat = batches[1]                              # one batch, ten steps
    fit = []
    for _ in range(10):
        state, loss = step(state, *repeat)
        fit.append(float(loss))
    if not fit[-1] < fit[0]:
        raise SystemExit(f"train: loss on a repeated batch did not fall: "
                         f"{fit}")
    row = dict(card=torch.cuda.get_device_name(0), nvidia_smi=smi,
               params=n_params, batch=batch, seq=seq, remat="full",
               attention="flash", step_ms=step_s * 1e3, tokens_s=tokens_s,
               mfu=tokens_s * flops_per_token / BF16_FLOP_S,
               flops_per_token=flops_per_token, peak_mem_gb=peak_mem,
               losses=losses, repeated_batch_losses=fit,
               flash_launches=dict(forward=counts[0], dq=counts[1],
                                   dkv=counts[2], forward_wgmma=counts[3],
                                   dq_wgmma=counts[4], dkv_wgmma=counts[5],
                                   steps=timed))
    line("train", **row)
    return row, state, step, repeat


def phase_train_profile(state, step, batch) -> dict:
    """Where a training step's time goes: torch.profiler over one step."""
    wall_us, kernels = _profiled(lambda: step(state, *batch))
    busy = sum(kernels.values())
    # both routes: flash_fwd_kernel and flash_fwd_wgmma_kernel, ...
    by = {kind: sum(v for k, v in kernels.items() if name in k)
          for kind, name in (("forward", "flash_fwd_"),
                             ("dq", "flash_bwd_dq_"),
                             ("dkv", "flash_bwd_dkv_"))}
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:10]
    row = dict(step_ms=wall_us / 1e3, device_busy_ms=busy / 1e3,
               idle_share=(1.0 - busy / wall_us) if busy else None,
               attention_share_of_busy=(sum(by.values()) / busy)
               if busy else None,
               flash_ms={k: v / 1e3 for k, v in by.items()},
               kernel_kinds=len(kernels),
               top_kernels_ms=[(k[:60], v / 1e3) for k, v in top])
    line("train_profile", **row)
    return row


def main(argv) -> int:
    record_path = None
    if argv[:1] == ["--record"] and len(argv) == 2:
        record_path = argv[1]
    elif argv:
        print("usage: python3 chip_smoke.py [--record PATH]", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs the port on the "
              "card only", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = phase_device()
    build = phase_build()
    kern = phase_kernels()
    flash = phase_flash()
    parity = phase_parity()
    serve, server = phase_serve(dev["nvidia_smi"])
    prof = phase_profile(server)
    del server
    torch.cuda.empty_cache()
    train_parity = phase_train_parity()
    train, state, step, repeat = phase_train(dev["nvidia_smi"])
    train_prof = phase_train_profile(state, step, repeat)

    # the paged kernels at the main path's cases: the split and combine
    # kernels at decode_bf16 (max_abs_err over every decode case), the
    # chunk kernel at chunk_bf16_T256
    decode = next(r for r in kern if r["case"] == "decode_bf16")
    chunk = next(r for r in kern if r["case"] == "chunk_bf16_T256")
    decodes = [r for r in kern if r["route"] == "split"]
    paged = dict(route="cuda", source="kubetpu_torch/ops/csrc/paged_attention.cu",
                 replaces="kubetpu/ops/paged_attention.py:65")
    launches = serve["paged_launches"]
    kernels = [
        dict(paged, name="paged_attention_split", instances="split",
             launches=launches["split_launches"],
             max_abs_err=max(r["split"]["max_err"] for r in decodes),
             ms=decode["split"]["ms"], plain_ms=decode["split"]["plain_ms"],
             bound_ms=decode["split"]["bound_ms"],
             bound_by=decode["split"]["bound_by"], library_ms=None,
             call_ms=decode["ms"], call_bound_ms=decode["bound_ms"],
             call_library_ms=decode["library_ms"],
             call_max_abs_err=max(r["max_abs_err"] for r in decodes),
             ok=all(r["ok"] for r in decodes)),
        dict(paged, name="paged_attention_combine", instances="split",
             launches=launches["combine_launches"],
             max_abs_err=max(r["combine"]["max_abs_err"] for r in decodes),
             ms=decode["combine"]["ms"],
             plain_ms=decode["combine"]["plain_ms"],
             bound_ms=decode["combine"]["bound_ms"],
             bound_by=decode["combine"]["bound_by"], library_ms=None,
             ok=all(r["ok"] for r in decodes)),
        dict(paged, name="paged_attention_chunk", instances="wgmma",
             launches=launches["wgmma_launches"],
             max_abs_err=chunk["max_abs_err"], ms=chunk["ms"],
             plain_ms=chunk["plain_ms"], bound_ms=chunk["bound_ms"],
             bound_by=chunk["bound_by"], library_ms=chunk["library_ms"],
             ok=chunk["ok"]),
    ]
    # the flash kernels at the main path's case (causal); max_abs_err and ok
    # over all three cases
    for kind, name, replaces, launches in (
            ("forward", "flash_forward", "kubetpu/ops/flash_attention.py:41",
             train["flash_launches"]["forward"]),
            ("dq", "flash_backward_dq", "kubetpu/ops/flash_attention.py:141",
             train["flash_launches"]["dq"]),
            ("dkv", "flash_backward_dkv", "kubetpu/ops/flash_attention.py:195",
             train["flash_launches"]["dkv"])):
        rows = [r for r in flash if r["kernel"] == kind]
        main_row = next(r for r in rows if r["case"] == "causal")
        kernels.append({
            "name": name, "route": "cuda", "instances": main_row["route"],
            "source": "kubetpu_torch/ops/csrc/flash_attention.cu",
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"],
            "bound_by": main_row["bound_by"],
            "library_ms": main_row["library_ms"],
            "ok": all(r["ok"] for r in rows),
        })
    record = {"device": dev, "build": build, "kernel_cases": kern,
              "flash_cases": flash, "parity": parity, "serve": serve,
              "profile": prof, "train_parity": train_parity,
              "train": train, "train_profile": train_prof,
              "kernels": kernels}
    if record_path:
        os.makedirs(os.path.dirname(os.path.abspath(record_path)),
                    exist_ok=True)
        with open(record_path, "w") as f:
            json.dump(record, f, indent=1)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
