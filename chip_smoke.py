"""Drive the PyTorch port (``kubetpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--record PATH] [--phases 29-33|34-35]

Phases, one line each, any failure exits non-zero:

1. device: the card's name, and ``nvidia-smi``'s name and power limit;
2. build: every CUDA kernel of the port, compiled from ``kubetpu_torch/ops/
   csrc`` with ``nvcc`` (all sources at once);
3. kernels: the paged-attention kernels at the flagship serving shapes,
   each case's route, grid and splits — decode (bf16, int8, window 256, and
   window 512 over the windowed server's ring table) on the split route,
   whose split kernel (partials) and combine kernel are each held against
   their plain versions; the T=256 chunk and the storm's 64-token chunk at
   a 1024-token prefix hit on the wgmma route, over bf16 pages and over
   int8 pages (the int8 instance), and the parity phase's f32 chunk on the
   SIMT route; every call against the plain attention,
   with its time (a replayed CUDA graph of 20 calls: device time without
   the host's enqueue; the eager calls' time beside it), the plain
   version's, the least time the card could take (bytes over 3.35 TB/s or
   operations over 989 TFLOP/s, whichever is larger) and one PyTorch
   library call's time as a yardstick; registers, spills and shared memory
   of the instances (a spill in a wgmma chunk instance fails); then the
   speculative verify chunk (``verify_route`` lines: B=8 at the ragged
   contexts, T = 2, 3, 5, 9, bf16 and int8 pages) on its three candidate
   routes — the wgmma chunk kernel, the SIMT chunk kernel, and the split
   route over the B*T queries as one-query rows — each against the plain
   attention and timed, beside the bound, the plain version and SDPA, with
   the route ``_route`` takes and the fastest;
4. flash: the forward, dQ and dK/dV kernels at the flagship training shape
   (B=4, S=2048, H=16, D=128, bf16; causal, causal with window 256, and
   non-causal), at ViT-B/16's (B=128, S=196, H=12, D=64, non-causal) and
   at the flash ring's per-step shape in phase 34 (B=2, S=2048, H=8,
   D=128: the causal diagonal step, the non-causal visiting steps),
   each against its plain version, with the same timings
   (SDPA forward and SDPA backward as the library yardsticks), the route
   that ran (the wgmma or SIMT instances), achieved TFLOP/s, and the
   instance's registers, spill bytes (``nvcc -Xptxas -v``) and shared
   memory; a spill in a bf16 D=128 wgmma instance fails the phase;
5. parity: a small f32 model served by the port on the CPU (plain version)
   and on the card (kernel) — prefill logits within 1e-3, greedy tokens
   equal; then shared-prefix reuse (f32 and int8 pools) and window 8 on the
   ring table: greedy tokens and reuse stats equal exactly, the pool oracle
   after every drain. Its chunks are the SIMT kernel's path: the paged
   counters are zeroed before and read after, and SIMT must have run;
6. serve: the flagship decoder (vocab 32000, d 2048, 12 layers, 16 heads,
   d_ff 5632, bf16, random weights from a seed) behind ``PagedDecodeServer``
   with staggered requests; every launch counter is zeroed just before and
   read just after: 12 split and combine launches per decode step, 12
   wgmma chunk launches (and a combine where a chunk splits its keys) per
   prefill chunk, and nothing on SIMT;
7. profile: ``torch.profiler`` over ten decode steps of eight slots — step
   time, device busy time, idle share, the top kernels;
8. prefix: shared-prefix reuse on the flagship's server (a 1024-token
   system prompt + 64-token tails, one seed then 15 requests; reuse off,
   on, and on over an int8 pool) and the host tier (4 families x 3 rounds
   through a one-family tree with a 1 GiB host tier, against a warm tree of
   all four): one line an arm with the server's TTFT p50/p99, prefill
   tokens computed and saved, hit rate, tier hits / fills / spills / bytes,
   decode tokens/s and the paged launches; after every timed arm, one
   profiled step of four hits on a fresh reuse-on server over a bf16 and
   over an int8 pool, and the kernels the int8 step spends its extra time
   in. Gates: the pool oracle after every drain, 15 x 1024 tokens saved,
   the host arm's tokens equal to the warm tree's, both on arms'
   first-token logits within 0.25 of the cold arm's, the int8 arm's
   chunks all on the int8 wgmma instance (none on SIMT);
9. window: the flagship with window 512 (rings of 33 pages), 8 prompts of
   640-1024 tokens, 256 new tokens each. Gates: pages in use never above
   8 x 33, first-token logits within 0.25 of the dense windowed forward,
   no windowed chunk on a kernel;
12. wire (runs after phase 9; its servers are freed before phase 10): the
   flagship behind the port's own ``ReplicaServer``s, two in this process
   on ``127.0.0.1:0`` sharing the one model, phase 6's server settings and
   prompts (``WIRE_STREAMS`` of them, 4, in the first four arms). Arms:
   routed (4 generates, serially over ``POST /generate``;
   tokens equal a quiet direct serial run on a fresh server); fork over a
   bf16 and an int8 pool (4 streams mid-decode on A, each frozen,
   snapshot, through the codec, restored on B and unfrozen; B's pages
   byte-identical to A's, pos and last equal, then both run to the end
   with equal tokens); drain (4 concurrent generates on A, ``POST /drain
   {"migrate_to": B}`` once all are mid-decode: every generate answers
   409 -> B, B finishes each with all 32 tokens, A's pool ends free; the
   drain's wall time, MB shipped, MB/s and the handoff gap against the
   ITL); prefix (phase 8's storm shape, B's tree warm on the system
   prompt: ``migrate_rid`` remaps >= 64 pages a stream and ships the rest;
   the bytes beside a cold target's); disagg (A ``role="prefill"``, B
   ``role="decode"``: 4 prompts of 1024 tokens, tokens equal the quiet
   run, every handoff committed, the overlap fraction and the TTFTs). In
   the drain and prefix arms a gate parks A's step loop once its streams
   are mid-decode, so the handoff always finds them in flight. The paged
   counters are zeroed before and read after the phase: split and wgmma
   (dense and int8) must have run, SIMT not;
15. dense (after phase 12; its servers are freed before phase 10):
   phase 6's flagship, prompts and settings behind ``DecodeServer`` (bf16
   and int8 caches) and ``PagedDecodeServer``, each with ``overlap`` off
   and on: decode tokens/s, step wall time, one profiled window of ten
   steps each (device busy time, idle share), then the paged pair twice
   more each, alternated (``dense_alternation``). Gates: overlap's
   tokens equal the pipeline-off tokens exactly on every server; the dense
   first-token logits within 0.25 of the paged server's; a counter of
   ``torch.cuda.synchronize``, event waits, ``.item()``, ``.cpu()`` and
   ``.tolist()`` reads 0 inside every dispatched step and 1 in every
   routed step;
16. spec: ``PagedSpeculativeDecodeServer`` with the flagship as target,
   a quarter-size random draft and the target as its own draft, over bf16
   and int8 pools (and the self draft over an f32 pool with the weights in
   f32), gamma_max 4, adaptive gamma, phase 6's prompts with 46 new tokens:
   tokens/s, rounds, mean tokens per round, the gamma histogram, TTFT p50,
   one profiled round (device busy, idle share, draft and verify device
   ms). Gates in ``phase_spec``'s docstring, among them the near-tie rule:
   speculative tokens equal the plain server's, except that a request's
   first divergence may fall where the plain run's top two logits lie
   within 0.25; and exact equality on phase 5's small f32 model;
17. multilora (after phase 16): the flagship with 64 resident rank-8
   adapters on wq/wk/wv/wo (~3.1 MB each in bf16), phase 6's prompts as 8
   tenants, 32 new tokens: the plain ``PagedDecodeServer`` and the packed
   ``PagedMultiLoraDecodeServer`` over bf16 (profiled: device busy, idle
   share, kernels a step, the LoRA gather's and deltas' device ms; then
   both run again twice each, alternated), int8 and with
   ``overlap``; each tenant alone on its merged weights
   (n_slots=1, in turn); ``SpecMultiLoraDecodeServer`` with phase 16's
   quarter draft; hot load and evict on the wire (two port replicas, an
   ``AdapterRegistry`` pushing a 65th adapter). Gates in
   ``phase_multilora``'s docstring: phase 16's near-tie rule against the
   merged servers, exact on phase 5's small f32 model, prefix isolation,
   0 / 1 host syncs a dispatched / routed step, the paged launches;
19. router (after phase 17): the port's ``RouterServer`` in front of port
   ``ReplicaServer``s on the flagship, in this process, phase 6's settings
   with a prefix tree. Arms: affinity (3 families x 3 members, a
   512-token system prompt and 64-token tails, 32 new tokens, serially
   through the router with ``head_quantum`` 16: tokens against a quiet
   direct serial run under phase 16's near-tie rule, each family on one
   replica, its later members hitting the tree; routed and direct TTFT
   p50, the router's overhead: its route latency less the replica's
   request time); random (the same storm, ``policy="random"``: the hit
   rate beside affinity's, peer-fetched hits counted apart); slo (both
   ``/slo`` surfaces return verdicts; a router whose objective no fleet
   meets burns: ``batch`` 503, ``interactive`` routed); scale_down (a
   ``ReplicaAutoscaler`` scales up on a hot policy through a launcher
   that builds a port replica, then down, migrate-then-remove, from a
   replica with 2 streams of 32 new tokens mid-decode: they finish on the
   survivor, near-tie rule against a quiet run, events scale_up <
   scale_down_migrate < drain < scale_down; the scale-down ms); profile
   (one storm replica's profiler, enabled before its warm-up, every 8th
   step: coverage >= 0.9 and each phase's ms and share; with ``overlap``,
   0 / 1 host syncs a dispatched / routed step and each sampled step's
   wait on its own event); tenant (a packed replica of 8 rank-8 adapters
   beside a plain one, a 9th distributed by ``POST /adapters``: a
   generate naming it lands on the packed replica by the tenant-affine
   pick, tokens equal to the in-process run). The paged counters are
   zeroed before and read after: split and wgmma must run, SIMT not;
10. train parity: the small f32 model trained three steps on the CPU (plain
   versions) and on the card (flash kernels) from the same weights and
   batches — first-step gradients and per-step losses agree;
11. train: the flagship at full width (max_seq 2048), batch 4 x seq 2048,
   full remat, flash attention, AdamW: one warm-up step, five timed steps
   (step time, tokens/s, MFU, peak memory; the flash launch counters are
   zeroed just before and must read 24 / 12 / 12 per step just after, and
   the wgmma counters 24 forward, 12 dQ and 12 dK/dV),
   then ten steps on one repeated batch, whose loss must fall;
13. train profile: ``torch.profiler`` over one training step — device busy
   time, idle share, the attention kernels' share, the top kernels;
18. lora_train: LoRA (rank 8, wq/wk/wv/wo) on phase 11's weights at phase
   11's configuration: one warm-up and five timed steps (step time,
   tokens/s, peak memory; flash counters 24 / 12 / 12 a step, all wgmma),
   ten steps on one repeated batch whose loss must fall, the base's bytes
   unchanged; then the small f32 model's three LoRA steps on the CPU and
   the card (first-step A/B gradients, per-step losses);
20. int8w (after phase 19): the flagship's weights through
   ``quantize_params`` (int8, per-output-channel scales; embedding and
   norms raw) behind ``PagedDecodeServer`` over a bf16 and over an int8
   pool and behind ``DecodeServer``, beside the bf16-weight paged server,
   at phase 6's prompts and settings: decode tokens/s, TTFT p50, peak
   memory (the arm's weights plus its peak above what was resident
   before it), ten profiled steps of the bf16 pair; gates in
   ``phase_int8w``'s docstring (tokens against the dequantized weights'
   under phase 16's near-tie rule, ``param_bytes`` ratio <= 0.56, peak
   below bf16's, the paged launches);
22. rolling: ``make_rolling_generate`` (ring cache) against
   ``make_generate`` on the flagship at window 512, bf16 and int8
   weights, 4 x 640-token prompts, 64 new tokens: tokens under the
   near-tie rule, tokens/s of both loops, the ring's bytes against the
   dense cache's;
21. moe (after phase 22, the flagship freed): the flagship's widths with 8
   experts, top-2, capacity 2.0 (~3.65B parameters) behind
   ``PagedDecodeServer`` at phase 6's settings; a top-1 dense-dispatch arm
   and the top-2 model on int8 weights: decode tokens/s, TTFT p50, peak
   memory, ten profiled steps with the MoE MLP's device time; gates in
   ``phase_moe``'s docstring (one-chunk logits against ``forward`` at the
   same N, the small f32 MoE model's tokens card against CPU, the paged
   launches);
23. moe_train (after phase 18): phase 10's small f32 model with 4
   experts, capacity 1.5 and aux 0.01 (three steps, CPU against card),
   then phase 21's config with aux 0.01 cut to 2 layers at phase 11's
   shape: step time, tokens/s, MFU over the active parameters, peak
   memory, flash launches all wgmma, a falling loss on a repeated batch;
24. text_data (after phase 23; phases 24-28 are the model's lifecycle,
   at the flagship's widths, on one corpus): at least 64 MB of seeded text
   (a word list under a small grammar, documents separated by a blank
   line, the last 5% held out) through ``ByteTokenizer.encode_file`` (host
   seconds, tokens/s), the native loader built at first use (seconds),
   ``TokenFile.batches`` at 4 x 2048 (ms a batch and its share of phase
   11's step: the data stall share), two workers' disjoint shards, and the
   committed BPE fixture through the stdlib ``re`` (its vectors exactly,
   no ``regex`` loaded);
25. text_train: the flagship (phase 11's config) trained 200 steps on the
   corpus with a synchronous ``save_checkpoint`` and an
   ``AsyncCheckpointer`` save at step 100 (bytes, write seconds, the ms the
   loop paid for the async save), ``evaluate`` on held-out windows (loss,
   perplexity), ``restore_checkpoint`` onto the card and onto the CPU.
   Gates in ``phase_text_train``'s docstring (restores byte-equal, the
   resumed losses within 1e-4, a mangled file typed, flash 24 / 12 / 12 a
   step, all wgmma, a falling loss);
26. text_serve: the trained flagship behind ``PagedDecodeServer`` at phase
   6's settings on string prompts cut from held-out text, answering text:
   decode tokens/s, TTFT p50, phase 6's launch rule; tokens against
   ``make_generate``'s under phase 16's near-tie rule, the text
   round-tripping through ``ByteTokenizer``;
27. distill: phase 16's quarter draft distilled 200 steps against the
   trained flagship: greedy agreement before and after beside a 3-layer
   ``truncated_draft``'s, then the speculative server (target + distilled
   draft) against the plain one on phase 26's prompts, alternated:
   tokens/s ratio, tokens per round, accepted share; the near-tie rule,
   no speed gate;
28. hf_import: seeded llama-layout state dicts at the flagship's widths
   (MHA, and 4 KV heads under a llama3 ``rope_scaling``) imported onto the
   card in bf16 (seconds, held peak memory against the weights' bytes),
   each served at phase 6's prompts; a small f32 import's tokens on the
   card equal the CPU's;
32. beam (after phase 27, on its trained flagship): ``make_beam_search``,
   beam 4, 4 held-out prompts of 256 tokens, 64 steps, without EOS, with
   EOS and with length penalty 0.6: ms a step against greedy's at batch
   16, one profiled search (the parent gather's and the cache upcast's
   device ms); gates in ``phase_beam``'s docstring (beam 1 equals greedy
   under the near-tie rule, every beam's score against a teacher-forced
   recompute, beyond it a search whose caches are left unreordered);
29. encoder (after phase 28): the masked-LM encoder at phase 11's widths
   and shape, ``attention="flash"`` (the flash kernels with
   ``causal=False``): step ms, tokens/s, MFU, device busy, idle share,
   peak memory beside phase 11's causal step; gates: 24 / 12 / 12 flash
   launches a step, all wgmma; a falling loss; the loss within 0.02 of
   the dense core's on the same batch and weights, and the final hidden
   states within 0.05 of the dense core's at every position (a causal
   core, the planted fault, beyond it);
33. profiling (on phase 29's model): ``profiling.marginal_ms`` of the
   flash forward at the encoder's shape three ways (eager calls, a CUDA
   graph of n calls, CUDA events) and ``profiling.trace()`` around two
   encoder steps (the trace names the three flash wgmma kernels);
30. vit: ViT-B/16's widths on the repo's block (~114M parameters), batch
   128 of ``SyntheticImages(224, 3, 1000)``, flash at D 64 over 196
   patches: step ms, images/s, a no-grad forward at batch 256, the flash
   forward at this shape against its bound; gates: all flash launches on
   wgmma, a falling loss;
31. seq2seq: the encoder-decoder at the flagship's widths (~1.63B
   parameters) on a copy task, batch 4, 1024 + 1024 tokens: step ms,
   tokens/s; then greedy generate on its weights (batch 8, source 512, 64
   new): the cached path's logits at every step within 0.25 of a
   teacher-forced ``decoder_forward``'s, cached against recompute tokens
   under the near-tie rule, ms a token, device busy against wall; no flash
   launch;
34. mesh_train (after phase 31): the flagship at max_seq 4096 trained on a
   {dp 2, sp 2, tp 2} world of 8 spawned ranks sharing the card (gloo; the
   hops' CUDA tensors staged through pinned host memory),
   ``attention="ring_flash"``, batch 4 x 4096, remat, AdamW, two steps,
   against the one-card flash step on the same weights and batch (world
   rank 0, first). Gates and readings in ``phase_mesh_train``'s
   docstring: step 1's loss within ``MESH_LOSS_TOL`` and the planted fault
   beyond it, each rank's flash launches a step, the flash ring against
   the dense ring on every rank; step ms, bytes a step by axis and staged,
   peak memory a rank and the card's total, the weights' gap after step 1;
   then the sharded checkpoint (``mesh_checkpoint`` line): the state saved
   by the world, restored onto {dp 4, tp 2} into a state drawn leaf by
   leaf, one step against the one-card restore of the same file (a
   process after the world); save and restore s and GB/s, a rank's peak
   while it draws its shard and what the restore adds;
35. mesh_axes: the other legs of ``dryrun_multichip`` in phase 34's
   8-rank world at a small f32 width, then the gang-launch CLI
   (``python -m kubetpu_torch.cli.gang_launch``) against a stub
   controller whose two pods name this card by its UUID: two workers
   sharing it over gloo (``phase_mesh_axes``'s docstring);
36. mesh_serve: the four flagship servers over {dp 2, tp 4} (four of
   phase 6's requests: the paged server's enqueued together, the others'
   staggered, two admitted whole), each rank's shard drawn leaf
   by leaf (``mesh_serve_build``: its peak against the shard plus one
   leaf), against the one-card servers (``phase_mesh_serve``'s
   docstring);
38. mesh_replica (in phase 36's world, after its servers, before phase
   37): phase 36's meshed paged server behind the port's
   ``ReplicaServer`` on world rank 0, ranks 1-7 following: the four
   requests as concurrent generates against phase 36's direct tokens, a
   fifth canceled mid-decode, a drain to the one-card reference server,
   ``check_lockstep`` on every rank (``phase_mesh_replica``'s
   docstring);
37. mesh_families: the encoder, ViT-B/16, seq2seq, beam 4 and the
   distillation of a quarter draft, each on its mesh in phase 36's 8-rank
   world (after its servers) at full widths and 2 layers, against the
   one-card runs on its rank 0 (``phase_mesh_families``'s docstring);
14. the ``kernels`` JSON line, 17 kernels (launches: the paged split,
   combine and wgmma chunk kernels' — dense and int8 instances — over
   phases 6, 8, 9, 12, 15, 16, 17, 19, 20, 21, 26, 27 and 28, the SIMT
   chunk's over phases 5, 16 and 28, the flash kernels' over the timed
   steps of phases 11, 18 and 23 and every flash launch of phases 25 and
   27; then the three flash kernels' ``causal=False`` cases at the
   encoder's shape, launches from phase 29's timed steps, and at ViT's,
   from phase 30's timed steps and no-grad calls; and the three at the
   flash ring's per-step shape, B=2, S=2048, H=8, D=128, timed in phase 4
   (``ring_step`` non-causal, ``ring_diag`` causal), launches from phase
   34's steps on all 8 ranks; the split and the wgmma chunk at a tp-4
   rank's heads, launches from phases 36 and 38; the three flash kernels at a
   meshed rank's shapes in phase 37, the encoder's, ViT's and the
   distillation target's), the script's wall time, then the result
   line.

Nothing of JAX or of the ``kubetpu`` package is imported. ``--record PATH``
also writes every measured number as one JSON file. ``--phases 29-33``
runs phases 1, 2 and 4, then only the other families (29, 33, 30, 31, and
32 on a random-weight flagship with ``SyntheticCorpus`` prompts) in a few
minutes, and prints no ``kernels`` line. ``--phases 34-38`` runs phases 1,
2 and 4 (and phase 3's tp-4 cases), then 34, 35, 36, 38 and 37, and
prints their ``kernels`` entries.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import gc
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_S = 3.35e12          # H100 SXM device memory rate
BF16_FLOP_S = 989e12           # H100 SXM dense bf16 tensor-core rate
F32_FLOP_S = 67e12             # H100 SXM f32 rate outside the tensor cores
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
                ps=16, ring=0):
    """Random pages scattered over a shuffled pool; slot b's queries sit at
    positions ctx_end[b]-t .. ctx_end[b]-1. With *ring* each slot's logical
    pages alias onto its own ring of that many physical pages (lp ->
    ring[lp % ring]), the windowed server's table."""
    from kubetpu_torch.jobs.quant import quantize_kv_chunk

    dev = "cuda"
    b = len(ctx_end)
    pages = [(c + ps - 1) // ps for c in ctx_end]
    max_pages = max(pages)
    n_pool = (b * ring if ring else sum(pages)) + 1
    perm = torch.randperm(n_pool, generator=gen, device=dev).cpu().numpy()
    table = np.full((b, max_pages), -1, np.int32)
    used = 0
    for i, n in enumerate(pages):
        if ring:
            table[i, :n] = perm[i * ring:(i + 1) * ring][np.arange(n) % ring]
            continue
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
    (4 * D flops per query head per visible key) at the peak for q's type
    (the bf16/f16 tensor-core rate; f32 outside the tensor cores)."""
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
    peak = F32_FLOP_S if q.dtype == torch.float32 else BF16_FLOP_S
    t_bytes, t_ops = nbytes / HBM_BYTES_S, flops / peak
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


# the paged instances phase 3 runs: mangled-name fragments of the split
# kernel over dense and int8 pages (bf16 q, D = 128, one row a block: the
# flagship is MHA), of the wgmma chunk kernel over dense and int8 pages
# (bf16, D = 128), and of the SIMT kernel at the parity phase's f32 D = 64
# chunks; with the code of each route in kubetpu_paged_smem_bytes
_PAGED_INSTANCES = {
    "split": ("paged_split_kernelI13__nv_bfloat16S1_Lb0ELi1ELi1EE", 2),
    "int8": ("paged_split_kernelI13__nv_bfloat16aLb1ELi1ELi1EE", 2),
    "wgmma": ("paged_chunk_wgmma_kernelI13__nv_bfloat16Li128ELb0EE", 1),
    "wgmma_int8": ("paged_chunk_wgmma_kernelI13__nv_bfloat16Li128ELb1EE", 3),
    "simt": ("paged_attn_kernelIffLb0ELi1ELi4EE", 0),
}
_PAGED_COUNTERS = ("launches", "split_launches", "combine_launches",
                   "wgmma_launches", "wgmma_int8_launches", "simt_launches")
# kernel names in profiler keys: every instance of the paged kernels
_PAGED_KERNELS = ("paged_attn_kernel", "paged_split_kernel",
                  "paged_combine_kernel", "paged_chunk_wgmma_kernel")


def _paged_builds(cases) -> dict:
    """Registers, spills and shared memory of the paged instances at the
    cases' shapes; a spill in a bf16 D=128 wgmma chunk instance (dense or
    int8 pages) fails."""
    from kubetpu_torch.ops import paged_attention as pa

    builds = {}
    for name, (q, kp, _, table, _, window) in cases:
        key = pa._route(q, kp, q.shape[1], window)
        if isinstance(kp, tuple):
            key = {"split": "int8", "wgmma": "wgmma_int8"}[key]
        vals = kp[0] if isinstance(kp, tuple) else kp
        fragment, code = _PAGED_INSTANCES[key]
        build = _ptxas(fragment, "paged_attention")
        build["dynamic_smem"] = pa._lib().kubetpu_paged_smem_bytes(
            code, vals.shape[3], vals.element_size(),
            vals.shape[1], table.shape[1], pa._SPLIT_KEYS,
            q.shape[2] // vals.shape[2])
        builds[name] = build
        if key.startswith("wgmma") and (build["spill_stores"]
                                        or build["spill_loads"]):
            raise SystemExit(f"paged {name}: the bf16 {key} chunk instance "
                             f"spills: {build}")
    return builds


def _tp4_cases() -> list:
    """Phase 36's shapes at a tp-4 rank of the flagship (16 heads over tp
    4: H = H_kv = 4 a rank): the decode step over phase 3's ragged 8085
    keys and the T=256 chunk at 768, drawn from their own generator so
    that ``--phases 34-38`` runs them on the same data."""
    gen = torch.Generator(device="cuda").manual_seed(1236)
    ragged = [2048, 1717, 1403, 1111, 877, 530, 301, 96]
    return [("decode_bf16_tp4", _paged_case(gen, ragged, 1, 0, False,
                                            torch.bfloat16, h=4, h_kv=4)),
            ("chunk_bf16_T256_tp4", _paged_case(gen, [1024], 256, 0, False,
                                                torch.bfloat16, h=4,
                                                h_kv=4))]


def phase_kernels(names=None) -> list:
    """The paged kernels at the flagship serving shapes: the decode cases
    on the split route (the split kernel and the combine kernel each
    against its plain version, and the call against the plain attention),
    among them the windowed server's decode over a ring table; the chunk
    cases on the wgmma route (T=256 mid-prompt, and the storm's 64-token
    tail at a 1024-token prefix hit), over dense and over int8 pages; the
    SIMT route at the parity phase's f32 chunk shape; and the decode and
    the T=256 chunk at a tp-4 rank's heads (phase 36). *names*: only those
    cases."""
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
        # the windowed phase's decode: window 512 over rings of 33 pages
        ("decode_window512_ring",
         _paged_case(gen, [1280, 1200, 1100, 1024, 900, 800, 700, 641], 1,
                     512, False, torch.bfloat16, ring=33)),
        # the prefix phase's hit chunk: a 64-token tail at pos 1024
        ("chunk_bf16_prefix_T64", _paged_case(gen, [1088], 64, 0, False,
                                              torch.bfloat16)),
        ("chunk_int8_prefix_T64", _paged_case(gen, [1088], 64, 0, True,
                                              torch.bfloat16)),
        ("chunk_int8_T256", _paged_case(gen, [1024], 256, 0, True,
                                        torch.bfloat16)),
        # the parity phase's chunks (f32, D 64, 4 heads on 2 kv heads, page
        # 16, budget 32): the SIMT route
        ("chunk_f32_parity_T32", _paged_case(gen, [70, 40, 64], 32, 0, False,
                                             torch.float32, h=4, h_kv=2,
                                             d=64)),
    ] + _tp4_cases()
    if names is not None:
        cases = [c for c in cases if c[0] in names]
    builds = _paged_builds(cases)
    rows = []
    for name, case in cases:
        q, kp, vp, table, pos, window = case
        b, t, h, d = q.shape
        h_kv = (kp[0] if isinstance(kp, tuple) else kp).shape[2]
        int8 = isinstance(kp, tuple)
        route = pa._route(q, kp, t, window)
        expected = ("split" if t == 1 else
                    "simt" if q.dtype == torch.float32 else "wgmma")
        if route != expected:
            raise SystemExit(f"paged_attention {name}: route {route}, not "
                             f"{expected}")
        kernel_counters = ("split_launches", "wgmma_launches",
                           "wgmma_int8_launches", "simt_launches")
        counts = [getattr(pa.paged_attention, c) for c in kernel_counters]
        if t == 1:
            run = lambda: pa.paged_attention(q[:, 0], kp, vp, table, pos,
                                             window=window)
            out = run()[:, None]
        else:
            run = lambda: pa.paged_attention_chunk(q, kp, vp, table, pos)
            out = run()
        torch.cuda.synchronize()
        moved = tuple(getattr(pa.paged_attention, c) - n
                      for c, n in zip(kernel_counters, counts))
        if moved != {"split": (1, 0, 0, 0),
                     "wgmma": (0, 0, 1, 0) if int8 else (0, 1, 0, 0),
                     "simt": (0, 0, 0, 1)}[route]:
            raise SystemExit(f"paged_attention {name}: the {route} route did "
                             f"not run ({moved})")
        ref = pa.paged_attention_reference(q, kp, vp, table, pos, window)
        err = float((out.float() - ref.float()).abs().max())
        tol = F32_TOL if q.dtype == torch.float32 else BF16_TOL
        ok = bool(torch.isfinite(out).all()) and err <= tol
        ms = graph_ms(run)
        eager_ms = cuda_ms(run)
        plain_ms = cuda_ms(lambda: pa.paged_attention_reference(
            q, kp, vp, table, pos, window), iters=5, warmup=1)
        library_ms = cuda_ms(_library(case))
        bound_ms, bound_by, nbytes, flops = _bound(case)
        row = dict(case=name, route=route,
                   build=builds[name],
                   max_abs_err=err, tol=tol,
                   ok=ok, ms=ms, eager_ms=eager_ms, plain_ms=plain_ms,
                   bound_ms=bound_ms,
                   bound_by=bound_by, library_ms=library_ms, bytes=nbytes,
                   flops=flops,
                   shape=dict(B=b, T=t, H=h, H_kv=h_kv, D=d, window=window,
                              int8=int8, dtype=str(q.dtype)[6:]))
        if t == 1:
            row.update(_split_parts(case))
            row["ok"] = ok and row.pop("ok_parts")
        elif route == "wgmma":
            n = pa._chunk_splits(q, h_kv)
            row.update(grid=[-(-t * (h // h_kv) // 64), h_kv, b * n],
                       key_splits=n)
        else:
            row.update(grid=[-(-t * (h // h_kv) // 16), h_kv, b])
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


# the verify chunk of phase 16: B = 8 slots at phase 3's ragged contexts,
# T = gamma + 1 queries a slot, over bf16 and int8 pages
VERIFY_T = (2, 3, 5, 9)
VERIFY_ROUTES = ("wgmma", "simt", "rows")


def phase_verify_routes() -> list:
    """The three candidate routes of the speculative verify chunk at every
    (T, pool): (a) the wgmma chunk kernel, (b) the SIMT chunk kernel, (c)
    the split route over the B*T queries as one-query rows. Each against
    the plain attention, timed (a replayed CUDA graph of 20 calls), beside
    the bound (keys, values and scales read once over 3.35 TB/s), the
    plain version's time and SDPA's on K/V already gathered. The route
    ``_route`` takes at each T is reported beside the fastest."""
    from kubetpu_torch.ops import paged_attention as pa

    gen = torch.Generator(device="cuda").manual_seed(4321)
    ragged = [2048, 1717, 1403, 1111, 877, 530, 301, 96]
    rows = []
    for int8 in (False, True):
        for t in VERIFY_T:
            case = _paged_case(gen, ragged, t, 0, int8, torch.bfloat16)
            q, kp, vp, table, pos, _ = case
            ref = pa.paged_attention_reference(q, kp, vp, table, pos, 0)
            ms, errs = {}, {}
            for route in VERIFY_ROUTES:
                run = (lambda r=route: pa._kernel(q, kp, vp, table, pos, 0,
                                                   route=r))
                out = run()
                torch.cuda.synchronize()
                errs[route] = float((out.float() - ref.float()).abs().max())
                if not (bool(torch.isfinite(out).all())
                        and errs[route] <= BF16_TOL):
                    raise SystemExit(f"verify T={t} int8={int8}: route "
                                     f"{route} disagrees ({errs[route]})")
                ms[route] = graph_ms(run)
            plain_ms = cuda_ms(lambda: pa.paged_attention_reference(
                q, kp, vp, table, pos, 0), iters=5, warmup=1)
            bound_ms, bound_by, nbytes, flops = _bound(case)
            row = dict(T=t, B=len(ragged), int8=int8, keys=sum(ragged),
                       ms=ms, max_abs_err=errs, tol=BF16_TOL,
                       fastest=min(ms, key=ms.get),
                       routed=pa._route(q, kp, t, 0),
                       plain_ms=plain_ms, library_ms=cuda_ms(_library(case)),
                       bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes)
            line("verify_route", **row)
            rows.append(row)
    return rows


# -- phase 4: the flash kernels against their plain versions -----------------

FLASH_SHAPE = dict(B=4, S=2048, H=16, D=128)
# ViT-B/16's attention (phase 30): 196 patches (a ragged last tile), 12
# heads of 64
VIT_FLASH_SHAPE = dict(B=128, S=196, H=12, D=64)
# the flash ring's per-step kernel shape in phase 34: B = 4 / dp,
# S_local = 4096 / sp, H = 16 / tp; the diagonal step is causal, each
# visiting block's step non-causal
RING_FLASH_SHAPE = dict(B=2, S=2048, H=8, D=128)
# a meshed rank's shapes in phase 37: the encoder on {dp 2, sp 2, tp 2}
# runs the whole sequence at B = 4 / dp and H = 16 / tp, RING_FLASH_SHAPE
# non-causal (the ring_step case); ViT-B/16 on {dp 4, tp 2} at B = 128 /
# dp and H = 12 / tp
VIT_MESH_FLASH_SHAPE = dict(B=32, S=196, H=6, D=64)
# and the distillation target's causal calls on {dp 4, tp 2}: B = 4 / dp,
# H = 16 / tp (its quarter draft's run at H = 4 / tp beside them)
DISTILL_MESH_FLASH_SHAPE = dict(B=1, S=2048, H=8, D=128)


def _visible_pairs(s: int, causal: bool, window: int) -> int:
    """(query, key) pairs one head computes: the causal half, the band, or
    every pair."""
    if not causal:
        return s * s
    if window <= 0:
        return s * (s + 1) // 2
    return sum(min(r + 1, window) for r in range(s))


def _flash_bound(kind: str, causal: bool, window: int, itemsize: int,
                 shape=FLASH_SHAPE):
    """Least time for one call at *shape*: its operations (2 flops per
    multiply-add, D per visible pair for each product recomputed: 2 in the
    forward, 3 in dQ, 4 in dK/dV) against its bytes (every (B, S, H, D)
    input read once and output written once, and the f32 lse / delta rows)."""
    b, s, h, d = (shape[x] for x in "BSHD")
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


# the instances phase 4 runs, bf16 at D = 128 (FLASH_SHAPE) and D = 64
# (VIT_FLASH_SHAPE): (route, mangled-name fragment less the head dim, kernel
# code of kubetpu_flash_smem_bytes)
_INSTANCES = {
    "forward": ("wgmma", "flash_fwd_wgmma_kernelI13__nv_bfloat16Li", 0),
    "dq": ("wgmma", "flash_bwd_dq_wgmma_kernelI13__nv_bfloat16Li", 1),
    "dkv": ("wgmma", "flash_bwd_dkv_wgmma_kernelI13__nv_bfloat16Li", 2),
}
# phase 4's cases: (name, causal, window, shape)
FLASH_CASES = (("causal", True, 0, FLASH_SHAPE),
               ("window256", True, 256, FLASH_SHAPE),
               ("noncausal", False, 0, FLASH_SHAPE),
               ("vit_noncausal", False, 0, VIT_FLASH_SHAPE),
               ("ring_diag", True, 0, RING_FLASH_SHAPE),
               ("ring_step", False, 0, RING_FLASH_SHAPE),
               ("vit_mesh_noncausal", False, 0, VIT_MESH_FLASH_SHAPE),
               ("mesh_distill_causal", True, 0, DISTILL_MESH_FLASH_SHAPE))


def _err_ok(x, ref, tol):
    """(max |x - ref|, every element within tol + tol * |ref|)."""
    diff = (x.float() - ref.float()).abs()
    return (float(diff.max()),
            bool(torch.isfinite(x).all()
                 and (diff <= tol + tol * ref.float().abs()).all()))


def phase_flash() -> list:
    import torch.nn.functional as F

    from kubetpu_torch.ops import flash_attention as fa

    rows = []
    builds = {}
    for d in sorted({shape["D"] for _c, _a, _w, shape in FLASH_CASES}):
        if fa._route(torch.bfloat16, d) != "wgmma":
            raise SystemExit(f"flash: bf16 at D={d} must take the wgmma "
                             "route")
        for kind, (route, fragment, code) in _INSTANCES.items():
            build = _ptxas(f"{fragment}{d}E")
            build["dynamic_smem"] = fa._lib().kubetpu_flash_smem_bytes(
                code, d, fa._ROUTE_CODE[route])
            builds[kind, d] = build
            if d == 128 and (build["spill_stores"] or build["spill_loads"]):
                raise SystemExit(f"flash {kind}: the bf16 D={d} wgmma "
                                 f"instance spills: {build}")
    for case, causal, window, shape in FLASH_CASES:
        b, s, h, d = (shape[x] for x in "BSHD")
        gen = torch.Generator(device="cuda").manual_seed(4321)
        q, k, v, g = (torch.randn((b, s, h, d), generator=gen, device="cuda",
                                  dtype=torch.bfloat16) for _ in range(4))
        # SDPA's (B, H, S, D) layout, timed only; the port never calls it
        qt, kt, vt, gt = (x.transpose(1, 2).contiguous()
                          for x in (q, k, v, g))
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
                kind, causal, window, q.element_size(), shape)
            ms = cuda_ms(run, iters=10, warmup=2)
            row = dict(kernel=kind, case=case, route=_INSTANCES[kind][0],
                       build=builds[kind, d],
                       max_abs_err=max(e for e, _ in errs[kind]),
                       tol=BF16_TOL, ok=all(o for _, o in errs[kind]),
                       ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                       bound_by=bound_by, library_ms=library_ms,
                       bytes=nbytes, flops=flops,
                       tflop_s=flops / ms / 1e9,
                       shape=dict(shape, causal=causal, window=window,
                                  dtype="bf16"))
            line("flash", **row)
            rows.append(row)
        del q, k, v, g, qt, kt, vt, gt, out, lse, delta, dq, dk, dv
        torch.cuda.empty_cache()
    bad = [(r["kernel"], r["case"], r["max_abs_err"]) for r in rows
           if not r["ok"]]
    if bad:
        raise SystemExit(f"flash kernels disagree with their plain versions: "
                         f"{bad}")
    return rows


# -- phase 5: CPU plain version vs the card's kernel, same small model ------

def phase_parity() -> dict:
    """The small f32 model on the CPU and on the card. Its chunks (f32 q)
    are the SIMT kernel's path: the paged counters are zeroed just before
    and read just after, and the SIMT kernel must have run."""
    from kubetpu_torch.jobs import model as model_lib
    from kubetpu_torch.jobs.decode import forward_chunk_io
    from kubetpu_torch.jobs.paged import (PagedDecodeServer,
                                          _paged_prefill_io, init_page_pool)
    from kubetpu_torch.ops import paged_attention as pa
    from kubetpu_torch.ops.paged_attention import paged_attention_chunk

    cfg = model_lib.ModelConfig(vocab=512, d_model=256, n_layers=2,
                                n_heads=4, n_kv_heads=2, d_ff=512,
                                max_seq=256)
    cpu_model = model_lib.init_params(torch.Generator().manual_seed(7), cfg,
                                      device="cpu")
    models = {"cpu": cpu_model, "cuda": copy.deepcopy(cpu_model).to("cuda")}
    rng = np.random.default_rng(7)
    prompt = rng.integers(0, cfg.vocab, 64)

    torch.cuda.synchronize()
    for c in _PAGED_COUNTERS:                  # zero just before the path
        setattr(pa.paged_attention, c, 0)
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
    served = _parity_servers(cfg, models, rng)
    torch.cuda.synchronize()
    launches = {c: getattr(pa.paged_attention, c)   # read just after
                for c in _PAGED_COUNTERS}
    line("parity_launches", paged_launches=launches)
    if launches["simt_launches"] <= 0:
        raise SystemExit(f"parity: no chunk ran on the SIMT kernel: "
                         f"{launches}")
    return {"prefill_logit_max_err": logit_err, "mismatches": mismatches,
            "servers": served, "paged_launches": launches}


def _parity_servers(cfg, models, rng) -> dict:
    """The server's new paths on both devices: shared-prefix reuse (a cold
    seed, then hits two at a time, chunked prefill, f32 and int8 pools)
    and window 8 on the ring table (ring of 2 pages, prompts up to 70
    tokens). Greedy tokens on the card must equal the CPU's exactly, and
    the pool oracle must hold after every drain."""

    from kubetpu_torch.jobs.paged import PagedDecodeServer

    head = rng.integers(0, cfg.vocab, 48).tolist()
    waves = [[head + rng.integers(0, cfg.vocab, 5).tolist()]]
    waves += [[head + rng.integers(0, cfg.vocab, n).tolist() for n in pair]
              for pair in ((3, 17), (1, 30))]
    window_waves = [[rng.integers(0, cfg.vocab, n).tolist()
                     for n in (5, 40, 23, 70)]]
    runs = {
        "prefix_f32": (cfg, dict(prefix_cache_pages=32), waves),
        "prefix_int8": (cfg, dict(prefix_cache_pages=32, kv_int8=True),
                        waves),
        "window8": (dataclasses.replace(cfg, window=8), {}, window_waves),
    }
    out = {}
    for name, (run_cfg, kw, run_waves) in runs.items():
        tokens, stats = {}, {}
        for dev, model in models.items():
            server = PagedDecodeServer(run_cfg, model, n_slots=3,
                                       max_seq=256, max_new_tokens=16,
                                       page_size=16, prefill_budget=32,
                                       device=dev, **kw)
            tokens[dev] = []
            for wave in run_waves:
                rids = [server.enqueue(p) for p in wave]
                server.drain()
                server.check_invariants()
                tokens[dev] += [server.pop_result(r) for r in rids]
            stats[dev] = server.prefix_cache_stats()
        equal = tokens["cpu"] == tokens["cuda"]
        out[name] = dict(requests=len(tokens["cuda"]), tokens_equal=equal,
                         stats_equal=stats["cpu"] == stats["cuda"],
                         requests_hit=stats["cuda"].get("requests_hit"))
        if not equal or stats["cpu"] != stats["cuda"]:
            raise SystemExit(f"parity {name}: the card's tokens or reuse "
                             f"stats differ from the CPU's: {out[name]}")
    line("parity_servers", **out)
    return out


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
    counts = _instrument(server)

    rng = np.random.default_rng(0)
    # warm-up request (cuBLAS handles, allocator), outside the counted run
    server.enqueue(rng.integers(0, cfg.vocab, 40).tolist())
    server.drain()

    lengths = [128, 1024, 256, 896, 384, 768, 512, 640]
    prompts = [rng.integers(0, cfg.vocab, n).tolist() for n in lengths]
    counts.update(steps=0, chunks=0, prefill_tokens=0)
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
                    wgmma_launches=n_chunk, wgmma_int8_launches=0,
                    simt_launches=0)
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


# -- phases 8 and 9: shared-prefix reuse and windowed serving at full width --

LOGIT_TOL = 0.25     # bf16 noise in a logit after 12 layers (phase 6's gate)


def _instrument(server) -> dict:
    """Count the server's decode steps, prefill chunks and prefill tokens
    computed, and keep each prompt's first-token logits (the row the final
    chunk samples from), by wrapping its legs."""
    st = {"steps": 0, "chunks": 0, "prefill_tokens": 0, "first_logits": {}}
    step_leg, chunk_leg = server._device_step, server._prefill_chunk_device
    sampler, seen = server._sampler, {}

    def counted_step():
        st["steps"] += 1
        return step_leg()

    def spied_sampler(r, *args):
        if r.dim() == 1:
            seen["r"] = r.float().clone()
        return sampler(r, *args)

    def counted_chunk(prompt, slot, pos, take, final):
        res = chunk_leg(prompt, slot, pos, take, final)
        if res is not None:
            st["chunks"] += 1
            st["prefill_tokens"] += take
            if final:      # None where a dp rank ran another rank's slot
                st["first_logits"][tuple(prompt)] = seen.pop("r", None)
        return res

    server._device_step = counted_step
    server._prefill_chunk_device = counted_chunk
    server._sampler = spied_sampler
    return st


def _drive(server, waves, launches) -> dict:
    """Enqueue each wave and step until the server is idle, the pool oracle
    after every drain. The paged launch counters are zeroed just before
    and read just after the run and added to *launches* (the main path's
    totals). Returns the results, the decode tokens/s over the steps that
    ran no prefill chunk, the wall time and the peak of pages in use."""
    from kubetpu_torch.ops import paged_attention as pa

    st = server._smoke_stats
    results, peak = [], 0
    decode_s, decode_tokens = 0.0, 0
    torch.cuda.synchronize()
    for c in _PAGED_COUNTERS:
        setattr(pa.paged_attention, c, 0)
    t_start = time.perf_counter()
    for wave in waves:
        rids = [server.enqueue(p) for p in wave]
        while not server._idle():
            chunks = st["chunks"]
            t0 = time.perf_counter()
            out = server.step()
            dt = time.perf_counter() - t0
            peak = max(peak, server.pages_in_use())
            if st["chunks"] == chunks and out:
                decode_s += dt
                decode_tokens += sum(len(v) for v in out.values())
        server.check_invariants()
        results += [server.pop_result(r) for r in rids]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_start
    counts = {c: getattr(pa.paged_attention, c) for c in _PAGED_COUNTERS}
    for c, n in counts.items():
        launches[c] = launches.get(c, 0) + n
    return dict(results=results, wall_s=wall, peak_pages=peak,
                decode_toks_s=decode_tokens / decode_s if decode_s else None,
                paged_launches=counts)


def _arm_row(server, run, smi, **extra) -> dict:
    """The line of one arm: server-recorded TTFT, prefill work, reuse and
    tier counters, decode tokens/s and the paged launches."""
    ttft = server.metrics_summary()["ttft"]
    reuse = server.prefix_cache_stats()
    tier = server.tier_stats()
    st = server._smoke_stats
    row = dict(card=torch.cuda.get_device_name(0), nvidia_smi=smi,
               requests=len(run["results"]), ttft_p50_ms=ttft["p50_ms"],
               ttft_p99_ms=ttft["p99_ms"], ttft_count=ttft["count"],
               prefill_tokens_computed=st["prefill_tokens"],
               prefill_chunks=st["chunks"], decode_steps=st["steps"],
               decode_toks_s=run["decode_toks_s"], wall_s=run["wall_s"],
               peak_pages_in_use=run["peak_pages"],
               paged_launches=run["paged_launches"])
    if reuse.get("enabled"):
        row.update(prefill_tokens_saved=reuse["prefill_tokens_saved"],
                   hit_rate=reuse["hit_rate"],
                   requests_hit=reuse["requests_hit"],
                   tier_hits=tier["hits"], tier_fills=tier["fills"],
                   tier_spills=tier["spills"], tier_bytes=tier["bytes"])
    row.update(extra)
    return row


def _flagship_server(model, cfg, **kw):
    from kubetpu_torch.jobs.paged import PagedDecodeServer

    server = PagedDecodeServer(cfg, model, n_slots=8, max_seq=2048,
                               page_size=16, prefill_budget=256,
                               device="cuda", **kw)
    server.warmup()
    server._smoke_stats = _instrument(server)
    return server


def _logit_gap(a: dict, b: dict, prompts) -> float:
    """Largest |difference| between two runs' first-token logits over
    *prompts*."""
    return max(float((a[tuple(p)] - b[tuple(p)]).abs().max())
               for p in prompts)


def _chunk_step_profile(model, cfg, seed, prompts, **kw) -> dict:
    """Where a prefill-chunk step's time goes: a fresh reuse-on server
    (*kw*: its pool) serves *seed* (the cold request that fills the tree),
    then torch.profiler covers the one step that admits *prompts* (prefix
    hits of it, enqueued together, so the step runs each one's tail chunk,
    then a decode step of the slots they fill)."""
    server = _flagship_server(model, cfg, max_new_tokens=32, **kw)
    rid = server.enqueue(seed)
    server.drain()
    server.pop_result(rid)
    rids = [server.enqueue(p) for p in prompts]
    chunks = server._smoke_stats["chunks"]
    wall_us, kernels, counts = _profiled(server.step)
    n_chunks = server._smoke_stats["chunks"] - chunks
    server.drain()
    server.check_invariants()
    for r in rids:
        server.pop_result(r)
    del server
    torch.cuda.empty_cache()
    busy = sum(kernels.values())
    attn = sum(v for k, v in kernels.items()
               if any(n in k for n in _PAGED_KERNELS))
    return dict(chunks=n_chunks, step_ms=wall_us / 1e3,
                device_busy_ms=busy / 1e3,
                idle_share=(1.0 - busy / wall_us) if busy else None,
                paged_attention_ms=attn / 1e3, kernel_kinds=len(kernels),
                **counts, kernels_ms={k: v / 1e3 for k, v in kernels.items()})


def phase_prefix(model, cfg, smi, launches) -> dict:
    """Shared-prefix reuse at full width (bench_model.py:662's storm at
    realistic lengths): a 1024-token system prompt and a unique 64-token
    tail, one cold seeding request, then 15 at once, 32 new tokens each;
    reuse off, on, and on over an int8 pool (whose chunks run on the wgmma
    route's int8 instance). Then the host tier (bench_model.py:737's
    shape): 4 families of 1024-token prompts with 16-token tails,
    round-robined 3 rounds one request at a time, through an HBM tree
    sized for one family with a 1 GiB host tier, against a warm HBM tree
    that holds all four. Last, after every timed arm, one step of four
    hits is profiled on a bf16 and on an int8 pool
    (``_chunk_step_profile``): where the int8 pool's step time goes beside
    the bf16 one's. Gates: the pool oracle after every drain; the host
    arm's tokens equal the warm-HBM arm's (a fill is a byte copy); both on
    arms' first-token logits within LOGIT_TOL of the off arm's; the int8
    arm's chunks all on the int8 wgmma instance, none on SIMT."""
    rng = np.random.default_rng(5)
    sys_prompt = rng.integers(1, cfg.vocab, 1024).tolist()
    storm = [sys_prompt + rng.integers(1, cfg.vocab, 64).tolist()
             for _ in range(16)]
    waves = [storm[:1], storm[1:]]
    rows, firsts, tokens = {}, {}, {}
    n_pages = 8 * 128 + 128
    reuse = {"storm_on": dict(prefix_cache_pages=128),
             "storm_on_int8": dict(prefix_cache_pages=128, kv_int8=True)}
    for arm, kw in (("storm_off", dict(prefix_cache_pages=0)),
                    *reuse.items()):
        server = _flagship_server(model, cfg, max_new_tokens=32,
                                  n_pages=n_pages, **kw)
        run = _drive(server, waves, launches)
        firsts[arm] = server._smoke_stats["first_logits"]
        tokens[arm] = run["results"]
        rows[arm] = _arm_row(server, run, smi)
        del server
        torch.cuda.empty_cache()
    # the hits' first-token logits against the cold arm's, and the share
    # of equal generated tokens
    for arm in ("storm_on", "storm_on_int8"):
        gen_pairs = [(a[1024 + 64:], b[1024 + 64:]) for a, b in
                     zip(tokens[arm], tokens["storm_off"])]
        rows[arm].update(
            first_logit_max_diff=_logit_gap(firsts[arm], firsts["storm_off"],
                                            storm[1:]),
            logit_tol=LOGIT_TOL,
            equal_token_share=sum(x == y for a, b in gen_pairs
                                  for x, y in zip(a, b))
            / sum(len(a) for a, _ in gen_pairs))
    for arm, row in rows.items():
        line("prefix", arm=arm, **row)
    saved = rows["storm_on"]["prefill_tokens_saved"]
    if saved != 15 * 1024 or rows["storm_on"]["requests_hit"] != 15:
        raise SystemExit(f"prefix: the storm saved {saved} tokens, not "
                         f"15 x 1024")
    for arm in ("storm_on", "storm_on_int8"):
        if not all(bool(torch.isfinite(x).all())
                   for x in firsts[arm].values()):
            raise SystemExit(f"prefix {arm}: non-finite first-token logits")
        if not rows[arm]["first_logit_max_diff"] <= LOGIT_TOL:
            raise SystemExit(f"prefix {arm}: hit first-token logits differ "
                             f"from the cold arm's by {rows[arm]}")
    int8_launches = rows["storm_on_int8"]["paged_launches"]
    if (int8_launches["simt_launches"] or int8_launches["wgmma_launches"]
            or int8_launches["wgmma_int8_launches"] <= 0):
        raise SystemExit(f"prefix: the int8 arm's chunks must all run on the "
                         f"int8 wgmma instance: {int8_launches}")

    families = [rng.integers(1, cfg.vocab, 1024).tolist() for _ in range(4)]
    tier_prompts = [fam + rng.integers(1, cfg.vocab, 16).tolist()
                    for _ in range(3) for fam in families]
    tier_waves = [[p] for p in tier_prompts]
    for arm, kw in (("tier_host", dict(prefix_cache_pages=64,
                                       host_tier_bytes=1 << 30)),
                    # all four families and every request's tail page
                    ("tier_warm_hbm", dict(prefix_cache_pages=4 * 64 + 16))):
        server = _flagship_server(model, cfg, max_new_tokens=32,
                                  n_pages=8 * 128 + 4 * 64 + 16, **kw)
        run = _drive(server, tier_waves, launches)
        tokens[arm] = run["results"]
        rows[arm] = _arm_row(server, run, smi)
        line("prefix", arm=arm, **rows[arm])
        del server
        torch.cuda.empty_cache()
    host = rows["tier_host"]
    if tokens["tier_host"] != tokens["tier_warm_hbm"]:
        raise SystemExit("prefix: the host tier's tokens differ from the "
                         "warm HBM tree's")
    if not (host["tier_spills"]["host"] > 0 and host["tier_fills"]["host"] > 0
            and host["requests_hit"] == 8):
        raise SystemExit(f"prefix: the host tier did not spill and fill "
                         f"back every return: {host}")

    # after every timed arm: one step of four hits on each pool (prompts
    # from their own generator, so the arms' prompts stay as they were)
    hit_rng = np.random.default_rng(6)
    hits = [sys_prompt + hit_rng.integers(1, cfg.vocab, 64).tolist()
            for _ in range(4)]
    profiles = {arm: _chunk_step_profile(model, cfg, storm[0], hits,
                                         n_pages=n_pages, **kw)
                for arm, kw in reuse.items()}
    # the int8 step beside the bf16 one: every kernel's device time, and
    # the kernels the int8 step spends the most extra time in (a paged
    # kernel's instances under one name, so the two pools' compare)
    bf16, int8 = ({next((n for n in _PAGED_KERNELS if n in k), k): v
                   for k, v in profiles[a]["kernels_ms"].items()}
                  for a in ("storm_on", "storm_on_int8"))
    extra_ms = {k: int8.get(k, 0.0) - bf16.get(k, 0.0)
                for k in set(bf16) | set(int8)}
    for arm, prof in profiles.items():
        top = sorted(prof["kernels_ms"].items(), key=lambda kv: -kv[1])[:10]
        line("prefix_profile", arm=arm,
             top_kernels_ms=[(k[:70], v) for k, v in top],
             **{k: v for k, v in prof.items() if k != "kernels_ms"})
    diffs = {f"{k}_int8_minus_bf16": profiles["storm_on_int8"][k]
             - profiles["storm_on"][k]
             for k in ("step_ms", "device_busy_ms", "device_kernels",
                       "cpu_ops")}
    line("prefix_profile_int8_extra", **diffs,
         top_extra_kernels_ms=[(k[:70], v) for k, v in sorted(
             extra_ms.items(), key=lambda kv: -kv[1])[:10]])
    rows["profiles"] = profiles
    return rows


def phase_window(model, cfg, smi, launches) -> dict:
    """Windowed serving at full width: the flagship with window 512 on the
    ring table (33 pages a slot), 8 requests of 640-1024-token prompts and
    256 new tokens each, so every ring wraps during prefill and again in
    decode. Gates: the pool oracle after the drain; pages in use never
    above 8 x 33; each first token's logits within LOGIT_TOL of the
    port's dense windowed forward of the prompt."""

    from kubetpu_torch.jobs import model as model_lib

    wcfg = dataclasses.replace(cfg, window=512)
    rng = np.random.default_rng(9)
    lengths = [640, 1024, 700, 960, 768, 896, 832, 1000]
    prompts = [rng.integers(1, cfg.vocab, n).tolist() for n in lengths]
    server = _flagship_server(model, wcfg, max_new_tokens=256)
    ring = server._ring_pages
    run = _drive(server, [prompts], launches)
    firsts = server._smoke_stats["first_logits"]
    with torch.no_grad():
        gap = max(float((model_lib.forward(
            model, torch.tensor([p], device="cuda"), wcfg)[0, -1].float()
            - firsts[tuple(p)]).abs().max()) for p in prompts)
    unwindowed = sum(server._pages_needed(n + 256 + 1) for n in lengths)
    row = _arm_row(server, run, smi, ring_pages=ring,
                   pages_bound=server.n_slots * ring,
                   unwindowed_worst_pages=unwindowed,
                   first_logit_max_diff_vs_dense=gap, logit_tol=LOGIT_TOL)
    line("window", **row)
    if ring != 33 or run["peak_pages"] > server.n_slots * ring:
        raise SystemExit(f"window: {run['peak_pages']} pages in use, above "
                         f"{server.n_slots} x {ring}")
    if not all(len(r) == n + 256 for r, n in zip(run["results"], lengths)):
        raise SystemExit("window: a request did not finish with 256 tokens")
    if not gap <= LOGIT_TOL:
        raise SystemExit(f"window: first-token logits {gap} off the dense "
                         f"windowed forward's")
    if (run["paged_launches"]["wgmma_launches"]
            or run["paged_launches"]["wgmma_int8_launches"]):
        raise SystemExit("window: a windowed chunk took the chunk kernel")
    return row


def _event_sums(events, ranges, count=lambda ev: 1):
    """(kernels, counts, range totals) of profiler events: see
    ``_profiled``."""
    from torch.autograd import DeviceType

    kernels, found = {}, {}
    counts = {"device_kernels": 0, "cpu_ops": 0}
    for ev in events:
        if ranges is not None and ev.key in ranges:
            if ev.device_type != DeviceType.CUDA:
                found[ev.key] = (found.get(ev.key, 0.0)
                                 + ev.device_time_total)
            continue
        if ev.device_type != DeviceType.CUDA:
            counts["cpu_ops"] += count(ev)
            continue
        kernels[ev.key] = (kernels.get(ev.key, 0.0)
                           + ev.self_device_time_total)
        counts["device_kernels"] += count(ev)
    return kernels, counts, found


def _profiled(run, ranges=None):
    """(wall us, {kernel name: device self time us}, {"device_kernels": the
    kernels run, "cpu_ops": the host-side operator calls, nested ones
    included}) of run() under torch.profiler. Only device-side events are
    summed (CPU ops would count twice); on one stream kernels never
    overlap, so their sum is the device busy time and 1 - busy / wall the
    idle share. *ranges*: a dict whose keys are ``record_function`` labels
    run() opens; each gets the device time (us) of the kernels launched
    inside it (the ranges' device-side annotations stay out of the busy
    sum).

    The sums run over the profiler's events one by one, not over
    ``key_averages()``, which walks each op's subtree again for every
    event it averages: on a window of 10^4 events (a flagship training
    step) that walk, not the run, takes most of the phase. The two totals
    are held equal by ``tests/test_torch_cuda.py``."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels, counts, found = _event_sums(prof.events(), ranges)
    if ranges is not None:
        ranges.update(found)
    return wall_us, kernels, counts


def _ten_step_profile(server, ranges=None) -> dict:
    """torch.profiler over ten steps of eight active slots (256-token
    prompts from their own generator), after three steps in: step time,
    device busy time, idle share, the paged kernels' share and the top
    kernels; with *ranges* (``_profiled``'s), each range's device ms a
    step. Drains the server after."""
    rng = np.random.default_rng(1)
    for _ in range(server.n_slots):
        server.enqueue(rng.integers(0, server.cfg.vocab, 256).tolist())
    while server._queue or server._prefills:
        server.step()
    for _ in range(3):
        server.step()
    active = int(server.active.sum())

    def ten_steps():
        for _ in range(10):
            server.step()

    wall_us, kernels, counts = _profiled(ten_steps, ranges)
    busy = sum(kernels.values())
    attn = sum(v for k, v in kernels.items()
               if any(n in k for n in _PAGED_KERNELS))
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    server.drain()
    extra = ({} if ranges is None else {"range_device_ms_per_step": {
        k: v / 10 / 1e3 for k, v in ranges.items()}})
    return dict(**extra, active_slots=active, steps=10,
                step_ms=wall_us / 10 / 1e3,
                device_busy_ms_per_step=busy / 10 / 1e3,
                idle_share=(1.0 - busy / wall_us) if busy else None,
                paged_attention_share_of_busy=(attn / busy) if busy else None,
                kernel_kinds=len(kernels),
                device_kernels_per_step=counts["device_kernels"] / 10,
                cpu_ops_per_step=counts["cpu_ops"] / 10,
                top_kernels_ms_per_step=[(k[:60], v / 10 / 1e3)
                                         for k, v in top])


def phase_profile(server) -> dict:
    """Where a decode step's time goes: torch.profiler over 10 steps of 8
    active slots (256-token prompts), after the counted run."""
    row = _ten_step_profile(server)
    line("profile", **row)
    return row


# -- phase 12: the paged server on the wire ----------------------------------

WIRE_NEW = 32        # new tokens a request, phase 6's
# every arm's streams but the prefix and disaggregated ones (phase 6's 8
# until phase 38 came)
WIRE_STREAMS = 4


def _wire_server(model, cfg, max_new_tokens=WIRE_NEW, **kw):
    """A flagship server with phase 6's settings, on the model's device."""
    from kubetpu_torch.jobs.paged import PagedDecodeServer

    return PagedDecodeServer(cfg, model, n_slots=8, max_seq=2048,
                             max_new_tokens=max_new_tokens, page_size=16,
                             prefill_budget=256,
                             device=next(model.parameters()).device, **kw)


def _serial(server, prompts) -> list:
    """The quiet reference: each prompt alone on *server*, to the end."""
    out = []
    for p in prompts:
        rid = server.enqueue(p)
        server.drain()
        out.append(server.pop_result(rid))
    server.check_invariants()
    return out


def _stamp(server) -> dict:
    """Host perf stamps of each request's emissions on *server* (wrapping
    ``_obs_tokens``), its TTFT (first emission - arrival), the rid of each
    enqueued prompt and each rid's enqueue time."""
    st = {"emits": {}, "ttft": {}, "rid": {}, "enq": {}}
    obs, enqueue = server._obs_tokens, server.enqueue

    def stamped(rid, n):
        now = time.perf_counter()
        if rid not in st["emits"] and rid in server._arrive:
            st["ttft"][rid] = now - server._arrive[rid]
        st["emits"].setdefault(rid, []).append(now)
        return obs(rid, n)

    def enqueued(prompt, *a, **kw):
        t0 = time.perf_counter()
        rid = enqueue(prompt, *a, **kw)
        st["rid"][tuple(prompt)] = rid
        st["enq"][rid] = t0
        return rid

    server._obs_tokens, server.enqueue = stamped, enqueued
    return st


def _gaps(stamps) -> list:
    """Every inter-token gap (ms) in *stamps*' emission lists, the first
    token's (it lands with the admission step's decode token) left out."""
    return [(b - a) * 1e3 for ts in stamps for a, b in zip(ts[1:], ts[2:])]


class _Hold:
    """Gate a replica's step loop for a handoff arm: it steps nothing until
    *count* requests have arrived (so they are admitted together, in one
    order, however the handler threads were scheduled), then runs until
    *park* of them (default: each) are migratable with at least 3 tokens,
    and from then on steps nothing again (``park=0``: never). A parked
    step waits on the replica's condition (releasing it) and advances
    nothing, so a handoff started after ``wait()`` finds every stream
    mid-flight, and none decodes on the source meanwhile; a parked meshed
    replica sends its followers no step."""

    def __init__(self, rep, count: int, park=None) -> None:
        import threading

        self.rep, self.count = rep, count
        self.park = count if park is None else park
        self.arrived = False
        self.held = threading.Event()
        self._step = rep.server.step
        rep.server.step = self._gated

    def _gated(self):
        srv = self.rep.server
        self.arrived = (self.arrived
                        or len(srv.unfinished_rids()) >= self.count)
        if not self.arrived or self.held.is_set() or (self.park and sum(
                len(srv._emitted.get(r, ())) >= 3
                for r in srv.migratable_rids()) >= self.park):
            if self.arrived:
                self.held.set()
            self.rep._cv.wait(timeout=0.005)
            return {}
        return self._step()

    def wait(self, what: str) -> None:
        if not self.held.wait(300):
            raise SystemExit(f"{what}: streams never reached "
                             f"mid-decode")

    def release(self) -> None:
        """Step normally again."""
        with self.rep._cv:
            self.rep.server.step = self._step
            self.rep._cv.notify_all()


def _generate(addr, prompt, key, **extra) -> tuple:
    """POST /generate -> (code, body): a 409's body too."""
    import urllib.error

    from kubetpu_torch.wire.httpcommon import RetryPolicy, request_json

    try:
        return 200, request_json(
            addr + "/generate", {"prompt": prompt, "timeout": 600, **extra},
            idempotency_key=key, timeout=600,
            retry=RetryPolicy(attempts=1, deadline=600.0))
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def _generate_all(addr, prompts, tag) -> list:
    """The prompts' generates posted concurrently -> [(code, body)]."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(len(prompts)) as pool:
        return list(pool.map(
            lambda ip: _generate(addr, ip[1], f"{tag}-{ip[0]}"),
            enumerate(prompts)))


def _chase(owner, prompts, tag, answers) -> list:
    """Each 409 of *answers* names *owner*: the same keys at the owner
    adopt the migrated streams -> their tokens."""
    out = []
    for i, (p, (code, body)) in enumerate(zip(prompts, answers)):
        if code != 409 or body["migrated"]["replica"] != owner.name:
            raise SystemExit(f"wire {tag}: request {i} answered {code} "
                             f"{str(body)[:200]}, not 409 -> {owner.name}")
        code, body = _generate(owner.address, p, f"{tag}-{i}")
        if code != 200:
            raise SystemExit(f"wire {tag}: the owner answered {code} "
                             f"{str(body)[:200]}")
        out.append(body["tokens"])
    return out


def _stop(*reps) -> None:
    for rep in reps:
        rep.shutdown(graceful=False)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def _counter(server, name, **labels) -> float:
    return server.obs.counter(name, **labels).value


def _wire_routed(model, cfg, prompts, quiet, smi) -> dict:
    """The generates, serially over POST /generate to one replica."""
    from kubetpu_torch.router import ReplicaServer

    a = _wire_server(model, cfg)
    a.warmup()
    st = _stamp(a)
    rep = ReplicaServer(a, "wire-a", idle_wait=0.002)
    rep.start()
    walls, tokens = [], []
    for i, p in enumerate(prompts):
        t0 = time.perf_counter()
        code, body = _generate(rep.address, p, f"routed-{i}")
        walls.append((time.perf_counter() - t0) * 1e3)
        if code != 200:
            raise SystemExit(f"wire routed: {code} {str(body)[:200]}")
        tokens.append(body["tokens"])
    with rep._cv:
        a.check_invariants()
    _stop(rep)
    ttft = [st["ttft"][st["rid"][tuple(p)]] * 1e3 for p in prompts]
    row = dict(arm="routed", card=torch.cuda.get_device_name(0),
               nvidia_smi=smi, requests=len(prompts),
               tokens_equal_quiet=tokens == quiet,
               ttft_ms=ttft, ttft_ms_p50=float(np.median(ttft)),
               request_ms=walls, itl_ms_p50=float(np.median(
                   _gaps(st["emits"].values()))))
    line("wire", **row)
    if tokens != quiet:
        raise SystemExit("wire routed: routed tokens differ from the quiet "
                         "serial run's")
    return row


def _live_pages(server, rid) -> dict:
    slot = server._slot_rid.index(rid)
    n = server._pages_needed(int(server.pos[slot]) + 1)
    return server._gather_phys_pages(server._table[slot, :n])


def _wire_fork(model, cfg, prompts, smi, arm, **kw) -> dict:
    """Streams mid-decode on A, each forked onto B through the codec
    (freeze, snapshot, encode, decode, restore, unfreeze); then both
    servers run to the end."""
    from kubetpu_torch.router.migration import (decode_snapshot,
                                                encode_snapshot)

    a, b = _wire_server(model, cfg, **kw), _wire_server(model, cfg, **kw)
    rids = [a.enqueue(p) for p in prompts]
    for _ in range(200):
        ready = set(a.migratable_rids())
        if all(r in ready and len(a._emitted[r]) >= 3 for r in rids):
            break
        a.step()
    if not all(r in a.migratable_rids() for r in rids):
        raise SystemExit(f"wire {arm}: streams never all mid-decode")
    times = {k: 0.0 for k in ("snapshot", "encode", "decode", "restore")}
    nbytes, identical, state_equal, pairs = 0, True, True, []
    for r in sorted(rids, key=a._slot_rid.index):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        a.freeze_slot(r)
        snap = a.snapshot_slot(r, allow_frozen=True)
        t1 = time.perf_counter()
        meta, blob = encode_snapshot(snap)
        t2 = time.perf_counter()
        back = decode_snapshot(meta, blob)
        t3 = time.perf_counter()
        rb = b.restore_slot(back)
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        a.unfreeze_slot(r)
        if rb is None:
            raise SystemExit(f"wire {arm}: B had no room for stream {r}")
        for k, dt in zip(times, (t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
            times[k] += dt
        nbytes += len(blob)
        pa_, pb = _live_pages(a, r), _live_pages(b, rb)
        identical &= all(torch.equal(pa_[n], pb[n]) for n in pa_)
        sa, sb = a._slot_rid.index(r), b._slot_rid.index(rb)
        state_equal &= (int(a.pos[sa]) == int(b.pos[sb])
                        and int(a.last[sa]) == int(b.last[sb]))
        pairs.append((r, rb))
    a.drain()
    b.drain()
    a.check_invariants()
    b.check_invariants()
    equal = [a.result(r) == b.result(rb) for r, rb in pairs]
    full = all(len(a.result(r)) == len(a._prompts[r]) + WIRE_NEW
               for r, _ in pairs)
    n = len(pairs)
    row = dict(arm=arm, card=torch.cuda.get_device_name(0), nvidia_smi=smi,
               streams=n, pages_byte_identical=identical,
               pos_last_equal=state_equal, tokens_equal=sum(equal),
               mb_per_stream=nbytes / n / 1e6,
               **{f"{k}_ms_per_stream": v / n * 1e3
                  for k, v in times.items()},
               snapshot_mb_s=nbytes / times["snapshot"] / 1e6,
               restore_mb_s=nbytes / times["restore"] / 1e6)
    line("wire", **row)
    if not (identical and state_equal and all(equal) and full):
        raise SystemExit(f"wire {arm}: the fork is not exact: {row}")
    del a, b
    torch.cuda.empty_cache()
    return row


def _wire_drain(model, cfg, prompts, quiet, smi) -> dict:
    """Concurrent streams on A; POST /drain {"migrate_to": B} once they
    are mid-decode; every generate on A answers 409 -> B, and B finishes
    each stream with all its tokens."""
    from concurrent.futures import ThreadPoolExecutor

    from kubetpu_torch.router import ReplicaServer
    from kubetpu_torch.wire.httpcommon import request_json

    a, b = _wire_server(model, cfg), _wire_server(model, cfg)
    sa, sb = _stamp(a), _stamp(b)
    rep_a = ReplicaServer(a, "wire-a", idle_wait=0.002)
    rep_b = ReplicaServer(b, "wire-b", idle_wait=0.002)
    hold = _Hold(rep_a, len(prompts))
    rep_a.start()
    rep_b.start()
    with ThreadPoolExecutor(1) as pool:
        fut = pool.submit(_generate_all, rep_a.address, prompts, "drain")
        hold.wait("wire drain")
        itl_before = float(np.median(_gaps(sa["emits"].values())))
        t0 = time.perf_counter()
        request_json(rep_a.address + "/drain",
                     {"migrate_to": rep_b.address, "reason": "scale_down"},
                     timeout=60)
        with rep_a._cv:
            if not rep_a._cv.wait_for(a._idle, timeout=600):
                raise SystemExit("wire drain: A never went idle")
        drain_s = time.perf_counter() - t0
        answers = fut.result(timeout=600)
    tokens = _chase(rep_b, prompts, "drain", answers)
    full = [len(t) == len(p) + WIRE_NEW for t, p in zip(tokens, prompts)]
    with rep_a._cv:
        a_free = len(a._free) == a.pool_pages
        a.check_invariants()
    with rep_b._cv:
        b.check_invariants()
    shipped = _counter(a, "kubetpu_migration_bytes_shipped_total")
    committed = _counter(a, "kubetpu_migrations_total", reason="scale_down",
                         result="committed")
    gaps, b_gaps = [], []
    for (code, body), p in zip(answers, prompts):
        ra, rb = sa["rid"][tuple(p)], body["migrated"]["rid"]
        ts = sb["emits"][rb]
        gaps.append((ts[0] - sa["emits"][ra][-1]) * 1e3)
        b_gaps += [(y - x) * 1e3 for x, y in zip(ts, ts[1:])]
    _stop(rep_a, rep_b)
    row = dict(arm="drain", card=torch.cuda.get_device_name(0),
               nvidia_smi=smi, streams=len(prompts),
               migrated=int(committed), answered_409=len(tokens),
               tokens_full=sum(full), tokens_equal_quiet=sum(
                   t == q for t, q in zip(tokens, quiet)),
               a_pool_all_free=a_free, drain_ms=drain_s * 1e3,
               mb_shipped=shipped / 1e6,
               mb_s=shipped / 1e6 / drain_s,
               itl_ms_p50_on_a=itl_before,
               itl_ms_p50_on_b=float(np.median(b_gaps)),
               handoff_gap_ms_max=max(gaps),
               handoff_gap_ms_p50=float(np.median(gaps)),
               handoff_gap_ms=gaps)
    line("wire", **row)
    if not (all(full) and a_free and committed == len(prompts)):
        raise SystemExit(f"wire drain: {row}")
    return row


def _wire_prefix(model, cfg, smi) -> dict:
    """Phase 8's storm shape: B's tree warm on a 1024-token system prompt;
    4 streams of it + 64-token tails mid-decode on A, each handed to B by
    migrate_rid: only the uncached suffix crosses the wire."""
    from concurrent.futures import ThreadPoolExecutor

    from kubetpu_torch.router import ReplicaServer
    from kubetpu_torch.router.migration import encode_snapshot

    rng = np.random.default_rng(12)
    sys_prompt = rng.integers(1, cfg.vocab, 1024).tolist()
    prompts = [sys_prompt + rng.integers(1, cfg.vocab, 64).tolist()
               for _ in range(5)]
    kw = dict(prefix_cache_pages=128, n_pages=8 * 128 + 128)
    quiet = _serial(_wire_server(model, cfg), prompts[1:])
    a, b = _wire_server(model, cfg, **kw), _wire_server(model, cfg, **kw)
    rep_a = ReplicaServer(a, "wire-pa", idle_wait=0.002)
    rep_b = ReplicaServer(b, "wire-pb", idle_wait=0.002)
    hold = _Hold(rep_a, 4)
    rep_a.start()
    rep_b.start()
    code, body = _generate(rep_b.address, prompts[0], "prefix-warm")
    if code != 200:
        raise SystemExit(f"wire prefix: warming B answered {code}")
    with ThreadPoolExecutor(1) as pool:
        fut = pool.submit(_generate_all, rep_a.address, prompts[1:],
                          "prefix")
        hold.wait("wire prefix")
        with rep_a._cv:
            rids = a.migratable_rids()
            full = {r: len(encode_snapshot(
                {"pages": a.snapshot_slot(r)["pages"]})[1]) for r in rids}
        shipped, ms = {}, {}
        for r in rids:
            before = _counter(a, "kubetpu_migration_bytes_shipped_total")
            t0 = time.perf_counter()
            if not rep_a.migrate_rid(r, rep_b.address, reason="prefix"):
                raise SystemExit(f"wire prefix: stream {r} did not move")
            ms[r] = (time.perf_counter() - t0) * 1e3
            shipped[r] = _counter(
                a, "kubetpu_migration_bytes_shipped_total") - before
        answers = fut.result(timeout=600)
    tokens = _chase(rep_b, prompts[1:], "prefix", answers)
    remapped = [e["pages_remapped"]
                for e in b.events.events(kind="migrate_in")]
    with rep_b._cv:
        b.check_invariants()
    _stop(rep_a, rep_b)
    row = dict(arm="prefix", card=torch.cuda.get_device_name(0),
               nvidia_smi=smi, streams=len(rids),
               pages_remapped=remapped,
               mb_shipped=[shipped[r] / 1e6 for r in rids],
               mb_cold=[full[r] / 1e6 for r in rids],
               migrate_ms=[ms[r] for r in rids],
               tokens_equal_quiet=sum(t == q for t, q in zip(tokens, quiet)))
    line("wire", **row)
    if len(remapped) != 4 or min(remapped) < 64:
        raise SystemExit(f"wire prefix: remapped {remapped}, want >= 64 "
                         f"pages a stream")
    return row


def _wire_disagg(model, cfg, smi) -> dict:
    """A prefill replica and a decode replica: 4 prompts of 1024 tokens,
    posted serially with B as the decode target; A streams the completed
    spans while later chunks compute and hands off at the first token."""
    from kubetpu_torch.router import ReplicaServer

    rng = np.random.default_rng(13)
    prompts = [rng.integers(0, cfg.vocab, 1024).tolist() for _ in range(4)]
    quiet = _serial(_wire_server(model, cfg), prompts)
    a, b = _wire_server(model, cfg), _wire_server(model, cfg)
    a.warmup()
    sa, sb = _stamp(a), _stamp(b)
    rep_a = ReplicaServer(a, "wire-pre", role="prefill", idle_wait=0.002)
    rep_b = ReplicaServer(b, "wire-dec", role="decode", idle_wait=0.002)
    rep_a.start()
    rep_b.start()
    walls, tokens, first_b = [], [], []
    for i, p in enumerate(prompts):
        t0 = time.perf_counter()
        answer = _generate(rep_a.address, p, f"disagg{i}-0",
                           decode_target=rep_b.address,
                           decode_name=rep_b.name)
        tokens += _chase(rep_b, [p], f"disagg{i}", [answer])
        walls.append((time.perf_counter() - t0) * 1e3)
        first_b.append(
            (sb["emits"][answer[1]["migrated"]["rid"]][0] - t0) * 1e3)
    committed = _counter(a, "kubetpu_handoffs_total", result="committed")
    overlap = (rep_a._handoff_early_bytes / rep_a._handoff_bytes
               if rep_a._handoff_bytes else 0.0)
    ttft_a = [sa["ttft"][sa["rid"][tuple(p)]] * 1e3 for p in prompts]
    with rep_a._cv:
        a.check_invariants()
    with rep_b._cv:
        b.check_invariants()
    _stop(rep_a, rep_b)
    row = dict(arm="disagg", card=torch.cuda.get_device_name(0),
               nvidia_smi=smi, requests=len(prompts),
               handoffs_committed=int(committed),
               tokens_equal_quiet=tokens == quiet,
               handoff_overlap_frac=overlap,
               handoff_mb=rep_a._handoff_bytes / 1e6,
               ttft_ms_on_prefill=ttft_a,
               first_decode_token_ms_on_b=first_b, request_ms=walls)
    line("wire", **row)
    if tokens != quiet or committed != len(prompts):
        raise SystemExit(f"wire disagg: {row}")
    return row


def phase_wire(model, cfg, smi, launches) -> dict:
    """The port's main path through its own replica wire, at full width.
    The paged launch counters are zeroed just before and read just after,
    and added to *launches*; the phase's servers run the split, combine
    and wgmma chunk kernels (dense and int8), never SIMT."""
    from kubetpu_torch.ops import paged_attention as pa

    rng = np.random.default_rng(0)
    rng.integers(0, cfg.vocab, 40)        # phase 6's warm-up prompt's draw
    lengths = [128, 1024, 256, 896, 384, 768, 512, 640]
    prompts = [rng.integers(0, cfg.vocab, n).tolist() for n in lengths]
    torch.cuda.synchronize()
    for c in _PAGED_COUNTERS:
        setattr(pa.paged_attention, c, 0)
    t0 = time.perf_counter()
    few = prompts[:WIRE_STREAMS]
    quiet = _serial(_wire_server(model, cfg), few)
    rows = {"routed": _wire_routed(model, cfg, few, quiet, smi)}
    for arm, kw in (("fork_bf16", {}), ("fork_int8", {"kv_int8": True})):
        rows[arm] = _wire_fork(model, cfg, few, smi, arm, **kw)
    rows["drain"] = _wire_drain(model, cfg, few, quiet, smi)
    rows["prefix"] = _wire_prefix(model, cfg, smi)
    rows["disagg"] = _wire_disagg(model, cfg, smi)
    torch.cuda.synchronize()
    counts = {c: getattr(pa.paged_attention, c) for c in _PAGED_COUNTERS}
    for c, n in counts.items():
        launches[c] = launches.get(c, 0) + n
    rows.update(seconds=time.perf_counter() - t0, paged_launches=counts)
    line("wire_launches", seconds=rows["seconds"], **counts)
    if (counts["split_launches"] <= 0 or counts["wgmma_launches"] <= 0
            or counts["wgmma_int8_launches"] <= 0 or counts["simt_launches"]):
        raise SystemExit(f"wire: paged launches {counts}")
    return rows


# -- phase 15: the dense server and overlap ----------------------------------

SERVE_LENGTHS = [128, 1024, 256, 896, 384, 768, 512, 640]
DENSE_NEW = 32       # new tokens a request, phase 6's


def _serve_prompts(cfg) -> list:
    """Phase 6's prompts (after its warm-up prompt's draw)."""
    rng = np.random.default_rng(0)
    rng.integers(0, cfg.vocab, 40)
    return [rng.integers(0, cfg.vocab, n).tolist() for n in SERVE_LENGTHS]


class _SyncCounter:
    """Counts the calls that wait for the card — ``torch.cuda.synchronize``,
    an event's ``synchronize`` and a tensor's ``.item()``, ``.cpu()``,
    ``.tolist()`` — inside each of a server's dispatched steps
    (``_dispatch_step``) and routed steps (``_route_step``). ``close``
    restores everything it patched."""

    def __init__(self, server) -> None:
        self.counts = {"dispatch": [], "route": []}
        self._window = None
        self._saved = []
        for owner, name in ((torch.Tensor, "item"), (torch.Tensor, "cpu"),
                            (torch.Tensor, "tolist"),
                            (torch.cuda, "synchronize"),
                            (torch.cuda.Event, "synchronize")):
            self._patch(owner, name)
        for leg in ("dispatch", "route"):
            self._wrap(server, leg)

    def _patch(self, owner, name) -> None:
        fn = getattr(owner, name)

        def counted(*args, **kwargs):
            if self._window is not None:
                self.counts[self._window][-1] += 1
            return fn(*args, **kwargs)

        setattr(owner, name, counted)
        self._saved.append((owner, name, fn))

    def _wrap(self, server, leg) -> None:
        attr = f"_{leg}_step"
        fn = getattr(server, attr)

        def windowed(*args):
            self.counts[leg].append(0)
            self._window = leg
            try:
                return fn(*args)
            finally:
                self._window = None

        setattr(server, attr, windowed)
        self._saved.append((server, attr, None))

    def close(self) -> dict:
        for owner, name, fn in self._saved:
            if fn is None:
                delattr(owner, name)
            else:
                setattr(owner, name, fn)
        d, r = self.counts["dispatch"], self.counts["route"]
        return dict(dispatched=len(d), routed=len(r),
                    dispatch_syncs_max=max(d, default=0),
                    route_syncs=sorted(set(r)))


def _overlap_run(server, prompts, launches, adapters=None) -> dict:
    """Phase 6's staggered run (two prompts every four steps) on *server*,
    with the host-sync counter on and the paged counters zeroed before
    and read after (added to *launches*). Decode tokens/s and step wall
    time over the steps that ran no prefill chunk. *adapters*: each
    prompt's adapter on a multi-LoRA server."""
    from kubetpu_torch.ops import paged_attention as pa

    st = server._smoke_stats
    torch.cuda.synchronize()
    for c in _PAGED_COUNTERS:
        setattr(pa.paged_attention, c, 0)
    sync = _SyncCounter(server)
    rids, steps = [], 0
    pending = [(p, {} if adapters is None else {"adapter": a})
               for p, a in zip(prompts, adapters or [None] * len(prompts))]
    decode_s, decode_tokens, decode_steps = 0.0, 0, 0
    t_start = time.perf_counter()
    try:
        while pending or not server._idle():
            if pending and steps % 4 == 0:
                rids += [server.enqueue(p, **kw) for p, kw in pending[:2]]
                pending = pending[2:]
            chunks = st["chunks"]
            t0 = time.perf_counter()
            out = server.step()
            dt = time.perf_counter() - t0
            if st["chunks"] == chunks and out:
                decode_s += dt
                decode_tokens += sum(len(v) for v in out.values())
                decode_steps += 1
            steps += 1
            if steps > 10_000:
                raise SystemExit("dense: did not converge")
    finally:
        syncs = sync.close()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_start
    counts = {c: getattr(pa.paged_attention, c) for c in _PAGED_COUNTERS}
    for c, n in counts.items():
        launches[c] = launches.get(c, 0) + n
    results = [server.pop_result(r) for r in rids]
    return dict(results=results, wall_s=wall, steps=steps,
                decode_steps=decode_steps,
                decode_toks_s=decode_tokens / decode_s if decode_s else None,
                decode_step_ms=decode_s / decode_steps * 1e3
                if decode_steps else None,
                syncs=syncs, paged_launches=counts)


def phase_dense(model, cfg, smi, launches) -> dict:
    """Phase 6's flagship, prompts and settings behind ``DecodeServer``
    (bf16 and int8 caches) and behind ``PagedDecodeServer``, each with
    ``overlap`` off and on: decode tokens/s, step wall time and one
    profiled window of ten steps (device busy time, idle share); then the
    paged pair again twice each, alternated. Gates:
    overlap's tokens equal the pipeline-off tokens exactly on every
    server; the dense first-token logits within LOGIT_TOL of the paged
    server's; the host-sync counter reads 0 inside every dispatched step
    and 1 in every routed step."""
    from kubetpu_torch.jobs.paged import PagedDecodeServer
    from kubetpu_torch.jobs.serving import DecodeServer

    prompts = _serve_prompts(cfg)
    arms = (("dense", DecodeServer, {}),
            ("dense_int8", DecodeServer, {"kv_int8": True}),
            ("paged", PagedDecodeServer, {"page_size": 16}))
    rows, runs, first, paged = {}, {}, {}, {}
    t_phase = time.perf_counter()
    for name, cls, kw in arms:
        for overlap in (False, True):
            arm = f"{name}_overlap" if overlap else name
            server = cls(cfg, model, n_slots=8, max_seq=2048,
                         max_new_tokens=DENSE_NEW, prefill_budget=256,
                         overlap=overlap, device="cuda", **kw)
            server.warmup()
            server._smoke_stats = _instrument(server)
            run = _overlap_run(server, prompts, launches)
            prof = _ten_step_profile(server)
            runs[arm] = run["results"]
            first[arm] = server._smoke_stats["first_logits"]
            row = dict(arm=arm, card=torch.cuda.get_device_name(0),
                       nvidia_smi=smi, overlap=overlap,
                       requests=len(prompts), new_tokens=DENSE_NEW,
                       **{k: v for k, v in run.items() if k != "results"},
                       profile=prof)
            line("dense", **row)
            rows[arm] = row
            if cls is PagedDecodeServer:
                server.check_invariants()
                paged[overlap] = server
            del server
            torch.cuda.empty_cache()
    # the paged server's decode tokens/s with overlap off and on, run
    # again in alternation (off, on, on, off) on the same two servers: the
    # host's noise between arms is as large as the effect
    alt = {False: [], True: []}
    for overlap in (False, True, True, False):
        run = _overlap_run(paged[overlap], prompts, launches)
        if run["results"] != runs["paged"]:
            raise SystemExit("dense: an alternation run's tokens differ")
        alt[overlap].append(run["decode_toks_s"])
    rows["paged_alternation"] = dict(
        off=alt[False], on=alt[True],
        median_off=float(np.median(alt[False])),
        median_on=float(np.median(alt[True])))
    line("dense_alternation", card=torch.cuda.get_device_name(0),
         nvidia_smi=smi, **rows["paged_alternation"])
    del paged
    torch.cuda.empty_cache()
    gaps = {arm: _logit_gap(first[arm], first["paged"], prompts)
            for arm in ("dense", "dense_int8")}
    equal = {name: runs[name] == runs[f"{name}_overlap"]
             for name, _, _ in arms}
    syncs_ok = all(
        r["syncs"]["dispatch_syncs_max"] == 0
        and r["syncs"]["route_syncs"] == [1]
        and r["syncs"]["routed"] == r["syncs"]["dispatched"]
        for arm, r in rows.items() if arm != "paged_alternation")
    # the dense path runs no paged kernel; the paged arms decode on the
    # split route and prefill on the wgmma route
    launches_ok = all(
        (sum(r["paged_launches"].values()) == 0) if arm.startswith("dense")
        else (r["paged_launches"]["split_launches"] > 0
              and r["paged_launches"]["wgmma_launches"] > 0)
        for arm, r in rows.items() if arm != "paged_alternation")
    summary = dict(tokens_equal_overlap=equal, first_logit_gap=gaps,
                   logit_tol=LOGIT_TOL, syncs_ok=syncs_ok,
                   launches_ok=launches_ok,
                   seconds=time.perf_counter() - t_phase)
    line("dense_gates", **summary)
    if (not all(equal.values()) or max(gaps.values()) > LOGIT_TOL
            or not syncs_ok or not launches_ok):
        raise SystemExit(f"dense: {summary}")
    rows["gates"] = summary
    return rows


# -- phase 16: speculative decoding on the paged server ----------------------

# new tokens a request (64 until phase 38 came): the first from the
# prefill, then 45 = 9 full rounds at gamma_max 4, so a self draft that
# accepts everything reads 5.0 tokens a round and one rejection 4.5
SPEC_NEW = 46
GAMMA_MAX = 4


def _record_top2(server) -> dict:
    """Keep the top two logits of every row the server samples, keyed by
    (prompt, index of the emitted token): the near-tie rule of phase 16
    reads them. Returns a dict filled as the server runs (device tensors;
    ``_top2_gaps`` reads them back)."""
    rec = {"keys": [], "top2": []}
    sampler, chunk_leg = server._sampler, server._prefill_chunk_device
    ctx = {}

    def chunk(prompt, slot, pos, take, final):
        ctx["prompt"] = tuple(prompt)
        return chunk_leg(prompt, slot, pos, take, final)

    def spy(r, *args):
        if r.dim() == 1:
            rec["keys"].append([(ctx["prompt"], 0)])
        else:
            keys = []
            for s in range(server.n_slots):
                rid = server._slot_rid[s]
                if not server.active[s] or rid is None:
                    keys.append(None)
                    continue
                idx = (len(server._emitted[rid])
                       + int(s in server._pending_first))
                keys.append((tuple(server._prompts[rid]), idx))
            rec["keys"].append(keys)
        rec["top2"].append(torch.topk(r.float(), 2, dim=-1).values
                           .reshape(-1, 2))
        return sampler(r, *args)

    server._sampler = spy
    server._prefill_chunk_device = chunk
    return rec


def _top2_gaps(rec) -> dict:
    """{(prompt, index): top-1 minus top-2 logit} from ``_record_top2``."""
    gaps = {}
    host = torch.cat(rec["top2"]).cpu().numpy()
    i = 0
    for keys in rec["keys"]:
        for key in keys:
            if key is not None:
                gaps[key] = float(host[i, 0] - host[i, 1])
            i += 1
    return gaps


def _near_tie_check(spec_out, plain_out, gaps, prompts) -> dict:
    """Phase 16's rule: speculative tokens equal the plain server's, except
    that the first divergence of a request, if any, may fall where the
    plain run's top two logits lie within LOGIT_TOL."""
    diverged, bad = [], []
    for p, a, b in zip(prompts, spec_out, plain_out):
        if a == b:
            continue
        n = len(p)
        j = next((i for i, (x, y) in enumerate(zip(a[n:], b[n:]))
                  if x != y), min(len(a), len(b)) - n)
        gap = gaps.get((tuple(p), j))
        diverged.append({"prompt_len": n, "index": j, "gap": gap})
        if gap is None or gap > LOGIT_TOL:
            bad.append(diverged[-1])
    return {"diverged": diverged, "bad": bad}


def _instrument_spec(server) -> dict:
    """Count the speculative server's rounds by gamma (the round's T is
    gamma + 1) and its prefill chunks, by wrapping its legs."""
    st = {"rounds_by_gamma": {}, "chunks": 0}
    round_leg, chunk_leg = server._device_round, server._prefill_chunk_device

    def counted_round(gamma, active):
        st["rounds_by_gamma"][gamma] = st["rounds_by_gamma"].get(gamma, 0) + 1
        return round_leg(gamma, active)

    def counted_chunk(*args):
        res = chunk_leg(*args)
        if res is not None:
            st["chunks"] += 1
        return res

    server._device_round = counted_round
    server._prefill_chunk_device = counted_chunk
    return st


def _expected_spec_launches(cfg, st, int8) -> dict:
    """The paged launches phase 16's arm must show, one call a layer: every
    prefill chunk (T >= 16) and every verify chunk (T = gamma + 1) on the
    route ``_route`` takes for it (the wgmma route's int8 instance over an
    int8 pool; "rows" counts as split launches)."""
    from kubetpu_torch.ops import paged_attention as pa

    wgmma = "wgmma_int8_launches" if int8 else "wgmma_launches"
    counter = {"wgmma": wgmma, "rows": "split_launches",
               "simt": "simt_launches"}
    want = {wgmma: 0, "split_launches": 0, "simt_launches": 0}
    q = torch.empty((1, 1, cfg.n_heads, cfg.head_dim), dtype=cfg.dtype,
                    device="meta")
    kv = torch.empty((1, 16, cfg.kv_heads, cfg.head_dim), device="meta",
                     dtype=torch.int8 if int8 else cfg.dtype)
    pool = (kv, kv) if int8 else kv
    want[counter[pa._route(q, pool, 256, 0)]] += st["chunks"]
    for gamma, n in st["rounds_by_gamma"].items():
        want[counter[pa._route(q, pool, gamma + 1, 0)]] += n
    return {k: v * cfg.n_layers for k, v in want.items()}


def _spec_round_profile(server, prompts) -> dict:
    """torch.profiler over one round of eight active slots: the round's
    wall and device busy time, its idle share, and the device time under
    the draft's proposal and under the verify chunk (record_function
    ranges around the two)."""
    from kubetpu_torch.jobs import spec_serving

    for p in prompts:
        server.enqueue(p)
    while server._queue or server._prefills:
        server.step()
    server.step()
    saved = (spec_serving.draft_propose, spec_serving.paged_forward_chunk)

    def ranged(label, fn):
        def run(*args, **kwargs):
            with torch.profiler.record_function(label):
                return fn(*args, **kwargs)
        return run

    spec_serving.draft_propose = ranged("spec_draft", saved[0])
    spec_serving.paged_forward_chunk = ranged("spec_verify", saved[1])
    try:
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            server.step()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    finally:
        spec_serving.draft_propose, spec_serving.paged_forward_chunk = saved
    # the ranges appear twice: as host events whose device total sums the
    # kernels they launched (read here), and as device-side annotations
    # spanning those kernels (left out of the busy sum)
    busy, ranges = 0.0, {}
    for ev in prof.key_averages():
        if ev.key in ("spec_draft", "spec_verify"):
            if ev.device_type != DeviceType.CUDA:
                ranges[ev.key] = getattr(ev, "device_time_total",
                                         getattr(ev, "cuda_time_total", 0.0))
        elif ev.device_type == DeviceType.CUDA:
            busy += getattr(ev, "self_device_time_total",
                            getattr(ev, "self_cuda_time_total", 0.0))
    server.drain()
    return dict(round_ms=wall_us / 1e3, device_busy_ms=busy / 1e3,
                idle_share=(1.0 - busy / wall_us) if busy else None,
                draft_device_ms=ranges.get("spec_draft", 0.0) / 1e3 or None,
                verify_device_ms=ranges.get("spec_verify", 0.0) / 1e3
                or None)


def _spec_small_f32() -> dict:
    """Phase 5's small f32 model (and a one-layer f32 draft) on the CPU and
    on the card, f32 and int8 pools: the speculative server's tokens equal
    the plain server's exactly, and the card's equal the CPU's."""
    from kubetpu_torch.jobs import model as model_lib
    from kubetpu_torch.jobs.paged import PagedDecodeServer
    from kubetpu_torch.jobs.spec_serving import PagedSpeculativeDecodeServer

    cfg = model_lib.ModelConfig(vocab=512, d_model=256, n_layers=2,
                                n_heads=4, n_kv_heads=2, d_ff=512,
                                max_seq=256)
    dcfg = model_lib.ModelConfig(vocab=512, d_model=64, n_layers=1,
                                 n_heads=2, d_ff=128, max_seq=256)
    target = model_lib.init_params(torch.Generator().manual_seed(7), cfg,
                                   device="cpu")
    draft = model_lib.init_params(torch.Generator().manual_seed(8), dcfg,
                                  device="cpu")
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab, n).tolist() for n in (5, 40, 23,
                                                                 70)]
    out = {}
    for dev in ("cpu", "cuda"):
        t = copy.deepcopy(target).to(dev)
        d = copy.deepcopy(draft).to(dev)
        for kv_int8 in (False, True):
            kw = dict(n_slots=3, max_seq=256, max_new_tokens=16,
                      page_size=16, prefill_budget=32, kv_int8=kv_int8,
                      device=dev)
            for kind, server in (
                    ("plain", PagedDecodeServer(cfg, t, **kw)),
                    ("spec", PagedSpeculativeDecodeServer(
                        cfg, dcfg, t, d, gamma_max=GAMMA_MAX, **kw))):
                rids = [server.enqueue(prompts[0])]
                server.step()
                rids += [server.enqueue(p) for p in prompts[1:]]
                server.drain()
                server.check_invariants()
                out[(dev, kv_int8, kind)] = [server.result(r) for r in rids]
    ref = {k: out[("cpu", k, "plain")] for k in (False, True)}
    equal = {f"{dev}_{'int8' if k else 'f32'}_{kind}": v == ref[k]
             for (dev, k, kind), v in out.items()}
    return {"equal_to_cpu_plain": equal, "ok": all(equal.values())}


def _spec_plain(model, cfg, prompts, smi, int8, kw) -> dict:
    """The plain paged server over the spec arms' pool, prompts and
    settings: its tokens, the top-two gaps of every row it sampled, and
    its tokens/s."""
    from kubetpu_torch.jobs.paged import PagedDecodeServer

    server = PagedDecodeServer(cfg, model, kv_int8=int8, **kw)
    server.warmup()
    rec = _record_top2(server)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rids = [server.enqueue(p) for p in prompts]
    server.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    server.check_invariants()
    out = dict(results=[server.pop_result(r) for r in rids],
               gaps=_top2_gaps(rec), toks_s=len(prompts) * SPEC_NEW / wall,
               wall_s=wall)
    line("spec_plain", pool="int8" if int8 else "bf16",
         card=torch.cuda.get_device_name(0), nvidia_smi=smi,
         toks_s=out["toks_s"], wall_s=wall)
    return out


def _spec_arm(arm, model, cfg, dcfg, draft, int8, kw, prompts, plain, smi,
              launches) -> dict:
    """One speculative arm: warmup, the counted run (paged counters zeroed
    before and read after, added to *launches*), the pool oracle, the
    near-tie rule against *plain*, and one profiled round. Raises on a
    launch count or a divergence the rule does not allow."""
    from kubetpu_torch.jobs.spec_serving import PagedSpeculativeDecodeServer
    from kubetpu_torch.ops import paged_attention as pa

    server = PagedSpeculativeDecodeServer(
        cfg, dcfg, model, draft, kv_int8=int8, gamma_max=GAMMA_MAX,
        adaptive_gamma=True, **kw)
    server.warmup()
    st = _instrument_spec(server)
    torch.cuda.synchronize()
    for c in _PAGED_COUNTERS:
        setattr(pa.paged_attention, c, 0)
    t0 = time.perf_counter()
    rids = [server.enqueue(p) for p in prompts]
    steps = 0
    while not server._idle():
        server.step()
        steps += 1
        if steps > 10_000:
            raise SystemExit(f"spec {arm}: did not converge")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {c: getattr(pa.paged_attention, c) for c in _PAGED_COUNTERS}
    server.check_invariants()
    for c, n in counts.items():
        launches[c] = launches.get(c, 0) + n
    results = [server.pop_result(r) for r in rids]
    want = _expected_spec_launches(cfg, st, int8)
    ties = _near_tie_check(results, plain["results"], plain["gaps"], prompts)
    proposed = server._c_spec_proposed.value
    row = dict(arm=arm, card=torch.cuda.get_device_name(0), nvidia_smi=smi,
               requests=len(prompts), new_tokens=SPEC_NEW,
               gamma_max=GAMMA_MAX, toks_s=len(prompts) * SPEC_NEW / wall,
               plain_toks_s=plain["toks_s"], wall_s=wall,
               rounds=int(server._c_spec_rounds.value),
               mean_tokens_per_round=server.mean_tokens_per_round(),
               accepted_share=(server._c_spec_accepted.value / proposed
                               if proposed else None),
               gamma_histogram=st["rounds_by_gamma"],
               slot_gammas=server.slot_gammas(),
               prefill_chunks=st["chunks"],
               ttft_p50_ms=server.metrics_summary()["ttft"]["p50_ms"],
               paged_launches=counts, expected_launches=want,
               tokens_equal_plain=sum(a == b for a, b in zip(
                   results, plain["results"])),
               diverged=ties["diverged"])
    row["profile"] = _spec_round_profile(server, [p[:256] for p in prompts])
    line("spec", **row)
    del server
    torch.cuda.empty_cache()
    if any(counts[k] != v for k, v in want.items()):
        raise SystemExit(f"spec {arm}: paged launches {counts}, expected "
                         f"{want}")
    if ties["bad"]:
        raise SystemExit(f"spec {arm}: tokens diverge from the plain server "
                         f"away from a near-tie: {ties['bad']}")
    return row


def phase_spec(model, cfg, smi, launches) -> dict:
    """``PagedSpeculativeDecodeServer`` with the flagship as target and two
    drafts: "quarter" (d 512, 3 layers, 4 heads, d_ff 1408, random from
    seed 7: the acceptance floor) and "self" (the target: the ceiling),
    each over bf16 and int8 pools, gamma_max 4 with adaptive gamma, phase
    6's prompts with SPEC_NEW new tokens each; then the self draft once more
    with the flagship's weights in f32 over an f32 pool. Beside each the
    plain ``PagedDecodeServer`` over the same pool and prompts.

    Gates: the pool oracle after every drain; the paged counters (zeroed
    before, read after) show every prefill and verify chunk on the route
    ``_route`` takes for it; greedy tokens equal the plain server's up to
    near-ties — the first divergence of a request, if any, must fall where
    the plain run's top two logits lie within LOGIT_TOL; the f32 self
    draft's mean tokens per round at least 0.9 * (gamma_max + 1); and, on
    phase 5's small f32 model, speculative tokens equal plain tokens
    exactly, on the card and on the CPU.

    Why the ceiling is gated at f32: the draft runs the dense cache's plain
    attention (f32 weights of each key, as the JAX package's dense path)
    and the verify the paged kernels; at bf16 the random flagship's top
    two logits tie within rounding on a few percent of positions, and
    there the two orders of summation pick different tokens, so the bf16
    self draft accepts ~0.88-0.96 of its proposals from run to run (its
    rate is recorded). In f32 the two agree but for ties below 1e-5."""
    from kubetpu_torch.jobs import model as model_lib

    t_phase = time.perf_counter()
    prompts = _serve_prompts(cfg)
    kw = dict(n_slots=8, max_seq=2048, max_new_tokens=SPEC_NEW,
              page_size=16, prefill_budget=256, device="cuda")
    plain = {int8: _spec_plain(model, cfg, prompts, smi, int8, kw)
             for int8 in (False, True)}
    qcfg = model_lib.ModelConfig(vocab=cfg.vocab, d_model=512, n_layers=3,
                                 n_heads=4, d_ff=1408, max_seq=2048,
                                 dtype=torch.bfloat16)
    quarter = model_lib.init_params(
        torch.Generator(device="cuda").manual_seed(7), qcfg, device="cuda")
    rows = {}
    for dname, (dcfg, draft) in (("quarter", (qcfg, quarter)),
                                 ("self", (cfg, model))):
        for int8 in (False, True):
            arm = f"{dname}_{'int8' if int8 else 'bf16'}"
            rows[arm] = _spec_arm(arm, model, cfg, dcfg, draft, int8, kw,
                                  prompts, plain[int8], smi, launches)
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    model32 = copy.deepcopy(model).float()
    plain32 = _spec_plain(model32, cfg32, prompts, smi, False, kw)
    rows["self_f32"] = _spec_arm("self_f32", model32, cfg32, cfg32, model32,
                                 False, kw, prompts, plain32, smi, launches)
    del model32
    torch.cuda.empty_cache()
    floor = 0.9 * (GAMMA_MAX + 1)
    ceiling = rows["self_f32"]["mean_tokens_per_round"]
    small = _spec_small_f32()
    line("spec_f32", **small)
    rows["small_f32"] = small
    rows["seconds"] = time.perf_counter() - t_phase
    line("spec_gates", self_f32_mean_tokens_per_round=ceiling, floor=floor,
         self_bf16=rows["self_bf16"]["mean_tokens_per_round"],
         self_int8=rows["self_int8"]["mean_tokens_per_round"],
         small_f32_ok=small["ok"], seconds=rows["seconds"])
    if ceiling < floor:
        raise SystemExit(f"spec: self-draft mean tokens per round "
                         f"{ceiling} < {floor}")
    if not small["ok"]:
        raise SystemExit(f"spec f32: tokens differ: {small}")
    return rows


# -- phase 17: multi-LoRA serving on the paged server ------------------------

ML_RESIDENT = 64     # resident adapters (scripts/bench_gate.py:503-510)
ML_NEW = 32          # new tokens a request, phase 6's
ML_TENANTS = [9 * i for i in range(8)]    # one adapter a prompt, 0 .. 63


def _tenant_adapters(cfg, lcfg, seeds):
    """``bench_model.py:1607-1615``'s tenant adapters on the card in the
    model's dtype: the init's A (seed 500 + t) and B drawn N(0, 0.05)
    (seed 900 + t)."""
    from kubetpu_torch.jobs.lora import init_lora_params

    out = []
    for t in seeds:
        a = init_lora_params(torch.Generator(device="cuda").manual_seed(
            500 + t), cfg, lcfg, device="cuda")
        gen = torch.Generator(device="cuda").manual_seed(900 + t)
        for tgt in lcfg.targets:
            b = a["blocks"][f"{tgt}_b"]
            a["blocks"][f"{tgt}_b"] = (torch.randn(
                b.shape, generator=gen, device="cuda") * 0.05).to(cfg.dtype)
        out.append(a)
    return out


class _LoraRanges:
    """``record_function`` ranges around the per-slot factor gather
    ("lora_gather") and the delta einsums ("lora_delta") of the decode
    legs while open; ``close`` restores the functions."""

    LABELS = ("lora_gather", "lora_delta")

    def __init__(self) -> None:
        from kubetpu_torch.jobs import decode, paged

        self._saved = [(paged, "select_lora", "lora_gather"),
                       (decode, "_lora_in", "lora_delta"),
                       (decode, "_lora_out", "lora_delta")]
        self._saved = [(mod, name, label, getattr(mod, name))
                       for mod, name, label in self._saved]
        for mod, name, label, fn in self._saved:
            setattr(mod, name, self._ranged(label, fn))

    @staticmethod
    def _ranged(label, fn):
        def run(*args, **kwargs):
            with torch.profiler.record_function(label):
                return fn(*args, **kwargs)
        return run

    def close(self) -> None:
        for mod, name, _label, fn in self._saved:
            setattr(mod, name, fn)


def _ml_server(model, cfg, lcfg, ads, **kw):
    """A packed multi-LoRA flagship server with phase 6's settings."""
    from kubetpu_torch.jobs.multi_lora import PagedMultiLoraDecodeServer

    return PagedMultiLoraDecodeServer(
        cfg, model, lcfg, ads, n_slots=8, max_seq=2048,
        max_new_tokens=ML_NEW, page_size=16, prefill_budget=256,
        device="cuda", **kw)


def _ml_arm(arm, server, prompts, adapters, smi, launches,
            top2=False, profile=False) -> dict:
    """One serving arm of phase 17 on a warmed-up *server*: phase 6's
    staggered run with the host-sync counter (``_overlap_run``), the
    paged launches checked against the legs that ran, the pool and
    directory oracles, and optionally the top-two logits of every row
    (the near-tie rule's input) and a profiled window of ten steps."""
    st = _instrument(server)
    server._smoke_stats = st
    rec = _record_top2(server) if top2 else None
    run = _overlap_run(server, prompts, launches, adapters)
    server.check_invariants()
    n_dec, n_chunk = (server.cfg.n_layers * st[k] for k in ("steps",
                                                            "chunks"))
    wgmma = ("wgmma_int8_launches" if server.kv_int8 else "wgmma_launches")
    counts = run["paged_launches"]
    launches_ok = (n_dec > 0 and counts["split_launches"] == n_dec
                   and counts[wgmma] == n_chunk
                   and counts["simt_launches"] == 0)
    syncs = run["syncs"]
    ttft = server.metrics_summary()["ttft"]
    row = dict(arm=arm, card=torch.cuda.get_device_name(0), nvidia_smi=smi,
               overlap=server.overlap, kv_int8=server.kv_int8,
               requests=len(prompts), new_tokens=ML_NEW,
               toks_s=len(prompts) * ML_NEW / run["wall_s"],
               **{k: v for k, v in run.items() if k != "results"},
               ttft_p50_ms=ttft["p50_ms"], ttft_p99_ms=ttft["p99_ms"],
               launches_ok=launches_ok,
               syncs_ok=(syncs["dispatch_syncs_max"] == 0
                         and syncs["route_syncs"] == [1]
                         and syncs["routed"] == syncs["dispatched"]))
    if hasattr(server, "lora_stack"):
        row.update(resident_adapters=len(server.resident_adapters()),
                   adapter_capacity=server.n_adapters,
                   stack_bytes=server._adapter_bytes_each
                   * server.n_adapters)
    out = dict(row=row, results=run["results"])
    if rec is not None:
        out["gaps"] = _top2_gaps(rec)
    if profile:
        row["profile"] = _ten_step_profile(server)
    line("multilora", **row)
    return out


def _ml_alternation(servers, prompts, first, smi, launches) -> dict:
    """The plain and the packed server's staggered runs again, alternated
    (plain, packed, packed, plain): one pair a run sits inside the host's
    noise. *servers*: {arm: (server, adapters)}; each
    run's tokens must repeat *first*[arm]. Decode tokens/s of every run
    and the medians' ratio."""
    alt = {"plain": [], "packed": []}
    for arm in ("plain", "packed", "packed", "plain"):
        server, adapters = servers[arm]
        run = _overlap_run(server, prompts, launches, adapters)
        if run["results"] != first[arm]:
            raise SystemExit(f"multilora: an alternation run of {arm} "
                             f"changed its tokens")
        alt[arm].append(run["decode_toks_s"])
    med = {arm: float(np.median(v)) for arm, v in alt.items()}
    row = dict(card=torch.cuda.get_device_name(0), nvidia_smi=smi,
               plain=alt["plain"], packed=alt["packed"],
               median_plain=med["plain"], median_packed=med["packed"],
               packed_over_plain=med["packed"] / med["plain"])
    line("multilora_alternation", **row)
    return row


def _ml_prefix(model, cfg, lcfg, ads, prompt) -> list:
    """Prefix isolation on a packed server with the tree on: *prompt* under
    one tenant, replayed under it (a hit), then under another tenant (a
    miss) -> the hit count after each of the three."""
    server = _ml_server(model, cfg, lcfg, ads, prefix_cache_pages=256)
    hits = []
    for aid in (ML_TENANTS[-1], ML_TENANTS[-1], ML_TENANTS[0]):
        rid = server.enqueue(prompt, adapter=aid)
        server.drain()
        server.pop_result(rid)
        hits.append(server.prefix_cache_stats()["requests_hit"])
    server.check_invariants()
    del server
    torch.cuda.empty_cache()
    return hits


def _ml_merged(model, cfg, lcfg, ads, prompts, smi, launches,
               kv_int8=False) -> dict:
    """The per-tenant arm of the reference storm: each prompt alone on its
    own ``PagedDecodeServer`` over its tenant's merged weights
    (``merge_lora``), at n_slots=1, in turn, over a bf16 or an int8 pool.
    Tokens, the top-two gaps of every row it sampled, and the tokens/s of
    the whole arm."""
    from kubetpu_torch.jobs.lora import merge_lora
    from kubetpu_torch.jobs.paged import PagedDecodeServer
    from kubetpu_torch.ops import paged_attention as pa

    results, gaps, ttft, wall = [], {}, [], 0.0
    for p, aid in zip(prompts, ML_TENANTS):
        merged = merge_lora(model, ads[aid], lcfg)
        server = PagedDecodeServer(cfg, merged, n_slots=1, max_seq=2048,
                                   max_new_tokens=ML_NEW, page_size=16,
                                   n_pages=2048 // 16, prefill_budget=256,
                                   kv_int8=kv_int8, device="cuda")
        rec = _record_top2(server)
        torch.cuda.synchronize()
        for c in _PAGED_COUNTERS:
            setattr(pa.paged_attention, c, 0)
        t0 = time.perf_counter()
        rid = server.enqueue(p)
        server.drain()
        torch.cuda.synchronize()
        wall += time.perf_counter() - t0
        for c in _PAGED_COUNTERS:
            launches[c] = launches.get(c, 0) + getattr(pa.paged_attention, c)
        server.check_invariants()
        results.append(server.pop_result(rid))
        gaps.update(_top2_gaps(rec))
        ttft.append(server.metrics_summary()["ttft"]["p50_ms"])
        del server, merged
        torch.cuda.empty_cache()
    row = dict(arm="merged_per_tenant" + ("_int8" if kv_int8 else ""),
               card=torch.cuda.get_device_name(0), kv_int8=kv_int8,
               nvidia_smi=smi, servers=len(prompts), n_slots=1,
               toks_s=len(prompts) * ML_NEW / wall, wall_s=wall,
               ttft_p50_ms=float(np.median(ttft)))
    line("multilora", **row)
    return dict(row=row, results=results, gaps=gaps)


def _ml_spec(model, cfg, lcfg, ads, prompts, smi, launches) -> dict:
    """``SpecMultiLoraDecodeServer`` with phase 16's quarter draft over a
    bf16 pool, the eight tenants at once: tokens, tokens/s, tokens a
    round, the paged launches (every prefill and verify chunk on the route
    ``_route`` takes for it)."""
    from kubetpu_torch.jobs import model as model_lib
    from kubetpu_torch.jobs.multi_lora import SpecMultiLoraDecodeServer
    from kubetpu_torch.ops import paged_attention as pa

    qcfg = model_lib.ModelConfig(vocab=cfg.vocab, d_model=512, n_layers=3,
                                 n_heads=4, d_ff=1408, max_seq=2048,
                                 dtype=torch.bfloat16)
    quarter = model_lib.init_params(
        torch.Generator(device="cuda").manual_seed(7), qcfg, device="cuda")
    server = SpecMultiLoraDecodeServer(
        cfg, qcfg, model, quarter, lcfg, ads, n_slots=8, max_seq=2048,
        max_new_tokens=ML_NEW, page_size=16, prefill_budget=256,
        gamma_max=GAMMA_MAX, device="cuda")
    server.warmup()
    st = _instrument_spec(server)
    torch.cuda.synchronize()
    for c in _PAGED_COUNTERS:
        setattr(pa.paged_attention, c, 0)
    t0 = time.perf_counter()
    rids = [server.enqueue(p, adapter=a) for p, a in zip(prompts,
                                                         ML_TENANTS)]
    server.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {c: getattr(pa.paged_attention, c) for c in _PAGED_COUNTERS}
    for c, n in counts.items():
        launches[c] = launches.get(c, 0) + n
    server.check_invariants()
    results = [server.pop_result(r) for r in rids]
    want = _expected_spec_launches(cfg, st, False)
    row = dict(arm="spec_quarter", card=torch.cuda.get_device_name(0),
               nvidia_smi=smi, toks_s=len(prompts) * ML_NEW / wall,
               wall_s=wall, rounds=int(server._c_spec_rounds.value),
               mean_tokens_per_round=server.mean_tokens_per_round(),
               ttft_p50_ms=server.metrics_summary()["ttft"]["p50_ms"],
               paged_launches=counts, expected_launches=want,
               launches_ok=all(counts[k] == v for k, v in want.items()))
    line("multilora", **row)
    del server, quarter
    torch.cuda.empty_cache()
    return dict(row=row, results=results)


def _ml_wire(model, cfg, lcfg, ads, extra, prompt, smi) -> dict:
    """Hot load and evict on the wire: a packed replica (64 resident
    adapters, full) and a plain one in this process. An
    ``AdapterRegistry`` pushes a 65th adapter (the LRU index is evicted),
    the same load replayed under its key is a no-op, a routed generate
    names it and equals the in-process run, its evict is refused 409
    while a request holds it, and the plain replica answers 404. The hot
    load's time over the wire and in process."""
    import urllib.error

    from kubetpu_torch.jobs.paged import PagedDecodeServer
    from kubetpu_torch.router import ReplicaServer
    from kubetpu_torch.router.adapters import AdapterRegistry
    from kubetpu_torch.wire.httpcommon import request_json

    a = _ml_server(model, cfg, lcfg, ads)
    b = PagedDecodeServer(cfg, model, n_slots=8, max_seq=2048,
                          max_new_tokens=ML_NEW, page_size=16,
                          prefill_budget=256, device="cuda")
    a.warmup()
    reps = [ReplicaServer(a, "ml-a", idle_wait=0.002),
            ReplicaServer(b, "ml-b", idle_wait=0.002)]
    for rep in reps:
        rep.start()
    try:
        reg = AdapterRegistry()
        name = reg.register(extra[0])
        victim = a._adapter_names[min(range(a.n_adapters),
                                      key=a._adapter_lru.__getitem__)]
        loads = a.obs.counter("kubetpu_adapter_loads_total")
        t0 = time.perf_counter()
        payload = {"action": "load", "name": name,
                   "adapter": reg.encoded(name)}
        first = request_json(reps[0].address + "/adapters", payload,
                             idempotency_key="ml-load", timeout=600)
        push_ms = (time.perf_counter() - t0) * 1e3
        replay = request_json(reps[0].address + "/adapters", payload,
                              idempotency_key="ml-load", timeout=600)
        again = reg.push_adapter(reps[0].address, name, timeout=600)
        with reps[0]._cv:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            other = a.load_adapter(extra[1])
            torch.cuda.synchronize()
            load_ms = (time.perf_counter() - t0) * 1e3
            a.evict_adapter(other)
        code, body = _generate(reps[0].address, prompt, "ml-gen",
                               adapter=name)
        with reps[0]._cv:
            rid = a.enqueue(prompt, adapter=name)
        try:
            reg.evict_adapter(reps[0].address, name, timeout=600)
            evict_code = 200
        except urllib.error.HTTPError as e:
            evict_code = e.code
        while True:
            with reps[0]._cv:
                if a.finished(rid):
                    inproc = a.pop_result(rid)
                    break
            time.sleep(0.01)
        evicted = reg.evict_adapter(reps[0].address, name,
                                    timeout=600)["evicted"]
        try:
            reg.push_adapter(reps[1].address, name, timeout=600)
            plain_code = 200
        except urllib.error.HTTPError as e:
            plain_code = e.code
        with reps[0]._cv:
            a.check_invariants()
            resident = len(a.resident_adapters())
    finally:
        _stop(*reps)
    row = dict(arm="wire", card=torch.cuda.get_device_name(0),
               nvidia_smi=smi, push_ms=push_ms, load_in_process_ms=load_ms,
               loaded=name in first["resident"],
               victim_evicted=victim not in first["resident"],
               resident_after_load=len(first["resident"]),
               replay_equal=replay == first,
               loads_counted=int(loads.value), again_resident=name in
               again["resident"], generate_code=code,
               routed_equal_in_process=code == 200
               and body["tokens"] == inproc,
               evict_in_use_code=evict_code, evicted_after=evicted,
               plain_replica_code=plain_code, resident_at_end=resident)
    line("multilora", **row)
    ok = (row["loaded"] and row["victim_evicted"]
          and row["resident_after_load"] == ML_RESIDENT
          and row["replay_equal"] and row["again_resident"]
          and row["loads_counted"] == 2 and row["routed_equal_in_process"]
          and evict_code == 409 and evicted is True and plain_code == 404)
    return dict(row=row, ok=ok)


def _ml_small_f32() -> dict:
    """Phase 5's small f32 model with three adapters on the CPU and on the
    card, f32 and int8 pools: the packed server's tokens equal each
    tenant's merged single-tenant server's exactly, the card's equal the
    CPU's."""
    from kubetpu_torch.jobs import model as model_lib
    from kubetpu_torch.jobs.lora import (LoraConfig, init_lora_params,
                                         merge_lora)
    from kubetpu_torch.jobs.multi_lora import PagedMultiLoraDecodeServer
    from kubetpu_torch.jobs.paged import PagedDecodeServer

    cfg = _small_cfg()
    lcfg = LoraConfig(rank=8, alpha=16.0)
    base = model_lib.init_params(torch.Generator().manual_seed(7), cfg,
                                 device="cpu")
    ads = []
    for t in range(3):
        a = init_lora_params(torch.Generator().manual_seed(500 + t), cfg,
                             lcfg, device="cpu")
        gen = torch.Generator().manual_seed(900 + t)
        for k, v in a["blocks"].items():
            if k.endswith("_b"):
                a["blocks"][k] = torch.randn(v.shape, generator=gen) * 0.05
        ads.append(a)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab, n).tolist()
               for n in (5, 40, 23, 70)]
    picks = [0, 1, 2, 0]
    out = {}
    for dev in ("cpu", "cuda"):
        m = copy.deepcopy(base).to(dev)
        ad = [{"blocks": {k: v.to(dev) for k, v in a["blocks"].items()}}
              for a in ads]
        for kv_int8 in (False, True):
            kw = dict(max_seq=256, max_new_tokens=16, page_size=16,
                      prefill_budget=32, kv_int8=kv_int8, device=dev)
            server = PagedMultiLoraDecodeServer(cfg, m, lcfg, ad, n_slots=3,
                                                **kw)
            rids = [server.enqueue(prompts[0], adapter=picks[0])]
            server.step()
            rids += [server.enqueue(p, adapter=a)
                     for p, a in zip(prompts[1:], picks[1:])]
            server.drain()
            server.check_invariants()
            out[(dev, kv_int8, "packed")] = [server.result(r) for r in rids]
            merged = []
            for p, a in zip(prompts, picks):
                ref = PagedDecodeServer(cfg, merge_lora(m, ad[a], lcfg),
                                        n_slots=1, **kw)
                rid = ref.enqueue(p)
                ref.drain()
                merged.append(ref.result(rid))
            out[(dev, kv_int8, "merged")] = merged
    ref = {k: out[("cpu", k, "merged")] for k in (False, True)}
    equal = {f"{dev}_{'int8' if k else 'f32'}_{kind}": v == ref[k]
             for (dev, k, kind), v in out.items()}
    return {"equal_to_cpu_merged": equal, "ok": all(equal.values())}


def phase_multilora(model, cfg, smi, launches) -> dict:
    """Multi-LoRA serving on the flagship: 64 resident rank-8 adapters on
    wq/wk/wv/wo (bench_model.py's tenant adapters), phase 6's prompts as
    eight tenants (adapters 0, 9, ..., 63), 32 new tokens, 8 slots,
    ``prefill_budget=256``. Arms: the plain ``PagedDecodeServer`` (what
    the adapters cost), the packed ``PagedMultiLoraDecodeServer`` over a
    bf16 pool (both again twice each, alternated: one pair is
    inside the host's noise), over an int8 pool and with ``overlap``; each tenant alone
    on its merged weights at n_slots=1 in turn, over a bf16 and an int8
    pool (the packed arms' references, pool for pool); the speculative
    packed
    server with phase 16's quarter draft; hot load / evict on the wire;
    phase 5's small f32 model on the CPU and the card.

    Gates: each tenant's packed tokens equal its merged server's, the
    first divergence allowed only where the merged run's top two logits
    lie within LOGIT_TOL (exactly equal on the small f32 model); the
    speculative tokens equal the packed server's under the same rule; a
    same-tenant replay hits the prefix tree and the prompt under another
    adapter misses it; 0 host syncs in each dispatched step and 1 in each
    routed one; the paged launches of every arm on the split and wgmma
    routes, none on SIMT; the oracles after every arm; the wire's
    answers (``_ml_wire``)."""
    from kubetpu_torch.jobs.lora import LoraConfig
    from kubetpu_torch.jobs.paged import PagedDecodeServer

    t_phase = time.perf_counter()
    lcfg = LoraConfig(rank=8, alpha=16.0)
    ads = _tenant_adapters(cfg, lcfg, range(ML_RESIDENT + 2))
    resident, extra = ads[:ML_RESIDENT], ads[ML_RESIDENT:]
    prompts = _serve_prompts(cfg)
    rows = {}
    plain = PagedDecodeServer(cfg, model, n_slots=8, max_seq=2048,
                              max_new_tokens=ML_NEW, page_size=16,
                              prefill_budget=256, device="cuda")
    plain.warmup()
    rows["plain"] = _ml_arm("plain", plain, prompts, None, smi, launches,
                            top2=True, profile=True)
    packed = _ml_server(model, cfg, lcfg, resident)
    packed.warmup()
    rows["packed"] = _ml_arm("packed", packed, prompts, ML_TENANTS, smi,
                             launches, top2=True)
    ranges = {k: 0.0 for k in _LoraRanges.LABELS}
    patch = _LoraRanges()
    try:
        prof = _ten_step_profile(packed, ranges)
    finally:
        patch.close()
    rows["packed"]["row"]["profile"] = prof
    line("multilora_profile", arm="packed", **prof)
    packed.check_invariants()
    alternation = _ml_alternation(
        {"plain": (plain, None), "packed": (packed, ML_TENANTS)}, prompts,
        {arm: rows[arm]["results"] for arm in ("plain", "packed")}, smi,
        launches)
    del plain, packed
    torch.cuda.empty_cache()
    # prefix isolation: a same-tenant replay hits, another tenant misses
    replay = _ml_prefix(model, cfg, lcfg, resident, prompts[-1])
    prefix_ok = replay == [0, 1, 1]
    for arm, kw in (("packed_int8", {"kv_int8": True}),
                    ("packed_overlap", {"overlap": True})):
        server = _ml_server(model, cfg, lcfg, resident, **kw)
        server.warmup()
        rows[arm] = _ml_arm(arm, server, prompts, ML_TENANTS, smi, launches)
        del server
        torch.cuda.empty_cache()
    rows["merged"] = _ml_merged(model, cfg, lcfg, resident, prompts, smi,
                                launches)
    rows["merged_int8"] = _ml_merged(model, cfg, lcfg, resident, prompts,
                                     smi, launches, kv_int8=True)
    rows["spec"] = _ml_spec(model, cfg, lcfg, resident, prompts, smi,
                            launches)
    rows["wire"] = _ml_wire(model, cfg, lcfg, resident, extra, prompts[0],
                            smi)
    small = _ml_small_f32()
    line("multilora_f32", **small)
    merged = rows["merged"]
    ref = {"packed": merged, "packed_overlap": merged,
           "packed_int8": rows["merged_int8"]}
    ties = {arm: _near_tie_check(rows[arm]["results"], m["results"],
                                 m["gaps"], prompts)
            for arm, m in ref.items()}
    spec_ties = _near_tie_check(rows["spec"]["results"],
                                rows["packed"]["results"],
                                rows["packed"]["gaps"], prompts)
    overlap_equal = (rows["packed_overlap"]["results"]
                     == rows["packed"]["results"])
    arms = ("plain", "packed", "packed_int8", "packed_overlap")
    p_prof, q_prof = rows["plain"]["row"]["profile"], prof
    summary = dict(
        tokens_equal_merged={a: sum(x == y for x, y in zip(
            rows[a]["results"], m["results"])) for a, m in ref.items()},
        diverged={a: t["diverged"] for a, t in ties.items()},
        bad={a: t["bad"] for a, t in ties.items()},
        spec_tokens_equal_packed=sum(x == y for x, y in zip(
            rows["spec"]["results"], rows["packed"]["results"])),
        spec_bad=spec_ties["bad"], overlap_tokens_equal=overlap_equal,
        prefix_replay_hits=replay, prefix_ok=prefix_ok,
        syncs_ok={a: rows[a]["row"]["syncs_ok"] for a in arms},
        launches_ok={a: rows[a]["row"]["launches_ok"] for a in arms},
        spec_launches_ok=rows["spec"]["row"]["launches_ok"],
        wire_ok=rows["wire"]["ok"], small_f32_ok=small["ok"],
        packed_over_plain_decode_toks_s=(
            rows["packed"]["row"]["decode_toks_s"]
            / rows["plain"]["row"]["decode_toks_s"]),
        alternated_packed_over_plain=alternation["packed_over_plain"],
        packed_over_merged_toks_s=(rows["packed"]["row"]["toks_s"]
                                   / merged["row"]["toks_s"]),
        step_device_busy_ms={"plain": p_prof["device_busy_ms_per_step"],
                             "packed": q_prof["device_busy_ms_per_step"]},
        step_kernels={"plain": p_prof["device_kernels_per_step"],
                      "packed": q_prof["device_kernels_per_step"]},
        lora_device_ms_per_step=q_prof["range_device_ms_per_step"],
        seconds=time.perf_counter() - t_phase)
    line("multilora_gates", **summary)
    failed = (any(summary["bad"].values()) or spec_ties["bad"]
              or not overlap_equal or not prefix_ok
              or not all(summary["syncs_ok"].values())
              or not all(summary["launches_ok"].values())
              or not summary["spec_launches_ok"] or not summary["wire_ok"]
              or not small["ok"])
    if failed:
        raise SystemExit(f"multilora: {summary}")
    out = {k: v["row"] for k, v in rows.items()}
    out.update(gates=summary, small_f32=small, alternation=alternation)
    return out


# -- phase 19: the router side -------------------------------------------------

ROUTER_FAMILIES = 3      # prompt families of the affinity storm (4 until
                         # phase 38 came)
ROUTER_MEMBERS = 3       # members a family (4 until phase 38 came)
ROUTER_SCALE_NEW = 32    # new tokens of each scale-down stream (64 until
                         # phase 38 came)
ROUTER_TREE_PAGES = 256  # a replica's prefix tree: every family's 32 pages


def _router_storm(cfg) -> list:
    """ROUTER_FAMILIES families x ROUTER_MEMBERS members: a 512-token
    system prompt a family and a 64-token tail a member, in rounds (member
    j of every family, then member j + 1), so each family's first member
    arrives cold."""
    rng = np.random.default_rng(19)
    heads = [rng.integers(1, cfg.vocab, 512).tolist()
             for _ in range(ROUTER_FAMILIES)]
    tails = [[rng.integers(1, cfg.vocab, 64).tolist()
              for _ in range(ROUTER_MEMBERS)] for _ in heads]
    return [heads[f] + tails[f][m] for m in range(ROUTER_MEMBERS)
            for f in range(ROUTER_FAMILIES)]


def _router_replica(model, cfg, name, profile=False, slos=None, **kw):
    """A started port replica over a flagship server with phase 6's
    settings and a prefix tree that holds every family, warmed up (its
    profiler enabled before the warm-up when *profile*) -> (replica,
    ``_stamp`` stamps)."""
    from kubetpu_torch.router import ReplicaServer

    server = _wire_server(model, cfg, prefix_cache_pages=ROUTER_TREE_PAGES,
                          **kw)
    if profile:
        server.enable_profiler(sample_every=8)
    server.warmup()
    if slos is not None:
        server.declare_slos(slos, eval_interval=0.0)
    stamps = _stamp(server)
    rep = ReplicaServer(server, name, idle_wait=0.002)
    rep.start()
    return rep, stamps


def _router_post(router, prompts, tag, **extra) -> tuple:
    """The prompts' generates through the router, one at a time ->
    (bodies, client walls in ms)."""
    bodies, walls = [], []
    for i, p in enumerate(prompts):
        t0 = time.perf_counter()
        code, body = _generate(router.address, p, f"{tag}-{i}", **extra)
        walls.append((time.perf_counter() - t0) * 1e3)
        if code != 200:
            raise SystemExit(f"router {tag}: request {i} answered {code} "
                             f"{str(body)[:200]}")
        bodies.append(body)
    return bodies, walls


def _tree_hits(reps) -> dict:
    """Requests that hit a replica's tree, and those of them whose pages a
    peer fetch had just brought (the prefix tier's hint, not affinity)."""
    hits = sum(r.server.prefix_cache_stats()["requests_hit"] for r in reps)
    peer = sum(_counter(r.server, "kubetpu_peer_prefix_fetch_total",
                        result="hit") for r in reps)
    return dict(requests_hit=int(hits), peer_fetch_hits=int(peer))


def _router_storm_arm(model, cfg, prompts, policy, smi, quiet=None,
                      slos=False):
    """The storm through a port router (*policy*) over two fresh port
    replicas, serially. Returns the row and, when *slos*, the live
    (router, replicas) for the SLO arm (else they are stopped)."""
    from kubetpu_torch.obs.slo import router_slos, serving_slos
    from kubetpu_torch.router import RouterServer

    serving = (serving_slos(ttft_p95_s=10.0, queue_wait_p99_s=10.0,
                            min_free_pages=1) if slos else None)
    made = [_router_replica(model, cfg, f"{policy}-{x}",
                            profile=slos and x == "a", slos=serving)
            for x in "ab"]
    reps = [rep for rep, _ in made]
    stamps = {rep.name: st for rep, st in made}
    router = RouterServer(
        policy=policy, head_quantum=16, load_refresh_s=0.05, seed=0,
        slos=(router_slos(route_p99_s=10.0, ttft_p50_s=10.0,
                          min_free_pages=1) if slos else None),
        slo_interval_s=0.2)
    router.start()
    for rep in reps:
        router.register_replica(rep.address)
    bodies, walls = _router_post(router, prompts, f"storm-{policy}")
    tokens = [b["tokens"] for b in bodies]
    ttft, server_ms = [], []
    for b in bodies:
        st = stamps[b["replica"]]
        ttft.append(st["ttft"][b["rid"]] * 1e3)
        server_ms.append((st["emits"][b["rid"]][-1] - st["enq"][b["rid"]])
                         * 1e3)
    lat = router._metrics.summary()
    families = {}
    for i, b in enumerate(bodies):
        families.setdefault(i % ROUTER_FAMILIES, set()).add(b["replica"])
    hits = _tree_hits(reps)
    row = dict(arm=policy, card=torch.cuda.get_device_name(0),
               nvidia_smi=smi, requests=len(prompts),
               replicas=[b["replica"] for b in bodies],
               families_pinned=all(len(v) == 1 for v in families.values()),
               **hits, hit_rate=hits["requests_hit"] / len(prompts),
               local_hit_rate=(hits["requests_hit"] - hits["peer_fetch_hits"])
               / len(prompts),
               ttft_ms_p50=float(np.median(ttft)), ttft_ms=ttft,
               request_ms_p50=float(np.median(walls)),
               server_request_ms_p50=float(np.median(server_ms)),
               router_route_ms_p50=lat["route"]["p50_ms"],
               router_upstream_ms_p50=lat["upstream"]["p50_ms"],
               router_overhead_ms_p50=lat["route"]["p50_ms"]
               - float(np.median(server_ms)),
               client_overhead_ms_p50=float(np.median(
                   [w - s for w, s in zip(walls, server_ms)])),
               fallbacks=int(router._c_fallback.value))
    if quiet is not None:
        ties = _near_tie_check(tokens, quiet["tokens"], quiet["gaps"],
                               prompts)
        row.update(tokens_equal_quiet=sum(
            t == q for t, q in zip(tokens, quiet["tokens"])),
            diverged=ties["diverged"], bad=ties["bad"])
    for rep in reps:
        with rep._cv:
            rep.server.check_invariants()
    if slos:
        return row, router, reps
    router.shutdown()
    _stop(*reps)
    return row, None, None


def _router_slos(router, reps, prompt, smi) -> dict:
    """Both ``/slo`` surfaces return verdicts; then a router over the same
    replicas declaring an objective no fleet meets burns: a ``batch``
    request is shed 503, an ``interactive`` one still routes."""
    from kubetpu_torch.obs.slo import Objective
    from kubetpu_torch.router import RouterServer
    from kubetpu_torch.wire.httpcommon import request_json

    router.evaluate_slos(0.0)
    rslo = request_json(router.address + "/slo", method="GET", timeout=60)
    replica_slo = {r.name: request_json(r.address + "/slo", method="GET",
                                        timeout=60) for r in reps}
    burning = RouterServer(
        head_quantum=16, load_refresh_s=0.05, slo_interval_s=0.05,
        slos=[Objective("impossible", metric="kubetpu_serving_queue_depth",
                        threshold=-1.0, reduce="max")])
    burning.start()
    try:
        for rep in reps:
            burning.register_replica(rep.address)
        for _ in range(3):
            burning.evaluate_slos(0.0)
        shed, _ = _generate(burning.address, prompt, "slo-batch",
                            slo_class="batch")
        routed, body = _generate(burning.address, prompt, "slo-interactive",
                                 slo_class="interactive")
        is_burning = burning._burning()
    finally:
        burning.shutdown()
    row = dict(arm="slo", card=torch.cuda.get_device_name(0),
               nvidia_smi=smi,
               router_verdicts={k: dict(ok=v["ok"], value=v["value"],
                                        burn_fast=v["burn_fast"])
                                for k, v in rslo["results"].items()},
               replica_verdicts={n: sorted(v["results"])
                                 for n, v in replica_slo.items()},
               burning=is_burning, batch_code=shed, interactive_code=routed,
               interactive_replica=body.get("replica"))
    line("router", **row)
    if not (rslo["results"] and all(v["results"]
                                    for v in replica_slo.values())
            and is_burning and shed == 503 and routed == 200):
        raise SystemExit(f"router slo: {row}")
    return row


def _owned_prompts(router, cfg, names, per_replica, n_tokens=256) -> list:
    """*per_replica* prompts of *n_tokens* for each of *names*, chosen by
    the router's own ring (each a family of its own)."""
    from kubetpu_torch.router import prefix_head_key

    rng = np.random.default_rng(191)
    out = {n: [] for n in names}
    while any(len(v) < per_replica for v in out.values()):
        p = rng.integers(1, cfg.vocab, n_tokens).tolist()
        owner = router.ring.lookup(prefix_head_key(
            p, router.head_tokens, router.head_quantum))
        if len(out.get(owner, [None] * per_replica)) < per_replica:
            out[owner].append(p)
    return [p for n in names for p in out[n]]


def _router_scale_down(model, cfg, smi) -> dict:
    """The autoscaler on port replicas: a hot policy (TTFT over a 1 us
    ceiling) scales one replica up to two through a launcher that builds a
    port replica on the shared model; then, with two streams of
    ROUTER_SCALE_NEW new tokens mid-decode on each, a relaxed policy
    scales down,
    migrate-then-remove: the victim's streams finish on the survivor
    (the router re-pins each) under the near-tie rule against a quiet
    run, and the router's events read scale_up < scale_down_migrate <
    drain < scale_down."""
    from concurrent.futures import ThreadPoolExecutor

    from kubetpu_torch.router import (ReplicaAutoscaler, RouterServer,
                                      ScalePolicy)

    made, stopped = {}, []

    def launch():
        rep, _ = _router_replica(model, cfg, "scale-a",
                                 max_new_tokens=ROUTER_SCALE_NEW)
        made[rep.name] = rep
        return rep.address

    rep_b, _ = _router_replica(model, cfg, "scale-b",
                               max_new_tokens=ROUTER_SCALE_NEW)
    made[rep_b.name] = rep_b
    router = RouterServer(head_quantum=16, load_refresh_s=0.05)
    router.start()
    try:
        router.register_replica(rep_b.address)
        scaler = ReplicaAutoscaler(
            router, launch,
            policy=ScalePolicy(min_replicas=1, max_replicas=2, up_after=1,
                               down_after=1, cooldown_s=0.0,
                               ttft_p50_ms=0.001),
            terminator=lambda name, url: stopped.append(name))
        code, _ = _generate(router.address, [1] * 64, "scale-warm")
        t0 = time.perf_counter()
        up = scaler.poll_once()["action"]
        up_ms = (time.perf_counter() - t0) * 1e3
        prompts = _owned_prompts(router, cfg, ["scale-a", "scale-b"], 2)
        quiet_srv = _wire_server(model, cfg, max_new_tokens=ROUTER_SCALE_NEW)
        rec = _record_top2(quiet_srv)
        quiet = _serial(quiet_srv, prompts)
        gaps = _top2_gaps(rec)
        del quiet_srv, rec
        holds = {n: _Hold(made[n], 2) for n in made}
        with ThreadPoolExecutor(len(prompts)) as pool:
            futs = [pool.submit(_generate, router.address, p, f"scale-{i}")
                    for i, p in enumerate(prompts)]
            for hold in holds.values():
                hold.wait("wire scale")
            scaler.policy = ScalePolicy(
                min_replicas=1, max_replicas=2, up_after=99, down_after=1,
                cooldown_s=0.0, cold_active_frac=1.01,
                queue_wait_p99_ms=1e9, ttft_p50_ms=1e9)
            t0 = time.perf_counter()
            drain = scaler.poll_once()["action"]
            holds["scale-b"].release()
            down = None
            while time.perf_counter() - t0 < 300 and down is None:
                down = scaler.poll_once()["action"]
                time.sleep(0.01)
            down_ms = (time.perf_counter() - t0) * 1e3
            answers = [f.result(timeout=600) for f in futs]
        tokens = [body.get("tokens") for _, body in answers]
        ties = _near_tie_check(tokens, quiet, gaps, prompts)
        seqs = {}
        for e in router.events.events():
            seqs.setdefault(e["kind"], e["seq"])
        order = [seqs.get(k) for k in ("scale_up", "scale_down_migrate",
                                       "drain", "scale_down")]
        with made["scale-b"]._cv:
            made["scale-b"].server.check_invariants()
        row = dict(arm="scale_down", card=torch.cuda.get_device_name(0),
                   nvidia_smi=smi, warm_code=code, scale_up=up,
                   scale_up_ms=up_ms, drain=drain, scale_down=down,
                   scale_down_ms=down_ms, streams=len(prompts),
                   answered=[c for c, _ in answers],
                   replicas=[b.get("replica") for _, b in answers],
                   repins=int(router._c_repin.value),
                   tokens_full=sum(t is not None and len(t) == len(p)
                                   + ROUTER_SCALE_NEW
                                   for t, p in zip(tokens, prompts)),
                   tokens_equal_quiet=sum(t == q for t, q in
                                          zip(tokens, quiet)),
                   diverged=ties["diverged"], bad=ties["bad"],
                   event_seq=order, terminated=stopped)
    finally:
        router.shutdown()
        _stop(*made.values())
    line("router", **row)
    if not (up == "scale_up:scale-a" and drain == "drain:scale-a"
            and down == "scale_down:scale-a" and stopped == ["scale-a"]
            and row["answered"] == [200] * len(prompts)
            and set(row["replicas"]) == {"scale-b"} and row["repins"] == 2
            and row["tokens_full"] == len(prompts) and not ties["bad"]
            and None not in order and order == sorted(order)):
        raise SystemExit(f"router scale_down: {row}")
    return row


def _router_profile(model, cfg, profiled_rep, smi) -> dict:
    """The profiler: the storm replica's breakdown (enabled before its
    warm-up, every 8th step sampled), then a server with ``overlap`` and
    the profiler on: the host-sync counter reads 0 in every dispatched
    step and 1 in every routed step, each sampled step waits once on its
    own copy's event, and nothing calls ``torch.cuda.synchronize``."""
    from kubetpu_torch.jobs import serving as serving_mod

    summary = profiled_rep.server.profile_summary()
    server = _wire_server(model, cfg, overlap=True)
    server.enable_profiler(sample_every=8)
    server.warmup()
    torch.cuda.synchronize()
    waits, dispatched, device_syncs = [], [], [0]
    real_wait, real_sync = serving_mod._wait_staged, torch.cuda.synchronize
    dispatch = server._dispatch_step

    def dispatched_step():
        handle = dispatch()
        dispatched.append(handle[0][1])
        return handle

    def wait(staged):
        waits.append(staged[1])
        return real_wait(staged)

    def no_sync(*args, **kwargs):
        device_syncs[0] += 1
        return real_sync(*args, **kwargs)

    server._dispatch_step = dispatched_step
    serving_mod._wait_staged, torch.cuda.synchronize = wait, no_sync
    sync = _SyncCounter(server)
    try:
        rids = [server.enqueue(p) for p in _serve_prompts(cfg)]
        server.drain()
    finally:
        syncs = sync.close()
        serving_mod._wait_staged, torch.cuda.synchronize = real_wait, real_sync
    overlap = server.profile_summary()
    for r in rids:
        server.pop_result(r)
    own = all(any(w is d for d in dispatched) for w in waits)
    row = dict(arm="profile", card=torch.cuda.get_device_name(0),
               nvidia_smi=smi, sample_every=summary["sample_every"],
               steps=summary["steps"], sampled_steps=summary["sampled_steps"],
               coverage=summary["coverage"],
               phase_ms={k: v["seconds"] * 1e3 / summary["sampled_steps"]
                         for k, v in summary["phases"].items()},
               phase_share={k: v["frac"]
                            for k, v in summary["phases"].items()},
               step_ms=summary["sampled_wall_s"] * 1e3
               / summary["sampled_steps"],
               recompiles=summary["recompiles"],
               overlap_coverage=overlap["coverage"],
               overlap_sampled_steps=overlap["sampled_steps"],
               overlap_syncs=syncs, sampled_waits=len(waits),
               waits_on_own_event=own, device_syncs=device_syncs[0])
    line("router", **row)
    if not (summary["coverage"] >= 0.9 and overlap["coverage"] >= 0.9
            and syncs["dispatch_syncs_max"] == 0
            and syncs["route_syncs"] == [1] and waits and own
            and device_syncs[0] == 0):
        raise SystemExit(f"router profile: {row}")
    return row


def _router_tenant(model, cfg, smi) -> dict:
    """Tenant affinity: a packed replica holding 8 rank-8 adapters (phase
    17's) beside a plain one; a 9th adapter registered with the router's
    ``AdapterRegistry`` and distributed by ``POST /adapters`` (the plain
    replica skipped); a generate naming it, on a prompt whose ring owner
    is the plain replica, lands on the packed one through the
    tenant-affine pick, with the in-process run's tokens."""
    from kubetpu_torch.jobs.lora import LoraConfig
    from kubetpu_torch.router import ReplicaServer, RouterServer
    from kubetpu_torch.router.adapters import AdapterRegistry
    from kubetpu_torch.wire.httpcommon import request_json

    lcfg = LoraConfig(rank=8, alpha=16.0)
    ads = _tenant_adapters(cfg, lcfg, range(8))
    extra = _tenant_adapters(cfg, lcfg, [8])[0]
    a = _ml_server(model, cfg, lcfg, ads, max_adapters=9)
    a.warmup()
    b = _wire_server(model, cfg)
    reps = [ReplicaServer(a, "tenant-packed", idle_wait=0.002),
            ReplicaServer(b, "tenant-plain", idle_wait=0.002)]
    for rep in reps:
        rep.start()
    reg = AdapterRegistry()
    name = reg.register(extra, name="tenant-9")
    router = RouterServer(head_quantum=16, load_refresh_s=0.05, adapters=reg)
    router.start()
    try:
        for rep in reps:
            router.register_replica(rep.address)
        t0 = time.perf_counter()
        out = request_json(router.address + "/adapters",
                           {"action": "load", "name": name},
                           idempotency_key="tenant-load", timeout=600)
        push_ms = (time.perf_counter() - t0) * 1e3
        router.pool.refresh(0.0)
        summ = request_json(router.address + "/adapters", method="GET",
                            timeout=60)
        prompt = _owned_prompts(router, cfg, ["tenant-plain"], 1)[0]
        affine = router._c_tenant_affine.value
        code, body = _generate(router.address, prompt, "tenant-gen",
                               adapter=name)
        with reps[0]._cv:
            rid = a.enqueue(prompt, adapter=name)
        while True:
            with reps[0]._cv:
                if a.finished(rid):
                    inproc = a.pop_result(rid)
                    break
            time.sleep(0.01)
        with reps[0]._cv:
            a.check_invariants()
        row = dict(arm="tenant", card=torch.cuda.get_device_name(0),
                   nvidia_smi=smi, distributed=sorted(out["results"]),
                   packed_ok=out["results"].get("tenant-packed", {}).get(
                       "ok"),
                   push_ms=push_ms, registered=summ["registered"],
                   resident_on_packed=len(summ["resident"].get(
                       "tenant-packed", [])),
                   generate_code=code, replica=body.get("replica"),
                   tenant_affine=int(router._c_tenant_affine.value - affine),
                   tokens_equal_in_process=code == 200
                   and body["tokens"] == inproc)
    finally:
        router.shutdown()
        _stop(*reps)
    line("router", **row)
    if not (row["distributed"] == ["tenant-packed"] and row["packed_ok"]
            and row["replica"] == "tenant-packed"
            and row["tenant_affine"] == 1
            and row["tokens_equal_in_process"]):
        raise SystemExit(f"router tenant: {row}")
    return row


def phase_router(model, cfg, smi, launches) -> dict:
    """The port's router side in front of port replicas on the flagship,
    in this process on ``127.0.0.1:0``: the affinity storm (against a
    quiet direct run and under ``policy="random"``), SLOs, the
    autoscaler's scale-down, the profiler and tenant affinity. The paged
    counters are zeroed just before and read just after, and added to
    *launches*: split and wgmma must run, SIMT not."""
    from kubetpu_torch.ops import paged_attention as pa

    prompts = _router_storm(cfg)
    torch.cuda.synchronize()
    for c in _PAGED_COUNTERS:
        setattr(pa.paged_attention, c, 0)
    t0 = time.perf_counter()
    quiet_srv = _wire_server(model, cfg, prefix_cache_pages=ROUTER_TREE_PAGES)
    quiet_srv.warmup()
    qst = _stamp(quiet_srv)
    rec = _record_top2(quiet_srv)
    quiet = dict(tokens=_serial(quiet_srv, prompts), gaps=_top2_gaps(rec))
    direct_ttft = [qst["ttft"][qst["rid"][tuple(p)]] * 1e3 for p in prompts]
    direct_hits = quiet_srv.prefix_cache_stats()["requests_hit"]
    del quiet_srv, rec
    rows = {}
    row, router, reps = _router_storm_arm(model, cfg, prompts, "affinity",
                                          smi, quiet=quiet, slos=True)
    row.update(direct_ttft_ms_p50=float(np.median(direct_ttft)),
               direct_ttft_ms=direct_ttft, direct_requests_hit=direct_hits)
    line("router", **row)
    rows["affinity"] = row
    if not (row["families_pinned"] and not row["bad"]
            and row["requests_hit"] >= len(prompts) - ROUTER_FAMILIES):
        raise SystemExit(f"router affinity: {row}")
    try:
        rows["slo"] = _router_slos(router, reps, prompts[0], smi)
        rows["profile"] = _router_profile(model, cfg, reps[0], smi)
    finally:
        router.shutdown()
        _stop(*reps)
    row, _, _ = _router_storm_arm(model, cfg, prompts, "random", smi)
    line("router", **row)
    rows["random"] = row
    rows["scale_down"] = _router_scale_down(model, cfg, smi)
    rows["tenant"] = _router_tenant(model, cfg, smi)
    torch.cuda.synchronize()
    counts = {c: getattr(pa.paged_attention, c) for c in _PAGED_COUNTERS}
    for c, n in counts.items():
        launches[c] = launches.get(c, 0) + n
    rows.update(seconds=time.perf_counter() - t0, paged_launches=counts)
    line("router_launches", seconds=rows["seconds"], **counts)
    if (counts["split_launches"] <= 0 or counts["wgmma_launches"] <= 0
            or counts["simt_launches"]):
        raise SystemExit(f"router: paged launches {counts}")
    return rows


# -- phase 10: the training step, CPU plain versions vs the card's kernels ---

TRAIN_TOL = 1e-4     # f32 on both sides: summation order only


def _small_cfg(**over):
    from kubetpu_torch.jobs import model as model_lib

    return model_lib.ModelConfig(vocab=512, d_model=256, n_layers=2,
                                 n_heads=4, n_kv_heads=2, d_ff=512,
                                 max_seq=256, **over)


def phase_train_parity(smi: str, cfg=None, tag="train_parity") -> dict:
    """Three steps of ``make_train_step(attention="flash")`` on the CPU and
    on the card, from the same weights and ``SyntheticCorpus`` batches:
    first-step gradients within TRAIN_TOL of the largest gradient of each
    leaf, per-step losses within TRAIN_TOL relative. *cfg*: phase 5's
    small f32 model by default (phase 23 passes it made MoE)."""
    from kubetpu_torch.jobs import model as model_lib
    from kubetpu_torch.jobs import train as train_lib
    from kubetpu_torch.jobs.data import SyntheticCorpus

    cfg = cfg or _small_cfg()
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
    row = dict(card=torch.cuda.get_device_name(0), nvidia_smi=smi,
               cfg="vocab 512, d 256, 2 layers, 4 heads / 2 kv, f32"
               + (f", {cfg.n_experts} experts, capacity "
                  f"{cfg.moe_capacity_factor}, top-{cfg.moe_top_k}, aux "
                  f"{cfg.moe_aux_coeff}" if cfg.n_experts else ""),
               batch=2, seq=200, steps=3, losses_cpu=losses["cpu"],
               losses_cuda=losses["cuda"], loss_rel_err=loss_err,
               grad_rel_err=grad_err, tol=TRAIN_TOL)
    line(tag, **row)
    if not grad_err <= TRAIN_TOL or not loss_err <= TRAIN_TOL:
        raise SystemExit(f"{tag}: gradients {grad_err}, losses "
                         f"{loss_err} above {TRAIN_TOL}")
    return row


# -- phase 11: the flagship's training step ----------------------------------

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


def phase_train(smi: str, cfg=None, tag="train", timed=5):
    """The training step at batch 4 x seq 2048: *cfg* is the flagship
    (phase 11) unless given (phase 23's MoE config)."""
    from kubetpu_torch.jobs import train as train_lib
    from kubetpu_torch.jobs.data import SyntheticCorpus

    cfg = cfg or _flagship_train_cfg()
    batch, seq = 4, 2048
    state, opt = train_lib.init_state(
        torch.Generator(device="cuda").manual_seed(0), cfg, device="cuda")
    n_params = sum(p.numel() for p in state.params.parameters())
    # model FLOPs count the parameters a token runs through: of each MoE
    # block's experts, top_k of n_experts
    n_active = n_params
    if cfg.n_experts:
        experts = sum(getattr(b, w).numel() for b in state.params.blocks
                      for w in ("w_gate", "w_up", "w_down"))
        n_active -= experts * (cfg.n_experts - cfg.moe_top_k) // cfg.n_experts
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
        raise SystemExit(f"{tag}: flash launches (forward, dq, dkv, "
                         f"forward wgmma, dq wgmma, dkv wgmma) {counts} != "
                         f"{expected}")
    if not all(np.isfinite(losses)):
        raise SystemExit(f"{tag}: non-finite losses {losses}")
    step_s = wall / timed
    tokens_s = batch * seq / step_s
    flops_per_token = 6 * n_active + 12 * cfg.n_layers * cfg.d_model * seq
    peak_mem = torch.cuda.max_memory_allocated() / 1e9

    repeat = batches[1]                              # one batch, ten steps
    fit = []
    for _ in range(10):
        state, loss = step(state, *repeat)
        fit.append(float(loss))
    if not fit[-1] < fit[0]:
        raise SystemExit(f"{tag}: loss on a repeated batch did not fall: "
                         f"{fit}")
    row = dict(card=torch.cuda.get_device_name(0), nvidia_smi=smi,
               params=n_params, active_params=n_active, layers=cfg.n_layers,
               experts=cfg.n_experts, batch=batch, seq=seq, remat="full",
               attention="flash", step_ms=step_s * 1e3, tokens_s=tokens_s,
               mfu=tokens_s * flops_per_token / BF16_FLOP_S,
               flops_per_token=flops_per_token, peak_mem_gb=peak_mem,
               losses=losses, repeated_batch_losses=fit,
               flash_launches=dict(forward=counts[0], dq=counts[1],
                                   dkv=counts[2], forward_wgmma=counts[3],
                                   dq_wgmma=counts[4], dkv_wgmma=counts[5],
                                   steps=timed))
    line(tag, **row)
    return row, state, step, repeat


def phase_train_profile(state, step, batch) -> dict:
    """Where a training step's time goes: torch.profiler over one step."""
    wall_us, kernels, counts = _profiled(lambda: step(state, *batch))
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
               kernel_kinds=len(kernels), **counts,
               top_kernels_ms=[(k[:60], v / 1e3) for k, v in top])
    line("train_profile", **row)
    return row


# -- phase 18: LoRA fine-tuning of the flagship --------------------------------

LORA_LR = 1e-3


def _lora_train_parity() -> dict:
    """Three LoRA steps of phase 10's small f32 model on the CPU (plain
    versions) and on the card (flash kernels), from the same base, the
    same adapter (B drawn N(0, 0.05), so A has a gradient from the first
    step) and the same batches: first-step A/B gradients within TRAIN_TOL
    of each leaf's largest, per-step losses within TRAIN_TOL relative."""
    from kubetpu_torch.jobs import lora as lora_lib
    from kubetpu_torch.jobs import model as model_lib
    from kubetpu_torch.jobs import train as train_lib
    from kubetpu_torch.jobs.data import SyntheticCorpus

    cfg = _small_cfg()
    lcfg = lora_lib.LoraConfig(rank=8, alpha=16.0)
    base = model_lib.init_params(torch.Generator().manual_seed(11), cfg,
                                 device="cpu")
    start = lora_lib.init_lora_params(torch.Generator().manual_seed(12),
                                      cfg, lcfg, device="cpu")
    gen = torch.Generator().manual_seed(13)
    for k, v in start["blocks"].items():
        if k.endswith("_b"):
            start["blocks"][k] = torch.randn(v.shape, generator=gen) * 0.05
    it = SyntheticCorpus(cfg.vocab, seed=1).batches(2, 200, seed=2)
    batches = [next(it) for _ in range(3)]
    attn = train_lib._resolve_attention("flash", cfg.window)
    grads, losses = {}, {}
    for dev in ("cpu", "cuda"):
        b = copy.deepcopy(base).to(dev)
        lora = {"blocks": {k: v.clone().to(dev).requires_grad_(True)
                           for k, v in start["blocks"].items()}}
        tokens, targets = (torch.from_numpy(x).long().to(dev)
                           for x in batches[0])
        loss = model_lib.next_token_loss(lora_lib._merged_view(b, lora, lcfg),
                                         tokens, targets, cfg, attn)
        grads[dev] = [x.cpu() for x in torch.autograd.grad(
            loss, train_lib._trained_leaves(lora))]
        opt = train_lib.make_optimizer(lr=LORA_LR)
        state = train_lib.TrainState(
            lora, opt.init(train_lib._trained_leaves(lora)))
        step = lora_lib.make_lora_train_step(cfg, lcfg, optimizer=opt,
                                             device=dev)
        losses[dev] = []
        for tokens, targets in batches:
            state, loss = step(state, b, tokens, targets)
            losses[dev].append(float(loss))
    grad_err = max(float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))
                   for a, b in zip(grads["cuda"], grads["cpu"]))
    loss_err = max(abs(a - b) / abs(b)
                   for a, b in zip(losses["cuda"], losses["cpu"]))
    row = dict(cfg="vocab 512, d 256, 2 layers, 4 heads / 2 kv, f32",
               lora="rank 8, alpha 16, wq wk wv wo", batch=2, seq=200,
               steps=3, losses_cpu=losses["cpu"],
               losses_cuda=losses["cuda"], loss_rel_err=loss_err,
               grad_rel_err=grad_err, tol=TRAIN_TOL)
    line("lora_train_parity", **row)
    if not grad_err <= TRAIN_TOL or not loss_err <= TRAIN_TOL:
        raise SystemExit(f"lora train parity: gradients {grad_err}, losses "
                         f"{loss_err} above {TRAIN_TOL}")
    return row


def phase_lora_train(base, smi) -> dict:
    """LoRA on the flagship at phase 11's configuration (batch 4 x seq
    2048, full remat, flash attention), rank 8 on wq/wk/wv/wo, the base
    being phase 11's trained weights: one warm-up step, five timed steps
    (step time, tokens/s, peak memory; the flash counters zeroed just
    before must read 24 / 12 / 12 a step, all wgmma, just after), ten
    steps on one repeated batch whose loss must fall, the base's bytes
    unchanged after all of them; then ``_lora_train_parity``."""
    from kubetpu_torch.jobs import lora as lora_lib
    from kubetpu_torch.jobs import train as train_lib
    from kubetpu_torch.jobs.data import SyntheticCorpus

    cfg = _flagship_train_cfg()
    lcfg = lora_lib.LoraConfig(rank=8, alpha=16.0)
    batch, seq, timed = 4, 2048, 5
    base.requires_grad_(False)
    before = [p.detach().clone() for p in base.parameters()]
    state, opt = lora_lib.init_lora_state(
        torch.Generator(device="cuda").manual_seed(1), cfg, lcfg,
        optimizer=train_lib.make_optimizer(lr=LORA_LR), device="cuda")
    n_lora = lora_lib.lora_param_count(state.params)
    step = lora_lib.make_lora_train_step(cfg, lcfg, optimizer=opt,
                                         attention="flash", device="cuda")
    it = SyntheticCorpus(cfg.vocab, seed=0).batches(batch, seq, seed=3)
    batches = [next(it) for _ in range(timed + 1)]
    state, loss = step(state, base, *batches[0])     # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_flash_counts()                             # zero just before
    t0 = time.perf_counter()
    losses = []
    for b in batches[1:]:
        state, loss = step(state, base, *b)
        losses.append(loss)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _flash_counts()                         # read just after
    losses = [float(x) for x in losses]
    peak_mem = torch.cuda.max_memory_allocated() / 1e9
    expected = (2 * cfg.n_layers * timed, cfg.n_layers * timed,
                cfg.n_layers * timed, 2 * cfg.n_layers * timed,
                cfg.n_layers * timed, cfg.n_layers * timed)
    fit = []
    for _ in range(10):
        state, loss = step(state, base, *batches[1])
        fit.append(float(loss))
    untouched = all(torch.equal(a, b) for a, b in zip(before,
                                                      base.parameters()))
    step_s = wall / timed
    n_base = sum(p.numel() for p in base.parameters())
    row = dict(card=torch.cuda.get_device_name(0), nvidia_smi=smi,
               lora="rank 8, alpha 16, wq wk wv wo", lora_params=n_lora,
               trainable_fraction=n_lora / n_base, batch=batch, seq=seq,
               remat="full", attention="flash", lr=LORA_LR,
               step_ms=step_s * 1e3, tokens_s=batch * seq / step_s,
               peak_mem_gb=peak_mem, losses=losses,
               repeated_batch_losses=fit, base_untouched=untouched,
               flash_launches=dict(forward=counts[0], dq=counts[1],
                                   dkv=counts[2], forward_wgmma=counts[3],
                                   dq_wgmma=counts[4], dkv_wgmma=counts[5],
                                   steps=timed))
    line("lora_train", **row)
    del before, state
    torch.cuda.empty_cache()
    if counts != expected:
        raise SystemExit(f"lora train: flash launches {counts} != "
                         f"{expected}")
    if not all(np.isfinite(losses + fit)):
        raise SystemExit(f"lora train: non-finite losses {losses} {fit}")
    if not fit[-1] < fit[0]:
        raise SystemExit(f"lora train: loss on a repeated batch did not "
                         f"fall: {fit}")
    if not untouched:
        raise SystemExit("lora train: the base's weights changed")
    row["parity"] = _lora_train_parity()
    return row


# -- phases 20-23: int8 weights, mixture-of-experts, the rolling generate ----

INT8W_RATIO = 0.56   # int8 weights' resident bytes against bf16's, at most


def _held_arm(name, weights, cls, cfg, prompts, launches, weight_bytes,
              **kw) -> tuple:
    """One serving arm at phase 6's settings (8 slots, prefill budget 256,
    DENSE_NEW new tokens, phase 6's staggered prompts): the server built
    and warmed with the allocator's peak reset just before, then
    ``_overlap_run``. Peak memory is what the arm holds at its peak: its
    weights' resident bytes plus the peak allocated above what was
    resident before the arm (pool, cache, activations, per-layer
    dequantized temporaries), so that weights other arms keep resident do
    not count. -> (row, server, run)."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    server = cls(cfg, weights, n_slots=8, max_seq=2048,
                 max_new_tokens=DENSE_NEW, prefill_budget=256,
                 device="cuda", **kw)
    server.warmup()
    server._smoke_stats = _instrument(server)
    run = _overlap_run(server, prompts, launches)
    torch.cuda.synchronize()
    peak = weight_bytes + torch.cuda.max_memory_allocated() - base
    ttft = server.metrics_summary()["ttft"]
    row = dict(arm=name, card=torch.cuda.get_device_name(0),
               requests=len(prompts), new_tokens=DENSE_NEW,
               decode_toks_s=run["decode_toks_s"],
               decode_step_ms=run["decode_step_ms"],
               ttft_p50_ms=ttft["p50_ms"], wall_s=run["wall_s"],
               weight_gb=weight_bytes / 1e9, peak_mem_gb=peak / 1e9,
               paged_launches=run["paged_launches"])
    return row, server, run


def _reference_tokens(cls, cfg, weights, prompts, launches, **kw):
    """Tokens and the top-two logit gaps (``_record_top2``) of a server of
    *cls* on *weights* at phase 6's settings: the near-tie rule's
    reference side."""
    server = cls(cfg, weights, n_slots=8, max_seq=2048,
                 max_new_tokens=DENSE_NEW, prefill_budget=256,
                 device="cuda", **kw)
    server._smoke_stats = _instrument(server)
    rec = _record_top2(server)
    out = _overlap_run(server, prompts, launches)["results"]
    return out, _top2_gaps(rec)


def phase_int8w(model, cfg, smi, launches):
    """Int8 weights on the flagship (phase 6's model, prompts and
    settings): ``quantize_params`` (per-output-channel scales; the
    embedding and norms raw), then the bf16-weight ``PagedDecodeServer``
    against int8 weights behind ``PagedDecodeServer`` over a bf16 pool and
    over an int8 pool (both halves quantized) and behind ``DecodeServer``:
    decode tokens/s, TTFT p50, peak memory (``_held_arm``) and, for the
    bf16 pair, ten profiled steps (device busy a step). Gates: each int8
    arm's tokens equal a server of its kind on the ``maybe_dequantize``d
    weights under phase 16's near-tie rule; ``param_bytes`` at most
    INT8W_RATIO of bf16's; the int8-weight paged arm's peak below the bf16
    arm's; the split and wgmma (dense and int8) instances ran, SIMT not.
    -> (rows, the int8 model)."""
    from kubetpu_torch.jobs import quant
    from kubetpu_torch.jobs.paged import PagedDecodeServer
    from kubetpu_torch.jobs.serving import DecodeServer

    t_phase = time.perf_counter()
    prompts = _serve_prompts(cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    qmodel = quant.quantize_params(model)
    torch.cuda.synchronize()
    quantize_ms = (time.perf_counter() - t0) * 1e3
    bytes_bf16, bytes_int8 = quant.param_bytes(model), quant.param_bytes(
        qmodel)
    phase_launches = {}
    arms = (("bf16", model, bytes_bf16, PagedDecodeServer,
             {"page_size": 16}),
            ("int8w", qmodel, bytes_int8, PagedDecodeServer,
             {"page_size": 16}),
            ("int8w_int8kv", qmodel, bytes_int8, PagedDecodeServer,
             {"page_size": 16, "kv_int8": True}),
            ("int8w_dense", qmodel, bytes_int8, DecodeServer, {}))
    rows, outs = {}, {}
    for name, weights, nbytes, cls, kw in arms:
        row, server, run = _held_arm(name, weights, cls, cfg, prompts,
                                     phase_launches, nbytes, **kw)
        outs[name] = run["results"]
        if name in ("bf16", "int8w"):
            row["profile"] = _ten_step_profile(server)
        if cls is PagedDecodeServer:
            server.check_invariants()
        line("int8w", nvidia_smi=smi, **row)
        rows[name] = row
        del server
    # the reference side: the same servers on the dequantized weights
    deq = quant.maybe_dequantize(qmodel)
    ties = {}
    for name, _w, _b, cls, kw in arms[1:]:
        want, gaps = _reference_tokens(cls, cfg, deq, prompts,
                                       phase_launches, **kw)
        ties[name] = _near_tie_check(outs[name], want, gaps, prompts)
    del deq
    torch.cuda.empty_cache()
    for c, n in phase_launches.items():
        launches[c] = launches.get(c, 0) + n
    ratio = bytes_int8 / bytes_bf16
    busy = {k: rows[k]["profile"]["device_busy_ms_per_step"]
            for k in ("bf16", "int8w")}
    gates = dict(param_bytes_bf16=bytes_bf16, param_bytes_int8=bytes_int8,
                 param_bytes_ratio=ratio, ratio_limit=INT8W_RATIO,
                 quantize_ms=quantize_ms,
                 peak_mem_gb={k: r["peak_mem_gb"] for k, r in rows.items()},
                 decode_toks_s={k: r["decode_toks_s"]
                                for k, r in rows.items()},
                 device_busy_ms_per_step=busy,
                 near_tie={k: v["diverged"] for k, v in ties.items()},
                 paged_launches=phase_launches,
                 seconds=time.perf_counter() - t_phase)
    line("int8w_gates", card=torch.cuda.get_device_name(0), nvidia_smi=smi,
         **gates)
    bad = {k: v["bad"] for k, v in ties.items() if v["bad"]}
    if bad:
        raise SystemExit(f"int8w: tokens differ from the dequantized "
                         f"weights' beyond near-ties: {bad}")
    if not ratio <= INT8W_RATIO:
        raise SystemExit(f"int8w: param_bytes ratio {ratio} above "
                         f"{INT8W_RATIO}")
    if not rows["int8w"]["peak_mem_gb"] < rows["bf16"]["peak_mem_gb"]:
        raise SystemExit(f"int8w: peak memory {gates['peak_mem_gb']}: the "
                         f"int8 arm is not below bf16")
    if (phase_launches["split_launches"] <= 0
            or phase_launches["wgmma_launches"] <= 0
            or phase_launches["wgmma_int8_launches"] <= 0
            or phase_launches["simt_launches"]):
        raise SystemExit(f"int8w: paged launches {phase_launches}")
    rows["gates"] = gates
    return rows, qmodel


def _moe_cfg(cfg, **over):
    """The flagship's widths with Mixtral-8x7B's routing: 8 experts, 2 a
    token, capacity factor 2.0 (``tests/test_jobs.py:711``'s)."""
    return dataclasses.replace(cfg, n_experts=8, moe_top_k=2,
                               moe_capacity_factor=2.0, **over)


def _moe_small_parity() -> dict:
    """Phase 5's small f32 model made MoE (4 experts, top-2, capacity
    2.0) behind ``PagedDecodeServer`` on the CPU and on the card (f32 q:
    SIMT chunks, split decode): greedy tokens equal, phase 5's tie
    exception aside (a first divergence where the CPU's top two logits
    lie within F32_TOL)."""
    from kubetpu_torch.jobs import model as model_lib
    from kubetpu_torch.jobs.paged import PagedDecodeServer

    cfg = _small_cfg(n_experts=4, moe_top_k=2, moe_capacity_factor=2.0)
    cpu_model = model_lib.init_params(torch.Generator().manual_seed(7), cfg,
                                      device="cpu")
    models = {"cpu": cpu_model, "cuda": copy.deepcopy(cpu_model).to("cuda")}
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, cfg.vocab, n).tolist() for n in (5, 40, 23,
                                                                 70)]
    tokens = {}
    for dev, model in models.items():
        server = PagedDecodeServer(cfg, model, n_slots=3, max_seq=256,
                                   max_new_tokens=16, page_size=16,
                                   prefill_budget=32, device=dev)
        rids = [server.enqueue(prompts[0])]
        server.step()
        rids += [server.enqueue(p) for p in prompts[1:]]
        server.drain()
        server.check_invariants()
        tokens[dev] = [server.result(r) for r in rids]
    mismatches = []
    for a, b in zip(tokens["cpu"], tokens["cuda"]):
        if a == b:
            continue
        i = next(j for j, (x, y) in enumerate(zip(a, b)) if x != y)
        top2 = torch.topk(model_lib.forward(
            cpu_model, torch.tensor([a[:i]]), cfg)[0, -1], 2).values
        mismatches.append({"step": i, "gap": float(top2[0] - top2[1])})
    return dict(requests=len(prompts), tokens_equal=not mismatches,
                mismatches=mismatches,
                ok=all(m["gap"] <= F32_TOL for m in mismatches))


def phase_moe(cfg, smi, launches) -> dict:
    """Mixture-of-experts at the flagship's widths (``_moe_cfg``: 8
    experts, top-2, capacity 2.0; ~3.65B parameters, random weights from
    seed 0) behind ``PagedDecodeServer`` at phase 6's settings; a top-1
    dense-dispatch arm (capacity factor 0) on the same weights; and the
    top-2 model with int8 weights: decode tokens/s, TTFT p50, peak memory
    and ten profiled steps with the MoE MLP's device time (a
    ``record_function`` range around the dispatch: router, expert
    products, combine; the int8 arm's per-layer dequantize runs before
    it, outside the range). Gates: a 256-token prompt served alone in
    one chunk gives first-token logits within LOGIT_TOL of ``forward`` on
    the same 256 tokens (the same N = 256 rows in both dispatches);
    ``_moe_small_parity``; split and wgmma ran on the flagship arms, SIMT
    not."""
    from kubetpu_torch.jobs import model as model_lib
    from kubetpu_torch.jobs import quant
    from kubetpu_torch.jobs.paged import PagedDecodeServer

    t_phase = time.perf_counter()
    mcfg = _moe_cfg(cfg)
    model = model_lib.init_params(
        torch.Generator(device="cuda").manual_seed(0), mcfg, device="cuda")
    n_params = sum(p.numel() for p in model.parameters())
    qmodel = quant.quantize_params(model)
    prompts = _serve_prompts(mcfg)
    phase_launches = {}
    saved = (model_lib._moe_mlp_capacity, model_lib._moe_mlp)

    def ranged(fn):
        def run(*args, **kwargs):
            with torch.profiler.record_function("moe_mlp"):
                return fn(*args, **kwargs)
        return run

    arms = (("top2", mcfg, model, quant.param_bytes(model)),
            ("top1_dense", dataclasses.replace(mcfg, moe_top_k=1,
                                               moe_capacity_factor=0.0),
             model, quant.param_bytes(model)),
            ("top2_int8w", mcfg, qmodel, quant.param_bytes(qmodel)))
    rows = {}
    for name, acfg, weights, nbytes in arms:
        row, server, run = _held_arm(name, weights, PagedDecodeServer, acfg,
                                     prompts, phase_launches, nbytes,
                                     page_size=16)
        model_lib._moe_mlp_capacity = ranged(saved[0])
        model_lib._moe_mlp = ranged(saved[1])
        try:
            prof = _ten_step_profile(server, {"moe_mlp": 0.0})
        finally:
            model_lib._moe_mlp_capacity, model_lib._moe_mlp = saved
        moe_ms = prof["range_device_ms_per_step"]["moe_mlp"]
        prof["moe_mlp_share_of_busy"] = (
            moe_ms / prof["device_busy_ms_per_step"]
            if prof["device_busy_ms_per_step"] else None)
        row["profile"] = prof
        if name == "top2":
            # one 256-token prompt alone: one chunk of N = 256 rows
            rng = np.random.default_rng(21)
            alone = rng.integers(0, mcfg.vocab, 256).tolist()
            rid = server.enqueue(alone)
            server.drain()
            server.pop_result(rid)
            served = server._smoke_stats["first_logits"][tuple(alone)]
            with torch.no_grad():
                dense = model_lib.forward(
                    model, torch.tensor([alone], device="cuda"), mcfg)
            row["one_chunk_logit_max_diff_vs_forward"] = float(
                (dense[0, -1].float() - served).abs().max())
        server.check_invariants()
        line("moe", nvidia_smi=smi, params=n_params, **row)
        rows[name] = row
        del server
    del model, qmodel
    torch.cuda.empty_cache()
    for c, n in phase_launches.items():
        launches[c] = launches.get(c, 0) + n
    small = _moe_small_parity()
    gap = rows["top2"]["one_chunk_logit_max_diff_vs_forward"]
    gates = dict(one_chunk_logit_max_diff=gap, logit_tol=LOGIT_TOL,
                 small_f32=small, paged_launches=phase_launches,
                 seconds=time.perf_counter() - t_phase)
    line("moe_gates", card=torch.cuda.get_device_name(0), nvidia_smi=smi,
         **gates)
    if not gap <= LOGIT_TOL:
        raise SystemExit(f"moe: one-chunk logits {gap} off the forward's")
    if not small["ok"]:
        raise SystemExit(f"moe: the card's tokens differ from the CPU's on "
                         f"the small f32 model: {small}")
    if (phase_launches["split_launches"] <= 0
            or phase_launches["wgmma_launches"] <= 0
            or phase_launches["simt_launches"]):
        raise SystemExit(f"moe: paged launches {phase_launches}")
    rows["gates"] = gates
    return rows


ROLL_WINDOW = 512
ROLL_BATCH, ROLL_PROMPT, ROLL_NEW = 4, 640, 64


def _recorded_generate(gen, weights, prompt, n, factory_name):
    """Run ``gen(weights, prompt, 0, n)`` with the sampler that the
    generate loop builds from ``sampling.<factory_name>`` recording each
    step's top-two logits -> (tokens, [(B, 2) per step] on the host,
    seconds)."""
    from kubetpu_torch.jobs import sampling

    real = getattr(sampling, factory_name)
    top2 = []

    def factory(*args, **kwargs):
        sample = real(*args, **kwargs)

        def spy(logits, *a, **k):
            top2.append(torch.topk(logits.float(), 2, dim=-1).values)
            return sample(logits, *a, **k)
        return spy

    setattr(sampling, factory_name, factory)
    try:
        run = gen()
    finally:
        setattr(sampling, factory_name, real)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = run(weights, prompt, 0, n)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return out, [t.cpu() for t in top2], seconds


def phase_rolling(model, qmodel, cfg, smi) -> dict:
    """``make_rolling_generate`` (a ring of ROLL_WINDOW cache slots a
    layer) on the flagship with window 512, bf16 and int8 weights, against
    ``make_generate`` (the dense cache) on the same windowed config: 4
    prompts of 640 tokens (the ring wraps in prefill and again in decode),
    64 new tokens greedy. Gate: each row's tokens equal the dense run's,
    except that its first divergence may fall where the dense run's top
    two logits lie within LOGIT_TOL. Reported: tokens/s of both loops and
    the ring's bytes against the dense cache's."""
    from kubetpu_torch.jobs import decode

    t_phase = time.perf_counter()
    wcfg = dataclasses.replace(cfg, window=ROLL_WINDOW)
    rng = np.random.default_rng(23)
    prompt = torch.from_numpy(rng.integers(
        0, cfg.vocab, (ROLL_BATCH, ROLL_PROMPT))).to("cuda")
    ring = decode.init_ring_cache(wcfg, ROLL_BATCH, device="cuda")
    dense = decode.init_kv_cache(wcfg, ROLL_BATCH, ROLL_PROMPT + ROLL_NEW,
                                 device="cuda")
    ring_bytes, dense_bytes = (sum(t.numel() * t.element_size() for t in c)
                               for c in (ring, dense))
    del ring, dense
    rows = {}
    for name, weights in (("bf16", model), ("int8w", qmodel)):
        want, top2, dense_s = _recorded_generate(
            lambda: decode.make_generate(wcfg), weights, prompt, ROLL_NEW,
            "make_slot_sampler")
        got, _t, ring_s = _recorded_generate(
            lambda: decode.make_rolling_generate(wcfg), weights, prompt,
            ROLL_NEW, "make_sampler")
        gaps = {(tuple(prompt[b].tolist()), j): float(t[b, 0] - t[b, 1])
                for j, t in enumerate(top2) for b in range(ROLL_BATCH)}
        plist = prompt.tolist()
        tie = _near_tie_check(got.tolist(), want.tolist(), gaps, plist)
        rows[name] = dict(
            tokens_equal=bool(torch.equal(got, want)),
            diverged=tie["diverged"], bad=tie["bad"],
            ring_toks_s=ROLL_BATCH * ROLL_NEW / ring_s,
            dense_toks_s=ROLL_BATCH * ROLL_NEW / dense_s)
    row = dict(card=torch.cuda.get_device_name(0), nvidia_smi=smi,
               window=ROLL_WINDOW, batch=ROLL_BATCH, prompt=ROLL_PROMPT,
               new_tokens=ROLL_NEW, ring_mb=ring_bytes / 1e6,
               dense_cache_mb=dense_bytes / 1e6,
               ring_over_dense=ring_bytes / dense_bytes, arms=rows,
               logit_tol=LOGIT_TOL, seconds=time.perf_counter() - t_phase)
    line("rolling", **row)
    bad = {k: v["bad"] for k, v in rows.items() if v["bad"]}
    if bad:
        raise SystemExit(f"rolling: tokens differ from make_generate's "
                         f"beyond near-ties: {bad}")
    return row


def phase_moe_train(smi) -> dict:
    """MoE training: phase 10's small f32 model with 4 experts, capacity
    1.5 and aux 0.01 three steps on the CPU and on the card
    (``phase_train_parity``); then phase 21's top-2 config (the flagship's
    widths, 8 experts, top-2, capacity 2.0, aux 0.01) cut to 2 layers at
    phase 11's batch 4 x seq 2048, full remat, flash attention
    (``phase_train``: step time, tokens/s, MFU over the parameters a token
    runs through, peak memory, flash launches all wgmma, a loss that falls
    on one repeated batch)."""
    parity = phase_train_parity(
        smi, _small_cfg(n_experts=4, moe_capacity_factor=1.5,
                        moe_aux_coeff=0.01), tag="moe_train_parity")
    cfg = _moe_cfg(_flagship_train_cfg(), n_layers=2, moe_aux_coeff=0.01)
    row, state, _step, _repeat = phase_train(smi, cfg, tag="moe_train",
                                             timed=3)
    del state, _step, _repeat
    torch.cuda.empty_cache()
    return {"parity": parity, "train": row}


# -- phases 24-28: the model lifecycle — text, training, checkpoint, serving,
# distillation, import --------------------------------------------------------

LIFE_DIR = os.path.join(ROOT, "build", "chip_smoke")   # git-ignored
CORPUS_BYTES = 64 << 20     # at least 64 MB of text
LIFE_BATCH, LIFE_SEQ = 4, 2048
LIFE_STEPS = 120            # phase 25's training steps (200 until phase
LIFE_SAVE_AT = 60           # 37 came); the checkpoints, mid-run
LIFE_RESUMED = 3            # steps compared after the restore
RESUME_TOL = 1e-4           # relative, the resumed losses
DISTILL_STEPS = 200
DISTILL_LR = 1e-3
DISTILL_PAIRS = 3           # plain / speculative pairs, alternated
LIFE_NEW = 32               # new tokens a text request, phase 6's
HF_WIDTHS = dict(vocab=32000, d=2048, layers=12, heads=16, d_ff=5632)

# a small grammar: every sentence is determiner adjective noun verb
# determiner adjective noun preposition determiner noun, and each word
# prefers one word of the next slot's class (taken 80% of the time), so
# the text is learnable beyond its spelling
_WORDS = (
    ("the", "a", "every", "one", "this", "that", "some", "no", "each",
     "her", "his", "our"),
    ("red", "quiet", "small", "ancient", "bright", "cold", "hungry",
     "gentle", "broken", "golden", "hidden", "narrow", "rapid", "silent",
     "tall", "wooden", "wild", "young", "pale", "heavy", "distant",
     "sudden", "empty", "careful", "curious", "dusty", "green", "open",
     "patient", "rough", "sharp", "sleepy"),
    ("river", "teacher", "garden", "engine", "window", "mountain", "fox",
     "lantern", "village", "sailor", "kettle", "letter", "market", "bridge",
     "forest", "merchant", "tower", "harbor", "candle", "painter",
     "library", "orchard", "island", "soldier", "clock", "meadow", "train",
     "valley", "doctor", "castle", "farmer", "storm", "wagon", "poet",
     "mirror", "temple", "rabbit", "cellar", "beacon", "compass"),
    ("watches", "follows", "carries", "finds", "remembers", "builds",
     "paints", "crosses", "guards", "answers", "opens", "hides", "visits",
     "repairs", "counts", "lifts", "greets", "forgets", "measures",
     "shelters", "chases", "describes", "sells", "borrows"),
    ("near", "under", "beside", "behind", "across", "beyond", "inside",
     "above", "toward", "around", "past", "along"))
_TEMPLATE = (0, 1, 2, 3, 0, 1, 2, 4, 0, 2)


def _corpus_text(seed: int, n_bytes: int) -> list:
    """Documents (lists of sentences joined) of seeded text, together at
    least *n_bytes* long once joined with ``"\\n\\n"``."""
    rng = np.random.default_rng(seed)
    words = [w for c in _WORDS for w in c]
    first = np.cumsum([0] + [len(c) for c in _WORDS])
    # each word's preferred successor in each class
    pref = [rng.integers(0, len(c), size=len(words)) for c in _WORDS]
    n = n_bytes // 60 + 1
    cols, prev = [], None
    for slot, c in enumerate(_TEMPLATE):
        size = len(_WORDS[c])
        w = rng.integers(0, size, n)
        if prev is not None:
            w = np.where(rng.random(n) < 0.8, pref[c][prev], w)
        prev = first[c] + w
        cols.append(prev)
    idx = np.stack(cols, axis=1).tolist()
    caps = [w.capitalize() for w in words]
    sentences = [" ".join([caps[r[0]]] + [words[i] for i in r[1:]]) + "."
                 for r in idx]
    bounds = np.cumsum(rng.integers(8, 40, size=n))
    docs, start = [], 0
    for end in bounds:
        if start >= n:
            break
        docs.append(" ".join(sentences[start:end]))
        start = end
    return docs


def phase_text_data(smi: str, step_ms: float) -> dict:
    """Phase 24: the corpus (seeded text, >= 64 MB, documents separated by
    a blank line; the last 5% of documents held out), ``ByteTokenizer.
    encode_file`` into two token files (host seconds, tokens/s), the
    native loader built at first use (seconds), ``TokenFile.batches`` at
    4 x 2048 (ms a batch, and its share of phase 11's step time: the data
    stall share), two workers' shards (disjoint spans, every row the
    file's tokens at the offset it was drawn from), and the committed BPE
    fixture through the stdlib ``re`` (its vectors exactly, and no
    ``regex`` module loaded)."""
    from kubetpu_torch.jobs import native_data
    from kubetpu_torch.jobs.data import ByteTokenizer
    from kubetpu_torch.jobs.tokenizer import load_hf_tokenizer

    t_phase = time.perf_counter()
    shutil.rmtree(LIFE_DIR, ignore_errors=True)
    os.makedirs(LIFE_DIR)
    t0 = time.perf_counter()
    docs = _corpus_text(24, CORPUS_BYTES)
    held_n = max(1, len(docs) // 20)
    texts = {"train": "\n\n".join(docs[:-held_n]),
             "held": "\n\n".join(docs[-held_n:])}
    paths = {}
    for name, text in texts.items():
        paths[name] = os.path.join(LIFE_DIR, f"{name}.txt")
        with open(paths[name], "w", encoding="utf-8") as f:
            f.write(text)
    gen_s = time.perf_counter() - t0
    text_bytes = sum(len(t) for t in texts.values())
    if text_bytes < CORPUS_BYTES:
        raise SystemExit(f"text_data: corpus {text_bytes} bytes")
    tok = ByteTokenizer()
    t0 = time.perf_counter()
    n_tokens = {name: tok.encode_file(paths[name], paths[name][:-4] + ".bin")
                for name in paths}
    encode_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    native_data._lib()                       # the first use builds it
    load_s = time.perf_counter() - t0
    files = {name: native_data.TokenFile(paths[name][:-4] + ".bin")
             for name in paths}
    if any(files[k].num_tokens != n_tokens[k] for k in files):
        raise SystemExit("text_data: token counts differ from encode_file's")
    it = files["train"].batches(LIFE_BATCH, LIFE_SEQ, seed=1)
    next(it)
    t0 = time.perf_counter()
    for _ in range(50):
        tokens, targets = next(it)
    batch_ms = (time.perf_counter() - t0) / 50 * 1e3
    ok_shift = bool((tokens[:, 1:] == targets[:, :-1]).all())
    # two workers: each draws only from its half of the stream
    flat = np.memmap(paths["train"][:-4] + ".bin", dtype=np.uint16, mode="r")
    span = files["train"].num_tokens // 2
    shards = {}
    for w in (0, 1):
        rows, _ = next(files["train"].batches(64, LIFE_SEQ, seed=5, worker=w,
                                              num_workers=2))
        offs = np.random.default_rng((5, w)).integers(
            w * span, w * span + span - (LIFE_SEQ + 1) + 1, size=64)
        rows_ok = all(np.array_equal(r, flat[o:o + LIFE_SEQ])
                      for r, o in zip(rows, offs))
        shards[w] = dict(rows_ok=rows_ok, lo=int(offs.min()),
                         hi=int(offs.max()) + LIFE_SEQ + 1)
    disjoint = (shards[0]["hi"] <= span <= shards[1]["lo"]
                and shards[0]["rows_ok"] and shards[1]["rows_ok"])
    del flat
    # the committed BPE fixture, stdlib re only
    t0 = time.perf_counter()
    bpe = load_hf_tokenizer(os.path.join(ROOT, "tests", "fixtures",
                                         "tiny_tokenizer.json"))
    with open(os.path.join(ROOT, "tests", "fixtures",
                           "tiny_tokenizer_vectors.json")) as f:
        vectors = json.load(f)
    bad_vectors = [t for t, ids in vectors.items() if bpe.encode(t) != ids]
    bpe_s = time.perf_counter() - t0
    regex_loaded = "regex" in sys.modules
    row = dict(card=torch.cuda.get_device_name(0), nvidia_smi=smi,
               text_bytes=text_bytes, documents=len(docs),
               held_out_documents=held_n, generate_s=gen_s,
               tokens=n_tokens, encode_s=encode_s,
               encode_tokens_s=sum(n_tokens.values()) / encode_s,
               loader_build_s=native_data.BUILD_SECONDS,
               loader_load_s=load_s, batch=[LIFE_BATCH, LIFE_SEQ],
               batch_ms=batch_ms, step_ms_phase11=step_ms,
               data_stall_share=batch_ms / step_ms, targets_shifted=ok_shift,
               shards=shards, shards_disjoint=disjoint,
               bpe_vectors=len(vectors), bpe_mismatches=bad_vectors,
               bpe_load_encode_s=bpe_s, regex_loaded=regex_loaded,
               seconds=time.perf_counter() - t_phase)
    line("text_data", **row)
    if not ok_shift or not disjoint:
        raise SystemExit(f"text_data: batches or shards wrong: {shards}")
    if bad_vectors or regex_loaded or len(vectors) < 10:
        raise SystemExit(f"text_data: BPE fixture {bad_vectors}, regex "
                         f"loaded {regex_loaded}")
    return row, files, texts["held"]


def _leaves_equal(leaves, snapshot) -> bool:
    return all(torch.equal(a, b.to(a.device)) for a, b in zip(leaves,
                                                              snapshot))


def _cpu_target(cfg, optimizer):
    """A CPU train state of *cfg*'s structure, weights uninitialized (the
    restore overwrites every tensor)."""
    from kubetpu_torch.jobs import train as train_lib
    from kubetpu_torch.jobs.model import Transformer

    with torch.no_grad():
        model = Transformer(cfg, torch.device("cpu"))
    return train_lib.state_from_params(model, optimizer)


def _flash_dict(c) -> dict:
    """``_flash_counts()`` by name."""
    return dict(forward=c[0], dq=c[1], dkv=c[2], forward_wgmma=c[3],
                dq_wgmma=c[4], dkv_wgmma=c[5])


def _flash_delta(run):
    """run() with the flash counters zeroed just before and read just
    after -> (its result, {forward, dq, dkv, *_wgmma})."""
    _zero_flash_counts()
    out = run()
    torch.cuda.synchronize()
    return out, _flash_dict(_flash_counts())


def _add_counts(total: dict, more: dict) -> None:
    for k, v in more.items():
        total[k] = total.get(k, 0) + v


def phase_text_train(smi: str, files) -> dict:
    """Phase 25: the flagship (phase 11's config: full remat, flash) trained
    LIFE_STEPS steps on ``TokenFile`` batches of the corpus, with a
    synchronous ``save_checkpoint`` and an ``AsyncCheckpointer`` save at
    step LIFE_SAVE_AT (bytes, write seconds, the ms the step loop paid
    for the async save against a step's ms, the steps' ms while its
    writer runs); ``evaluate`` on held-out windows; ``restore_checkpoint``
    into a fresh state on the card and onto the CPU. Gates: the flash
    launches of the training loop 24 / 12 / 12 a step, all wgmma; a
    falling loss; both restores byte-equal to the state at the save; the
    resumed run's next LIFE_RESUMED losses within RESUME_TOL relative of
    the uninterrupted run's; a mangled checkpoint raises
    ``CorruptCheckpointError``."""
    from kubetpu_torch.jobs import checkpoint as ckpt
    from kubetpu_torch.jobs import train as train_lib
    from kubetpu_torch.jobs.data import evaluate

    t_phase = time.perf_counter()
    cfg = _flagship_train_cfg()
    state, opt = train_lib.init_state(
        torch.Generator(device="cuda").manual_seed(0), cfg, device="cuda")
    step = train_lib.make_train_step(cfg, opt, attention="flash",
                                     device="cuda")
    it = files["train"].batches(LIFE_BATCH, LIFE_SEQ, seed=1)
    state, _ = step(state, *next(it))                # warm-up
    torch.cuda.synchronize()
    launches, losses = {}, []

    def run_steps(n):
        nonlocal state
        out = []
        for _ in range(n):
            state, loss = step(state, *next(it))
            out.append(loss)
        return [float(x) for x in out]

    t0 = time.perf_counter()
    first, counts = _flash_delta(lambda: run_steps(LIFE_SAVE_AT - 1))
    loop_s = time.perf_counter() - t0
    losses += first
    _add_counts(launches, counts)
    n = LIFE_SAVE_AT - 1
    want = {"forward": 2 * cfg.n_layers * n, "dq": cfg.n_layers * n,
            "dkv": cfg.n_layers * n, "forward_wgmma": 2 * cfg.n_layers * n,
            "dq_wgmma": cfg.n_layers * n, "dkv_wgmma": cfg.n_layers * n}
    if counts != want:
        raise SystemExit(f"text_train: flash launches {counts} != {want}")
    step_ms = loop_s / n * 1e3
    # the checkpoints at step LIFE_SAVE_AT
    snapshot = [t.detach().clone() for t in ckpt._leaves(state)]
    saved_step = state.step
    n_bytes = sum(t.numel() * t.element_size() for t in snapshot)
    sync_dir = os.path.join(LIFE_DIR, "ckpt", str(saved_step))
    async_dir = os.path.join(LIFE_DIR, "ckpt_async", str(saved_step))
    t0 = time.perf_counter()
    ckpt.save_checkpoint(sync_dir, state)
    sync_s = time.perf_counter() - t0
    file_bytes = os.path.getsize(os.path.join(sync_dir, ckpt.STATE_FILE))
    saver = ckpt.AsyncCheckpointer()
    t0 = time.perf_counter()
    saver.save(async_dir, state)
    paid_ms = (time.perf_counter() - t0) * 1e3
    batches_after = [next(it) for _ in range(LIFE_RESUMED)]
    t0 = time.perf_counter()

    def straight_steps():
        nonlocal state
        out = []
        for b in batches_after:
            state, loss = step(state, *b)
            out.append(float(loss))
        return out

    straight, counts = _flash_delta(straight_steps)
    during_ms = (time.perf_counter() - t0) / LIFE_RESUMED * 1e3
    _add_counts(launches, counts)
    losses += straight
    t0 = time.perf_counter()
    saver.close()
    async_wait_s = time.perf_counter() - t0
    rest, counts = _flash_delta(
        lambda: run_steps(LIFE_STEPS - LIFE_SAVE_AT - LIFE_RESUMED))
    losses += rest
    _add_counts(launches, counts)
    held = files["held"].batches(LIFE_BATCH, LIFE_SEQ, seed=3)
    eval_step = train_lib.make_eval_step(cfg, attention="flash",
                                         device="cuda")
    ev, counts = _flash_delta(
        lambda: evaluate(eval_step, state.params, held, 4))
    _add_counts(launches, counts)

    # restore on the card, then resume from it
    fresh, _ = train_lib.init_state(
        torch.Generator(device="cuda").manual_seed(1), cfg, device="cuda")
    t0 = time.perf_counter()
    ckpt.restore_checkpoint(sync_dir, fresh)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    card_equal = (_leaves_equal(ckpt._leaves(fresh), snapshot)
                  and fresh.step == saved_step)

    def resumed_steps():
        nonlocal fresh
        out = []
        for b in batches_after:
            fresh, loss = step(fresh, *b)
            out.append(float(loss))
        return out

    resumed, counts = _flash_delta(resumed_steps)
    _add_counts(launches, counts)
    gap = max(abs(a - b) / abs(b) for a, b in zip(resumed, straight))
    del fresh
    torch.cuda.empty_cache()
    # the async files onto the CPU
    host = _cpu_target(cfg, opt)
    t0 = time.perf_counter()
    ckpt.restore_checkpoint(async_dir, host)
    cpu_restore_s = time.perf_counter() - t0
    cpu_equal = (_leaves_equal(ckpt._leaves(host), snapshot)
                 and host.step == saved_step
                 and all(t.device.type == "cpu" for t in ckpt._leaves(host)))
    del host, snapshot
    # a mangled checkpoint: the sync file cut to half its length
    path = os.path.join(sync_dir, ckpt.STATE_FILE)
    os.truncate(path, file_bytes // 2)
    probe = _cpu_target(dataclasses.replace(cfg, n_layers=1), opt)
    try:
        ckpt.restore_checkpoint(sync_dir, probe)
        typed = False
    except ckpt.CorruptCheckpointError:
        typed = True
    del probe
    shutil.rmtree(os.path.join(LIFE_DIR, "ckpt"), ignore_errors=True)
    shutil.rmtree(os.path.join(LIFE_DIR, "ckpt_async"), ignore_errors=True)
    head, tail = np.mean(losses[:10]), np.mean(losses[-10:])
    row = dict(card=torch.cuda.get_device_name(0), nvidia_smi=smi,
               steps=len(losses) + 1, batch=[LIFE_BATCH, LIFE_SEQ],
               step_ms=step_ms, tokens_s=LIFE_BATCH * LIFE_SEQ / step_ms * 1e3,
               loss_first10=float(head), loss_last10=float(tail),
               losses_every_10=losses[::10], eval=ev,
               checkpoint=dict(step=saved_step, state_bytes=n_bytes,
                               file_bytes=file_bytes, sync_write_s=sync_s,
                               sync_gb_s=file_bytes / sync_s / 1e9,
                               async_paid_ms=paid_ms,
                               async_paid_over_step=paid_ms / step_ms,
                               steps_during_write_ms=during_ms,
                               async_wait_at_close_s=async_wait_s,
                               card_restore_s=restore_s,
                               cpu_restore_s=cpu_restore_s),
               restored_card_equal=card_equal, restored_cpu_equal=cpu_equal,
               straight_losses=straight, resumed_losses=resumed,
               resumed_max_rel_gap=gap, resume_tol=RESUME_TOL,
               mangled_raises_typed=typed, flash_launches=launches,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
               seconds=time.perf_counter() - t_phase)
    line("text_train", **row)
    if not tail < head or not all(np.isfinite(losses)):
        raise SystemExit(f"text_train: loss did not fall: {head} -> {tail}")
    if not card_equal or not cpu_equal:
        raise SystemExit(f"text_train: restore differs (card {card_equal}, "
                         f"cpu {cpu_equal})")
    if not gap <= RESUME_TOL:
        raise SystemExit(f"text_train: resumed losses {resumed} vs "
                         f"{straight}: gap {gap}")
    if not typed:
        raise SystemExit("text_train: a mangled checkpoint restored")
    return row, state, cfg


def _text_prompts(held: str) -> tuple:
    """Phase 26's prompts: held-out text cut at SERVE_LENGTHS characters
    (ASCII: one byte token each, after a BOS), each starting at a
    sentence."""
    import re

    from kubetpu_torch.jobs.data import ByteTokenizer

    tok = ByteTokenizer()
    starts = [m.start() for m in re.finditer(r"[A-Z]", held)]
    rng = np.random.default_rng(26)
    texts = []
    for n in SERVE_LENGTHS:
        s = starts[int(rng.integers(0, len(starts) // 2))]
        texts.append(held[s:s + n - 1])
    return texts, [tok.encode(t, bos=True, eos=False) for t in texts]


def _generate_top2(cfg, model, prompts, n) -> tuple:
    """``make_generate``'s greedy tokens of each prompt alone, and the
    top-two gaps of every row it sampled ({(prompt, index): gap})."""
    from kubetpu_torch.jobs import decode

    outs, gaps = [], {}
    for p in prompts:
        out, top2, _s = _recorded_generate(
            lambda: decode.make_generate(cfg), model,
            torch.tensor([p], device="cuda"), n, "make_slot_sampler")
        outs.append(out[0].tolist())
        for j, t in enumerate(top2):
            gaps[(tuple(p), j)] = float(t[0, 0] - t[0, 1])
    return outs, gaps


def _paged_expected(cfg, st) -> dict:
    """Phase 6's launch rule: one attention call per layer and decode step
    (split + combine) or prefill chunk (wgmma), nothing on SIMT."""
    n_dec, n_chunk = (cfg.n_layers * st[k] for k in ("steps", "chunks"))
    return dict(launches=n_dec + n_chunk, split_launches=n_dec,
                wgmma_launches=n_chunk, wgmma_int8_launches=0,
                simt_launches=0)


def phase_text_serve(model, cfg, held, smi, launches) -> dict:
    """Phase 26: the restored-and-trained flagship behind
    ``PagedDecodeServer`` at phase 6's settings, fed string prompts cut
    from held-out text, answering decoded text: decode tokens/s, TTFT p50,
    the paged launches (counters zeroed before, read after: phase 6's
    rule, nothing on SIMT). Gates: the tokens equal ``make_generate``'s
    under phase 16's near-tie rule, the decoded text encodes back to the
    same byte ids."""
    from kubetpu_torch.jobs.data import ByteTokenizer

    t_phase = time.perf_counter()
    texts, prompts = _text_prompts(held)
    server = _flagship_server(model, cfg, max_new_tokens=LIFE_NEW)
    run = _drive(server, [prompts], launches)
    st = server._smoke_stats
    want = _paged_expected(cfg, st)
    got = {k: run["paged_launches"][k] for k in want}
    ttft = server.metrics_summary()["ttft"]["p50_ms"]
    del server
    torch.cuda.empty_cache()
    ref, gaps = _generate_top2(cfg, model, prompts, LIFE_NEW)
    ties = _near_tie_check(run["results"], ref, gaps, prompts)
    tok = ByteTokenizer()
    answers, round_trip, other_ids = [], True, 0
    for p, out in zip(prompts, run["results"]):
        new = out[len(p):]
        text = tok.decode(new)
        answers.append(text)
        byte_ids = [i for i in new if i < 256]
        other_ids += len(new) - len(byte_ids)
        round_trip &= tok.encode(text, bos=False, eos=False) == byte_ids
    row = dict(card=torch.cuda.get_device_name(0), nvidia_smi=smi,
               requests=len(prompts), prompt_chars=[len(t) for t in texts],
               new_tokens=LIFE_NEW, decode_toks_s=run["decode_toks_s"],
               ttft_p50_ms=ttft, wall_s=run["wall_s"],
               paged_launches=run["paged_launches"], expected_launches=want,
               tokens_equal_generate=sum(a == b for a, b in zip(
                   run["results"], ref)),
               diverged=ties["diverged"], round_trip=round_trip,
               non_byte_ids=other_ids,
               sample={"prompt_tail": texts[0][-60:], "answer": answers[0]},
               seconds=time.perf_counter() - t_phase)
    line("text_serve", **row)
    if got != want:
        raise SystemExit(f"text_serve: paged launches {got} != {want}")
    if ties["bad"]:
        raise SystemExit(f"text_serve: tokens differ from make_generate's "
                         f"beyond near-ties: {ties['bad']}")
    if not round_trip:
        raise SystemExit(f"text_serve: decoded text does not round-trip: "
                         f"{answers}")
    return row, prompts


def _timed_serve(server, prompts, launches, new_tokens, st) -> dict:
    """Serve *prompts* at once on a warmed server: results, tokens/s over
    the whole run and over the steps that ran no prefill chunk (*st*: the
    server's chunk counter, ``_instrument`` or ``_instrument_spec``), the
    paged launches (zeroed before, added to *launches*)."""
    from kubetpu_torch.ops import paged_attention as pa

    for c in _PAGED_COUNTERS:
        setattr(pa.paged_attention, c, 0)
    torch.cuda.synchronize()
    t_start = time.perf_counter()
    rids = [server.enqueue(p) for p in prompts]
    decode_s, decode_tokens = 0.0, 0
    while not server._idle():
        chunks = st["chunks"]
        t0 = time.perf_counter()
        out = server.step()
        dt = time.perf_counter() - t0
        if st["chunks"] == chunks and out:
            decode_s += dt
            decode_tokens += sum(len(v) for v in out.values())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_start
    counts = {c: getattr(pa.paged_attention, c) for c in _PAGED_COUNTERS}
    _add_counts(launches, counts)
    server.check_invariants()
    return dict(results=[server.pop_result(r) for r in rids], wall_s=wall,
                toks_s=len(prompts) * new_tokens / wall,
                decode_toks_s=decode_tokens / decode_s if decode_s else None,
                paged_launches=counts)


def phase_distill(target, cfg, files, prompts, smi, launches) -> dict:
    """Phase 27: phase 16's quarter draft (d 512, 3 layers, 4 heads, d_ff
    1408, random from seed 7) distilled against the trained flagship on
    the corpus (DISTILL_STEPS steps, flash on both, lr DISTILL_LR):
    greedy agreement on held-out windows before and after, beside a
    3-layer ``truncated_draft``'s; then ``PagedSpeculativeDecodeServer``
    (target + distilled draft, gamma_max 4, adaptive) against the plain
    ``PagedDecodeServer`` on phase 26's prompts with SPEC_NEW new tokens,
    DISTILL_PAIRS pairs alternated: tokens/s and its ratio over the whole
    run and over the steps that ran no prefill chunk, tokens per round,
    accepted share; then one profiled round beside ten profiled plain
    steps (wall, device busy, idle share; the draft's and the verify's
    device ms). Gates: agreement after > before; the speculative
    tokens equal the plain server's under phase 16's near-tie rule. No
    speed gate."""
    from kubetpu_torch.jobs import distill
    from kubetpu_torch.jobs import model as model_lib
    from kubetpu_torch.jobs.paged import PagedDecodeServer
    from kubetpu_torch.jobs.spec_serving import PagedSpeculativeDecodeServer
    from kubetpu_torch.jobs.train import make_optimizer

    t_phase = time.perf_counter()
    qcfg = model_lib.ModelConfig(vocab=cfg.vocab, d_model=512, n_layers=3,
                                 n_heads=4, d_ff=1408, max_seq=2048,
                                 dtype=torch.bfloat16)
    step, opt = distill.make_distill_step(
        cfg, qcfg, make_optimizer(lr=DISTILL_LR), device="cuda")
    dstate = distill.init_draft_state(
        torch.Generator(device="cuda").manual_seed(7), qcfg, opt,
        device="cuda")
    held, _ = next(files["held"].batches(LIFE_BATCH, LIFE_SEQ, seed=4))
    flash = {}

    def agree(dc, d):
        a, counts = _flash_delta(lambda: distill.agreement_rate(
            cfg, dc, target, d, held))
        _add_counts(flash, counts)
        return a

    before = agree(qcfg, dstate.params)
    tcfg3, trunc = distill.truncated_draft(cfg, target, min(3, cfg.n_layers))
    truncated = agree(tcfg3, trunc)
    del trunc
    it = files["train"].batches(LIFE_BATCH, LIFE_SEQ, seed=2)
    dstate, _ = step(dstate, target, *next(it))       # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()

    def steps():
        nonlocal dstate
        out = []
        for _ in range(DISTILL_STEPS - 1):
            dstate, loss = step(dstate, target, *next(it))
            out.append(loss)
        return [float(x) for x in out]

    losses, counts = _flash_delta(steps)
    distill_ms = (time.perf_counter() - t0) / (DISTILL_STEPS - 1) * 1e3
    _add_counts(flash, counts)
    after = agree(qcfg, dstate.params)
    draft = dstate.params
    for p in draft.parameters():
        p.requires_grad_(False)
    del dstate
    torch.cuda.empty_cache()

    kw = dict(n_slots=8, max_seq=2048, max_new_tokens=SPEC_NEW,
              page_size=16, prefill_budget=256, device="cuda")
    plain_srv = PagedDecodeServer(cfg, target, **kw)
    plain_srv.warmup()
    plain_st = _instrument(plain_srv)
    rec = _record_top2(plain_srv)
    spec_srv = PagedSpeculativeDecodeServer(cfg, qcfg, target, draft,
                                            gamma_max=GAMMA_MAX,
                                            adaptive_gamma=True, **kw)
    spec_srv.warmup()
    spec_st = _instrument_spec(spec_srv)
    pairs = []
    for i in range(DISTILL_PAIRS):
        plain = _timed_serve(plain_srv, prompts, launches, SPEC_NEW,
                             plain_st)
        rounds0 = spec_srv._c_spec_rounds.value
        prop0 = spec_srv._c_spec_proposed.value
        acc0 = spec_srv._c_spec_accepted.value
        spec = _timed_serve(spec_srv, prompts, launches, SPEC_NEW, spec_st)
        rounds = spec_srv._c_spec_rounds.value - rounds0
        proposed = spec_srv._c_spec_proposed.value - prop0
        pairs.append(dict(
            plain_toks_s=plain["toks_s"], spec_toks_s=spec["toks_s"],
            ratio=spec["toks_s"] / plain["toks_s"],
            plain_decode_toks_s=plain["decode_toks_s"],
            spec_decode_toks_s=spec["decode_toks_s"],
            decode_ratio=spec["decode_toks_s"] / plain["decode_toks_s"],
            rounds=int(rounds),
            accepted_share=((spec_srv._c_spec_accepted.value - acc0)
                            / proposed if proposed else None),
            plain=plain["results"], spec=spec["results"]))
    gaps = _top2_gaps(rec)
    # where a round's time goes, beside a plain decode step's
    head = [p[:256] for p in prompts]
    round_profile = _spec_round_profile(spec_srv, head)
    step_profile = _ten_step_profile(plain_srv)
    ties = _near_tie_check(pairs[0]["spec"], pairs[0]["plain"], gaps,
                           prompts)
    stable = all(p["plain"] == pairs[0]["plain"] and p["spec"]
                 == pairs[0]["spec"] for p in pairs)
    mean_tpr = spec_srv.mean_tokens_per_round()
    del plain_srv, spec_srv
    torch.cuda.empty_cache()
    row = dict(card=torch.cuda.get_device_name(0), nvidia_smi=smi,
               draft="d 512, 3 layers, 4 heads, d_ff 1408, bf16, seed 7",
               distill_steps=DISTILL_STEPS, distill_step_ms=distill_ms,
               distill_loss_first10=float(np.mean(losses[:10])),
               distill_loss_last10=float(np.mean(losses[-10:])),
               agreement_before=before, agreement_after=after,
               agreement_truncated3=truncated,
               agreement_windows=[LIFE_BATCH, LIFE_SEQ],
               spec_new_tokens=SPEC_NEW, gamma_max=GAMMA_MAX,
               pairs=[{k: v for k, v in p.items() if k not in ("plain",
                                                              "spec")}
                      for p in pairs],
               ratio_median=float(np.median([p["ratio"] for p in pairs])),
               decode_ratio_median=float(np.median(
                   [p["decode_ratio"] for p in pairs])),
               round_profile=round_profile, plain_step_profile=step_profile,
               mean_tokens_per_round=mean_tpr,
               tokens_equal_plain=sum(a == b for a, b in zip(
                   pairs[0]["spec"], pairs[0]["plain"])),
               runs_repeat_tokens=stable, diverged=ties["diverged"],
               flash_launches=flash,
               seconds=time.perf_counter() - t_phase)
    line("distill", **row)
    if not after > before:
        raise SystemExit(f"distill: agreement {before} -> {after}")
    if ties["bad"]:
        raise SystemExit(f"distill: speculative tokens differ from the plain "
                         f"server's beyond near-ties: {ties['bad']}")
    return row


def _llama_state_dict(gen, vocab, d, layers, heads, kv_heads, d_ff,
                      dtype=torch.bfloat16) -> dict:
    """A seeded state dict in ``LlamaForCausalLM``'s layout (torch Linear
    weights (out, in), norms at one), on the CPU."""
    hd = d // heads

    def w(out, inp):
        return (torch.randn((out, inp), generator=gen) * inp ** -0.5).to(
            dtype)

    sd = {"model.embed_tokens.weight": w(vocab, d)}
    for i in range(layers):
        p = f"model.layers.{i}."
        sd.update({
            p + "input_layernorm.weight": torch.ones(d, dtype=dtype),
            p + "post_attention_layernorm.weight": torch.ones(d, dtype=dtype),
            p + "self_attn.q_proj.weight": w(heads * hd, d),
            p + "self_attn.k_proj.weight": w(kv_heads * hd, d),
            p + "self_attn.v_proj.weight": w(kv_heads * hd, d),
            p + "self_attn.o_proj.weight": w(d, heads * hd),
            p + "mlp.gate_proj.weight": w(d_ff, d),
            p + "mlp.up_proj.weight": w(d_ff, d),
            p + "mlp.down_proj.weight": w(d, d_ff)})
    sd["model.norm.weight"] = torch.ones(d, dtype=dtype)
    sd["lm_head.weight"] = w(vocab, d)
    return sd


def _llama_namespace(vocab, d, layers, heads, kv_heads, d_ff, max_pos,
                     **extra):
    import types

    return types.SimpleNamespace(
        model_type="llama", vocab_size=vocab, hidden_size=d,
        num_hidden_layers=layers, num_attention_heads=heads,
        num_key_value_heads=kv_heads, intermediate_size=d_ff,
        max_position_embeddings=max_pos, rms_norm_eps=1e-6,
        rope_theta=10000.0, **extra)


def phase_hf_import(smi: str, launches) -> dict:
    """Phase 28: seeded llama-layout state dicts at the flagship's widths
    (MHA, and GQA with 4 KV heads under a llama3 ``rope_scaling``
    namespace), bf16 on the host, imported straight onto the card in bf16
    by ``params_from_hf``: import seconds and the held peak memory against
    the weights' bytes; each imported model serves phase 6's prompts
    (every request its 32 tokens, the first token within LOGIT_TOL of a
    dense forward's best, the paged launches by phase 6's rule); and a
    small f32 import (vocab 512, d 256, 2 layers, 4 heads / 2 kv) serves
    equal tokens on the card and on the CPU."""
    import types

    from kubetpu_torch.jobs import hf_import
    from kubetpu_torch.jobs import model as model_lib
    from kubetpu_torch.jobs.paged import PagedDecodeServer

    t_phase = time.perf_counter()
    widths = HF_WIDTHS
    prompts = _serve_prompts(model_lib.ModelConfig(vocab=widths["vocab"]))
    arms = {}
    for name, kv, extra in (
            ("mha", widths["heads"], {}),
            ("gqa_llama3", 4, {"rope_scaling": {
                "rope_type": "llama3", "factor": 8.0,
                "low_freq_factor": 1.0, "high_freq_factor": 4.0,
                "original_max_position_embeddings": 8192}})):
        t0 = time.perf_counter()
        sd = _llama_state_dict(torch.Generator().manual_seed(28), kv_heads=kv,
                               **widths)
        make_s = time.perf_counter() - t0
        ns = _llama_namespace(widths["vocab"], widths["d"], widths["layers"],
                              widths["heads"], kv, widths["d_ff"], 2048,
                              **extra)
        weight_bytes = sum(t.numel() * 2 for t in sd.values())
        gc.collect()              # the last arm's server holds cycles
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model, cfg = hf_import.params_from_hf(
            types.SimpleNamespace(config=ns, state_dict=lambda: sd),
            dtype=torch.bfloat16, device="cuda")
        torch.cuda.synchronize()
        import_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - base
        held = torch.cuda.memory_allocated() - base
        del sd
        cfg = dataclasses.replace(cfg, max_seq=2048)
        server = _flagship_server(model, cfg, max_new_tokens=32)
        run = _drive(server, [prompts], launches)
        want = _paged_expected(cfg, server._smoke_stats)
        got = {k: run["paged_launches"][k] for k in want}
        i = SERVE_LENGTHS.index(max(SERVE_LENGTHS))
        with torch.no_grad():
            dense = model_lib.forward(
                model, torch.tensor([prompts[i]], device="cuda"), cfg)[0, -1]
        served = run["results"][i][len(prompts[i])]
        first_gap = float(dense.float().max() - dense.float()[served])
        ok = (got == want and first_gap <= LOGIT_TOL
              and all(len(r) == len(p) + 32
                      for r, p in zip(run["results"], prompts)))
        arms[name] = dict(kv_heads=kv, rope_llama3=cfg.rope_llama3_scaling,
                          state_dict_make_s=make_s, import_s=import_s,
                          weight_bytes=weight_bytes, held_bytes=held,
                          peak_bytes=peak, peak_over_weights=peak
                          / weight_bytes, decode_toks_s=run["decode_toks_s"],
                          paged_launches=run["paged_launches"],
                          first_token_dense_gap=first_gap, ok=ok)
        del server, model, dense
        torch.cuda.empty_cache()
    # the small f32 import: card tokens == CPU tokens
    small = dict(vocab=512, d=256, layers=2, heads=4, kv_heads=2, d_ff=512)
    sd = _llama_state_dict(torch.Generator().manual_seed(29),
                           dtype=torch.float32, **small)
    ns = _llama_namespace(small["vocab"], small["d"], small["layers"],
                          small["heads"], small["kv_heads"], small["d_ff"],
                          256)
    rng = np.random.default_rng(28)
    sp = [rng.integers(0, 512, n).tolist() for n in (5, 40, 23, 70)]
    tokens = {}
    for dev in ("cpu", "cuda"):
        model, scfg = hf_import.params_from_hf(
            types.SimpleNamespace(config=ns, state_dict=lambda: sd),
            device=dev)
        server = PagedDecodeServer(scfg, model, n_slots=3, max_seq=256,
                                   max_new_tokens=16, page_size=16,
                                   prefill_budget=32, device=dev)
        if dev == "cuda":
            run = _timed_serve(server, sp, launches, 16, _instrument(server))
        else:
            rids = [server.enqueue(p) for p in sp]
            server.drain()
            run = {"results": [server.pop_result(r) for r in rids]}
        tokens[dev] = run["results"]
    small_equal = tokens["cpu"] == tokens["cuda"]
    row = dict(card=torch.cuda.get_device_name(0), nvidia_smi=smi,
               widths=widths, arms=arms, small_f32_equal=small_equal,
               seconds=time.perf_counter() - t_phase)
    line("hf_import", **row)
    bad = [k for k, v in arms.items() if not v["ok"]]
    if bad or not small_equal:
        raise SystemExit(f"hf_import: arms {bad} failed, small f32 equal "
                         f"{small_equal}")
    return row


# -- phases 29-33: the other model families ----------------------------------

FAMILY_STEPS = 5            # timed train steps of phases 29 and 30
S2S_STEPS = 3               # phase 31's (each profiled step costs the
                            # profiler ~10 s of processing)
MLM_RATE = 0.15
ENC_LOSS_TOL = 0.02         # |flash - dense| masked-LM loss in nats: bf16
                            # through 12 layers, averaged over ~1.2k masked
                            # positions
ENC_HIDDEN_TOL = 0.05       # the worst position's relative L2 gap between
                            # the final hidden states under the step's flash
                            # core and under the dense core: bf16 through 12
                            # layers; a causal core (the planted fault) must
                            # read above it
VIT_BATCH, VIT_INFER_BATCH = 128, 256
S2S_BATCH, S2S_SRC, S2S_TGT = 4, 1024, 1024
S2S_GEN_BATCH, S2S_GEN_SRC, S2S_GEN_NEW = 8, 512, 64
BEAM_K, BEAM_BATCH, BEAM_PROMPT, BEAM_STEPS = 4, 4, 256, 64
BEAM_SCORE_TOL = 0.005      # nats a generated token: a top beam's score
                            # against a teacher-forced recompute (bf16); a
                            # search whose cache is left unreordered (the
                            # planted fault) must read above it
PROFILE_N = (4, 20)         # marginal_ms's two run lengths
PROFILED_STEPS = 16         # decode steps of the profiled beam search and
                            # seq2seq generate (the profiler's processing
                            # grows with the kernels it saw)
_WGMMA_FLASH = ("flash_fwd_wgmma_kernel", "flash_bwd_dq_wgmma_kernel",
                "flash_bwd_dkv_wgmma_kernel")


def _timed_window(step_once, n, tokens_per_step) -> dict:
    """n calls of step_once() (each returns a device loss, read back inside
    its step) under ``torch.profiler`` and a ``profiling.StepTimer``; the
    flash counters zeroed just before and read just after, the peak memory
    reset just before: losses, the timer's summary, the window's wall and
    device busy ms, idle share, peak memory, flash launches."""
    from kubetpu_torch.jobs.profiling import StepTimer

    timer = StepTimer(tokens_per_step)
    losses = []

    def run():
        for _ in range(n):
            with timer.step():
                losses.append(float(step_once()))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    (wall_us, kernels, _counts), flash = _flash_delta(lambda: _profiled(run))
    busy = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:6]
    return dict(losses=losses, timer=timer.summary(),
                step_ms=timer.summary()["p50_ms"], window_ms=wall_us / 1e3,
                device_busy_ms_per_step=busy / n / 1e3,
                idle_share=(1.0 - busy / wall_us) if busy else None,
                peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                top_kernels_ms_per_step=[(k[:60], v / n / 1e3)
                                         for k, v in top],
                flash_launches=flash)


def _flash_gate(tag, flash, layers, steps, what="a step") -> None:
    """Full remat: 2 forward, 1 dQ and 1 dK/dV launch a layer and step, every
    one on the wgmma instances (none on SIMT)."""
    want = dict(forward=2 * layers * steps, dq=layers * steps,
                dkv=layers * steps)
    want.update({f"{k}_wgmma": v for k, v in list(want.items())})
    if flash != want:
        raise SystemExit(f"{tag}: flash launches {flash} != {want} "
                         f"({steps} x {what}, all wgmma)")


def phase_encoder(smi: str, causal_step_ms: float):
    """Phase 29: the masked-LM encoder at the flagship's widths (phase 11's
    config: vocab 32000, d 2048, 12 layers, 16 heads, d_ff 5632, bf16, full
    remat), batch 4 x 2048 from ``mlm_batches`` over ``SyntheticCorpus``,
    mask rate 0.15, ``mask_id`` = vocab - 1, ``attention="flash"`` (the
    flash kernels with ``causal=False``): one warm-up step, FAMILY_STEPS
    timed steps on one repeated batch (so that the loss must fall, as on
    phase 11's repeated batch) under ``torch.profiler`` (step ms from
    ``StepTimer``,
    tokens/s, MFU with 6N + 12·L·d·S a token, device busy, idle share,
    peak memory), beside phase 11's causal step. Gates: 24 / 12 / 12 flash
    launches a step, all wgmma; the loss falls over the timed steps; the
    first timed step's loss within ENC_LOSS_TOL of ``attention="dense"``
    on the same batch and weights; on that batch, the final hidden states
    under the step's core within ENC_HIDDEN_TOL of the dense core's at
    every position, and those under a causal flash core (a planted fault)
    beyond it. Returns the state, step and a batch for phase 33."""
    from functools import partial

    from kubetpu_torch.jobs import encoder
    from kubetpu_torch.jobs import train as train_lib
    from kubetpu_torch.jobs.data import SyntheticCorpus, mlm_batches
    from kubetpu_torch.ops.flash_attention import flash_attention

    t_phase = time.perf_counter()
    cfg = _flagship_train_cfg()
    batch, seq = FLASH_SHAPE["B"], FLASH_SHAPE["S"]
    mask_id = cfg.vocab - 1
    state, opt = train_lib.init_state(
        torch.Generator(device="cuda").manual_seed(29), cfg, device="cuda")
    n_params = sum(p.numel() for p in state.params.parameters())
    step = encoder.make_mlm_train_step(cfg, mask_id, opt, attention="flash",
                                       device="cuda")
    it = mlm_batches(SyntheticCorpus(cfg.vocab, seed=0), batch, seq,
                     mask_rate=MLM_RATE, seed=29)
    warm, timed = (tuple(torch.from_numpy(x).to("cuda") for x in next(it))
                   for _ in range(2))
    state, loss = step(state, *warm)                     # warm-up
    with torch.no_grad():
        dense = float(encoder.masked_lm_loss(state.params, *timed, mask_id,
                                             cfg))
        hidden_gap = _hidden_gaps(state.params, cfg, torch.where(
            timed[1], mask_id, timed[0]), encoder.bidirectional_attention(
                "flash", "encoder"), encoder.dense_bidirectional_attention,
            partial(flash_attention, causal=True))

    def one():
        nonlocal state
        state, loss = step(state, *timed)
        return loss

    win = _timed_window(one, FAMILY_STEPS, batch * seq)
    losses = win["losses"]
    tokens_s = batch * seq / (win["step_ms"] / 1e3)
    flops_per_token = 6 * n_params + 12 * cfg.n_layers * cfg.d_model * seq
    row = dict(card=torch.cuda.get_device_name(0), nvidia_smi=smi,
               params=n_params, batch=batch, seq=seq, mask_rate=MLM_RATE,
               masked_positions=int(timed[1].sum()),
               data="one mlm_batches batch, repeated",
               attention="flash, causal=False", remat="full",
               tokens_s=tokens_s,
               mfu=tokens_s * flops_per_token / BF16_FLOP_S,
               flops_per_token=flops_per_token,
               flops_term="6N + 12*L*d*S: the attention term counts full "
                          "visibility (every query-key pair)",
               causal_step_ms=causal_step_ms,
               step_over_causal=win["step_ms"] / causal_step_ms,
               dense_loss=dense, flash_step_loss=losses[0],
               loss_gap=abs(losses[0] - dense), loss_tol=ENC_LOSS_TOL,
               hidden_gap=hidden_gap, hidden_tol=ENC_HIDDEN_TOL,
               seconds=time.perf_counter() - t_phase, **win)
    line("encoder", **row)
    _flash_gate("encoder", win["flash_launches"], cfg.n_layers, FAMILY_STEPS)
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise SystemExit(f"encoder: the loss did not fall: {losses}")
    if not row["loss_gap"] <= ENC_LOSS_TOL:
        raise SystemExit(f"encoder: flash loss {losses[0]} against dense "
                         f"{dense}: gap above {ENC_LOSS_TOL}")
    if not hidden_gap["step"] <= ENC_HIDDEN_TOL < hidden_gap["causal"]:
        raise SystemExit(f"encoder: hidden-state gaps {hidden_gap} against "
                         f"the dense core: the step's must be within "
                         f"{ENC_HIDDEN_TOL}, the causal fault's beyond it")
    return row, state, step, timed


def _hidden_gaps(params, cfg, tokens, step_core, dense_core,
                 fault_core) -> dict:
    """The worst position's ||h - h_dense|| / ||h_dense|| over the final
    hidden states of ``forward_hidden`` under the step's attention core
    and under a planted fault's, against the dense core's."""
    from kubetpu_torch.jobs.model import forward_hidden

    ref = forward_hidden(params, tokens, cfg, attn_fn=dense_core)[0].float()
    norm = torch.linalg.vector_norm(ref, dim=-1)
    out = {}
    for name, core in (("step", step_core), ("causal", fault_core)):
        h = forward_hidden(params, tokens, cfg, attn_fn=core)[0].float()
        out[name] = float((torch.linalg.vector_norm(h - ref, dim=-1)
                           / norm).max())
    return out


def _trace_kernel_ms(path: str) -> tuple:
    """(device kernel ms, the kernel names) of a Chrome trace."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    return (sum(e.get("dur", 0) for e in kernels) / 1e3,
            {e.get("name", "") for e in kernels})


def phase_profiling(state, step, batch, smi: str) -> dict:
    """Phase 33: ``profiling.marginal_ms`` on the encoder's flash forward
    (FLASH_SHAPE, ``causal=False``, each call's output the next call's q)
    three ways: the slope of n eager calls, the slope of a replayed CUDA
    graph of n calls, and CUDA events around back-to-back calls; then
    ``profiling.trace()`` around two of phase 29's steps (StepTimer step
    ms, the trace's kernel time against the steps' wall). Gates: one trace
    file, naming the three flash wgmma kernels; 2 x 24 / 12 / 12 flash
    launches in the traced steps, all wgmma."""
    from kubetpu_torch.jobs import profiling
    from kubetpu_torch.ops import flash_attention as fa

    t_phase = time.perf_counter()
    b, s, h, d = (FLASH_SHAPE[x] for x in "BSHD")
    gen = torch.Generator(device="cuda").manual_seed(33)
    q, k, v = (torch.randn((b, s, h, d), generator=gen, device="cuda",
                           dtype=torch.bfloat16) for _ in range(3))

    def chain(n):
        out = q
        for _ in range(n):
            out, _lse = fa.flash_forward(out, k, v, False, 0)
        return out

    def eager(n):
        return lambda: chain(n)[0, 0, 0, 0].float()

    graphs = []

    def graphed(n):
        chain(n)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = chain(n)
        graphs.append((graph, out))

        def run():
            graph.replay()
            return out[0, 0, 0, 0].float()
        return run

    _zero_flash_counts()
    ms = {"eager_slope": profiling.marginal_ms(eager, *PROFILE_N),
          "graph_slope": profiling.marginal_ms(graphed, *PROFILE_N),
          "cuda_events": cuda_ms(lambda: fa.flash_forward(q, k, v, False, 0),
                                 iters=20)}
    marginal_launches = _flash_dict(_flash_counts())
    del graphs, q, k, v
    torch.cuda.empty_cache()

    trace_dir = os.path.join(LIFE_DIR, "trace")
    shutil.rmtree(trace_dir, ignore_errors=True)
    timer = profiling.StepTimer(b * s)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_flash_counts()
    t0 = time.perf_counter()
    with profiling.trace(trace_dir):
        for _ in range(2):
            with timer.step():
                state, loss = step(state, *batch)
                float(loss)
    wall_ms = (time.perf_counter() - t0) * 1e3
    flash = _flash_dict(_flash_counts())
    files = sorted(os.listdir(trace_dir)) if os.path.isdir(trace_dir) else []
    busy_ms, names = (_trace_kernel_ms(os.path.join(trace_dir, files[0]))
                      if len(files) == 1 else (0.0, set()))
    named = {n: any(n in x for x in names) for n in _WGMMA_FLASH}
    row = dict(card=torch.cuda.get_device_name(0), nvidia_smi=smi,
               shape=dict(FLASH_SHAPE, causal=False, dtype="bf16"),
               n=list(PROFILE_N), flash_forward_ms=ms,
               eager_over_events=ms["eager_slope"] / ms["cuda_events"],
               graph_over_events=ms["graph_slope"] / ms["cuda_events"],
               marginal_flash_launches=marginal_launches,
               trace_files=files,
               trace_mb=(os.path.getsize(os.path.join(trace_dir, files[0]))
                         / 1e6 if files else 0.0),
               trace_names_flash_wgmma=named, traced_steps=2,
               traced_step_ms=timer.summary(), traced_wall_ms=wall_ms,
               trace_kernel_ms=busy_ms,
               idle_share=1.0 - busy_ms / wall_ms if busy_ms else None,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
               flash_launches=flash,
               seconds=time.perf_counter() - t_phase)
    line("profiling", **row)
    shutil.rmtree(trace_dir, ignore_errors=True)
    if len(files) != 1 or not all(named.values()):
        raise SystemExit(f"profiling: trace files {files}, flash wgmma "
                         f"kernels named {named}")
    _flash_gate("profiling", flash, _flagship_train_cfg().n_layers, 2)
    return row


def _vit_cfg():
    from kubetpu_torch.jobs import model as model_lib
    from kubetpu_torch.jobs.vision import VitConfig

    # ViT-Base (Dosovitskiy et al. 2020, Table 1): 12 layers, hidden 768,
    # MLP 3072, 12 heads; patch 16 at 224 pixels, 1000 classes; the repo's
    # SwiGLU block (three MLP matrices) makes it ~114M parameters
    return VitConfig(image_size=224, patch_size=16, channels=3,
                     n_classes=1000,
                     model=model_lib.ModelConfig(
                         d_model=768, n_layers=12, n_heads=12, d_ff=3072,
                         max_seq=196, dtype=torch.bfloat16, remat=True,
                         remat_policy="full"))


def phase_vit(smi: str, flash_rows) -> dict:
    """Phase 30: ViT-B/16's widths on the repo's block (``_vit_cfg``),
    batch 128 of ``SyntheticImages(224, 3, 1000)`` (its prototypes take
    0.6 GB of host memory; the batches are made and uploaded before the
    timed window, the generator's ms a batch on the ``vit_data`` line),
    bf16, full remat, ``attention="flash"`` (D 64, 196 patches): one
    warm-up and FAMILY_STEPS timed train steps cycling over two batches
    (each seen more than once, so that the loss must fall) under
    ``torch.profiler``
    (step ms, images/s, device busy, idle share, peak memory), a no-grad
    ``vit_forward`` at batch 256 (images/s), and phase 4's flash forward
    at this shape against its bound. Gates: 24 / 12 / 12 flash launches a
    step, all wgmma (and 12 forward a no-grad call); the loss falls."""
    from kubetpu_torch.jobs import vision
    from kubetpu_torch.jobs.data import SyntheticImages
    from kubetpu_torch.jobs.encoder import bidirectional_attention

    t_phase = time.perf_counter()
    cfg = _vit_cfg()
    t0 = time.perf_counter()
    data = SyntheticImages(cfg.image_size, cfg.channels, cfg.n_classes,
                           seed=30)
    proto_s = time.perf_counter() - t0
    it = data.batches(VIT_BATCH, seed=30)
    n_batches = 3                        # a warm-up batch and two timed
    t0 = time.perf_counter()
    host = [next(it) for _ in range(n_batches)]
    gen_ms = (time.perf_counter() - t0) / n_batches * 1e3
    t0 = time.perf_counter()
    batches = [(torch.from_numpy(i).to("cuda"), torch.from_numpy(l).to("cuda"))
               for i, l in host]
    torch.cuda.synchronize()
    up_ms = (time.perf_counter() - t0) / n_batches * 1e3
    line("vit_data", card=torch.cuda.get_device_name(0), nvidia_smi=smi,
         prototypes_gb=data._prototypes.nbytes / 1e9,
         prototypes_s=proto_s, batch=VIT_BATCH,
         generator_ms_per_batch=gen_ms, upload_ms_per_batch=up_ms)
    del data, host, it

    state, opt = vision.init_vit_state(
        torch.Generator(device="cuda").manual_seed(30), cfg, device="cuda")
    n_params = sum(p.numel() for p in state.params.parameters())
    step = vision.make_vit_train_step(cfg, opt, attention="flash",
                                      device="cuda")
    state, loss = step(state, *batches[0])               # warm-up
    feed = iter(batches[1:] * FAMILY_STEPS)

    def one():
        nonlocal state
        state, loss = step(state, *next(feed))
        return loss

    win = _timed_window(one, FAMILY_STEPS, VIT_BATCH)
    losses = win["losses"]
    images = torch.cat([batches[1][0], batches[2][0]])[:VIT_INFER_BATCH]
    attn = bidirectional_attention("flash", "vit")

    def infer():
        with torch.no_grad():
            return vision.vit_forward(state.params, images, cfg,
                                      attn_fn=attn)

    infer()
    infer_ms, infer_flash = _flash_delta(lambda: cuda_ms(infer, iters=5,
                                                         warmup=1))
    fwd = next(r for r in flash_rows if r["case"] == "vit_noncausal"
               and r["kernel"] == "forward")
    mcfg = cfg.model
    tokens = VIT_BATCH * cfg.n_patches
    flops_per_token = (6 * n_params
                       + 12 * mcfg.n_layers * mcfg.d_model * cfg.n_patches)
    row = dict(card=torch.cuda.get_device_name(0), nvidia_smi=smi,
               params=n_params,
               widths="ViT-B/16 (Dosovitskiy et al. 2020, Table 1): 12 "
                      "layers, d 768, MLP 3072, 12 heads, patch 16, 224 px, "
                      "1000 classes; SwiGLU blocks",
               batch=VIT_BATCH, patches=cfg.n_patches,
               attention="flash, causal=False", remat="full",
               images_s=VIT_BATCH / (win["step_ms"] / 1e3),
               mfu=tokens / (win["step_ms"] / 1e3) * flops_per_token
               / BF16_FLOP_S,
               infer_batch=VIT_INFER_BATCH, infer_ms=infer_ms,
               infer_images_s=VIT_INFER_BATCH / (infer_ms / 1e3),
               infer_flash_launches=infer_flash,
               flash_forward=dict(ms=fwd["ms"], bound_ms=fwd["bound_ms"],
                                  bound_by=fwd["bound_by"],
                                  library_ms=fwd["library_ms"],
                                  shape=fwd["shape"]),
               seconds=time.perf_counter() - t_phase, **win)
    line("vit", **row)
    _flash_gate("vit", win["flash_launches"], mcfg.n_layers, FAMILY_STEPS)
    # the counted window holds cuda_ms's warm-up call and 5 timed calls
    want = dict(forward=6 * mcfg.n_layers, dq=0, dkv=0,
                forward_wgmma=6 * mcfg.n_layers, dq_wgmma=0, dkv_wgmma=0)
    if infer_flash != want:
        raise SystemExit(f"vit: no-grad forward flash launches "
                         f"{infer_flash} != {want}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise SystemExit(f"vit: the loss did not fall: {losses}")
    return row


def phase_seq2seq(smi: str) -> dict:
    """Phase 31: the encoder-decoder at the flagship's widths (both stacks
    phase 11's config; ~1.63B parameters, 0.95B in the decoder with its
    cross branch), trained on a copy task (target = source) at batch 4,
    source 1024, target 1024: one warm-up and S2S_STEPS timed steps
    (step ms, tokens/s, device busy, idle share, peak memory); then greedy
    generate on the trained weights, batch 8, source 512, 64 new tokens,
    ``cached=True`` (ms a token; device busy against wall over a profiled
    PROFILED_STEPS-token generate) against
    ``cached=False``. Gates: the cached path's f32 logits at every step
    within LOGIT_TOL of ``decoder_forward``'s (f32 head) with the cached
    path's own tokens teacher-forced (the same gap one position off is
    reported beside it, as what a misplaced row would read); the cached
    tokens equal the recompute's, a row's first divergence allowed only
    where the recompute's top-two logit gap is within LOGIT_TOL (counted);
    no flash launch anywhere in the phase (the family's attention is
    dense, as in the JAX package)."""
    from kubetpu_torch.jobs import seq2seq
    from kubetpu_torch.jobs.data import SyntheticCorpus

    t_phase = time.perf_counter()
    cfg = _flagship_train_cfg()
    _zero_flash_counts()
    state, opt = seq2seq.init_seq2seq_state(
        torch.Generator(device="cuda").manual_seed(31), cfg, device="cuda")
    n_params = sum(p.numel() for p in state.params.parameters())
    n_decoder = sum(p.numel() for p in state.params.decoder.parameters())
    step = seq2seq.make_seq2seq_train_step(cfg, opt, device="cuda")
    it = SyntheticCorpus(cfg.vocab, seed=31).batches(S2S_BATCH, S2S_SRC,
                                                    seed=31)
    batches = []
    for _ in range(S2S_STEPS + 1):
        src = torch.from_numpy(next(it)[0]).to("cuda")
        tgt_in = torch.cat([torch.ones_like(src[:, :1]), src[:, :-1]], 1)
        batches.append((src, tgt_in, src))
    state, loss = step(state, *batches[0])               # warm-up
    feed = iter(batches[1:])

    def one():
        nonlocal state
        state, loss = step(state, *next(feed))
        return loss

    before = _flash_dict(_flash_counts())   # init and warm-up
    win = _timed_window(one, S2S_STEPS, S2S_BATCH * (S2S_SRC + S2S_TGT))
    params = state.params
    del state, opt, step
    torch.cuda.empty_cache()
    src = torch.from_numpy(next(SyntheticCorpus(cfg.vocab, seed=32).batches(
        S2S_GEN_BATCH, S2S_GEN_SRC, seed=32))[0]).to("cuda")
    cached = seq2seq.make_seq2seq_generate(cfg, bos_id=1, device="cuda")
    recompute = seq2seq.make_seq2seq_generate(cfg, bos_id=1, cached=False,
                                              device="cuda")
    # the warm-up run records the cached logits of every step
    real_chunk, steps = seq2seq.decoder_forward_chunk, []

    def recorded_chunk(*args):
        out = real_chunk(*args)
        steps.append(out[0][:, 0].float())
        return out

    seq2seq.decoder_forward_chunk = recorded_chunk
    try:
        toks_w = cached(params, src, S2S_GEN_NEW)
    finally:
        seq2seq.decoder_forward_chunk = real_chunk
    with torch.no_grad():
        memory = seq2seq.encode(params, src, cfg)
        fed = torch.cat([torch.ones_like(toks_w[:, :1]), toks_w[:, :-1]], 1)
        x, _aux = seq2seq.decoder_forward(params, fed, memory, cfg,
                                          return_hidden=True)
        forced = torch.einsum("btd,dv->btv", x.float(),
                              params.decoder.head.float())
        got = torch.stack(steps, 1)
        forced_gap = float((got - forced).abs().max())
        offset_gap = float((got[:, :-1] - forced[:, 1:]).abs().max())
    del steps, got, forced
    from kubetpu_torch.jobs.profiling import StepTimer

    timer = StepTimer(S2S_GEN_BATCH * S2S_GEN_NEW)
    with timer.step():
        toks_c = cached(params, src, S2S_GEN_NEW).tolist()
    gen_ms = timer.summary()["p50_ms"]
    wall_us, kernels, _counts = _profiled(
        lambda: cached(params, src, PROFILED_STEPS))
    busy = sum(kernels.values())
    t0 = time.perf_counter()
    out_r = recompute(params, src, S2S_GEN_NEW)
    rec_ms = (time.perf_counter() - t0) * 1e3
    with torch.no_grad():
        full = torch.cat([torch.ones_like(out_r[:, :1]), out_r], 1)
        logits = seq2seq.decoder_forward(params, full, memory, cfg)
        top2 = torch.topk(logits[:, :S2S_GEN_NEW].float(), 2, dim=-1).values
    gaps = (top2[..., 0] - top2[..., 1]).cpu().numpy()
    # phase 16's rule, each row keyed by its source
    srcs = src.tolist()
    ties = _near_tie_check(
        [p + t for p, t in zip(srcs, toks_c)],
        [p + t for p, t in zip(srcs, out_r.tolist())],
        {(tuple(p), j): float(g) for p, row in zip(srcs, gaps)
         for j, g in enumerate(row)}, srcs)
    flash = {k: before[k] + win["flash_launches"][k] + v
             for k, v in _flash_dict(_flash_counts()).items()}
    row = dict(card=torch.cuda.get_device_name(0), nvidia_smi=smi,
               params=n_params, decoder_params=n_decoder,
               batch=S2S_BATCH, src=S2S_SRC, tgt=S2S_TGT, task="copy",
               tokens_s=S2S_BATCH * (S2S_SRC + S2S_TGT)
               / (win["step_ms"] / 1e3),
               target_tokens_s=S2S_BATCH * S2S_TGT / (win["step_ms"] / 1e3),
               gen=dict(batch=S2S_GEN_BATCH, src=S2S_GEN_SRC,
                        new=S2S_GEN_NEW, cached_ms=gen_ms,
                        cached_ms_per_token=gen_ms / S2S_GEN_NEW,
                        recompute_ms=rec_ms,
                        profiled_tokens=PROFILED_STEPS,
                        profiled_wall_ms=wall_us / 1e3,
                        device_busy_ms=busy / 1e3,
                        idle_share=(1.0 - busy / wall_us) if busy else None,
                        teacher_forced_logit_gap=forced_gap,
                        one_position_off_gap=offset_gap,
                        logit_tol=LOGIT_TOL,
                        warmup_tokens_equal=toks_w.tolist() == toks_c,
                        rows_equal=sum(a == b for a, b in zip(
                            toks_c, out_r.tolist())),
                        near_tie_divergences=len(ties["diverged"]),
                        diverged=ties["diverged"]),
               phase_flash_launches=flash,
               seconds=time.perf_counter() - t_phase, **win)
    line("seq2seq", **row)
    if any(flash.values()):
        raise SystemExit(f"seq2seq: flash launches {flash}: the family's "
                         "attention is dense")
    if not all(np.isfinite(win["losses"])):
        raise SystemExit(f"seq2seq: non-finite losses {win['losses']}")
    if not forced_gap <= LOGIT_TOL or toks_w.tolist() != toks_c:
        raise SystemExit(f"seq2seq: cached logits {forced_gap} off the "
                         f"teacher-forced decoder_forward's (bound "
                         f"{LOGIT_TOL}), or the two cached runs differ")
    if ties["bad"]:
        raise SystemExit(f"seq2seq: cached tokens differ from the "
                         f"recompute's beyond near-ties: {ties['bad']}")
    return row


def _unreordered(real_one, held: dict):
    """Beam search's planted fault: ``beam._forward_one`` forwarding each
    step through the caches as the last step left them (kept in *held*),
    not as the parent gather reordered them."""
    def forward(cfg_, params_, token, k_cache, v_cache, pos, **kw):
        k_cache, v_cache = held.get("kv", (k_cache, v_cache))
        out = real_one(cfg_, params_, token, k_cache, v_cache, pos, **kw)
        held["kv"] = out[1:]
        return out

    return forward


def _teacher_forced_scores(model, cfg, seqs, s_p, eos_id, alpha) -> list:
    """Each row's sum of generated-token log-probs from one forward over
    the whole sequence (f32 head), up to and including its first EOS,
    divided by the GNMT penalty when *alpha* > 0: the beam's invariant."""
    from kubetpu_torch.jobs import model as model_lib

    with torch.no_grad():
        x, _aux = model_lib.forward_hidden(model, seqs[:, :-1], cfg)
        logp = torch.log_softmax(
            torch.einsum("bsd,dv->bsv", x.float(), model.head.float()), -1)
        picked = torch.gather(logp[:, s_p - 1:], 2,
                              seqs[:, s_p:, None])[..., 0].cpu().numpy()
    gen = seqs[:, s_p:].cpu().numpy()
    out = []
    for lp, toks in zip(picked, gen):
        n = len(toks)
        if eos_id is not None and (toks == eos_id).any():
            n = int(np.argmax(toks == eos_id)) + 1
        total = float(lp[:n].sum())
        if alpha > 0:
            total /= ((5.0 + n) / 6.0) ** alpha
        out.append(total)
    return out


def phase_beam(model, cfg, files, smi: str,
               weights="phase 25's trained flagship") -> dict:
    """Phase 32: ``make_beam_search`` on phase 25's trained flagship (the
    weights phases 26-27 serve): beam 4, 4 held-out prompts of 256 tokens,
    64 steps, without EOS, with EOS and with ``length_penalty=0.6`` (and
    EOS): ms a step (StepTimer around each search) against greedy
    ``make_generate``'s at batch B*K; one profiled search (device busy,
    idle share over PROFILED_STEPS steps, the parent gather's device ms —
    ``aten::index_select``, which also tiles the prompt's cache once — and
    the f32 upcast of the
    cache in ``decode._attend_cached``, timed in a ``record_function``
    range, as a share of busy time). Gates: ``beam_size=1`` tokens equal
    ``make_generate``'s greedy tokens under the near-tie rule; every
    beam's score within BEAM_SCORE_TOL a generated token of a
    teacher-forced recompute, and a search that leaves the caches
    unreordered (a planted fault, without EOS) beyond it (on phase 25's
    model the top beam alone read that fault to the bit as the sound run:
    its cache row stays right while its parent stays beam 0); no flash
    launch."""
    from kubetpu_torch.jobs import beam, decode
    from kubetpu_torch.jobs.data import ByteTokenizer
    from kubetpu_torch.jobs.profiling import StepTimer

    t_phase = time.perf_counter()
    _zero_flash_counts()
    prompts = torch.from_numpy(next(files["held"].batches(
        BEAM_BATCH, BEAM_PROMPT, seed=32))[0]).long().to("cuda")
    eos = ByteTokenizer.EOS
    runs = {"no_eos": {}, "eos": {"eos_id": eos},
            "penalty": {"eos_id": eos, "length_penalty": 0.6}}
    rows, bad_scores = {}, []
    for name, kw in runs.items():
        search = beam.make_beam_search(cfg, BEAM_K, device="cuda", **kw)
        timer = StepTimer(BEAM_BATCH * BEAM_K)
        with timer.step():
            seqs, scores = search(model, prompts, BEAM_STEPS)
            scores = scores.cpu().numpy()
        ref = np.reshape(_teacher_forced_scores(
            model, cfg, seqs.flatten(0, 1), BEAM_PROMPT, kw.get("eos_id"),
            kw.get("length_penalty", 0.0)), scores.shape)
        err = float(np.max(np.abs(scores - ref)))
        gen = seqs[:, :, BEAM_PROMPT:].cpu().numpy()
        rows[name] = dict(ms=timer.summary()["p50_ms"],
                          ms_per_step=timer.summary()["p50_ms"] / BEAM_STEPS,
                          top_scores=scores[:, 0].tolist(),
                          recomputed=ref[:, 0].tolist(), score_err=err,
                          top_score_err=float(np.max(np.abs(
                              scores[:, 0] - ref[:, 0]))),
                          beams_with_eos=int((gen == eos).any(-1).sum()),
                          distinct_top_beams=len({tuple(r) for r in
                                                  gen[:, 0].tolist()}))
        if not err <= BEAM_SCORE_TOL * BEAM_STEPS:
            bad_scores.append((name, err))
        del seqs
    # the planted fault: each step forwards through the caches as the last
    # step left them, not as the parent gather reordered them
    real_one, held = beam._forward_one, {}
    beam._forward_one = _unreordered(real_one, held)
    try:
        seqs, scores = beam.make_beam_search(cfg, BEAM_K, device="cuda")(
            model, prompts, BEAM_STEPS)
    finally:
        beam._forward_one = real_one
    held.clear()
    fault_err = float(np.max(np.abs(scores.cpu().numpy() - np.reshape(
        _teacher_forced_scores(model, cfg, seqs.flatten(0, 1), BEAM_PROMPT,
                               None, 0.0), scores.shape))))
    del seqs, scores
    # greedy at batch B*K, and beam_size=1 against greedy
    greedy = decode.make_generate(cfg)
    wide = prompts.repeat_interleave(BEAM_K, dim=0)
    greedy(model, wide, 0, 2)
    timer = StepTimer(BEAM_BATCH * BEAM_K)
    with timer.step():
        greedy(model, wide, 0, BEAM_STEPS).cpu()
    greedy_ms = timer.summary()["p50_ms"]
    g_out, top2, _s = _recorded_generate(lambda: decode.make_generate(cfg),
                                         model, prompts, BEAM_STEPS,
                                         "make_slot_sampler")
    gaps = torch.stack([t[:, 0] - t[:, 1] for t in top2], 1).numpy()
    one = beam.make_beam_search(cfg, 1, device="cuda")(model, prompts,
                                                       BEAM_STEPS)[0][:, 0]
    rows_p = prompts.tolist()
    ties = _near_tie_check(
        one.tolist(), g_out.tolist(),
        {(tuple(p), j): float(g) for p, row in zip(rows_p, gaps)
         for j, g in enumerate(row)}, rows_p)
    # one profiled search: the parent gather and the cache's f32 upcast
    from torch.profiler import record_function

    real = decode._attend_cached

    def attend(q, k_cache, v_cache, pos, window=0):
        with record_function("beam.kv_upcast"):
            k_cache, v_cache = k_cache.float(), v_cache.float()
        return real(q, k_cache, v_cache, pos, window)

    ranges = {"aten::index_select": 0.0, "beam.kv_upcast": 0.0}
    search = beam.make_beam_search(cfg, BEAM_K, device="cuda")
    decode._attend_cached = attend
    try:
        wall_us, kernels, counts = _profiled(
            lambda: search(model, prompts, PROFILED_STEPS), ranges)
    finally:
        decode._attend_cached = real
    busy = sum(kernels.values())
    flash = _flash_dict(_flash_counts())
    row = dict(card=torch.cuda.get_device_name(0), nvidia_smi=smi,
               model=weights, beam=BEAM_K,
               batch=BEAM_BATCH, prompt=BEAM_PROMPT, steps=BEAM_STEPS,
               runs=rows, greedy_batch=BEAM_BATCH * BEAM_K,
               greedy_ms=greedy_ms,
               greedy_ms_per_step=greedy_ms / BEAM_STEPS,
               beam_over_greedy=rows["no_eos"]["ms"] / greedy_ms,
               beam1_rows_equal_greedy=sum(a == b for a, b in zip(
                   one.tolist(), g_out.tolist())),
               beam1_diverged=ties["diverged"],
               profile=dict(steps=PROFILED_STEPS, wall_ms=wall_us / 1e3,
                            device_busy_ms=busy / 1e3,
                            idle_share=(1.0 - busy / wall_us) if busy
                            else None,
                            parent_gather_ms=ranges["aten::index_select"]
                            / 1e3,
                            parent_gather_ms_per_step=ranges[
                                "aten::index_select"] / 1e3 / PROFILED_STEPS,
                            kv_upcast_ms=ranges["beam.kv_upcast"] / 1e3,
                            kv_upcast_share_of_busy=(
                                ranges["beam.kv_upcast"] / busy)
                            if busy else None,
                            device_kernels=counts["device_kernels"]),
               score_tol_per_token=BEAM_SCORE_TOL,
               unreordered_fault_score_err=fault_err, flash_launches=flash,
               seconds=time.perf_counter() - t_phase)
    line("beam", **row)
    if ties["bad"]:
        raise SystemExit(f"beam: beam_size=1 differs from greedy beyond "
                         f"near-ties: {ties['bad']}")
    if bad_scores:
        raise SystemExit(f"beam: beam scores off the teacher-forced "
                         f"recompute by more than {BEAM_SCORE_TOL} a token: "
                         f"{bad_scores}")
    if not fault_err > BEAM_SCORE_TOL * BEAM_STEPS:
        raise SystemExit(f"beam: the unreordered-cache fault reads "
                         f"{fault_err}, within the bound "
                         f"{BEAM_SCORE_TOL * BEAM_STEPS}")
    if any(flash.values()):
        raise SystemExit(f"beam: flash launches {flash}")
    return row


# -- phases 34-35: the multi-device training path ---------------------------
# N ranks time-sharing the one card, gloo between them (NCCL refuses two
# ranks on one device); the collectives stage CUDA tensors through pinned
# host buffers where gloo does not take them. What this measures is whether
# the collectives and the ring are right, and what a step moves; no time
# here stands for NVLink.

MESH_AXES = {"dp": 2, "sp": 2, "tp": 2}     # dryrun_multichip's mesh at n=8
MESH_BATCH, MESH_SEQ = 4, 4096              # bench_model.py's flagship shape
MESH_STEPS = 2
MESH_SEED = 34
# the sharded checkpoint's restore layout (phase 34): the same 8 ranks as
# {dp 4, tp 2}, the flash core (no sp ring)
MESH_RESTORE_AXES = {"dp": 4, "tp": 2}
# a rank's device memory while it builds its shard (drawn leaf by leaf, or
# restored into): at most the bytes built plus one whole leaf, plus this
# share for the allocator's rounding
BUILD_PEAK_SLACK = 0.1
# |loss of the 8-rank ring_flash step - the one-card flash step's|, in
# nats, at step 1 (the forward) and at step 2 (after one update): bf16
# rounds the tp partial sums and the ring's merges in other places than
# the one-card step. The card read 1.7e-4 at step 1 and 2.7e-4 at step 2
# (PERF.md), and the planted faults read beyond it in every run
MESH_LOSS_TOL = 2e-3
# after step 1, over every rank's leaves: the largest relative L2 gap of
# the weights to the reference's (sound 0.40%: bf16 rounding of the
# weights) and of their change over the step to the reference's change
# (sound 0.19: an update of ~2.5 bf16 ulps rounds either way). A skipped
# update reads 1.0 on the change; the planted backward fault (gradients
# not summed over sp) must read beyond both bounds
MESH_PARAM_GAP_TOL = 6e-3
MESH_UPDATE_GAP_TOL = 0.4
# the flash ring against the dense ring on the same ranks, bf16: each
# tensor's ||flash - dense|| / ||dense|| (out, dq, dk, dv); a ring that
# drops its last visiting block must read beyond it
MESH_RING_TOL = 2e-2
MESH_WORLD_S = 900                          # a world's wall-clock limit
SMALL_MESH_TOL = 1e-4                       # phase 35, f32: relative
# phase 35's pipeline step runs at lr PIPE_LR and holds each element's
# change to the one-card step's within PIPE_UPDATE_TOL steps, leaving out
# elements whose reference gradient is zero to rounding (|g| <= 1e-6 of
# the leaf's largest); a stage that gets no gradient misses by a step. An
# element just above that cut still turns f32 rounding into a share of a
# step through Adam's g / (|g| + eps): the CPU tests read up to 0.04
PIPE_LR = 1e-2
PIPE_UPDATE_TOL = 0.25

def _mesh_train_cfg():
    return dataclasses.replace(_flagship_train_cfg(), max_seq=MESH_SEQ)


def _mesh_batch(cfg):
    tokens = np.random.default_rng(MESH_SEED).integers(
        0, cfg.vocab, (MESH_BATCH, MESH_SEQ))
    return tokens, np.roll(tokens, -1, axis=1)


def _rank_main(target, rank, world, store, args, q, init):
    """One rank of a one-card world: ``cuda:0``, gloo through a file
    store (unless the target joins a group itself); its result (or its
    failure) goes to *q*."""
    import datetime

    import torch.distributed as dist

    sys.path.insert(0, ROOT)
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    if init and world > 1:
        dist.init_process_group(
            "gloo", init_method=f"file://{store}", world_size=world,
            rank=rank, timeout=datetime.timedelta(seconds=MESH_WORLD_S))
    try:
        q.put((rank, target(rank, world, args)))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _run_world(target, world: int, args, tag: str,
               init: bool = True) -> list:
    """*target*(rank, world, args) on *world* spawned ranks sharing the
    card -> their results, rank order. A rank that fails, or a world past
    ``MESH_WORLD_S``, fails the phase; every process is stopped.
    ``init=False``: the target joins its process group itself."""
    import gc
    import multiprocessing as mp
    import queue

    gc.collect()              # the ranks share the card and the host
    torch.cuda.empty_cache()
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    os.makedirs(LIFE_DIR, exist_ok=True)
    store = os.path.join(LIFE_DIR, f"{tag}-store-{os.getpid()}")
    if os.path.exists(store):
        os.remove(store)
    procs = [ctx.Process(target=_rank_main,
                         args=(target, r, world, store, args, q, init))
             for r in range(world)]
    for p in procs:
        p.start()
    out, deadline = {}, time.time() + MESH_WORLD_S
    while len(out) < world and time.time() < deadline:
        try:
            rank, res = q.get(timeout=1.0)
            out[rank] = res
        except queue.Empty:
            if any(p.exitcode not in (None, 0) for p in procs):
                break
    for p in procs:
        p.join(timeout=max(1.0, deadline - time.time()) if len(out) == world
               else 1.0)
        if p.is_alive():
            p.kill()
            p.join()
    codes = [p.exitcode for p in procs]
    if len(out) < world or codes != [0] * world:
        raise SystemExit(f"{tag}: world of {world} failed: exit codes "
                         f"{codes}, results from ranks {sorted(out)}")
    return [out[r] for r in range(world)]


def _mesh_ref_rank(_rank, _world, args):
    """The one-card reference (on world rank 0): phase 34's weights and
    batch, the flash step; the weights after step 1 saved for the world
    to compare."""
    from kubetpu_torch.jobs import train as train_lib
    from kubetpu_torch.jobs.model import init_params

    cfg = _mesh_train_cfg()
    model = init_params(torch.Generator(device="cuda").manual_seed(
        MESH_SEED), cfg, device="cuda")
    opt = train_lib.make_optimizer()
    state = train_lib.state_from_params(model, opt)
    step = train_lib.make_train_step(cfg, opt, attention="flash",
                                     device="cuda")
    batch = _mesh_batch(cfg)
    torch.cuda.reset_peak_memory_stats()
    losses, ms = [], []
    for i in range(MESH_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, loss = step(state, *batch)
        losses.append(float(loss))
        ms.append((time.perf_counter() - t0) * 1e3)
        if i == 0:
            torch.save({k: v.detach().cpu() for k, v in
                        state.params.state_dict().items()}, args["ref_path"])
    return {"losses": losses, "step_ms": ms,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}


def _ring_check(mesh, rank: int, shape, causal: bool, tol: float,
                plant: bool = False) -> dict:
    """The flash ring (kernels) against the ring's plain version (the
    dense ring) on this rank's block of one random input: forward and the
    gradients of sum(out * cot), each tensor's ||flash - dense|| /
    ||dense||. *plant*: the flash ring drops its last visiting block
    (forward and backward; its hops still run)."""
    from kubetpu_torch.jobs import ring_attention as ring_lib

    gen = torch.Generator(device="cuda").manual_seed(100 + rank)
    b, s, h, d = (shape[x] for x in "BSHD")
    dtype = shape.get("dtype", torch.bfloat16)
    q, k, v, cot = (torch.randn((b, s, h, d), generator=gen, device="cuda",
                                dtype=dtype) for _ in range(4))
    sound = ring_lib._visible
    last = mesh.size(mesh.mesh_dim_names.index("sp")) - 1
    res = {}
    for impl in ("flash", "dense"):
        if plant and impl == "flash":
            ring_lib._visible = lambda t, i, c: t != last and sound(t, i, c)
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
        out = ring_lib.make_ring_attention(mesh, impl=impl,
                                           causal=causal)(*leaves)
        grads = torch.autograd.grad((out.float() * cot.float()).sum(),
                                    leaves)
        ring_lib._visible = sound
        res[impl] = (out.detach(), *grads)
    errs = [float((x.float() - ref.float()).norm() / ref.float().norm())
            for x, ref in zip(res["flash"], res["dense"])]
    finite = all(bool(torch.isfinite(x).all()) for x in res["flash"])
    return {"rel_err": max(errs), "ok": finite and max(errs) <= tol,
            "tol": tol}


def _leaf_ref(ref_sd, name, specs, mesh):
    """This rank's slice of the reference's leaf *name*."""
    from kubetpu_torch.jobs import train as train_lib

    leaf = name.split(".")[-1]
    spec = specs[leaf] if "." not in name else specs["blocks"][leaf][1:]
    return train_lib._take(ref_sd[name], spec, mesh)


def _step_gaps(params, init, after1, ref_sd, cfg, mesh):
    """Over this rank's leaves: the largest relative L2 gap of the weights
    after step 1 (*after1*) to the reference's, and of their change over
    the step (from *init*) to the reference's change."""
    from kubetpu_torch.jobs import train as train_lib

    specs = train_lib.param_specs(cfg)
    gap = upd = 0.0
    for (name, _p), a, p0 in zip(params.named_parameters(), after1, init):
        ref = _leaf_ref(ref_sd, name, specs, mesh).to("cuda").float()
        gap = max(gap, float((a.float() - ref).norm() / ref.norm()))
        d_ref = ref - p0.float()
        upd = max(upd, float((a.float() - p0.float() - d_ref).norm()
                             / d_ref.norm().clamp(min=1e-30)))
    return gap, upd


def _largest_leaf_bytes(cfg) -> int:
    from kubetpu_torch.jobs.model import Transformer

    return max(p.numel() * p.element_size()
               for p in Transformer(cfg, torch.device("meta")).parameters())


def _tensor_bytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _mesh_save(state, path: str) -> dict:
    """Phase 34's sharded save of the stepped {dp 2, sp 2, tp 2} state:
    every rank gathers to the writer, which writes; seconds on this
    rank's clock and the file's bytes."""
    import torch.distributed as dist

    from kubetpu_torch.jobs import checkpoint as ckpt

    torch.cuda.synchronize()
    dist.barrier()
    t0 = time.perf_counter()
    ckpt.save_checkpoint(path, state)
    save_s = time.perf_counter() - t0
    return {"save_s": save_s, "file_bytes": os.path.getsize(
        os.path.join(path, ckpt.STATE_FILE))}


def _mesh_restore_leg(cfg, batch, path: str) -> dict:
    """Phase 34's restore onto MESH_RESTORE_AXES: a fresh shard drawn
    leaf by leaf there (``train.init_shard``: its peak over what was
    allocated before, read before the optimizer state exists, against the
    shard's bytes plus one whole leaf), a state over it, the checkpoint
    restored into that (seconds, the peak it adds over the state it
    fills), one flash step's loss; then the planted
    fault, every rank restoring tp rank 0's slices (the behaviour before
    the sharded save: each rank wrote its own slices to one path), and
    the loss at those weights."""
    import torch.distributed as dist

    from kubetpu_torch.jobs import checkpoint as ckpt
    from kubetpu_torch.jobs import train as train_lib
    from kubetpu_torch.jobs.meshjob import make_mesh

    mesh = make_mesh(MESH_RESTORE_AXES, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    shard = train_lib.init_shard(
        torch.Generator(device="cuda").manual_seed(MESH_SEED + 1), cfg, mesh,
        "cuda")
    torch.cuda.synchronize()
    init_peak = torch.cuda.max_memory_allocated() - base
    opt = train_lib.make_optimizer()
    state = train_lib.state_from_params(shard, opt)
    del shard
    state_bytes = _tensor_bytes(ckpt._leaves(state))
    dist.barrier()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    ckpt.restore_checkpoint(path, state)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    restore_peak = torch.cuda.max_memory_allocated() - base
    restore_extra = torch.cuda.max_memory_allocated() - held
    dist.barrier()
    restore_wall = time.perf_counter() - t0
    restored_step = state.step
    step = train_lib.make_train_step(cfg, opt, attention="flash",
                                     device="cuda", mesh=mesh)
    _, loss = step(state, *batch)
    loss = float(loss)
    sound = train_lib._region
    train_lib._region = lambda shape, spec, m, coords=None: sound(
        shape, spec, m, {})
    try:
        ckpt.restore_checkpoint(path, state)
    finally:
        train_lib._region = sound
    # the fault's reading: the loss at the restored weights (the step's
    # forward alone)
    fault = train_lib.make_eval_step(cfg, "flash", "cuda", mesh)(
        state.params, *batch)
    return {"restore_s": restore_s, "restore_wall_s": restore_wall,
            "loss": loss, "fault_loss": float(fault),
            "restored_step": restored_step,
            "init_peak_gb": init_peak / 1e9,
            "restore_peak_gb": restore_peak / 1e9,
            "restore_extra_gb": restore_extra / 1e9,
            "state_gb": state_bytes / 1e9,
            "shard_gb": _tensor_bytes(state.params.parameters()) / 1e9,
            "largest_leaf_gb": _largest_leaf_bytes(cfg) / 1e9}


def _one_card_restore(path: str) -> dict:
    """The one-card reference of phase 34's restore (world rank 0, the
    other ranks waiting): the sharded file restored into a one-card
    state, one flash step on the same batch."""
    from kubetpu_torch.jobs import checkpoint as ckpt
    from kubetpu_torch.jobs import train as train_lib

    cfg = _mesh_train_cfg()
    state, opt = train_lib.init_state(
        torch.Generator(device="cuda").manual_seed(MESH_SEED + 1), cfg,
        device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ckpt.restore_checkpoint(path, state)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    step = train_lib.make_train_step(cfg, opt, attention="flash",
                                     device="cuda")
    _, loss = step(state, *_mesh_batch(cfg))
    return {"loss": float(loss), "restore_s": restore_s}


def _sync_without_sp(sound):
    """The planted backward fault: ``train.grad_sync`` whose gradients are
    not summed over sp (each sp rank updates with its own tokens' part)."""
    def grad_sync(cfg, groups, pp=False):
        sync = sound(cfg, groups, pp)
        sync.reduce_axes = [tuple(a for a in axes if a != "sp")
                            for axes in sync.reduce_axes]
        return sync

    return grad_sync


def _mesh_train_rank(rank, world, args):
    """Phase 34 on one rank: the ring check (and its planted fault), the
    planted RoPE fault's loss, the main-path steps (counts zeroed just
    before, read just after), the weights after step 1 against the
    reference's; the sharded save and the restore onto another layout;
    one step with the planted backward fault and the loss at its weights;
    on rank 0, the one-card restore of the same file."""
    import torch.distributed as dist

    from kubetpu_torch.jobs import collectives as col
    from kubetpu_torch.jobs import train as train_lib
    from kubetpu_torch.jobs.meshjob import make_mesh

    # the one-card reference first, on rank 0 (the others wait)
    ref = _mesh_ref_rank(rank, 1, args) if rank == 0 else None
    torch.cuda.empty_cache()
    dist.barrier()
    cfg = _mesh_train_cfg()
    mesh = make_mesh(MESH_AXES, device="cuda")
    sp_idx = col.axis_index(mesh, "sp")
    ring = {c: _ring_check(mesh, rank, RING_FLASH_SHAPE, c == "causal",
                           MESH_RING_TOL) for c in ("causal", "noncausal")}
    ring_fault = {c: _ring_check(mesh, rank, RING_FLASH_SHAPE,
                                 c == "causal", MESH_RING_TOL, plant=True)
                  for c in ("causal", "noncausal")}
    state, opt = train_lib.init_state(
        torch.Generator(device="cuda").manual_seed(MESH_SEED), cfg,
        device="cuda", mesh=mesh)
    torch.cuda.empty_cache()
    batch = _mesh_batch(cfg)
    # the planted fault: every sp rank's RoPE positions start at 0
    sound = train_lib._positions
    train_lib._positions = lambda _i, s, dev: sound(0, s, dev)
    fault = float(train_lib.make_eval_step(cfg, "ring_flash", "cuda",
                                           mesh)(state.params, *batch))
    train_lib._positions = sound
    init = [p.detach().clone() for p in state.params.parameters()]
    step = train_lib.make_train_step(cfg, opt, attention="ring_flash",
                                     device="cuda", mesh=mesh)
    torch.cuda.synchronize()
    dist.barrier()
    torch.cuda.reset_peak_memory_stats()
    _zero_flash_counts()                              # zero just before
    losses, ms, per_step, axis, staged = [], [], [], [], []
    for i in range(MESH_STEPS):
        before = _flash_counts()
        col.reset_counters()
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        state, loss = step(state, *batch)
        torch.cuda.synchronize()
        dist.barrier()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
        per_step.append([a - b for a, b in zip(_flash_counts(), before)])
        axis.append(dict(col.axis_bytes))
        staged.append(col.stage_through_host.bytes)
        if i == 0:
            after1 = [p.detach().clone() for p in state.params.parameters()]
    counts = _flash_counts()                          # read just after
    peak = torch.cuda.max_memory_allocated() / 1e9
    smi_mem = None
    if rank == 0:
        smi_mem = subprocess.run(
            ["nvidia-smi", "--query-gpu=memory.used,memory.total",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    dist.barrier()
    ref_sd = torch.load(args["ref_path"], mmap=True)
    gap, upd = _step_gaps(state.params, init, after1, ref_sd, cfg, mesh)
    # the sharded checkpoint: save this state, restore it onto another
    # layout
    ckpt = _mesh_save(state, args["ckpt_path"])
    del state, step, init, after1
    torch.cuda.empty_cache()
    ckpt.update(_mesh_restore_leg(cfg, batch, args["ckpt_path"]))
    torch.cuda.empty_cache()
    # the planted backward fault, from the same weights: one step whose
    # gradients are not summed over sp, then step 2's loss at its weights
    # (the eval step: the forward that step 2 would run first)
    fstate, fopt = train_lib.init_state(
        torch.Generator(device="cuda").manual_seed(MESH_SEED), cfg,
        device="cuda", mesh=mesh)
    finit = [p.detach().clone() for p in fstate.params.parameters()]
    sound_sync = train_lib.grad_sync
    train_lib.grad_sync = _sync_without_sp(sound_sync)
    fstep = train_lib.make_train_step(cfg, fopt, attention="ring_flash",
                                      device="cuda", mesh=mesh)
    train_lib.grad_sync = sound_sync
    fstate, _ = fstep(fstate, *batch)
    fgap, fupd = _step_gaps(fstate.params, finit,
                            [p.detach() for p in fstate.params.parameters()],
                            ref_sd, cfg, mesh)
    floss2 = float(train_lib.make_eval_step(cfg, "ring_flash", "cuda", mesh)(
        fstate.params, *batch))
    del fstate, fstep, finit
    torch.cuda.empty_cache()
    dist.barrier()
    ckpt["one_card"] = (_one_card_restore(args["ckpt_path"]) if rank == 0
                        else None)
    dist.barrier()
    expected = (2 * cfg.n_layers * (1 + sp_idx), cfg.n_layers * (1 + sp_idx),
                cfg.n_layers * (1 + sp_idx)) * 2
    return {"losses": losses, "step_ms": ms, "fault_loss": fault,
            "ring": ring, "ring_fault": ring_fault,
            "per_step_launches": per_step,
            "expected_per_step": list(expected), "launches": list(counts),
            "axis_bytes": axis, "staged_bytes": staged, "peak_mem_gb": peak,
            "nvidia_smi_mem": smi_mem, "param_gap": gap, "update_gap": upd,
            "bwd_fault_loss2": floss2, "bwd_fault_param_gap": fgap,
            "bwd_fault_update_gap": fupd,
            "sp_index": sp_idx, "tp_index": col.axis_index(mesh, "tp"),
            "dp_index": col.axis_index(mesh, "dp"), "checkpoint": ckpt,
            "ref": ref}


def _mesh_train_axes_rank(rank, world, args):
    """Phases 34 and 35 on one rank of one world: phase 34's legs, then
    phase 35's (``_mesh_axes_rank``)."""
    out = _mesh_train_rank(rank, world, args)
    gc.collect()
    torch.cuda.empty_cache()
    out["axes"], out["axes_wall_s"] = _timed(_mesh_axes_rank, rank, world,
                                             args)
    return out


def phase_mesh_train(smi: str):
    """Phase 34: the flagship at full width trained two steps on a
    {dp 2, sp 2, tp 2} world of 8 ranks sharing the card,
    ``attention="ring_flash"`` (the flash kernels in every ring step),
    batch 4 x 4096, against the one-card flash step on the same weights
    and batch (world rank 0, before the others start). Gates: step 1's loss
    within ``MESH_LOSS_TOL`` of the reference's, the planted fault (RoPE
    positions not offset by the sp rank) beyond it; step 2's loss within
    ``MESH_LOSS_TOL``, and the weights after step 1 and their change over
    it within ``MESH_PARAM_GAP_TOL`` and ``MESH_UPDATE_GAP_TOL`` of the
    reference's, the planted backward fault (gradients not summed over sp;
    one step, then step 2's loss at its weights by the eval step) beyond
    all three; every rank's flash launches a step as its ring
    position says (2 x 12 x (1 + sp index) forward under remat,
    12 x (1 + sp index) dQ and dK/dV), all on the wgmma instances; the
    flash ring against the dense ring on every rank at the step's kernel
    shape within ``MESH_RING_TOL``, the ring that drops its last visiting
    block beyond it; one loss on every rank, finite. Then the sharded
    checkpoint (the ``mesh_checkpoint`` line): the stepped state saved
    (gathered to one writer), restored in the same world onto
    ``MESH_RESTORE_AXES`` into a state drawn leaf by leaf there, one flash
    step: its loss within ``MESH_LOSS_TOL`` of the one-card step restored
    from the same file (world rank 0, after every rank's legs), every
    rank restoring tp rank 0's slices beyond it (read by the eval step);
    each rank's peak while it drew its shard (``train.init_shard``, before
    the optimizer state exists) at most the shard's bytes plus one whole
    leaf, and what the restore added over the state it fills at most one
    whole leaf (``BUILD_PEAK_SLACK`` above each); save and restore seconds
    and GB/s."""
    cfg = _mesh_train_cfg()
    ref_path = os.path.join(LIFE_DIR, "mesh_ref.pt")
    ckpt_path = os.path.join(LIFE_DIR, "mesh_ckpt")
    os.makedirs(LIFE_DIR, exist_ok=True)
    t0 = time.perf_counter()
    ranks = _run_world(_mesh_train_axes_rank, 8, {"ref_path": ref_path,
                                                  "ckpt_path": ckpt_path},
                       "mesh_train")
    axes = {"ranks": [r.pop("axes") for r in ranks],
            "wall_s": ranks[0]["axes_wall_s"]}
    ref = ranks[0]["ref"]
    os.remove(ref_path)
    shutil.rmtree(ckpt_path, ignore_errors=True)
    wall = time.perf_counter() - t0
    r0 = ranks[0]
    bad = []
    if any(r["losses"] != r0["losses"] for r in ranks):
        bad.append("ranks disagree on the loss")
    if not all(np.isfinite(r0["losses"])):
        bad.append(f"non-finite losses {r0['losses']}")
    gap = abs(r0["losses"][0] - ref["losses"][0])
    fault_gap = abs(r0["fault_loss"] - ref["losses"][0])
    if not gap <= MESH_LOSS_TOL:
        bad.append(f"step-1 loss {r0['losses'][0]} vs one-card "
                   f"{ref['losses'][0]}: gap {gap} > {MESH_LOSS_TOL}")
    if not fault_gap > MESH_LOSS_TOL:
        bad.append(f"planted fault's loss gap {fault_gap} within the bound")
    gap2 = abs(r0["losses"][1] - ref["losses"][1])
    bwd_gap2 = abs(r0["bwd_fault_loss2"] - ref["losses"][1])
    param_gap = max(r["param_gap"] for r in ranks)
    update_gap = max(r["update_gap"] for r in ranks)
    bwd_param_gap = max(r["bwd_fault_param_gap"] for r in ranks)
    bwd_update_gap = max(r["bwd_fault_update_gap"] for r in ranks)
    for what, sound, fault, tol in (
            ("step-2 loss gap", gap2, bwd_gap2, MESH_LOSS_TOL),
            ("weights' gap after step 1", param_gap, bwd_param_gap,
             MESH_PARAM_GAP_TOL),
            ("update's gap at step 1", update_gap, bwd_update_gap,
             MESH_UPDATE_GAP_TOL)):
        if not sound <= tol:
            bad.append(f"{what} {sound} > {tol}")
        if not fault > tol:
            bad.append(f"backward fault's {what} {fault} within {tol}")
    for rank, r in enumerate(ranks):
        for s, got in enumerate(r["per_step_launches"]):
            if got != r["expected_per_step"]:
                bad.append(f"rank {rank} step {s}: flash launches {got} != "
                           f"{r['expected_per_step']}")
        for c, chk in r["ring"].items():
            if not chk["ok"]:
                bad.append(f"rank {rank}: {c} flash ring vs dense ring "
                           f"{chk['rel_err']}")
    ring_fault = max(chk["rel_err"] for r in ranks
                     for chk in r["ring_fault"].values())
    if not ring_fault > MESH_RING_TOL:
        bad.append(f"the ring without its last visiting block reads "
                   f"{ring_fault}, within {MESH_RING_TOL}")
    ck = [r["checkpoint"] for r in ranks]
    ckpt_ref = ck[0]["one_card"]
    restore_gap = max(abs(c["loss"] - ckpt_ref["loss"]) for c in ck)
    restore_fault_gap = min(abs(c["fault_loss"] - ckpt_ref["loss"])
                            for c in ck)
    if not restore_gap <= MESH_LOSS_TOL:
        bad.append(f"the step after the restore onto {MESH_RESTORE_AXES}: "
                   f"loss gap {restore_gap} to the one-card restore's")
    if not restore_fault_gap > MESH_LOSS_TOL:
        bad.append(f"every rank restoring one rank's slices reads "
                   f"{restore_fault_gap}, within {MESH_LOSS_TOL}")
    if any(c["restored_step"] != MESH_STEPS for c in ck):
        bad.append("the restored step count is not the saved one")
    for rank, c in enumerate(ck):
        limit = (1 + BUILD_PEAK_SLACK) * (c["shard_gb"]
                                          + c["largest_leaf_gb"])
        if not c["init_peak_gb"] <= limit:
            bad.append(f"rank {rank}: drawing its shard peaked at "
                       f"{c['init_peak_gb']} GB, over {limit}")
        limit = (1 + BUILD_PEAK_SLACK) * c["largest_leaf_gb"]
        if not c["restore_extra_gb"] <= limit:
            bad.append(f"rank {rank}: restoring into its state added "
                       f"{c['restore_extra_gb']} GB, over {limit}")
    save_s = max(c["save_s"] for c in ck)
    restore_s = max(c["restore_wall_s"] for c in ck)
    file_gb = ck[0]["file_bytes"] / 1e9
    checkpoint = dict(
        file_gb=file_gb, save_s=save_s, save_gb_s=file_gb / save_s,
        restore_s=restore_s, restore_gb_s=file_gb / restore_s,
        restore_rank_s=[c["restore_s"] for c in ck],
        one_card_restore_s=ckpt_ref["restore_s"],
        restore_axes=MESH_RESTORE_AXES, loss=ck[0]["loss"],
        one_card_loss=ckpt_ref["loss"], loss_gap=restore_gap,
        fault_loss=ck[0]["fault_loss"], fault_gap=restore_fault_gap,
        state_gb_rank=ck[0]["state_gb"], shard_gb_rank=ck[0]["shard_gb"],
        largest_leaf_gb=ck[0]["largest_leaf_gb"],
        init_peak_gb_rank_max=max(c["init_peak_gb"] for c in ck),
        restore_peak_gb_rank_max=max(c["restore_peak_gb"] for c in ck),
        restore_extra_gb_rank_max=max(c["restore_extra_gb"] for c in ck))
    line("mesh_checkpoint", card=torch.cuda.get_device_name(0),
         nvidia_smi=smi, **checkpoint)
    launches = [sum(r["launches"][i] for r in ranks) for i in range(3)]
    row = dict(
        card=torch.cuda.get_device_name(0), nvidia_smi=smi,
        setting="8 ranks time-sharing one card; gloo, host-staged",
        checkpoint=checkpoint,
        mesh=MESH_AXES, batch=MESH_BATCH, seq=MESH_SEQ, layers=cfg.n_layers,
        attention="ring_flash", remat="full",
        losses=r0["losses"], ref_losses=ref["losses"], loss_gap=gap,
        loss_tol=MESH_LOSS_TOL, fault_loss=r0["fault_loss"],
        fault_gap=fault_gap, loss_gap_step2=gap2,
        param_gap_max=param_gap, param_gap_tol=MESH_PARAM_GAP_TOL,
        update_gap_max=update_gap, update_gap_tol=MESH_UPDATE_GAP_TOL,
        bwd_fault=dict(loss2=r0["bwd_fault_loss2"], loss_gap_step2=bwd_gap2,
                       param_gap_max=bwd_param_gap,
                       update_gap_max=bwd_update_gap),
        flash_per_step={f"rank{i}": r["per_step_launches"][0]
                        for i, r in enumerate(ranks)},
        flash_expected={f"rank{i}": r["expected_per_step"]
                        for i, r in enumerate(ranks)},
        flash_launches=dict(forward=launches[0], dq=launches[1],
                            dkv=launches[2], steps=MESH_STEPS, ranks=8),
        step_ms=r0["step_ms"], ref_step_ms=ref["step_ms"],
        bytes_per_step_rank0={k: v for k, v in r0["axis_bytes"][-1].items()},
        staged_bytes_per_step_rank0=r0["staged_bytes"][-1],
        staged_bytes_per_step_all=sum(r["staged_bytes"][-1] for r in ranks),
        peak_mem_gb_rank_max=max(r["peak_mem_gb"] for r in ranks),
        ref_peak_mem_gb=ref["peak_mem_gb"],
        nvidia_smi_mem=r0["nvidia_smi_mem"],
        ring_check={f"rank{i}": r["ring"] for i, r in enumerate(ranks)},
        ring_rel_err_max=max(chk["rel_err"] for r in ranks
                             for chk in r["ring"].values()),
        ring_tol=MESH_RING_TOL, ring_fault_rel_err_max=ring_fault,
        wall_s=wall, ok=not bad)
    line("mesh_train", **row)
    if bad:
        raise SystemExit("mesh_train: " + "; ".join(bad))
    return row, axes


SMALL_MESH_KW = dict(vocab=512, d_model=256, n_layers=4, n_heads=4,
                     d_ff=512, max_seq=512)


def _small_mesh_batch(seed=35):
    tokens = np.random.default_rng(seed).integers(
        0, SMALL_MESH_KW["vocab"], (4, 256))
    return tokens, np.roll(tokens, -1, axis=1)


def _one_card_losses(cfg, tree, attention, batch, steps=1, lr=3e-4,
                     accum=1):
    """The one-card step on *tree*'s weights -> (losses, weights)."""
    from kubetpu_torch.jobs import train as train_lib
    from kubetpu_torch.jobs.convert import params_from_numpy

    opt = train_lib.make_optimizer(lr=lr)
    state = train_lib.state_from_params(params_from_numpy(tree, cfg, "cuda"),
                                        opt)
    step = train_lib.make_train_step(cfg, opt, attention=attention,
                                     accum_steps=accum, device="cuda")
    losses = [float(step(state, *batch)[1]) for _ in range(steps)]
    return losses, state.params


def _one_card_grads(cfg, tree, batch, accum=1) -> dict:
    """The gradient of the one-card loss at *tree*'s weights, as a tree
    (the micro-batches' mean under *accum*, as the step takes it)."""
    from kubetpu_torch.jobs import model as model_lib
    from kubetpu_torch.jobs.convert import params_from_numpy, params_to_numpy

    model = params_from_numpy(tree, cfg, "cuda")
    leaves = list(model.parameters())
    for p in leaves:
        p.requires_grad_(True)
    tokens, targets = (torch.as_tensor(x, device="cuda") for x in batch)
    micro = tokens.shape[0] // accum
    grads = [sum(g) / accum for g in zip(*(torch.autograd.grad(
        model_lib.next_token_loss(model, tokens[i * micro:(i + 1) * micro],
                                  targets[i * micro:(i + 1) * micro], cfg),
        leaves) for i in range(accum)))]
    with torch.no_grad():
        for p, g in zip(leaves, grads):
            p.copy_(g)
    return params_to_numpy(model)


def _flat(tree, path=()) -> list:
    """(path, array) of every leaf of a nested dict, in key order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k], path + (k,))]
    return [(path, np.asarray(tree))]


def _pipe_update_gap(tree, got, ref, grads) -> float:
    """The largest |change of an element over one step - the reference
    step's change|, in steps of PIPE_LR, over the elements whose reference
    gradient is not zero to rounding (|g| > 1e-6 of the leaf's largest):
    a model's or an adapter's tree."""
    worst = 0.0
    for (_n, w0), (_, a), (_, r), (_, g) in zip(
            _flat(tree), _flat(got), _flat(ref), _flat(grads)):
        keep = np.abs(g) > 1e-6 * np.abs(g).max()
        worst = max(worst, float(np.abs((a - w0) - (r - w0))[keep].max()))
    return worst / PIPE_LR


def _mesh_axes_rank(rank, world, args):
    """Phase 35 on one rank: each leg's mesh step (and rank 0's one-card
    references)."""
    from kubetpu_torch.jobs import pipeline as pipe
    from kubetpu_torch.jobs import train as train_lib
    from kubetpu_torch.jobs.convert import (gather_params, params_to_numpy,
                                            shard_params)
    from kubetpu_torch.jobs.meshjob import make_mesh, make_multislice_mesh
    from kubetpu_torch.jobs.model import ModelConfig, init_params

    cfg = ModelConfig(**SMALL_MESH_KW)
    tree = params_to_numpy(init_params(torch.Generator().manual_seed(35),
                                       cfg, device="cpu"))
    batch = _small_mesh_batch()
    out = {}

    def mesh_step(c, mesh, attention, steps=1):
        opt = train_lib.make_optimizer()
        state = train_lib.state_from_params(
            shard_params(tree, c, mesh, "cuda"), opt)
        step = train_lib.make_train_step(c, opt, attention=attention,
                                         device="cuda", mesh=mesh)
        return [float(step(state, *batch)[1]) for _ in range(steps)]

    dp = make_mesh(MESH_AXES, device="cuda")
    out["ring"] = mesh_step(cfg, dp, "ring", 2)
    out["ring_flash"] = mesh_step(cfg, dp, "ring_flash")
    wcfg = dataclasses.replace(cfg, window=8)
    out["banded"] = mesh_step(wcfg, dp, "ring")
    ms = make_multislice_mesh({"dcn": 2, "sp": 2, "tp": 2}, device="cuda")
    out["multislice"] = mesh_step(cfg, ms, "ring", 2)
    # the pipeline: {dp 1, pp 2, sp 2, tp 2}, two microbatches, one step
    # at PIPE_LR; then the planted fault: the backward hop into stage 0
    # sends zeros
    pmesh = make_mesh({"dp": 1, "pp": 2, "sp": 2, "tp": 2}, device="cuda")

    def pipe_step():
        opt = train_lib.make_optimizer(lr=PIPE_LR)
        pstate = train_lib.state_from_params(
            shard_params(tree, cfg, pmesh, "cuda", pp=True), opt)
        pstep = pipe.make_pipeline_train_step(cfg, pmesh, 2, opt,
                                              device="cuda")
        loss = float(pstep(pstate, *batch)[1])
        return loss, gather_params(pstate.params, cfg, pmesh, pp=True)

    ploss, ptree = pipe_step()
    out["pipeline"] = [ploss]
    sound_bwd = pipe._RecvPrev.backward
    pipe._RecvPrev.backward = staticmethod(
        lambda ctx, g: sound_bwd(ctx, torch.zeros_like(g)))
    _fault_loss, ftree = pipe_step()
    pipe._RecvPrev.backward = staticmethod(sound_bwd)
    # the rings against their plain version and the one-card flash core:
    # the flash ring, bidirectional and causal, vs the dense ring on the
    # same ranks; the bidirectional ring vs non-causal one-card flash
    sp_mesh = make_mesh({"sp": world}, device="cuda")
    f32 = dict(B=2, S=64, H=4, D=64, dtype=torch.float32)
    out["ring_check"] = {c: _ring_check(sp_mesh, rank, f32, c == "causal",
                                        SMALL_MESH_TOL)
                         for c in ("causal", "noncausal")}
    out["bidir"] = _bidir_vs_one_card(sp_mesh, rank, world)
    out.update(_ep_legs(rank))
    out.update(_lora_leg(rank, cfg, tree, batch))
    if rank == 0:
        out["ref_flash"], _ = _one_card_losses(cfg, tree, "flash", batch, 2)
        out["ref_dense_window"], _ = _one_card_losses(wcfg, tree, "dense",
                                                      batch)
        ref = params_to_numpy(_one_card_losses(cfg, tree, "flash", batch,
                                               lr=PIPE_LR)[1])
        grads = _one_card_grads(cfg, tree, batch)
        out["pipeline_update_gap"] = _pipe_update_gap(tree, ptree, ref, grads)
        out["pipeline_fault_update_gap"] = _pipe_update_gap(tree, ftree, ref,
                                                            grads)
    return out


# phase 35's expert-axis legs: the {dp 2, ep 4} step with capacity
# dispatch at tests/test_jobs.py's ep config, fed by the global batch and
# by prefetch_to_mesh; the five-axis pipeline at _dryrun_pipeline's factors
# and config (capacity 2.0, E = 2 ep, two microbatches)
EP_KW = dict(vocab=64, d_model=32, n_layers=2, n_heads=4, d_ff=64,
             max_seq=64, n_experts=4, moe_capacity_factor=1.5)
EP_AXES = {"dp": 2, "ep": 4}
FIVE_KW = dict(vocab=128, d_model=64, n_layers=4, n_heads=4, d_ff=128,
               max_seq=128, n_experts=4, moe_capacity_factor=2.0)
FIVE_AXES = {"dp": 2, "pp": 2, "sp": 1, "tp": 1, "ep": 2}
FIVE_MICRO = 2


def _tree_of(cfg, seed) -> dict:
    from kubetpu_torch.jobs.convert import params_to_numpy
    from kubetpu_torch.jobs.model import init_params

    return params_to_numpy(init_params(torch.Generator().manual_seed(seed),
                                       cfg, device="cpu"))


def _ep_legs(rank) -> dict:
    """The ep step (one step at PIPE_LR, the weights gathered; the same
    step fed by ``prefetch_to_mesh``, whose blocks must be
    ``local_batch``'s) and the five-axis pipeline step; rank 0 also runs
    the one-card references (the pipeline's with ``accum_steps`` = its
    microbatches: a capacity dispatch spans one microbatch) and their
    gradients."""
    from kubetpu_torch.jobs import pipeline as pipe
    from kubetpu_torch.jobs import train as train_lib
    from kubetpu_torch.jobs.convert import (gather_params, params_to_numpy,
                                            shard_params)
    from kubetpu_torch.jobs.data import prefetch_to_mesh
    from kubetpu_torch.jobs.meshjob import make_mesh
    from kubetpu_torch.jobs.model import ModelConfig

    out = {}
    ecfg = ModelConfig(**EP_KW)
    etree = _tree_of(ecfg, 36)
    tokens = np.random.default_rng(36).integers(0, ecfg.vocab, (4, 32))
    ebatch = (tokens, np.roll(tokens, -1, axis=1))
    emesh = make_mesh(EP_AXES, device="cuda")

    def ep_step(batches):
        opt = train_lib.make_optimizer(lr=PIPE_LR)
        state = train_lib.state_from_params(
            shard_params(etree, ecfg, emesh, "cuda"), opt)
        step = train_lib.make_train_step(ecfg, opt, attention="dense",
                                         device="cuda", mesh=emesh)
        losses = [float(step(state, *b)[1]) for b in batches]
        return losses, gather_params(state.params, ecfg, emesh)

    out["ep"], ep_tree = ep_step([ebatch])
    staged = list(prefetch_to_mesh(iter([ebatch]), emesh, device="cuda"))
    out["ep_prefetch_blocks_ok"] = all(
        np.array_equal(x.cpu().numpy(),
                       train_lib.local_batch(np.asarray(y), emesh))
        for x, y in zip(staged[0], ebatch))
    out["ep_prefetch"], _ = ep_step(staged)
    fcfg = ModelConfig(**FIVE_KW)
    ftree = _tree_of(fcfg, 37)
    tokens = np.random.default_rng(37).integers(0, fcfg.vocab, (4, 32))
    fbatch = (tokens, np.roll(tokens, -1, axis=1))
    fmesh = make_mesh(FIVE_AXES, device="cuda")
    opt = train_lib.make_optimizer(lr=PIPE_LR)
    fstate = train_lib.state_from_params(
        shard_params(ftree, fcfg, fmesh, "cuda", pp=True), opt)
    fstep = pipe.make_pipeline_train_step(fcfg, fmesh, FIVE_MICRO, opt,
                                          device="cuda")
    out["five_axis"] = [float(fstep(fstate, *fbatch)[1])]
    five_tree = gather_params(fstate.params, fcfg, fmesh, pp=True)
    if rank == 0:
        out["ref_ep"], ref = _one_card_losses(ecfg, etree, "dense", ebatch,
                                              lr=PIPE_LR)
        out["ep_update_gap"] = _pipe_update_gap(
            etree, ep_tree, params_to_numpy(ref),
            _one_card_grads(ecfg, etree, ebatch))
        out["ref_five_axis"], ref = _one_card_losses(
            fcfg, ftree, "dense", fbatch, lr=PIPE_LR, accum=FIVE_MICRO)
        out["five_axis_update_gap"] = _pipe_update_gap(
            ftree, five_tree, params_to_numpy(ref),
            _one_card_grads(fcfg, ftree, fbatch, accum=FIVE_MICRO))
    return out


def _lora_leg(rank, cfg, tree, batch) -> dict:
    """The sharded LoRA step on {dp 2, sp 2, tp 2} with ``ring_flash``,
    one step at PIPE_LR from a rank-8 adapter whose B factors are drawn
    off zero (every factor has a gradient); rank 0 runs the one-card LoRA
    step (flash) and its gradient."""
    from kubetpu_torch.jobs import collectives as col
    from kubetpu_torch.jobs import lora as lora_lib
    from kubetpu_torch.jobs import model as model_lib
    from kubetpu_torch.jobs import train as train_lib
    from kubetpu_torch.jobs.convert import (lora_to_numpy, params_from_numpy,
                                            shard_params)
    from kubetpu_torch.jobs.meshjob import make_mesh

    lcfg = lora_lib.LoraConfig(rank=8, alpha=16.0)

    def adapter():
        a = lora_lib.init_lora_params(torch.Generator().manual_seed(38),
                                      cfg, lcfg, device="cpu")
        gen = torch.Generator().manual_seed(39)
        for t in lcfg.targets:
            b = a["blocks"][f"{t}_b"]
            a["blocks"][f"{t}_b"] = torch.randn(b.shape, generator=gen) * 0.05
        return {"blocks": {k: v.to("cuda") for k, v in a["blocks"].items()}}

    def step_of(lora, base, mesh=None, attention="flash"):
        for v in lora["blocks"].values():
            v.requires_grad_(True)
        opt = train_lib.make_optimizer(lr=PIPE_LR)
        state = train_lib.TrainState(
            lora, opt.init(train_lib._trained_leaves(lora)))
        step = lora_lib.make_lora_train_step(cfg, lcfg, opt,
                                             attention=attention,
                                             device="cuda", mesh=mesh)
        return float(step(state, base, *batch)[1]), state.params

    mesh = make_mesh(MESH_AXES, device="cuda")
    loss, lora = step_of(lora_lib.shard_lora(adapter(), mesh),
                         shard_params(tree, cfg, mesh, "cuda"), mesh,
                         "ring_flash")
    whole = {}
    for k, v in lora["blocks"].items():
        spec = lora_lib._leaf_spec(k)
        t = v.detach()
        if "tp" in spec:
            t = col.all_gather(t, col.group_of(mesh, "tp"), "gather",
                               spec.index("tp"))
        whole[k] = t.float().cpu().numpy()
    out = {"lora": [loss]}
    if rank == 0:
        start = lora_to_numpy(adapter())
        base = params_from_numpy(tree, cfg, "cuda")
        out["ref_lora"], ref = step_of(adapter(), base)
        out["ref_lora"] = [out["ref_lora"]]
        probe = adapter()
        leaves = train_lib._trained_leaves(probe)
        for v in leaves:
            v.requires_grad_(True)
        tokens, targets = (torch.as_tensor(x, device="cuda") for x in batch)
        grads = torch.autograd.grad(model_lib.next_token_loss(
            lora_lib._merged_view(base, probe, lcfg), tokens, targets, cfg),
            leaves)
        out["lora_update_gap"] = _pipe_update_gap(
            start, {"blocks": whole}, lora_to_numpy(ref),
            {"blocks": {k: g.float().cpu().numpy() for k, g in
                        zip(sorted(probe["blocks"]), grads)}})
    return out


def _bidir_vs_one_card(mesh, rank, world) -> dict:
    """The bidirectional flash ring over *mesh*'s sp ring against
    ``flash_attention(causal=False)`` on one card, same input: this
    rank's block of the output and of dq."""
    from kubetpu_torch.jobs.ring_attention import make_ring_attention
    from kubetpu_torch.ops.flash_attention import flash_attention

    gen = torch.Generator(device="cuda").manual_seed(7)
    q, k, v, cot = (torch.randn((2, 32 * world, 4, 64), generator=gen,
                                device="cuda") for _ in range(4))
    s = 32
    blk = slice(rank * s, (rank + 1) * s)

    def run(fn, *xs):
        leaves = [x.clone().requires_grad_(True) for x in xs]
        out = fn(*leaves)
        return out.detach(), torch.autograd.grad((out * cot[:, :out.shape[1]]
                                         if out.shape[1] == cot.shape[1]
                                         else out * cot[:, blk]).sum(),
                                        leaves)

    one, one_g = run(lambda a, b, c: flash_attention(a, b, c, causal=False),
                     q, k, v)
    ring, ring_g = run(make_ring_attention(mesh, impl="flash", causal=False),
                       q[:, blk].contiguous(), k[:, blk].contiguous(),
                       v[:, blk].contiguous())
    errs = [_err_ok(ring, one[:, blk], SMALL_MESH_TOL)] + [
        _err_ok(g, w[:, blk], SMALL_MESH_TOL)
        for g, w in zip(ring_g, one_g)]
    return {"max_abs_err": max(e for e, _ in errs),
            "ok": all(o for _, o in errs)}


def _gang_cli() -> dict:
    """The gang-launch CLI as a process (``python -m
    kubetpu_torch.cli.gang_launch``) against a stdlib stub of the
    controller's ``GET /pods/<name>``, whose two pods both name this card
    by its UUID (``nvidia-smi``), as the device manager writes it: two
    workers share the card over gloo -> its exit code, its report (None
    where it failed), the UUID and the end of its errors."""
    import threading
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    uid = subprocess.run(["nvidia-smi", "--query-gpu=uuid",
                          "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True).stdout.strip()

    class Pods(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_GET(self):  # noqa: N802 (stdlib name)
            body = json.dumps({"pod": self.path.rsplit("/", 1)[-1],
                               "containers": {"main": {
                                   "mounts": [], "devices": [],
                                   "env": {"NVIDIA_VISIBLE_DEVICES": uid}}}})
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.end_headers()
            self.wfile.write(body.encode())

    stub = ThreadingHTTPServer(("127.0.0.1", 0), Pods)
    threading.Thread(target=stub.serve_forever, daemon=True).start()
    try:
        proc = subprocess.run(
            [sys.executable, "-m", "kubetpu_torch.cli.gang_launch",
             "--controller", f"http://127.0.0.1:{stub.server_address[1]}",
             "--timeout", "240", "w0", "w1"],
            cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT),
            capture_output=True, text=True, timeout=300)
    finally:
        stub.shutdown()
        stub.server_close()
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    return {"rc": proc.returncode, "uuid": uid,
            "out": json.loads(lines[-1]) if proc.returncode == 0 and lines
            else None, "stderr": proc.stderr[-1500:]}


def phase_mesh_axes(smi: str, axes: dict) -> dict:
    """Phase 35: the other legs of ``dryrun_multichip`` in one 8-rank world
    at a small f32 width (vocab 512, d 256, 4 layers, 4 heads, batch
    4 x 256): the dense and the flash ring step on {dp 2, sp 2, tp 2}
    against the one-card flash step; the banded ring (window 8) against
    the one-card dense windowed step; {dcn 2, sp 2, tp 2} equal to
    {dp 2, sp 2, tp 2} exactly; the pipeline {dp 1, pp 2, sp 2, tp 2}
    against the one-card step (its loss, and each weight's change over a
    step at ``PIPE_LR`` within ``PIPE_UPDATE_TOL`` steps, a pipeline whose
    backward hop into stage 0 sends zeros beyond it); the flash ring, causal
    and bidirectional, against the dense ring on the same ranks, and the
    bidirectional flash ring against one-card non-causal flash; the
    expert axis (``_ep_legs``: the {dp 2, ep 4} step with capacity
    dispatch, also fed by ``prefetch_to_mesh``, and the five-axis pipeline
    {dp 2, pp 2, ep 2, sp 1}) and the sharded LoRA step on {dp 2, sp 2,
    tp 2} with ``ring_flash`` (``_lora_leg``), each against the one-card
    step, its loss and each weight's change as the pipeline's; then the
    gang-launch CLI (``_gang_cli``): two pods naming this card by its
    UUID, two workers sharing it over gloo, exit 0, one finite loss equal
    on both, process count 2 and global devices 2 on each, each worker
    seeing the card by the UUID. Losses within ``SMALL_MESH_TOL``
    relative. The 8-rank legs run in phase 34's world, after its legs
    (``phase_mesh_train``'s *axes*)."""
    t0 = time.perf_counter()
    ranks = axes["ranks"]
    t_gang = time.perf_counter()
    cli = _gang_cli()
    t_gang = time.perf_counter() - t_gang
    gang = (cli["out"] or {}).get("workers", [])
    r0 = ranks[0]
    bad = []

    def close(a, b):
        return abs(a - b) <= SMALL_MESH_TOL * abs(b)

    for key in ("ring", "ring_flash", "banded", "multislice", "pipeline"):
        if any(r[key] != r0[key] for r in ranks):
            bad.append(f"{key}: ranks disagree")
    if not close(r0["ring"][0], r0["ref_flash"][0]):
        bad.append(f"dense ring {r0['ring']} vs flash {r0['ref_flash']}")
    if not close(r0["ring"][1], r0["ref_flash"][1]):
        bad.append(f"dense ring step 2 {r0['ring']} vs {r0['ref_flash']}")
    if not close(r0["ring_flash"][0], r0["ref_flash"][0]):
        bad.append(f"flash ring {r0['ring_flash']} vs {r0['ref_flash']}")
    if not close(r0["banded"][0], r0["ref_dense_window"][0]):
        bad.append(f"banded {r0['banded']} vs {r0['ref_dense_window']}")
    if r0["multislice"] != r0["ring"]:
        bad.append(f"multislice {r0['multislice']} != dp {r0['ring']}")
    if not close(r0["pipeline"][0], r0["ref_flash"][0]):
        bad.append(f"pipeline {r0['pipeline']} vs {r0['ref_flash']}")
    if not r0["pipeline_update_gap"] <= PIPE_UPDATE_TOL:
        bad.append(f"pipeline update gap {r0['pipeline_update_gap']} steps")
    if not r0["pipeline_fault_update_gap"] > PIPE_UPDATE_TOL:
        bad.append(f"pipeline with a zero backward hop: update gap "
                   f"{r0['pipeline_fault_update_gap']} steps, in bound")
    for rank, r in enumerate(ranks):
        for c, chk in r["ring_check"].items():
            if not chk["ok"]:
                bad.append(f"rank {rank} {c}: {chk['rel_err']}")
        if not r["bidir"]["ok"]:
            bad.append(f"rank {rank} bidir_one_card: "
                       f"{r['bidir']['max_abs_err']}")
    if not (cli["rc"] == 0 and len(gang) == 2
            and gang[0]["loss"] == gang[1]["loss"]
            and np.isfinite(gang[0]["loss"])
            and [g["process_index"] for g in gang] == [0, 1]
            and all(g["process_count"] == 2 and g["global_devices"] == 2
                    and g["backend"] == "gloo"
                    and g["device_names"] == [cli["uuid"]] for g in gang)
            and cli["uuid"].startswith("GPU-")):
        bad.append(f"gang CLI: exit {cli['rc']}, {gang}, uuid "
                   f"{cli['uuid']!r}: {cli['stderr'][-600:]}")
    for key in ("ep", "ep_prefetch", "five_axis", "lora"):
        if any(r[key] != r0[key] for r in ranks):
            bad.append(f"{key}: ranks disagree")
    for key in ("ep", "five_axis", "lora"):
        if not close(r0[key][0], r0[f"ref_{key}"][0]):
            bad.append(f"{key} {r0[key]} vs one card {r0[f'ref_{key}']}")
        if not r0[f"{key}_update_gap"] <= PIPE_UPDATE_TOL:
            bad.append(f"{key} update gap {r0[f'{key}_update_gap']} steps")
    if r0["ep_prefetch"] != r0["ep"] or not all(
            r["ep_prefetch_blocks_ok"] for r in ranks):
        bad.append(f"prefetch_to_mesh: blocks ok "
                   f"{[r['ep_prefetch_blocks_ok'] for r in ranks]}, losses "
                   f"{r0['ep_prefetch']} vs {r0['ep']}")
    row = dict(card=torch.cuda.get_device_name(0), nvidia_smi=smi,
               setting="8 ranks time-sharing one card; gloo, host-staged",
               cfg=SMALL_MESH_KW, dtype="float32", tol=SMALL_MESH_TOL,
               ring=r0["ring"], ring_flash=r0["ring_flash"],
               ref_flash=r0["ref_flash"], banded=r0["banded"],
               ref_dense_window=r0["ref_dense_window"],
               multislice=r0["multislice"], pipeline=r0["pipeline"],
               pipeline_lr=PIPE_LR,
               pipeline_update_gap_steps=r0["pipeline_update_gap"],
               pipeline_fault_update_gap_steps=r0[
                   "pipeline_fault_update_gap"],
               pipeline_update_tol_steps=PIPE_UPDATE_TOL,
               ring_check_rel_err=max(c["rel_err"] for r in ranks
                                      for c in r["ring_check"].values()),
               bidir_max_err=max(r["bidir"]["max_abs_err"] for r in ranks),
               gang_losses=[g["loss"] for g in gang],
               gang_cli=dict(rc=cli["rc"], uuid=cli["uuid"],
                             backend=[g.get("backend") for g in gang],
                             device_names=[g.get("device_names")
                                           for g in gang],
                             wall_s=t_gang),
               ep_cfg=EP_KW, ep_axes=EP_AXES, ep=r0["ep"],
               ref_ep=r0["ref_ep"], ep_prefetch=r0["ep_prefetch"],
               ep_update_gap_steps=r0["ep_update_gap"],
               five_axis_cfg=FIVE_KW, five_axis_axes=FIVE_AXES,
               five_axis=r0["five_axis"], ref_five_axis=r0["ref_five_axis"],
               five_axis_update_gap_steps=r0["five_axis_update_gap"],
               lora=r0["lora"], ref_lora=r0["ref_lora"],
               lora_update_gap_steps=r0["lora_update_gap"],
               wall_s=axes["wall_s"] + time.perf_counter() - t0, ok=not bad)
    line("mesh_axes", **row)
    if bad:
        raise SystemExit("mesh_axes: " + "; ".join(bad))
    return row


# -- phase 36: serving over a mesh -------------------------------------------

# _serving_mesh_factors(flagship, 8): tp as wide as heads, kv heads, d_ff
# and vocab allow next to dp 2
SERVE_MESH_AXES = {"dp": 2, "tp": 4}
SERVE_MESH_KINDS = ("paged", "dense", "spec", "lora")
SERVE_MESH_TENANTS = (0, 9)            # two of phase 17's rank-8 adapters
SERVE_MESH_NEW = 8                     # new tokens a request (phase 6: 32)
# requests: the first of phase 6's prompts (its 8 until phase 37 came)
SERVE_MESH_PROMPTS = 4
SERVE_FAULT_PROMPTS = 3                # the planted fault's requests
GEN_MESH_STEPS = 8


def _serve_cfg():
    from kubetpu_torch.jobs import model as model_lib

    return model_lib.ModelConfig(vocab=32000, d_model=2048, n_layers=12,
                                 n_heads=16, d_ff=5632, max_seq=2048,
                                 dtype=torch.bfloat16)


# phase 36's prediction of a rank's peak while it builds its tp-4 shard
# (PERF.md §6): the shard (0.47 GB) plus the largest leaf (0.13 GB); the
# peak a rank read 4.77-5.47 GB when every rank drew the whole model
MESH_BUILD_PREDICTED_GB = 0.60
WHOLE_MODEL_SERVE_PEAK_GB = (4.77, 5.47)


def _serve_models(model=None) -> dict:
    """Phase 6's flagship (seed 0; *model*, its shard, where the caller
    built it), phase 16's quarter draft (seed 7) and two of phase 17's
    rank-8 adapters, all on the card."""
    from kubetpu_torch.jobs import model as model_lib
    from kubetpu_torch.jobs.lora import LoraConfig

    cfg = _serve_cfg()
    qcfg = model_lib.ModelConfig(vocab=cfg.vocab, d_model=512, n_layers=3,
                                 n_heads=4, d_ff=1408, max_seq=2048,
                                 dtype=torch.bfloat16)
    lcfg = LoraConfig(rank=8, alpha=16.0)

    def init(c, seed):
        return model_lib.init_params(
            torch.Generator(device="cuda").manual_seed(seed), c,
            device="cuda")

    return dict(cfg=cfg, model=init(cfg, 0) if model is None else model,
                qcfg=qcfg, quarter=init(qcfg, 7),
                lcfg=lcfg,
                ads=_tenant_adapters(cfg, lcfg, SERVE_MESH_TENANTS))


def _serve_server(kind, m, mesh):
    """A server of *kind* at phase 6's settings (8 slots, max_seq 2048,
    prefill budget 256; pages of 16) but SERVE_MESH_NEW new tokens, over
    *mesh* (None: one card)."""
    from kubetpu_torch.jobs.multi_lora import PagedMultiLoraDecodeServer
    from kubetpu_torch.jobs.paged import PagedDecodeServer
    from kubetpu_torch.jobs.serving import DecodeServer
    from kubetpu_torch.jobs.spec_serving import PagedSpeculativeDecodeServer

    kw = dict(n_slots=8, max_seq=2048, max_new_tokens=SERVE_MESH_NEW,
              prefill_budget=256, device="cuda", mesh=mesh)
    if kind == "dense":
        return DecodeServer(m["cfg"], m["model"], **kw)
    kw["page_size"] = 16
    if kind == "spec":
        return PagedSpeculativeDecodeServer(m["cfg"], m["qcfg"], m["model"],
                                            m["quarter"], gamma_max=GAMMA_MAX,
                                            **kw)
    if kind == "lora":
        return PagedMultiLoraDecodeServer(m["cfg"], m["model"], m["lcfg"],
                                          m["ads"], **kw)
    return PagedDecodeServer(m["cfg"], m["model"], **kw)


class _Collectives:
    """Counts the collective calls (each one a host sync under gloo)
    while open; ``close`` restores the functions and returns the count."""

    NAMES = ("all_reduce_", "all_gather", "broadcast_")

    def __init__(self) -> None:
        from kubetpu_torch.jobs import collectives as col

        self.col, self.n = col, 0
        self._saved = {n: getattr(col, n) for n in self.NAMES}
        for name, fn in self._saved.items():
            setattr(col, name, self._counted(fn))

    def _counted(self, fn):
        def run(*args, **kwargs):
            self.n += 1
            return fn(*args, **kwargs)
        return run

    def close(self) -> int:
        for name, fn in self._saved.items():
            setattr(self.col, name, fn)
        return self.n


def _ttft_tap(server) -> list:
    """The TTFT samples (s) the server records from now on."""
    got, record = [], server._metrics.record

    def tap(op, seconds):
        if op == "ttft":
            got.append(seconds)
        record(op, seconds)

    server._metrics.record = tap
    return got


def _serve_lifecycle(kind, server, prompts, top2=False,
                     logits=False, together=False) -> dict:
    """``_dryrun_serving``'s staggered lifecycle at phase 6's prompts: two
    submitted (each prefilled whole, its first token read at once), one
    step, the others enqueued while those decode, drain. With *together*
    every prompt is enqueued before the first step instead, so each
    prompt's prefill chunks fall where they fall for the same requests
    queued behind a replica (phase 38), and the two runs compute the same
    sums. Paged counters, per-axis bytes and collective calls are zeroed
    just before and read just after; each step's wall ms and whether it
    ran a prefill chunk are kept, and the TTFT samples; with *logits* each
    prompt's first-token logits too."""
    from kubetpu_torch.jobs import collectives as col
    from kubetpu_torch.ops import paged_attention as pa

    picks = ([{"adapter": i % len(SERVE_MESH_TENANTS)}
              for i in range(len(prompts))] if kind == "lora"
             else [{}] * len(prompts))
    st = _instrument(server)
    rec = _record_top2(server) if top2 else None
    syncs = _SyncCounter(server)
    torch.cuda.synchronize()
    for c in _PAGED_COUNTERS:
        setattr(pa.paged_attention, c, 0)
    col.reset_counters()
    colls = _Collectives()
    steps = []

    def step():
        chunks = st["chunks"]
        t0 = time.perf_counter()
        out = server.step()
        steps.append(((time.perf_counter() - t0) * 1e3,
                      sum(len(v) for v in out.values()),
                      st["chunks"] > chunks))

    ttft = _ttft_tap(server)
    t_start = time.perf_counter()
    if together:
        rids = [server.enqueue(p, **x) for p, x in zip(prompts, picks)]
    else:
        rids = [server.submit(p, **x)
                for p, x in zip(prompts[:2], picks[:2])]
        step()
        rids += [server.enqueue(p, **x)
                 for p, x in zip(prompts[2:], picks[2:])]
    while not server._idle():
        step()
        if len(steps) > 10_000:
            raise SystemExit(f"mesh_serve {kind}: did not converge")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_start
    n_coll = colls.close()
    sync = syncs.close()
    launches = {c: getattr(pa.paged_attention, c) for c in _PAGED_COUNTERS}
    axis_bytes = dict(col.axis_bytes)
    server.check_lockstep()
    if hasattr(server, "check_invariants"):
        server.check_invariants()
    decode = [(ms, n) for ms, n, chunk in steps if not chunk and n]
    return dict(tokens=[server.result(r) for r in rids], wall_s=wall,
                steps=len(steps), decode_steps=st["steps"],
                chunks=st["chunks"],
                decode_toks_s=(sum(n for _, n in decode)
                               / (sum(ms for ms, _ in decode) / 1e3)
                               if decode else None),
                step_ms=float(np.median([ms for ms, _ in decode]))
                if decode else None,
                ttft_ms_p50=float(np.median(ttft)) * 1e3,
                launches=launches,
                bytes_per_step={k: v / len(steps)
                                for k, v in axis_bytes.items()},
                collectives_per_step=n_coll / len(steps),
                host_syncs=sync,
                gaps=_top2_gaps(rec) if rec is not None else None,
                first_logits=[st["first_logits"][tuple(p)].cpu().numpy()
                              for p in prompts] if logits else None)


def _generate_legs(mesh) -> dict:
    """``make_generate`` at phase 35's small f32 width, plain and at window
    8, over *mesh* (None: one card): 4 prompts of 16, 8 new tokens."""
    from kubetpu_torch.jobs.convert import params_from_numpy
    from kubetpu_torch.jobs.decode import make_generate
    from kubetpu_torch.jobs.model import ModelConfig

    cfg = ModelConfig(**SMALL_MESH_KW)
    model = params_from_numpy(_tree_of(cfg, 35), cfg, "cuda")
    prompt = torch.from_numpy(np.random.default_rng(36).integers(
        0, cfg.vocab, (4, 16))).to("cuda")
    return {w: make_generate(dataclasses.replace(cfg, window=w), mesh=mesh)(
        model, prompt, 0, GEN_MESH_STEPS).cpu().tolist() for w in (0, 8)}


class _NoWoReduce:
    """The collectives module for ``decode`` and ``paged`` with
    ``reduce_from`` the identity: the planted fault of phase 36 (``wo``'s
    partial sums stay each rank's own, in the prefill chunks and the
    decode steps; the MLP's, in ``model``, are still summed)."""

    def __init__(self, col) -> None:
        self._col = col

    def __getattr__(self, name):
        return getattr(self._col, name)

    @staticmethod
    def reduce_from(x, group, axis="tp"):
        return x


def _host_mem_gb() -> dict:
    """This process's resident set (``VmRSS``) and the host's available
    memory, GB, from ``/proc``, each None where the kernel does not report
    it: a world's host footprint."""
    def field(path, name):
        with open(path) as f:
            for ln in f:
                if ln.startswith(name):
                    return int(ln.split()[1]) / 1e6
        return None

    return {"rss_gb": field("/proc/self/status", "VmRSS:"),
            "available_gb": field("/proc/meminfo", "MemAvailable:")}


def _mesh_serve_leg(rank, mesh, keep=None):
    """Phase 36's servers on one rank (*mesh* None: the one-card
    reference, with the top-2 logits the near-tie rule reads): the four
    servers' lifecycles, the planted fault (meshed only), the generate
    legs, peak memory. The paged server stays in *keep* (phase 38 serves
    it behind the wire)."""
    import torch.distributed as dist

    from kubetpu_torch.jobs import decode, paged

    shard, build = None, None
    if mesh is not None:
        # the rank's shard drawn leaf by leaf (seed 0, as the one card's
        # whole model): never the whole model on a rank
        from kubetpu_torch.jobs import train as train_lib

        cfg = _serve_cfg()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        shard = train_lib.init_shard(
            torch.Generator(device="cuda").manual_seed(0), cfg, mesh, "cuda")
        torch.cuda.synchronize()
        build = dict(peak_gb=(torch.cuda.max_memory_allocated() - base) / 1e9,
                     shard_gb=_tensor_bytes(shard.parameters()) / 1e9,
                     largest_leaf_gb=_largest_leaf_bytes(cfg) / 1e9)
    m = _serve_models(shard)
    prompts = _serve_prompts(m["cfg"])[:SERVE_MESH_PROMPTS]
    torch.cuda.reset_peak_memory_stats()
    out = {}
    for kind in SERVE_MESH_KINDS:
        server = _serve_server(kind, m, mesh)
        if kind == "paged":
            server.warmup()
        # the paged server's requests queued together, as phase 38 sends
        # them; the other servers' staggered, two admitted whole
        out[kind] = _serve_lifecycle(kind, server, prompts,
                                     top2=mesh is None and kind != "spec",
                                     logits=kind == "paged",
                                     together=kind == "paged")
        if kind == "paged" and keep is not None:
            keep["server"] = server
        del server
        torch.cuda.empty_cache()
    if mesh is not None:
        sound = paged.col
        decode.col = paged.col = _NoWoReduce(sound)
        try:
            out["fault"] = _serve_lifecycle(
                "paged", _serve_server("paged", m, mesh),
                prompts[:SERVE_FAULT_PROMPTS], logits=True, together=True)
        finally:
            decode.col = paged.col = sound
    out["generate"] = _generate_legs(mesh)
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["build"] = build
    out["host"] = _host_mem_gb()
    if mesh is not None:
        dist.barrier()
        if rank == 0:
            out["smi_used_mb"] = subprocess.run(
                ["nvidia-smi", "--query-gpu=memory.used",
                 "--format=csv,noheader,nounits"], capture_output=True,
                text=True).stdout.strip()
        dist.barrier()
    return out


def _timed(fn, *a):
    t0 = time.perf_counter()
    out = fn(*a)
    gc.collect()
    torch.cuda.empty_cache()
    return out, time.perf_counter() - t0


def _mesh_serve_rank(rank, world, args):
    """Phases 36, 38 and 37 on one rank of one world: rank 0 runs the
    one-card references first (the others wait), then every rank its
    meshed legs: phase 36's servers, phase 38's replica over the paged
    one (``_mesh_replica_leg``), then phase 37's families
    (``_mesh_families_rank``)."""
    import torch.distributed as dist

    from kubetpu_torch.jobs.meshjob import make_mesh

    out, keep, keep_ref = {}, {}, {}
    if rank == 0:
        out["ref"], out["ref_wall_s"] = _timed(_mesh_serve_leg, rank, None,
                                               keep_ref)
    dist.barrier()
    serve, out["wall_s"] = _timed(_mesh_serve_leg, rank, make_mesh(
        SERVE_MESH_AXES, device="cuda"), keep)
    out.update(serve)
    # phase 38: the meshed paged server behind the wire, then gone
    out["replica"], out["replica_wall_s"] = _timed(
        _mesh_replica_leg, rank, keep.pop("server"), keep_ref.pop(
            "server", None), serve["paged"])
    del keep, keep_ref
    gc.collect()
    torch.cuda.empty_cache()
    if rank == 0:
        out["families_ref"], out["families_ref_wall_s"] = _timed(
            _mesh_families_rank, rank, 1, args)
    dist.barrier()
    out["families"], out["families_wall_s"] = _timed(
        _mesh_families_rank, rank, world, args)
    return out


def phase_mesh_serve(smi: str):
    """Phase 36: the servers over {dp 2, tp 4} (``dryrun_multichip``'s
    serving mesh at n = 8 for the flagship) in an 8-rank world sharing the
    card, against the one-card servers on the same weights, run first on
    the world's rank 0. Each of ``PagedDecodeServer``,
    ``DecodeServer`` (slots on dp), the paged speculative server (phase
    16's quarter draft, whole on every rank) and
    ``PagedMultiLoraDecodeServer`` (two rank-8 adapters) runs phase 6's
    settings and first ``SERVE_MESH_PROMPTS`` prompts, ``SERVE_MESH_NEW``
    new tokens a request (``_serve_lifecycle``): the paged server's (and
    the planted fault's) all enqueued before the first step, as phase 38
    sends them; the other three staggered, two submitted whole (a
    whole-prompt prefill, the first token read at once, on dp its owner's
    broadcast), one step, two more enqueued while those decode. The paged
    servers stay for phase 38.

    Gates: every rank emits the same tokens; each server's tokens equal
    the one-card server's under phase 16's near-tie rule (the first
    divergence of a request may fall only where the one-card run's top two
    logits lie within LOGIT_TOL; the speculative server's read the plain
    paged run's), and the paged server's first-token logits on every rank
    within LOGIT_TOL of the one card's; a paged server whose ``wo`` partial
    sums are not reduced over tp (``_NoWoReduce``, on its first
    ``SERVE_FAULT_PROMPTS`` prompts) must fail that gate; the paged
    servers launch the split and
    combine kernels on every decode step and the wgmma chunk on every
    prefill chunk, 12 a layer stack, and the SIMT kernel never;
    ``make_generate(mesh=)`` at phase 35's f32 width, plain and at window
    8, returns the one-card call's tokens exactly on every rank. Readings:
    decode tokens/s and step ms of the world and the one card, host syncs
    and collective calls a step, bytes a step by axis, paged launches a
    rank, peak memory a rank and the card's total. Each rank draws its
    shard of the flagship leaf by leaf (``train.init_shard``, seed 0 as
    the one card's whole model): its peak while building it (the
    ``mesh_serve_build`` line, beside the whole-model peak and the
    prediction) at most the shard plus one whole leaf. The reference
    process and the world then go on to phase 38's and 37's legs
    (``_mesh_replica_leg``, ``_mesh_families_rank``) -> (row, the
    results for ``phase_mesh_replica`` and for ``phase_mesh_families``)."""
    t0 = time.perf_counter()
    host_before = _host_mem_gb()
    line("mesh_serve_start", host=host_before)
    args = {"dir": LIFE_DIR}
    os.makedirs(LIFE_DIR, exist_ok=True)
    ranks = _run_world(_mesh_serve_rank, 8, args, "mesh_serve")
    ref, t_ref = ranks[0].pop("ref"), ranks[0]["ref_wall_s"]
    for name in FAM_TRAIN:
        os.remove(os.path.join(LIFE_DIR, f"fam_{name}.pt"))
    replica = {"ranks": [r.pop("replica") for r in ranks],
               "wall_s": ranks[0]["replica_wall_s"]}
    fam = {"ref": ranks[0].pop("families_ref"),
           "ranks": [r.pop("families") for r in ranks],
           "ref_wall_s": ranks[0]["families_ref_wall_s"],
           "wall_s": ranks[0]["families_wall_s"]}
    all_prompts = _serve_prompts(_serve_cfg())[:SERVE_MESH_PROMPTS]
    layers = _serve_cfg().n_layers
    bad, rows = [], {}
    r0 = ranks[0]
    for kind in SERVE_MESH_KINDS + ("fault",):
        prompts = (all_prompts[:SERVE_FAULT_PROMPTS] if kind == "fault"
                   else all_prompts)
        if any(r[kind]["tokens"] != r0[kind]["tokens"] for r in ranks):
            bad.append(f"{kind}: ranks emit different tokens")
        # the one-card run of the same server (the fault's: the sound
        # paged one), and the top-2 gaps of the one-card run whose sampler
        # saw the stream (the speculative server's: the plain paged one)
        want = ref["paged" if kind == "fault" else kind]["tokens"][
            :len(prompts)]
        gaps = ref["paged" if kind in ("spec", "fault") else kind]["gaps"]
        ties = _near_tie_check(r0[kind]["tokens"], want, gaps, prompts)
        emitted = [(a[len(p):], b[len(p):]) for p, a, b in zip(
            prompts, r0[kind]["tokens"], want)]
        rows[kind] = dict(
            tokens_equal=sum(a == b for a, b in emitted),
            mismatch_share=(sum(x != y for a, b in emitted
                                for x, y in zip(a, b))
                            / sum(len(a) for a, _ in emitted)),
            diverged=ties["diverged"], bad=len(ties["bad"]))
        if kind != "fault" and ties["bad"]:
            bad.append(f"{kind}: tokens diverge from the one-card server "
                       f"away from a near-tie: {ties['bad']}")
    # the first-token logits of every rank's paged run against the one
    # card's: bf16 noise (phase 6's LOGIT_TOL) for the sound server
    gaps = {k: max(float(np.abs(a - b).max()) for r in ranks
                   for a, b in zip(r[k]["first_logits"],
                                   ref["paged"]["first_logits"]))
            for k in ("paged", "fault")}
    if gaps["paged"] > LOGIT_TOL:
        bad.append(f"paged: first-token logits {gaps['paged']} from the one "
                   f"card's (bound {LOGIT_TOL})")
    if not rows["fault"]["bad"] and gaps["fault"] <= LOGIT_TOL:
        bad.append("the planted fault (wo not reduced over tp) passes the "
                   f"gate: logit gap {gaps['fault']}, near-tie rule held")
    for kind in ("paged", "spec", "lora"):
        for rank, r in enumerate(ranks):
            got = r[kind]
            n = got["launches"]
            # the speculative server's rounds are verify chunks: wgmma
            if n["simt_launches"] or not n["wgmma_launches"] or (
                    kind != "spec" and not n["split_launches"]):
                bad.append(f"{kind} rank {rank}: paged launches {n}")
            if kind != "spec" and (
                    n["split_launches"] != layers * got["decode_steps"]
                    or n["wgmma_launches"] != layers * got["chunks"]):
                bad.append(f"{kind} rank {rank}: {n} for "
                           f"{got['decode_steps']} decode steps and "
                           f"{got['chunks']} chunks")
    for rank, r in enumerate(ranks):
        if r["generate"] != ref["generate"]:
            bad.append(f"make_generate rank {rank}: tokens differ from the "
                       f"one card's")
        b = r["build"]
        limit = (1 + BUILD_PEAK_SLACK) * (b["shard_gb"] + b["largest_leaf_gb"])
        if not b["peak_gb"] <= limit:
            bad.append(f"rank {rank}: building its shard peaked at "
                       f"{b['peak_gb']} GB, over {limit}")
    build = dict(peak_gb_rank_max=max(r["build"]["peak_gb"] for r in ranks),
                 shard_gb=r0["build"]["shard_gb"],
                 largest_leaf_gb=r0["build"]["largest_leaf_gb"],
                 predicted_gb=MESH_BUILD_PREDICTED_GB,
                 whole_model_peak_gb_rank=WHOLE_MODEL_SERVE_PEAK_GB)
    line("mesh_serve_build", card=torch.cuda.get_device_name(0),
         nvidia_smi=smi, **build)
    total = {c: sum(r[k]["launches"][c] for r in ranks
                    for k in ("paged", "spec", "lora"))
             for c in _PAGED_COUNTERS}
    paged_r0 = r0["paged"]
    row = dict(
        card=torch.cuda.get_device_name(0), nvidia_smi=smi,
        setting="8 ranks time-sharing one card; gloo",
        axes=SERVE_MESH_AXES, kinds=list(SERVE_MESH_KINDS),
        near_tie=rows, logit_gap=gaps["paged"], fault_logit_gap=gaps["fault"],
        logit_tol=LOGIT_TOL, new_tokens=SERVE_MESH_NEW,
        decode_toks_s=paged_r0["decode_toks_s"],
        one_card_decode_toks_s=ref["paged"]["decode_toks_s"],
        step_ms=paged_r0["step_ms"],
        one_card_step_ms=ref["paged"]["step_ms"],
        per_kind={k: dict(decode_toks_s=r0[k]["decode_toks_s"],
                          one_card_decode_toks_s=ref[k]["decode_toks_s"],
                          step_ms=r0[k]["step_ms"],
                          one_card_step_ms=ref[k]["step_ms"],
                          wall_s=r0[k]["wall_s"],
                          one_card_wall_s=ref[k]["wall_s"],
                          steps=r0[k]["steps"],
                          bytes_per_step=r0[k]["bytes_per_step"],
                          collectives_per_step=r0[k][
                              "collectives_per_step"],
                          host_syncs=r0[k]["host_syncs"],
                          launches=r0[k]["launches"])
                  for k in SERVE_MESH_KINDS},
        paged_launches_per_decode_step={
            c: paged_r0["launches"][c] / max(paged_r0["decode_steps"], 1)
            for c in ("split_launches", "combine_launches")},
        paged_wgmma_per_chunk=(paged_r0["launches"]["wgmma_launches"]
                               / max(paged_r0["chunks"], 1)),
        launches_all_ranks=total,
        peak_mem_gb_per_rank=max(r["peak_mem_gb"] for r in ranks),
        build=build,
        one_card_peak_mem_gb=ref["peak_mem_gb"],
        smi_memory_used_mb=r0["smi_used_mb"],
        host_per_rank=[r["host"] for r in ranks], host_before=host_before,
        generate_equal=all(r["generate"] == ref["generate"] for r in ranks),
        ref_wall_s=t_ref, wall_s=time.perf_counter() - t0, ok=not bad)
    line("mesh_serve", **row)
    if bad:
        raise SystemExit("mesh_serve: " + "; ".join(bad))
    return row, replica, fam


# -- phase 38: a meshed server behind the replica wire ------------------------
# Phase 36's meshed paged server (world rank 0 serves, ranks 1-7 follow)
# and rank 0's one-card reference paged server as the drain's target B.

REPLICA_CANCEL_STEPS = 12     # the fifth stream's deadline, in decode steps
# the drain round's requests: the first and third of the four, whose
# prefill chunks fall as in the first round ([0, 128) at once, then the
# rest), so that what A decodes before the handoff is the direct run's
REPLICA_DRAINED = (0, 2)


def _send_in_order(rep, prompts, tag, pool, **extra) -> list:
    """POST each prompt once the one before it is queued (a ``_Hold``
    holds the loop): futures of (code, body), queued in prompt order."""
    futs = []
    for i, p in enumerate(prompts):
        n = len(rep.server.unfinished_rids())
        futs.append(pool.submit(_generate, rep.address, p, f"{tag}-{i}",
                                **extra))
        with rep._cv:
            if not rep._cv.wait_for(
                    lambda: len(rep.server.unfinished_rids()) > n, 120):
                raise SystemExit(f"mesh_replica {tag}: request {i} never "
                                 f"queued")
    return futs


def _mesh_replica_leg(rank, server, ref, direct):
    """Phase 38 on one rank: rank 0 serves the meshed paged *server*
    (``ReplicaServer``) and its one-card reference *ref* as B, the other
    ranks follow (``follow_replica``); then ``check_lockstep`` on every
    rank. Rank 0's rounds: phase 36's four prompts as concurrent
    generates (queued in order, as phase 36 enqueued them; *direct* is
    phase 36's run), the fifth prompt canceled mid-decode by its
    deadline, then ``REPLICA_DRAINED`` of the four again, drained to B
    once one stream is mid-decode -> each rank's launches of its meshed
    server (counters set to 0 just before; on rank 0, which also runs B,
    the sum of each meshed step's own, B's steps serialised with them on
    one lock), ticks and answers."""
    import threading
    from concurrent.futures import ThreadPoolExecutor

    from kubetpu_torch.ops import paged_attention as pa
    from kubetpu_torch.router.replica import ReplicaServer, follow_replica

    for c in _PAGED_COUNTERS:
        setattr(pa.paged_attention, c, 0)
    out = {}
    if rank != 0:
        out["lockstep"] = follow_replica(server)
        mesh_launches = {c: getattr(pa.paged_attention, c)
                         for c in _PAGED_COUNTERS}
    else:
        prompts = _serve_prompts(server.cfg)[:SERVE_MESH_PROMPTS + 1]
        st = _instrument(server)
        ttft = _ttft_tap(server)
        steps, step_leg, b_step = [], server.step, ref.step
        mesh_launches = dict.fromkeys(_PAGED_COUNTERS, 0)
        serial = threading.Lock()

        def timed_step():
            chunks = st["chunks"]
            with serial:
                n0 = {c: getattr(pa.paged_attention, c)
                      for c in _PAGED_COUNTERS}
                t0 = time.perf_counter()
                got = step_leg()
                ms = (time.perf_counter() - t0) * 1e3
                for c in _PAGED_COUNTERS:
                    mesh_launches[c] += getattr(pa.paged_attention, c) - n0[c]
            steps.append((ms, sum(len(v) for v in got.values()),
                          st["chunks"] > chunks))
            return got

        def serial_b_step():
            with serial:
                return b_step()

        server.step = timed_step
        ref.step = serial_b_step
        b_top2 = _record_top2(ref)
        rep = ReplicaServer(server, "mesh", idle_wait=0.002)
        rep_b = ReplicaServer(ref, "one-card", idle_wait=0.002)
        rep.start()
        rep_b.start()
        n4 = SERVE_MESH_PROMPTS
        with ThreadPoolExecutor(n4) as pool:
            # round 1: the four prompts, as phase 36 enqueued them
            gate = _Hold(rep, n4, park=0)
            lock0 = rep.lockstep_stats()
            answers = [f.result() for f in _send_in_order(
                rep, prompts[:n4], "wire", pool)]
            gate.release()
            lock1 = rep.lockstep_stats()
            decode = [(ms, n) for ms, n, chunk in steps if not chunk and n]
            out["wire"] = dict(
                codes=[c for c, _ in answers],
                tokens=[b.get("tokens") for _, b in answers],
                ttft_ms_p50=float(np.median(ttft)) * 1e3,
                decode_toks_s=(sum(n for _, n in decode)
                               / (sum(ms for ms, _ in decode) / 1e3)),
                step_ms=float(np.median([ms for ms, _ in decode])),
                steps=len(steps), decode_steps=len(decode),
                ticks={k: lock1["ticks"][k] - lock0["ticks"][k]
                       for k in lock1["ticks"]},
                calls=lock1["calls"] - lock0["calls"],
                bytes=lock1["bytes"] - lock0["bytes"])
            # round 2: the fifth stream, canceled by its deadline while
            # the loop holds it mid-decode
            gate = _Hold(rep, 1)
            t_cancel = REPLICA_CANCEL_STEPS * out["wire"]["step_ms"] / 1e3
            code, body = _generate(rep.address, prompts[n4], "cancel",
                                   timeout=t_cancel)
            out["cancel"] = dict(code=code, error=body.get("error"),
                                 mid_decode=gate.held.is_set(),
                                 deadline_s=t_cancel)
            gate.release()
            # round 3: two of the four again, drained to B mid-decode
            shipped0 = _counter(server,
                                "kubetpu_migration_bytes_shipped_total")
            drained = [prompts[i] for i in REPLICA_DRAINED]
            gate = _Hold(rep, len(drained), park=1)
            futs = _send_in_order(rep, drained, "drain", pool)
            gate.wait("mesh_replica drain")
            t0 = time.perf_counter()
            drain_answer = request_drain(rep.address, rep_b.address)
            gate.release()
            with rep._cv:
                if not rep._cv.wait_for(rep.server._idle, timeout=600):
                    raise SystemExit("mesh_replica drain: never idle")
            drain_s = time.perf_counter() - t0
            answers = [f.result() for f in futs]
        finals, hops = [], []
        for i, (p, (code, body)) in enumerate(zip(drained, answers)):
            hop = "mesh"
            if code == 409 and body["migrated"]["replica"] == "one-card":
                code, body = _generate(rep_b.address, p, f"drain-{i}")
                hop = "one-card"
            finals.append(body.get("tokens") if code == 200 else None)
            hops.append(hop)
        shipped = (_counter(server, "kubetpu_migration_bytes_shipped_total")
                   - shipped0)
        out["drain"] = dict(
            answer=drain_answer, tokens=finals, hops=hops,
            migrated=int(_counter(server, "kubetpu_migrations_total",
                                  reason="drain", result="committed")),
            drain_ms=drain_s * 1e3, mb_shipped=shipped / 1e6,
            mb_s=shipped / 1e6 / drain_s,
            b_gaps=_top2_gaps(b_top2))
        rep.shutdown()
        rep_b.shutdown()
        out["lockstep"] = rep.lockstep_stats()
        out["prompts"] = prompts
        out["direct"] = {k: direct[k] for k in (
            "tokens", "ttft_ms_p50", "decode_toks_s", "step_ms")}
        ref.step = b_step
    server.check_lockstep()
    out["lockstep_ok"] = True
    out["launches"] = mesh_launches
    return out


def request_drain(addr, target) -> dict:
    """POST /drain {"migrate_to": target} -> its answer."""
    from kubetpu_torch.wire.httpcommon import request_json

    return request_json(addr + "/drain", {"migrate_to": target,
                                          "reason": "drain"}, timeout=60)


def phase_mesh_replica(smi: str, replica: dict) -> dict:
    """Phase 38: phase 36's meshed paged server on {dp 2, tp 4} behind the
    port's ``ReplicaServer`` on world rank 0 (ranks 1-7 follow), on
    ``127.0.0.1:0``, in phase 36's world after its servers
    (``_mesh_replica_leg``). Gates: the four concurrent generates answer
    phase 36's direct meshed tokens exactly (queued in one order, every
    prompt's prefill chunks fall as in the direct run); the fifth stream
    answers 503, canceled by its deadline while mid-decode; after
    ``POST /drain {"migrate_to": B}`` (B: the one-card reference paged
    server on rank 0; ``REPLICA_DRAINED`` of the four requests sent
    again) every stream ends with the undrained tokens, where
    B decoded a stream's tail the first divergence only at a near-tie of
    B's own top-2 logits (``LOGIT_TOL``: one card against tp 4 sums in
    another order); ``check_lockstep`` holds on all 8 ranks. Readings:
    TTFT p50 and decode tokens/s through the wire against phase 36's
    direct run, ticks and broadcast bytes a decode step, the drain's ms,
    MB shipped and MB/s, the split and chunk launches a rank. 8 ranks
    share one card over gloo: what a step does, not NVLink's speed."""
    ranks = replica["ranks"]
    r0 = ranks[0]
    wire, cancel, drain = r0["wire"], r0["cancel"], r0["drain"]
    prompts, direct = r0["prompts"], r0["direct"]
    want = direct["tokens"]
    bad = []
    if wire["codes"] != [200] * len(want) or wire["tokens"] != want:
        bad.append(f"wire tokens differ from phase 36's direct run: codes "
                   f"{wire['codes']}, equal "
                   f"{[a == b for a, b in zip(wire['tokens'], want)]}")
    if cancel["code"] != 503 or not cancel["mid_decode"]:
        bad.append(f"cancel: {cancel}")
    gaps = drain["b_gaps"]
    tie = []
    drained = [(prompts[i], want[i]) for i in REPLICA_DRAINED]
    for (p, w), got, hop in zip(drained, drain["tokens"], drain["hops"]):
        if got is None:
            bad.append(f"drain: a request of {len(p)} tokens failed")
            continue
        if got == w:
            continue
        n = len(p)
        j = next((i for i, (x, y) in enumerate(zip(got[n:], w[n:]))
                  if x != y), min(len(got), len(w)) - n)
        gap = gaps.get((tuple(p), j))
        tie.append({"prompt_len": n, "index": j, "gap": gap, "hop": hop})
        if hop != "one-card" or gap is None or gap > LOGIT_TOL:
            bad.append(f"drain: tokens diverge away from a near-tie of B's "
                       f"logits: {tie[-1]}")
    if not drain["migrated"]:
        bad.append("drain: no stream migrated")
    launches = [r["launches"] for r in ranks]
    for rank, n in enumerate(launches):
        if not n["split_launches"] or not n["wgmma_launches"] \
                or n["simt_launches"]:
            bad.append(f"rank {rank}: paged launches {n}")
    for rank, r in enumerate(ranks[1:], 1):
        if r["lockstep"] != r0["lockstep"]:
            bad.append(f"rank {rank}: lockstep {r['lockstep']} vs rank 0's "
                       f"{r0['lockstep']}")
    decode_steps = max(wire["decode_steps"], 1)
    row = dict(
        card=torch.cuda.get_device_name(0), nvidia_smi=smi,
        setting="8 ranks time-sharing one card; gloo (what a step does, "
                "not NVLink's speed)",
        axes=SERVE_MESH_AXES, requests=len(want),
        tokens_equal=sum(a == b for a, b in zip(wire["tokens"], want)),
        ttft_ms_p50=wire["ttft_ms_p50"],
        direct_ttft_ms_p50=direct["ttft_ms_p50"],
        decode_toks_s=wire["decode_toks_s"],
        direct_decode_toks_s=direct["decode_toks_s"],
        step_ms=wire["step_ms"], direct_step_ms=direct["step_ms"],
        ticks_per_step=sum(wire["ticks"].values()) / wire["steps"],
        ticks=wire["ticks"], calls=wire["calls"], steps=wire["steps"],
        decode_steps=decode_steps,
        broadcast_bytes_per_step=wire["bytes"] / wire["steps"],
        cancel=cancel,
        drain_ms=drain["drain_ms"], drain_mb_shipped=drain["mb_shipped"],
        drain_mb_s=drain["mb_s"], drain_migrated=drain["migrated"],
        drain_hops=drain["hops"],
        drain_tokens_equal=sum(a == w for a, (_, w) in zip(drain["tokens"],
                                                           drained)),
        drain_near_ties=tie,
        # each rank's meshed server's own (rank 0's without B's)
        launches_per_rank={c: [n[c] for n in launches] for c in (
            "split_launches", "combine_launches", "wgmma_launches")},
        launches_ranks_equal=all(n == launches[0] for n in launches),
        launches_all_ranks={c: sum(n[c] for n in launches)
                            for c in _PAGED_COUNTERS},
        lockstep=r0["lockstep"],
        lockstep_ok=all(r["lockstep_ok"] for r in ranks),
        wall_s=replica["wall_s"], ok=not bad)
    line("mesh_replica", **row)
    if bad:
        raise SystemExit("mesh_replica: " + "; ".join(bad))
    return row


# -- phase 37: the other families over a mesh ---------------------------------
# One 8-rank world on the card, each family at its full widths with its
# depth cut to FAM_LAYERS layers, against its one-card step (a process of
# its own, first) on the same weights: every rank draws its shard from the
# seed the one card draws the whole model from.

FAM_LAYERS = 2
FAM_SEED = 37
FAM_AXES = {"encoder": {"dp": 2, "sp": 2, "tp": 2},
            "vit": {"dp": 4, "tp": 2},
            "seq2seq": {"dp": 2, "sp": 2, "tp": 2},
            "beam": {"dp": 2, "tp": 4},
            "distill": {"dp": 4, "tp": 2}}
FAM_TRAIN = ("encoder", "vit", "seq2seq", "distill")
FAM_ENC_BATCH, FAM_ENC_SEQ = 4, 2048       # phase 29's
FAM_VIT_BATCH = 128                        # phase 30's
FAM_S2S_BATCH, FAM_S2S_LEN = 4, 512        # phase 31's 1024 cut to 512
FAM_BEAM_K, FAM_BEAM_BATCH, FAM_BEAM_PROMPT, FAM_BEAM_STEPS = 4, 4, 128, 8
FAM_DISTILL_BATCH, FAM_DISTILL_SEQ = 4, 2048
# |a family's loss - the one card's|, nats, bf16: the masked LM's mean runs
# over its ~15% masked positions only (1.2k a batch), a noisier mean than
# phase 34's 16k positions
FAM_LOSS_TOL = 5e-3
# |the global gradient norm (GradSync.sq_norm) - the one-card gradient's| /
# the one card's, bf16: the gradients' partial sums round in other places
FAM_NORM_TOL = 0.02
# |beam score - the one card's|, nats over FAM_BEAM_STEPS tokens, f32
FAM_BEAM_TOL = 1e-2


def _fam_cfgs() -> dict:
    """The families' configs: the flagship (phase 11's, ``_flagship_train
    _cfg``) for the encoder, seq2seq and the distillation target,
    ViT-B/16 (``_vit_cfg``), the flagship in f32 for beam search (the
    dense decode path, no kernel: f32 keeps its gate tight), phase 16's
    quarter draft; every depth cut to FAM_LAYERS."""
    from kubetpu_torch.jobs.model import ModelConfig

    flag = dataclasses.replace(_flagship_train_cfg(), n_layers=FAM_LAYERS)
    vit = _vit_cfg()
    return dict(
        flag=flag,
        vit=dataclasses.replace(vit, model=dataclasses.replace(
            vit.model, n_layers=FAM_LAYERS)),
        beam=dataclasses.replace(flag, dtype=torch.float32, remat=False),
        draft=ModelConfig(vocab=flag.vocab, d_model=512, n_layers=FAM_LAYERS,
                          n_heads=4, d_ff=1408, max_seq=2048,
                          dtype=torch.bfloat16))


def _fam_batch(c, name):
    """Family *name*'s batch, the same in every process (seeded)."""
    from kubetpu_torch.jobs.data import SyntheticCorpus, mlm_batches

    vocab = c["flag"].vocab
    if name == "encoder":
        return next(mlm_batches(SyntheticCorpus(vocab, seed=FAM_SEED),
                                FAM_ENC_BATCH, FAM_ENC_SEQ, seed=FAM_SEED))
    if name == "vit":
        vit = c["vit"]
        gen = torch.Generator().manual_seed(FAM_SEED)
        return (torch.randn((FAM_VIT_BATCH, vit.image_size, vit.image_size,
                             vit.channels), generator=gen).numpy(),
                torch.randint(0, vit.n_classes, (FAM_VIT_BATCH,),
                              generator=gen).numpy())
    if name == "seq2seq":
        src = next(SyntheticCorpus(vocab, seed=FAM_SEED).batches(
            FAM_S2S_BATCH, FAM_S2S_LEN, seed=FAM_SEED))[0]
        tgt_in = np.concatenate([np.ones_like(src[:, :1]), src[:, :-1]], 1)
        return src, tgt_in, src
    if name == "beam":
        return next(SyntheticCorpus(vocab, seed=FAM_SEED + 1).batches(
            FAM_BEAM_BATCH, FAM_BEAM_PROMPT, seed=FAM_SEED + 1))[0]
    return next(SyntheticCorpus(vocab, seed=FAM_SEED + 2).batches(
        FAM_DISTILL_BATCH, FAM_DISTILL_SEQ, seed=FAM_SEED + 2))


def _fam_gen(offset=0):
    return torch.Generator(device="cuda").manual_seed(FAM_SEED + offset)


def _fam_norm(loss_fn, sync, params, batch) -> float:
    """The gradient's global norm at *params* on *batch*: summed by the
    step's ``GradSync`` on a mesh, the plain sum of squares on one
    card."""
    leaves = list(params.parameters())
    grads = list(torch.autograd.grad(loss_fn(params, *batch), leaves))
    if sync is None:
        return float(torch.sqrt(sum((g.float() ** 2).sum() for g in grads)))
    return float(torch.sqrt(sync.sq_norm(sync.reduce(grads))))


def _fam_update_gap(params, init, after1, ref_sd, specs, mesh) -> float:
    """Over this rank's leaves, the largest relative L2 gap of their change
    over step 1 to the one card's change (its slice of it)."""
    from kubetpu_torch.jobs import train as train_lib

    upd = 0.0
    for (name, _p), a, p0 in zip(params.named_parameters(), after1, init):
        ref = train_lib._take(ref_sd[name], train_lib.local_spec(
            specs, name), mesh).to("cuda").float()
        d_ref = ref - p0.float()
        upd = max(upd, float((a.float() - p0.float() - d_ref).norm()
                             / d_ref.norm().clamp(min=1e-30)))
    return upd


def _fam_parts(name, c, mesh, target=None):
    """(init state, step, loss_fn, sync, specs, batch on the card, fault)
    of a training family on *mesh* (None: one card); *fault* reads the
    family's planted fault at the initial weights (meshed only)."""
    from functools import partial

    from kubetpu_torch.jobs import collectives as col
    from kubetpu_torch.jobs import distill, encoder, seq2seq, vision
    from kubetpu_torch.jobs import model as model_lib
    from kubetpu_torch.jobs import train as train_lib
    from kubetpu_torch.ops.flash_attention import flash_attention

    b = _fam_batch(c, name)
    flag, opt = c["flag"], train_lib.make_optimizer()
    bidir = partial(flash_attention, causal=False)
    if name == "encoder":
        mask_id = flag.vocab - 1
        state, _ = train_lib.init_state(_fam_gen(), flag, opt, "cuda",
                                        mesh=mesh)
        step = encoder.make_mlm_train_step(flag, mask_id, opt, "flash",
                                           mesh=mesh, device="cuda")
        batch = (torch.from_numpy(b[0]).long().cuda(),
                 torch.from_numpy(b[1]).cuda())
        specs = train_lib.param_specs(flag)
        if mesh is None:
            return state, step, (lambda p, t, m: encoder.masked_lm_loss(
                p, t, m, mask_id, flag, attn_fn=bidir)), None, specs, \
                batch, None
        loss_fn, sync = encoder.mlm_mesh_parts(flag, mask_id, bidir, mesh)

        def fault(params):       # the gradient summed over sp as well
            return _fam_norm(loss_fn, train_lib.grad_sync(
                flag, col.groups_of(mesh)), params, batch)
    elif name == "vit":
        cfg = c["vit"]
        state, _ = vision.init_vit_state(_fam_gen(1), cfg, opt, mesh=mesh,
                                         device="cuda")
        step = vision.make_vit_train_step(cfg, opt, "flash", mesh=mesh,
                                          device="cuda")
        batch = (torch.from_numpy(b[0]).cuda(),
                 torch.from_numpy(b[1]).long().cuda())
        specs = vision.vit_param_specs(cfg)
        if mesh is None:
            return state, step, (lambda p, x, y: vision.vit_loss(
                p, x, y, cfg, attn_fn=bidir)), None, specs, batch, None
        loss_fn, sync = vision.vit_mesh_parts(cfg, bidir, mesh)

        @torch.no_grad()
        def fault(params):       # wo's and the MLP's partial sums unreduced
            sound = model_lib.col
            model_lib.col = _NoWoReduce(sound)
            try:
                return float(loss_fn(params, *batch))
            finally:
                model_lib.col = sound
    elif name == "seq2seq":
        state, _ = seq2seq.init_seq2seq_state(_fam_gen(2), flag, opt,
                                              mesh=mesh, device="cuda")
        step = seq2seq.make_seq2seq_train_step(flag, opt, mesh=mesh,
                                               device="cuda")
        batch = tuple(torch.from_numpy(x).long().cuda() for x in b)
        specs = seq2seq.seq2seq_param_specs(flag)
        if mesh is None:
            return state, step, (lambda p, s, ti, to: seq2seq.seq2seq_loss(
                p, s, ti, to, flag)), None, specs, batch, None
        loss_fn, sync = seq2seq.seq2seq_mesh_parts(flag, mesh)

        def fault(_params):      # the source's other sp blocks never seen
            sound = seq2seq.make_ring_attention   # by the encoder and the
            seq2seq.make_ring_attention = (       # cross branch: one step
                lambda m, impl="dense", causal=True, window=0: sound(
                    m if causal else None, impl=impl, causal=causal,
                    window=window))
            try:
                fstep = seq2seq.make_seq2seq_train_step(flag, opt, mesh=mesh,
                                                        device="cuda")
            finally:
                seq2seq.make_ring_attention = sound
            fstate, _ = seq2seq.init_seq2seq_state(_fam_gen(2), flag, opt,
                                                   mesh=mesh, device="cuda")
            init = [p.detach().clone() for p in fstate.params.parameters()]
            fstep(fstate, *batch)
            return init, [p.detach().clone()
                          for p in fstate.params.parameters()]
    else:
        dcfg = c["draft"]
        state, _ = train_lib.init_state(_fam_gen(4), dcfg, opt, "cuda",
                                        mesh=mesh)
        step, _ = distill.make_distill_step(flag, dcfg, opt, device="cuda",
                                            mesh=mesh)
        tokens, targets = (torch.from_numpy(x).long().cuda() for x in b)
        specs = train_lib.param_specs(dcfg)
        if mesh is None:
            causal = partial(flash_attention, causal=True)
            t_logits = model_lib.forward(target, tokens, flag, causal)
            return state, (lambda st, *xs: step(st, target, *xs)), (
                lambda p, tk, tg: distill.distill_loss(
                    dcfg, p, t_logits, tk, tg, attn_fn=causal)), None, \
                specs, (tokens, targets), None
        teacher, t_loss, sync = distill.distill_mesh_parts(
            flag, dcfg, 1.0, 0.5, mesh, "flash")
        t_logits = teacher(target, tokens)

        def loss_fn(p, tk, tg):
            return t_loss(p, tk, tg, t_logits)

        def fault(_params):      # the vocab gradient sliced at tp rank 0's
            sound = distill.gather_vocab   # columns on every rank: one step
            fstate, _ = train_lib.init_state(_fam_gen(4), dcfg, opt, "cuda",
                                             mesh=mesh)
            init = [p.detach().clone() for p in fstate.params.parameters()]
            distill.gather_vocab = lambda x, g, _i: sound(x, g, 0)
            try:
                step(fstate, target, tokens, targets)
            finally:
                distill.gather_vocab = sound
            return init, [p.detach().clone()
                          for p in fstate.params.parameters()]
        return state, (lambda st, *xs: step(st, target, *xs)), loss_fn, \
            sync, specs, (tokens, targets), fault
    return state, step, loss_fn, sync, specs, batch, fault


def _fam_train_leg(name, c, mesh, ref_path):
    """One training family: the gradient norm and the planted fault at the
    initial weights, then two steps (flash counts zeroed just before, read
    just after), their losses and ms; the one card saves its weights
    after step 1 to *ref_path*, a mesh rank reads its slices back for the
    update gap."""
    import torch.distributed as dist

    from kubetpu_torch.jobs import train as train_lib
    from kubetpu_torch.jobs.model import init_params

    target = None
    if name == "distill":
        target = (init_params(_fam_gen(3), c["flag"], "cuda") if mesh is None
                  else train_lib.init_shard(_fam_gen(3), c["flag"], mesh,
                                            "cuda"))
    state, step, loss_fn, sync, specs, batch, fault = _fam_parts(
        name, c, mesh, target)
    out = {"norm": _fam_norm(loss_fn, sync, state.params, batch)}
    fault_out = fault(state.params) if fault is not None else None
    init = [p.detach().clone() for p in state.params.parameters()]
    torch.cuda.synchronize()
    if mesh is not None:
        dist.barrier()
    _zero_flash_counts()                              # zero just before
    losses, ms = [], []
    for i in range(2):
        t0 = time.perf_counter()
        state, loss = step(state, *batch)
        losses.append(float(loss))
        ms.append((time.perf_counter() - t0) * 1e3)
        if i == 0:
            after1 = [p.detach().clone() for p in state.params.parameters()]
    counts = _flash_counts()                          # read just after
    out["launches"], out["wgmma"] = list(counts[:3]), list(counts[3:])
    out.update(losses=losses, step_ms=ms)
    if mesh is None:
        torch.save({n: p.detach().cpu() for n, p in zip(
            (n for n, _ in state.params.named_parameters()), after1)},
            ref_path)
        return out
    ref_sd = torch.load(ref_path, mmap=True)
    out["update_gap"] = _fam_update_gap(state.params, init, after1, ref_sd,
                                        specs, mesh)
    if name in ("seq2seq", "distill"):
        finit, fafter = fault_out
        out["fault"] = _fam_update_gap(state.params, finit, fafter, ref_sd,
                                       specs, mesh)
    else:
        out["fault"] = fault_out
    return out


def _fam_beam_leg(c, mesh) -> dict:
    """Beam search on the f32 flagship: the meshed search from the rank's
    shard (and, meshed, with unreordered caches: the planted fault)."""
    from kubetpu_torch.jobs import beam
    from kubetpu_torch.jobs import train as train_lib
    from kubetpu_torch.jobs.model import init_params

    cfg = c["beam"]
    model = (init_params(_fam_gen(5), cfg, "cuda") if mesh is None else
             train_lib.init_shard(_fam_gen(5), cfg, mesh, "cuda"))
    prompt = torch.from_numpy(_fam_batch(c, "beam")).long().cuda()
    search = beam.make_beam_search(cfg, FAM_BEAM_K, mesh=mesh, device="cuda")
    t0 = time.perf_counter()
    seqs, scores = search(model, prompt, FAM_BEAM_STEPS)
    out = {"seqs": seqs.cpu().tolist(), "scores": scores.cpu().tolist(),
           "wall_s": time.perf_counter() - t0}
    if mesh is not None:
        real_one = beam._forward_one
        beam._forward_one = _unreordered(real_one, {})
        try:
            out["fault_scores"] = search(model, prompt,
                                         FAM_BEAM_STEPS)[1].cpu().tolist()
        finally:
            beam._forward_one = real_one
    return out


def _mesh_families_rank(rank, world, args):
    """Phase 37 on one rank (*world* 1: the one-card references)."""
    from kubetpu_torch.jobs.meshjob import make_mesh

    c = _fam_cfgs()
    out = {}
    for name in FAM_TRAIN + ("beam",):
        mesh = (make_mesh(FAM_AXES[name], device="cuda") if world > 1
                else None)
        torch.cuda.reset_peak_memory_stats()
        if name == "beam":
            out[name] = _fam_beam_leg(c, mesh)
        else:
            out[name] = _fam_train_leg(
                name, c, mesh, os.path.join(args["dir"], f"fam_{name}.pt"))
        out[name]["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        gc.collect()
        torch.cuda.empty_cache()
    return out


def _fam_expected_launches(name, c) -> list:
    """(forward, dQ, dK/dV) flash launches a rank a step: a layer's
    forward twice under remat (its recompute), once more per layer for
    the distillation target's no-grad forward; none for seq2seq (dense
    rings) and beam."""
    if name == "seq2seq":
        return [0, 0, 0]
    cfg = c["vit"].model if name == "vit" else (
        c["draft"] if name == "distill" else c["flag"])
    fwd = cfg.n_layers * (2 if cfg.remat else 1)
    if name == "distill":
        fwd += c["flag"].n_layers
    return [fwd, cfg.n_layers, cfg.n_layers]


def phase_mesh_families(smi: str, fam: dict) -> dict:
    """Phase 37: the masked-LM encoder ({dp 2, sp 2, tp 2}, flash at the
    rank's heads over the whole sequence), ViT-B/16 ({dp 4, tp 2}),
    seq2seq ({dp 2, sp 2, tp 2}, dense rings), beam 4 ({dp 2, tp 4}, f32)
    and distillation of phase 16's quarter draft ({dp 4, tp 2}) in one
    8-rank world sharing the card, each at its full widths with
    FAM_LAYERS layers, against the one-card runs on the same weights (on
    the world's rank 0, first). Gates, per training family: steps 1 and
    2's losses within FAM_LOSS_TOL of the one card's, the change over
    step 1 within MESH_UPDATE_GAP_TOL, the gradient's global norm within
    FAM_NORM_TOL; every rank the same losses; each rank's flash launches a
    step as the family's layers say, all on the wgmma instances. Each
    planted fault beyond its gate: the encoder's gradient summed over sp
    too (norm), ViT's blocks without their tp reductions (loss), seq2seq's
    cross branch and encoder without the non-causal ring (update gap of
    one step: on random weights its loss moved only 0.0076), the
    distillation's vocab gradient sliced at tp rank 0's columns on every
    rank (update gap). Beam: every rank's scores within FAM_BEAM_TOL of
    the one card's, the search with unreordered caches beyond it. The legs
    run in phase 36's world, after its servers (``phase_mesh_serve``'s
    *fam*)."""
    ref, ranks = fam["ref"], fam["ranks"]
    c = _fam_cfgs()
    r0, bad, rows = ranks[0], [], {}
    for name in FAM_TRAIN:
        got, want = r0[name], ref[name]
        if any(r[name]["losses"] != got["losses"] for r in ranks):
            bad.append(f"{name}: ranks disagree on the loss")
        gaps = [abs(a - b) for a, b in zip(got["losses"], want["losses"])]
        norm_gap = max(abs(r[name]["norm"] - want["norm"]) / want["norm"]
                       for r in ranks)
        update_gap = max(r[name]["update_gap"] for r in ranks)
        if name == "encoder":
            fault = ("norm_gap", min(abs(r[name]["fault"] - want["norm"])
                                     / want["norm"] for r in ranks),
                     FAM_NORM_TOL)
        elif name in ("seq2seq", "distill"):
            fault = ("update_gap", max(r[name]["fault"] for r in ranks),
                     MESH_UPDATE_GAP_TOL)
        else:
            fault = ("loss_gap", abs(got["fault"] - want["losses"][0]),
                     FAM_LOSS_TOL)
        for what, val, tol in (("step-1 loss gap", gaps[0], FAM_LOSS_TOL),
                               ("step-2 loss gap", gaps[1], FAM_LOSS_TOL),
                               ("update gap", update_gap,
                                MESH_UPDATE_GAP_TOL),
                               ("gradient norm gap", norm_gap,
                                FAM_NORM_TOL)):
            if not val <= tol:
                bad.append(f"{name}: {what} {val} > {tol}")
        if not fault[1] > fault[2]:
            bad.append(f"{name}: the planted fault's {fault[0]} {fault[1]} "
                       f"within {fault[2]}")
        expected = [2 * n for n in _fam_expected_launches(name, c)]
        for rank, r in enumerate(ranks):
            if r[name]["launches"] != expected or (
                    r[name]["wgmma"] != expected):
                bad.append(f"{name} rank {rank}: flash launches "
                           f"{r[name]['launches']} (wgmma "
                           f"{r[name]['wgmma']}) != {expected} (2 steps)")
        rows[name] = dict(
            axes=FAM_AXES[name], losses=got["losses"],
            one_card_losses=want["losses"], loss_gaps=gaps,
            update_gap=update_gap, norm=got["norm"],
            one_card_norm=want["norm"], norm_gap=norm_gap,
            fault=dict(zip(("reads", "value", "tol"), fault)),
            launches_rank0=got["launches"], expected_launches=expected,
            launches_all_ranks=[sum(r[name]["launches"][i] for r in ranks)
                                for i in range(3)],
            step_ms=got["step_ms"], one_card_step_ms=want["step_ms"],
            peak_mem_gb_rank_max=max(r[name]["peak_mem_gb"] for r in ranks),
            one_card_peak_mem_gb=want["peak_mem_gb"])
    want = np.array(ref["beam"]["scores"])
    beam_gap = max(float(np.abs(np.array(r["beam"]["scores"]) - want).max())
                   for r in ranks)
    beam_fault = min(float(np.abs(np.array(r["beam"]["fault_scores"])
                                  - want).max()) for r in ranks)
    if not beam_gap <= FAM_BEAM_TOL:
        bad.append(f"beam: scores {beam_gap} from the one card's")
    if not beam_fault > FAM_BEAM_TOL:
        bad.append(f"beam: unreordered caches read {beam_fault}, within "
                   f"{FAM_BEAM_TOL}")
    if any(r["beam"]["seqs"] != r0["beam"]["seqs"] for r in ranks):
        bad.append("beam: ranks return different sequences")
    rows["beam"] = dict(
        axes=FAM_AXES["beam"], k=FAM_BEAM_K, steps=FAM_BEAM_STEPS,
        score_gap=beam_gap, tol=FAM_BEAM_TOL, fault_score_gap=beam_fault,
        seqs_equal_one_card=r0["beam"]["seqs"] == ref["beam"]["seqs"],
        wall_s=r0["beam"]["wall_s"], one_card_wall_s=ref["beam"]["wall_s"],
        peak_mem_gb_rank_max=max(r["beam"]["peak_mem_gb"] for r in ranks))
    row = dict(card=torch.cuda.get_device_name(0), nvidia_smi=smi,
               setting="8 ranks time-sharing one card; gloo",
               reduced=(f"depth: every family cut to {FAM_LAYERS} layers; "
                        f"seq2seq's source and target to {FAM_S2S_LEN} "
                        "tokens (phase 31: 1024)"),
               families=rows, ref_wall_s=fam["ref_wall_s"],
               wall_s=fam["wall_s"], ok=not bad)
    line("mesh_families", **row)
    if bad:
        raise SystemExit("mesh_families: " + "; ".join(bad))
    return row


def _family_kernel_rows(flash, fam) -> list:
    """The three flash kernels at a meshed rank's shapes in phase 37: the
    encoder's (RING_FLASH_SHAPE non-causal, phase 4's ring_step case),
    ViT's (VIT_MESH_FLASH_SHAPE) and the distillation target's
    (DISTILL_MESH_FLASH_SHAPE, causal; its draft's calls at 2 heads
    counted beside them), launches summed over the 8 ranks' two steps."""
    rows = []
    for family, case in (("encoder", "ring_step"),
                         ("vit", "vit_mesh_noncausal"),
                         ("distill", "mesh_distill_causal")):
        launches = fam["families"][family]["launches_all_ranks"]
        for i, (kind, name, replaces) in enumerate((
                ("forward", "flash_forward",
                 "kubetpu/ops/flash_attention.py:41"),
                ("dq", "flash_backward_dq",
                 "kubetpu/ops/flash_attention.py:141"),
                ("dkv", "flash_backward_dkv",
                 "kubetpu/ops/flash_attention.py:195"))):
            r = next(r for r in flash if r["kernel"] == kind
                     and r["case"] == case)
            rows.append({
                "name": f"{name}_mesh_{family}", "route": "cuda",
                "instances": r["route"],
                "source": "kubetpu_torch/ops/csrc/flash_attention.cu",
                "replaces": replaces, "launches": launches[i],
                "launches_from": f"phase 37 {family}, 8 ranks x 2 steps",
                "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                "ok": r["ok"], "shape": r["shape"]})
    return rows


def _tp4_kernel_rows(kern, mesh_serve, mesh_replica) -> list:
    """The split and the wgmma chunk kernels at a tp-4 rank's heads (phase
    3's tp4 cases), launches summed over the 8 ranks of phase 36's paged
    servers' main-path runs and of phase 38's meshed replica."""
    case = {r["case"]: r for r in kern}
    dec, chunk = case["decode_bf16_tp4"], case["chunk_bf16_T256_tp4"]
    launches = {c: mesh_serve["launches_all_ranks"][c]
                + mesh_replica["launches_all_ranks"][c]
                for c in _PAGED_COUNTERS}
    paged = dict(route="cuda",
                 source="kubetpu_torch/ops/csrc/paged_attention.cu",
                 replaces="kubetpu/ops/paged_attention.py:65",
                 launches_from="phases 36 and 38, 8 ranks",
                 launches_phase_38={
                     c: mesh_replica["launches_all_ranks"][c]
                     for c in ("split_launches", "combine_launches",
                               "wgmma_launches")})
    return [
        dict(paged, name="paged_attention_split_tp4", instances="split",
             launches=launches["split_launches"],
             max_abs_err=dec["split"]["max_err"], ms=dec["split"]["ms"],
             plain_ms=dec["split"]["plain_ms"],
             bound_ms=dec["split"]["bound_ms"],
             bound_by=dec["split"]["bound_by"], library_ms=None,
             call_ms=dec["ms"], call_bound_ms=dec["bound_ms"],
             call_library_ms=dec["library_ms"],
             combine_launches=launches["combine_launches"],
             combine_ms=dec["combine"]["ms"],
             combine_bound_ms=dec["combine"]["bound_ms"],
             grid=dec["grid"], splits=dec["splits"], ok=dec["ok"],
             shape=dec["shape"]),
        dict(paged, name="paged_attention_chunk_tp4", instances="wgmma",
             launches=launches["wgmma_launches"],
             max_abs_err=chunk["max_abs_err"], ms=chunk["ms"],
             plain_ms=chunk["plain_ms"], bound_ms=chunk["bound_ms"],
             bound_by=chunk["bound_by"], library_ms=chunk["library_ms"],
             grid=chunk["grid"], key_splits=chunk["key_splits"],
             ok=chunk["ok"], shape=chunk["shape"]),
    ]


def _mesh_kernel_rows(flash, mesh_train) -> list:
    """The three flash kernels on phase 34's path: timed at the ring's
    per-step shape (the visiting blocks' non-causal steps; the causal
    diagonal step beside them), launches summed over the 8 ranks' three
    main-path steps."""
    rows = []
    for kind, name, replaces in (
            ("forward", "flash_forward", "kubetpu/ops/flash_attention.py:41"),
            ("dq", "flash_backward_dq", "kubetpu/ops/flash_attention.py:141"),
            ("dkv", "flash_backward_dkv",
             "kubetpu/ops/flash_attention.py:195")):
        step, diag = (next(r for r in flash if r["kernel"] == kind
                           and r["case"] == case)
                      for case in ("ring_step", "ring_diag"))
        rows.append({
            "name": f"{name}_mesh_ring", "route": "cuda",
            "instances": step["route"],
            "source": "kubetpu_torch/ops/csrc/flash_attention.cu",
            "replaces": replaces,
            "launches": mesh_train["flash_launches"][kind],
            "launches_from": f"phase 34, 8 ranks x {MESH_STEPS} steps",
            "max_abs_err": max(step["max_abs_err"], diag["max_abs_err"]),
            "ms": step["ms"], "plain_ms": step["plain_ms"],
            "bound_ms": step["bound_ms"], "bound_by": step["bound_by"],
            "library_ms": step["library_ms"], "diag_ms": diag["ms"],
            "diag_bound_ms": diag["bound_ms"],
            "diag_library_ms": diag["library_ms"],
            "ok": step["ok"] and diag["ok"], "shape": step["shape"]})
    return rows


def main(argv) -> int:
    t_script = time.perf_counter()
    record_path = None
    only = argv[-1] if argv[-2:-1] == ["--phases"] else None
    if only is not None and only not in PHASE_RANGES:
        print(f"chip_smoke: unknown --phases {only}", file=sys.stderr)
        return 2
    if only:
        argv = argv[:-2]
    if argv[:1] == ["--record"] and len(argv) == 2:
        record_path = argv[1]
    elif argv:
        print("usage: python3 chip_smoke.py [--record PATH] "
              f"[--phases {'|'.join(PHASE_RANGES)}]", file=sys.stderr)
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
    if only:
        return finish({"device": dev, "build": build,
                       **PHASE_RANGES[only](dev["nvidia_smi"])},
                      t_script, record_path, only)
    kern = phase_kernels()
    verify = phase_verify_routes()
    flash = phase_flash()
    parity = phase_parity()
    serve, server = phase_serve(dev["nvidia_smi"])
    prof = phase_profile(server)
    model, cfg = server.params, server.cfg
    del server
    torch.cuda.empty_cache()
    # the paged launches of every main-path phase: serve, prefix, window,
    # wire, dense, spec, multilora, router, int8w, moe, text_serve, distill,
    # hf_import
    paged_launches = dict(serve["paged_launches"])
    prefix = phase_prefix(model, cfg, dev["nvidia_smi"], paged_launches)
    window = phase_window(model, cfg, dev["nvidia_smi"], paged_launches)
    wire = phase_wire(model, cfg, dev["nvidia_smi"], paged_launches)
    dense = phase_dense(model, cfg, dev["nvidia_smi"], paged_launches)
    spec = phase_spec(model, cfg, dev["nvidia_smi"], paged_launches)
    multilora = phase_multilora(model, cfg, dev["nvidia_smi"],
                                paged_launches)
    router = phase_router(model, cfg, dev["nvidia_smi"], paged_launches)
    int8w, qmodel = phase_int8w(model, cfg, dev["nvidia_smi"],
                                paged_launches)
    rolling = phase_rolling(model, qmodel, cfg, dev["nvidia_smi"])
    del model, qmodel
    torch.cuda.empty_cache()
    moe = phase_moe(cfg, dev["nvidia_smi"], paged_launches)
    train_parity = phase_train_parity(dev["nvidia_smi"])
    train, state, step, repeat = phase_train(dev["nvidia_smi"])
    train_prof = phase_train_profile(state, step, repeat)
    base = state.params                 # phase 18 fine-tunes on top of it
    del state, step, repeat
    torch.cuda.empty_cache()
    lora_train = phase_lora_train(base, dev["nvidia_smi"])
    del base
    torch.cuda.empty_cache()
    moe_train = phase_moe_train(dev["nvidia_smi"])
    # the lifecycle: text -> corpus -> train -> checkpoint -> restore ->
    # serve text -> distil a draft -> speculate; then the importer
    text_data, files, held = phase_text_data(dev["nvidia_smi"],
                                             train["step_ms"])
    text_train, life_state, life_cfg = phase_text_train(dev["nvidia_smi"],
                                                        files)
    target = life_state.params
    del life_state
    torch.cuda.empty_cache()
    text_serve, text_prompts = phase_text_serve(
        target, life_cfg, held, dev["nvidia_smi"], paged_launches)
    distill = phase_distill(target, life_cfg, files, text_prompts,
                            dev["nvidia_smi"], paged_launches)
    beam = phase_beam(target, life_cfg, files, dev["nvidia_smi"])
    del target
    for f in files.values():
        f.close()
    torch.cuda.empty_cache()
    hf_import = phase_hf_import(dev["nvidia_smi"], paged_launches)
    # the other families: the encoder (and phase 33 on its steps), ViT,
    # seq2seq
    encoder, enc_state, enc_step, enc_batch = phase_encoder(
        dev["nvidia_smi"], train["step_ms"])
    profiling = phase_profiling(enc_state, enc_step, enc_batch,
                                dev["nvidia_smi"])
    del enc_state, enc_step, enc_batch
    torch.cuda.empty_cache()
    vit = phase_vit(dev["nvidia_smi"], flash)
    torch.cuda.empty_cache()
    seq2seq = phase_seq2seq(dev["nvidia_smi"])
    torch.cuda.empty_cache()
    # the multi-device training path: worlds of ranks sharing the card
    mesh_train, axes = phase_mesh_train(dev["nvidia_smi"])
    mesh_axes = phase_mesh_axes(dev["nvidia_smi"], axes)
    mesh_serve, replica, fam = phase_mesh_serve(dev["nvidia_smi"])
    mesh_replica = phase_mesh_replica(dev["nvidia_smi"], replica)
    mesh_families = phase_mesh_families(dev["nvidia_smi"], fam)
    shutil.rmtree(LIFE_DIR, ignore_errors=True)

    # the paged kernels at the main path's cases (launches: phases 6, 8, 9,
    # 12, 15, 16, 17, 19, 20, 21, 26, 27 and 28; the SIMT chunk's: phase 5,
    # phase 16's f32 arm, whose verify chunks take it too, and phase 28's
    # small f32 import): the split and combine
    # kernels at decode_bf16 (max_abs_err over every decode case), the
    # chunk kernel's dense instance at chunk_bf16_T256 (max_abs_err over
    # both dense wgmma cases), its int8 instance at the int8 storm arm's
    # prefix-hit chunk (T=256 beside it), the SIMT kernel at the parity
    # phase's f32 chunk (the one path it still runs on, whose launches it
    # reports)
    case = {r["case"]: r for r in kern}
    decode = case["decode_bf16"]
    chunk = case["chunk_bf16_T256"]
    chunk8, chunk8_t256 = (case[k] for k in ("chunk_int8_prefix_T64",
                                             "chunk_int8_T256"))
    simt = case["chunk_f32_parity_T32"]
    decodes = [r for r in kern if r["route"] == "split"]
    chunks = [r for r in kern if r["route"] == "wgmma"
              and not r["shape"]["int8"]]
    chunks8 = [r for r in kern if r["route"] == "wgmma" and r["shape"]["int8"]]
    paged = dict(route="cuda", source="kubetpu_torch/ops/csrc/paged_attention.cu",
                 replaces="kubetpu/ops/paged_attention.py:65")
    # the verify chunk's cases (phase 3): each route's ms by T, per pool
    verify_ms = {("int8" if r["int8"] else "bf16"): {} for r in verify}
    for r in verify:
        verify_ms["int8" if r["int8"] else "bf16"][r["T"]] = dict(
            r["ms"], routed=r["routed"], bound_ms=r["bound_ms"],
            plain_ms=r["plain_ms"], library_ms=r["library_ms"])
    kernels = [
        dict(paged, name="paged_attention_split", instances="split",
             launches=paged_launches["split_launches"],
             max_abs_err=max(r["split"]["max_err"] for r in decodes),
             ms=decode["split"]["ms"], plain_ms=decode["split"]["plain_ms"],
             bound_ms=decode["split"]["bound_ms"],
             bound_by=decode["split"]["bound_by"], library_ms=None,
             call_ms=decode["ms"], call_bound_ms=decode["bound_ms"],
             call_library_ms=decode["library_ms"],
             call_max_abs_err=max(r["max_abs_err"] for r in decodes),
             ok=all(r["ok"] for r in decodes)),
        dict(paged, name="paged_attention_combine", instances="split",
             launches=paged_launches["combine_launches"],
             max_abs_err=max(r["combine"]["max_abs_err"] for r in decodes),
             ms=decode["combine"]["ms"],
             plain_ms=decode["combine"]["plain_ms"],
             bound_ms=decode["combine"]["bound_ms"],
             bound_by=decode["combine"]["bound_by"], library_ms=None,
             ok=all(r["ok"] for r in decodes)),
        dict(paged, name="paged_attention_chunk", instances="wgmma",
             launches=paged_launches["wgmma_launches"],
             max_abs_err=max(r["max_abs_err"] for r in chunks),
             ms=chunk["ms"],
             plain_ms=chunk["plain_ms"], bound_ms=chunk["bound_ms"],
             bound_by=chunk["bound_by"], library_ms=chunk["library_ms"],
             verify=verify_ms["bf16"], ok=all(r["ok"] for r in chunks)),
        dict(paged, name="paged_attention_chunk_int8", instances="wgmma_int8",
             launches=paged_launches["wgmma_int8_launches"],
             max_abs_err=max(r["max_abs_err"] for r in chunks8),
             ms=chunk8["ms"], plain_ms=chunk8["plain_ms"],
             bound_ms=chunk8["bound_ms"], bound_by=chunk8["bound_by"],
             library_ms=chunk8["library_ms"],
             t256_ms=chunk8_t256["ms"], t256_bound_ms=chunk8_t256["bound_ms"],
             t256_plain_ms=chunk8_t256["plain_ms"],
             t256_library_ms=chunk8_t256["library_ms"],
             verify=verify_ms["int8"], ok=all(r["ok"] for r in chunks8)),
        dict(paged, name="paged_attention_chunk_simt", instances="simt",
             launches=parity["paged_launches"]["simt_launches"]
             + paged_launches["simt_launches"],
             launches_from="parity, spec, hf_import",
             max_abs_err=simt["max_abs_err"],
             ms=simt["ms"], plain_ms=simt["plain_ms"],
             bound_ms=simt["bound_ms"], bound_by=simt["bound_by"],
             library_ms=simt["library_ms"], ok=simt["ok"]),
    ]
    # the flash kernels at the main path's case (causal); max_abs_err and ok
    # over all three cases; launches over the timed steps of phases 11, 18
    # and 23 and the training, evaluation and distillation of 25 and 27
    trained = (train, lora_train, moe_train["train"], text_train, distill)
    flash_kernels = (
        ("forward", "flash_forward", "kubetpu/ops/flash_attention.py:41"),
        ("dq", "flash_backward_dq", "kubetpu/ops/flash_attention.py:141"),
        ("dkv", "flash_backward_dkv", "kubetpu/ops/flash_attention.py:195"))
    for kind, name, replaces in flash_kernels:
        launches = sum(r["flash_launches"][kind] for r in trained)
        rows = [r for r in flash if r["kernel"] == kind
                and all(r["shape"][x] == FLASH_SHAPE[x] for x in "BSHD")]
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
    # their causal=False cases at the encoder's shape (phase 4's noncausal
    # case: FLASH_SHAPE) and ViT's (VIT_FLASH_SHAPE), each with the
    # launches of phase 29's timed steps or of phase 30's timed steps and
    # no-grad calls
    vit_launches = {k: vit["flash_launches"][k] + vit["infer_flash_launches"][k]
                    for k in vit["flash_launches"]}
    for tag, case, counts, phase in (
            ("encoder", "noncausal", encoder["flash_launches"], "29"),
            ("vit", "vit_noncausal", vit_launches, "30")):
        for kind, name, replaces in flash_kernels:
            r = next(r for r in flash if r["kernel"] == kind
                     and r["case"] == case)
            kernels.append({
                "name": f"{name}_noncausal_{tag}", "route": "cuda",
                "instances": r["route"],
                "source": "kubetpu_torch/ops/csrc/flash_attention.cu",
                "replaces": replaces, "launches": counts[kind],
                "launches_from": f"phase {phase}",
                "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                "ok": r["ok"], "shape": r["shape"],
            })
    kernels += _mesh_kernel_rows(flash, mesh_train)
    kernels += _tp4_kernel_rows(kern, mesh_serve, mesh_replica)
    kernels += _family_kernel_rows(flash, mesh_families)
    record = {"device": dev, "build": build, "kernel_cases": kern,
              "flash_cases": flash, "parity": parity, "serve": serve,
              "profile": prof, "prefix": prefix, "window": window,
              "wire": wire, "verify_routes": verify, "dense": dense,
              "spec": spec, "multilora": multilora, "router": router,
              "main_path_paged_launches": paged_launches,
              "train_parity": train_parity,
              "train": train, "train_profile": train_prof,
              "lora_train": lora_train, "int8w": int8w, "rolling": rolling,
              "moe": moe, "moe_train": moe_train, "text_data": text_data,
              "text_train": text_train, "text_serve": text_serve,
              "distill": distill, "hf_import": hf_import, "beam": beam,
              "encoder": encoder, "profiling": profiling, "vit": vit,
              "seq2seq": seq2seq, "mesh_train": mesh_train,
              "mesh_axes": mesh_axes, "mesh_serve": mesh_serve,
              "mesh_replica": mesh_replica,
              "mesh_families": mesh_families, "kernels": kernels}
    return finish(record, t_script, record_path)


def finish(record: dict, t_script: float, record_path, phases=None) -> int:
    """The shared tail of a run: the wall line, the record (``--record``),
    the ``kernels`` line where the run has one, and the contract's last
    line (naming *phases* when ``--phases`` cut the run)."""
    record["wall_s"] = time.perf_counter() - t_script
    line("wall", seconds=record["wall_s"])
    if record_path:
        os.makedirs(os.path.dirname(os.path.abspath(record_path)),
                    exist_ok=True)
        with open(record_path, "w") as f:
            json.dump(record, f, indent=1)
    if "kernels" in record:
        print(json.dumps({"kernels": record["kernels"]}), flush=True)
    print(json.dumps({"ok": True, **({"phases": phases} if phases else {}),
                      "device": {
                          "platform": "gpu",
                          "kind": torch.cuda.get_device_name(0),
                          "count": torch.cuda.device_count()}}), flush=True)
    return 0


def run_families(smi: str) -> dict:
    """``--phases 29-33``: phase 4, then 29, 33, 30 and 31 as the whole run
    drives them, and 32 on a random-weight flagship (the whole run gives it
    phase 25's trained one) with ``SyntheticCorpus`` prompts."""
    from kubetpu_torch.jobs.data import SyntheticCorpus
    from kubetpu_torch.jobs.model import init_params

    record = {"flash_cases": phase_flash()}
    record["encoder"], state, step, batch = phase_encoder(smi, float("nan"))
    record["profiling"] = phase_profiling(state, step, batch, smi)
    del state, step, batch
    torch.cuda.empty_cache()
    record["vit"] = phase_vit(smi, record["flash_cases"])
    torch.cuda.empty_cache()
    record["seq2seq"] = phase_seq2seq(smi)
    torch.cuda.empty_cache()
    cfg = _flagship_train_cfg()
    model = init_params(torch.Generator(device="cuda").manual_seed(32), cfg,
                        device="cuda")
    record["beam"] = phase_beam(
        model, cfg, {"held": SyntheticCorpus(cfg.vocab, seed=32)}, smi,
        weights="a random-weight flagship")
    return record


def run_mesh(smi: str) -> dict:
    """``--phases 34-38``: phase 4 (with the ring's and the meshed
    families' cases) and phase 3's tp-4 cases, then 34, 35, 36, 38 and 37
    as the whole run drives them, and their ``kernels`` entries."""
    record = {"flash_cases": phase_flash(),
              "kernel_cases": phase_kernels(
                  names=[n for n, _ in _tp4_cases()])}
    torch.cuda.empty_cache()
    record["mesh_train"], axes = phase_mesh_train(smi)
    record["mesh_axes"] = phase_mesh_axes(smi, axes)
    record["mesh_serve"], replica, fam = phase_mesh_serve(smi)
    record["mesh_replica"] = phase_mesh_replica(smi, replica)
    record["mesh_families"] = phase_mesh_families(smi, fam)
    shutil.rmtree(LIFE_DIR, ignore_errors=True)
    record["kernels"] = (
        _mesh_kernel_rows(record["flash_cases"], record["mesh_train"])
        + _tp4_kernel_rows(record["kernel_cases"], record["mesh_serve"],
                           record["mesh_replica"])
        + _family_kernel_rows(record["flash_cases"],
                              record["mesh_families"]))
    return record


# ``--phases`` ranges: each runs phases 1, 2 and its own, then the shared
# tail
PHASE_RANGES = {"29-33": run_families, "34-38": run_mesh}


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
