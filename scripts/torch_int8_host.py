"""Where the host time of an int8-weight decode step goes, beside bf16's,
on one card: the flagship (random weights, seed 0) behind
PagedDecodeServer (8 slots of 256-token prompts), ten
decode steps under torch.profiler, host operators sorted by self CPU
time; and maybe_dequantize of one block, timed alone.

    python3 scripts/torch_int8_host.py
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from kubetpu_torch.jobs import model as model_lib, quant  # noqa: E402
from kubetpu_torch.jobs.paged import PagedDecodeServer  # noqa: E402

cfg = model_lib.ModelConfig(vocab=32000, d_model=2048, n_layers=12,
                            n_heads=16, d_ff=5632, max_seq=2048,
                            dtype=torch.bfloat16)
model = model_lib.init_params(torch.Generator(device="cuda").manual_seed(0),
                              cfg, device="cuda")
qmodel = quant.quantize_params(model)
print(torch.cuda.get_device_name(0), flush=True)
for name, weights in (("bf16", model), ("int8w", qmodel), ("bf16", model),
                      ("int8w", qmodel)):
    server = PagedDecodeServer(cfg, weights, n_slots=8, max_seq=2048,
                               max_new_tokens=64, page_size=16,
                               prefill_budget=256, device="cuda")
    rng = np.random.default_rng(1)
    for _ in range(8):
        server.enqueue(rng.integers(0, cfg.vocab, 256).tolist())
    while server._queue or server._prefills:
        server.step()
    for _ in range(3):
        server.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        server.step()
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 100
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(10):
            server.step()
        torch.cuda.synchronize()
    rows = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    print(f"== {name}: step {plain_ms:.2f} ms unprofiled", flush=True)
    for e in rows[:12]:
        print(f"  {e.key[:50]:50s} calls {e.count / 10:7.1f}/step  self "
              f"{e.self_cpu_time_total / 10 / 1e3:7.3f} ms/step", flush=True)
    server.drain()
    del server
blk = qmodel.blocks[0]
for sync in (False, True):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(100):
        quant.maybe_dequantize(blk)
        if sync:
            torch.cuda.synchronize()
    print(f"maybe_dequantize(block) sync={sync}: "
          f"{(time.perf_counter() - t0) * 10:.3f} ms", flush=True)
t0 = time.perf_counter()
for _ in range(100):
    quant.maybe_dequantize(model.blocks[0])
print(f"maybe_dequantize(raw block): {(time.perf_counter() - t0) * 10:.4f} ms")
