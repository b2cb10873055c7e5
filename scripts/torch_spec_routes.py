"""The speculative server's acceptance under each verify-chunk route, on the
card.

    python3 scripts/torch_spec_routes.py

Builds the paged kernels, then serves ``chip_smoke.py`` phase 16's self-draft
arm (the flagship drafting for itself, phase 6's prompts, 64 new tokens, 8
slots, gamma_max 4, adaptive gamma) over a bf16 and an int8 pool with the
verify chunk (T = gamma + 1 <= 9) forced onto each candidate route in turn —
the wgmma chunk kernel, the split route over one-query rows, the SIMT chunk
kernel — beside the plain paged server. One ``spec`` line an arm (mean tokens
per round, accepted share, tokens equal to the plain server's, tokens/s), as
``chip_smoke.py`` prints them. Needs one CUDA card; imports no JAX.
"""

from __future__ import annotations

import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from kubetpu_torch.jobs import model as model_lib  # noqa: E402
from kubetpu_torch.ops import paged_attention as pa  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_spec_routes: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = chip_smoke.phase_device()["nvidia_smi"]
    chip_smoke.phase_build()
    cfg = model_lib.ModelConfig(vocab=32000, d_model=2048, n_layers=12,
                                n_heads=16, d_ff=5632, max_seq=2048,
                                dtype=torch.bfloat16)
    model = model_lib.init_params(
        torch.Generator(device="cuda").manual_seed(0), cfg, device="cuda")
    prompts = chip_smoke._serve_prompts(cfg)
    kw = dict(n_slots=8, max_seq=2048, max_new_tokens=chip_smoke.SPEC_NEW,
              page_size=16, prefill_budget=256, device="cuda")
    route = pa._route
    try:
        for int8 in (False, True):
            plain = chip_smoke._spec_plain(model, cfg, prompts, smi, int8, kw)
            for forced in ("wgmma", "rows", "simt"):
                pa._route = (lambda r: lambda q, k, t, w: (
                    r if 2 <= t <= 9 else route(q, k, t, w)))(forced)
                chip_smoke._spec_arm(
                    f"self_{'int8' if int8 else 'bf16'}_{forced}", model,
                    cfg, cfg, model, int8, kw, prompts, plain, smi, {})
    finally:
        pa._route = route
    return 0


if __name__ == "__main__":
    sys.exit(main())
