"""One leg of an A/B comparison of ``chip_smoke.py``'s shared-prefix phase
(phase 8) between two checkouts of the PyTorch port, on one NVIDIA GPU.

    python3 scripts/torch_prefix_ab.py CHECKOUT_ROOT LABEL

builds the kernels of the checkout at CHECKOUT_ROOT (into its own
``build/``), makes the flagship decoder from seed 0 as phase 6 does, runs
that checkout's ``phase_prefix`` and prints one ``ab:`` JSON line per arm
with the server's TTFT p50/p99, the arm's wall time, its first-token
logit gap to the cold arm and its paged launches. Run the legs in turns
inside one machine session, e.g. for a parent tree unpacked into
``build/parent`` and this one:

    for leg in parent change change parent; do
      python3 scripts/torch_prefix_ab.py \\
          $([ $leg = parent ] && echo build/parent || echo .) $leg
    done

Nothing of JAX or of the ``kubetpu`` package is imported.
"""

from __future__ import annotations

import json
import os
import sys
import time


def main(argv) -> int:
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    root, label = os.path.abspath(argv[0]), argv[1]
    sys.path.insert(0, root)
    import torch

    import chip_smoke
    from kubetpu_torch.jobs import model as model_lib

    if not torch.cuda.is_available():
        print("torch_prefix_ab: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    chip_smoke.phase_build()
    cfg = model_lib.ModelConfig(vocab=32000, d_model=2048, n_layers=12,
                                n_heads=16, d_ff=5632, max_seq=2048,
                                dtype=torch.bfloat16)
    model = model_lib.init_params(
        torch.Generator(device="cuda").manual_seed(0), cfg, device="cuda")
    t0 = time.perf_counter()
    rows = chip_smoke.phase_prefix(model, cfg, label, {})
    for arm, row in rows.items():
        if arm == "profiles":
            continue
        print("ab: " + json.dumps(dict(
            tree=label, arm=arm, ttft_p50_ms=row["ttft_p50_ms"],
            ttft_p99_ms=row["ttft_p99_ms"], wall_s=row["wall_s"],
            first_logit_max_diff=row.get("first_logit_max_diff"),
            paged_launches=row["paged_launches"])), flush=True)
    print("ab: " + json.dumps(dict(tree=label,
                                   phase_s=time.perf_counter() - t0)),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
