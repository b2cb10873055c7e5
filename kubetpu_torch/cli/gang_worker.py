"""``python -m kubetpu_torch.cli.gang_worker`` — one gang member as an OS
process (port of ``kubetpu/cli/gang_worker.py``).

The inside-the-container entry point a launcher starts once per gang pod:
builds the member's ``LaunchConfig`` from the injected allocation env
(``TPU_VISIBLE_DEVICES`` or ``NVIDIA_VISIBLE_DEVICES`` and
``TPU_WORKER_ID``, through ``jobs.launch.launch_config``) plus the gang
facts only the launcher knows (coordinator address, gang size, this
member's rank), joins the ``torch.distributed`` process group and runs one
data-parallel train step whose gradient all-reduce crosses the process
boundary (``jobs.launch.run_gang_member``). A member that names n devices
runs n local ranks, one process each, ranks ``rank * n + local_rank``.

Prints ONE JSON line, the JAX package's report plus the backend that ran::

    {"process_index": 0, "process_count": 2, "global_devices": 4,
     "loss": 5.01, "backend": "gloo", "local_ranks": 2, "ranks": [0, 1],
     "device_names": []}

``process_index`` is the member's gang rank, ``process_count`` the gang
size, ``global_devices`` the world's ranks; an identical ``loss`` on every
member certifies the cross-process all-reduce.

    python -m kubetpu_torch.cli.gang_worker --coordinator HOST:PORT \\
        --num-processes N --rank R --backend gloo|nccl [--platform cpu]

``--platform cpu`` is the hardware-free path (gloo over TCP); without it
every local rank runs on its card (``cuda:<local device id>``) and the
worker raises where there is none. ``--backend`` is the launcher's choice
(``gang_launch``): gloo on the CPU or where members share a card, NCCL
otherwise.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--coordinator", required=True, help="rank-0 host:port")
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--rank", type=int, required=True,
                    help="gang rank (position in the placed gang, NOT "
                         "necessarily the host's TPU_WORKER_ID)")
    ap.add_argument("--platform", default=None, choices=("cpu",),
                    help="'cpu' for hardware-free runs (default: the card)")
    ap.add_argument("--backend", required=True, choices=("gloo", "nccl"),
                    help="the process group's backend, the launcher's "
                         "choice")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    from kubetpu_torch.jobs.launch import (launch_config, run_gang_member,
                                           visible_device_names)

    host, _, port = args.coordinator.rpartition(":")
    config = launch_config(os.environ, [host] * args.num_processes,
                           rank=args.rank, coordinator_port=int(port))
    out = run_gang_member(config, args.backend,
                          device="cpu" if args.platform == "cpu" else None,
                          seed=args.seed)
    # the devices the pod named by id, where it did (GPU-<uuid>)
    out["device_names"] = visible_device_names(os.environ)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
