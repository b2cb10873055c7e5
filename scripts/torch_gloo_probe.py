"""Which collectives a process group takes on CUDA tensors, on one card.

    python3 scripts/torch_gloo_probe.py [--ranks 2]

Spawns a world of N processes that all use ``cuda:0`` and asks it two
things, printing one JSON line each:

- ``nccl``: does NCCL run a world of several ranks on one device? Each rank
  runs one ``all_reduce`` under a 90 s limit; the line holds each rank's
  exit code and the error text NCCL gave.
- ``gloo_cuda``: under gloo, which operations take CUDA tensors, in f32 and
  in bf16: ``all_reduce``, ``broadcast``, ``all_gather``, ``reduce_scatter``,
  ``all_to_all``, ``send``/``recv`` and ``batch_isend_irecv``. Each runs in
  a world of its own (an operation that crashes its ranks takes no other
  down), on CUDA tensors, its result checked against the same operation on
  CPU tensors; the line maps each to "ok", "wrong", the error text, or "no
  answer" with the ranks' exit codes.

A probe of what the installed torch supports, not a path of the port: the
port's staging rule (``kubetpu_torch/jobs/collectives.py``) was written
from its answer. Needs a CUDA device; prints the torch and CUDA versions.
"""

from __future__ import annotations

import datetime
import json
import multiprocessing as mp
import os
import sys
import tempfile
import time

import torch
import torch.distributed as dist

DEVICE = "cuda"
OPS = ("all_reduce", "broadcast", "all_gather", "reduce_scatter",
       "all_to_all", "send_recv", "batch_isend_irecv")


def _call(op, rank, world, dev, dtype):
    """Run *op* on tensors on *dev* -> the result as a CPU f32 tensor."""
    x = (torch.arange(8, dtype=torch.float32) + 10 * rank).to(dev, dtype)
    if op == "all_reduce":
        dist.all_reduce(x)
        return x.float().cpu()
    if op == "broadcast":
        dist.broadcast(x, src=0)
        return x.float().cpu()
    if op == "all_gather":
        outs = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(outs, x)
        return torch.cat(outs).float().cpu()
    if op == "reduce_scatter":
        out = torch.empty(8 // world, dtype=dtype, device=dev)
        dist.reduce_scatter(out, list(x.chunk(world)))
        return out.float().cpu()
    if op == "all_to_all":
        outs = [torch.empty(8 // world, dtype=dtype, device=dev)
                for _ in range(world)]
        dist.all_to_all(outs, list(x.chunk(world)))
        return torch.cat(outs).float().cpu()
    nxt, prv = (rank + 1) % world, (rank - 1) % world
    got = torch.empty_like(x)
    if op == "send_recv":
        if rank % 2 == 0:
            dist.send(x, nxt)
            dist.recv(got, prv)
        else:
            dist.recv(got, prv)
            dist.send(x, nxt)
        return got.float().cpu()
    ops = [dist.P2POp(dist.isend, x, nxt), dist.P2POp(dist.irecv, got, prv)]
    for w in dist.batch_isend_irecv(ops):
        w.wait()
    return got.float().cpu()


def _gloo_worker(rank, world, path, q, op):
    if DEVICE == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{path}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=20))
    table = {}
    for dtype in (torch.float32, torch.bfloat16):
        key = f"{op}/{str(dtype).split('.')[-1]}"
        try:     # the probe's question is whether these raise
            want = _call(op, rank, world, "cpu", dtype)
        except (RuntimeError, ValueError, TypeError) as e:
            table[key] = "cpu too: " + str(e).splitlines()[0][:160]
            continue
        try:
            got = _call(op, rank, world, torch.device(DEVICE, 0), dtype)
            torch.cuda.synchronize()
            table[key] = "ok" if torch.equal(got, want) else "wrong"
        except (RuntimeError, ValueError, TypeError) as e:
            table[key] = str(e).splitlines()[0][:160]
        q.put((rank, table))
    dist.destroy_process_group()


def _nccl_worker(rank, world, path, q, _op=None):
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{path}",
                            world_size=world, rank=rank,
                            device_id=torch.device("cuda", 0))
    x = torch.ones(4, device="cuda")
    try:     # the probe's question is whether NCCL refuses the world
        dist.all_reduce(x)
        torch.cuda.synchronize()
        q.put((rank, f"ok {x[0].item()}"))
    except (RuntimeError, dist.DistBackendError) as e:
        q.put((rank, str(e).splitlines()[0][:300]))


def _world(target, world, limit, op=None):
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "store")
        procs = [ctx.Process(target=target, args=(r, world, path, q, op))
                 for r in range(world)]
        for p in procs:
            p.start()
        out, t_end = {}, time.time() + limit
        while time.time() < t_end and any(p.is_alive() for p in procs):
            time.sleep(0.5)
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
        while not q.empty():      # each rank's latest table
            rank, val = q.get()
            out[rank] = val
        return out, [p.exitcode for p in procs]


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("torch_gloo_probe: needs a CUDA device", file=sys.stderr)
        return 1
    world = int(argv[argv.index("--ranks") + 1]) if "--ranks" in argv else 2
    print(json.dumps({"torch": torch.__version__, "cuda": torch.version.cuda,
                      "device": torch.cuda.get_device_name(0)}), flush=True)
    out, codes = _world(_nccl_worker, world, 90.0)
    print("nccl: " + json.dumps({"ranks": world, "exit_codes": codes,
                                 "results": out}), flush=True)
    table, codes = {}, {}
    for op in OPS:     # a world each: a crash takes only its own op down
        out, codes[op] = _world(_gloo_worker, world, 45.0, op)
        for dtype in ("float32", "bfloat16"):
            table[f"{op}/{dtype}"] = out.get(0, {}).get(
                f"{op}/{dtype}", f"no answer (exit codes {codes[op]})")
    print("gloo_cuda: " + json.dumps({"ranks": world, "table": table}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
