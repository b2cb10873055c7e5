"""Multi-host job launch wiring: from the scheduler's allocation to a
``torch.distributed`` process group (port of ``kubetpu/jobs/launch.py``).

The device manager injects the device env contract per container
(``TPU_VISIBLE_DEVICES`` or ``NVIDIA_VISIBLE_DEVICES``, the worker id);
this module is its inside-the-container counterpart: a gang's allocations
become each worker's ``LaunchConfig`` (process index = gang rank, process
count = gang size, the devices it may use, coordinator = gang rank 0), and
``initialize_distributed`` joins the process group.

On the card the idiom is one process a GPU: a worker whose env names
several devices runs one local rank for each (``local_rank`` 0 .. n-1),
rank ``process_id * n + local_rank`` of a world of ``num_processes * n``,
each on ``cuda:<local_device_ids[local_rank]>``. The backend is the
caller's: NCCL where each rank has its own GPU, gloo where ranks share one
(NCCL refuses two ranks on one device).
"""

from __future__ import annotations

import datetime
from dataclasses import dataclass
from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np


@dataclass(frozen=True)
class LaunchConfig:
    """Everything ``init_process_group`` needs for one gang worker."""

    coordinator_address: str
    num_processes: int
    process_id: int
    local_device_ids: List[int]

    def ranks_per_process(self) -> int:
        return max(1, len(self.local_device_ids))

    def world_size(self) -> int:
        return self.num_processes * self.ranks_per_process()

    def rank(self, local_rank: int = 0) -> int:
        if not 0 <= local_rank < self.ranks_per_process():
            raise ValueError(f"local_rank {local_rank} outside [0, "
                             f"{self.ranks_per_process()})")
        return self.process_id * self.ranks_per_process() + local_rank

    def initialize_kwargs(self, backend: str,
                          local_rank: int = 0) -> Dict[str, object]:
        """``init_process_group``'s arguments for local rank *local_rank*
        of this worker."""
        return {"backend": backend,
                "init_method": f"tcp://{self.coordinator_address}",
                "world_size": self.world_size(),
                "rank": self.rank(local_rank)}


def launch_config(env: Mapping[str, str], gang_hosts: Sequence[str],
                  rank: Optional[int] = None,
                  coordinator_port: int = 8476) -> LaunchConfig:
    """A worker's LaunchConfig from its injected container env and the
    gang's host list (ordered by gang rank, the order ``schedule_gang``
    placed them).

    ``rank`` is the worker's position within the gang; it defaults to the
    env's TPU_WORKER_ID, which equals the gang rank only when the gang
    spans a full slice in host order: a partial-slice gang (hosts {0, 2})
    must pass it. The local devices come from ``TPU_VISIBLE_DEVICES``, or
    ``NVIDIA_VISIBLE_DEVICES`` for a GPU container. A list of ordinals
    ("2,3") names them as they are; a list of GPU ids or UUIDs, as the
    device manager writes them ("GPU-…"), names devices that the container
    runtime exposes as ordinals 0 .. n-1: one local rank each
    (``visible_device_names`` returns the ids, for a launcher with no such
    runtime to put in ``CUDA_VISIBLE_DEVICES``)."""
    if not gang_hosts:
        raise ValueError("gang_hosts must name at least the coordinator host")
    process_id = int(env.get("TPU_WORKER_ID", "0")) if rank is None else rank
    if not 0 <= process_id < len(gang_hosts):
        raise ValueError(
            f"process_id {process_id} outside [0, {len(gang_hosts)}); pass "
            "the gang rank explicitly for partial-slice gangs")
    visible = visible_devices(env)
    if visible_device_names(env):
        local_device_ids = list(range(len(visible)))
    else:
        local_device_ids = [int(x) for x in visible]
    return LaunchConfig(
        coordinator_address=f"{gang_hosts[0]}:{coordinator_port}",
        num_processes=len(gang_hosts),
        process_id=process_id,
        local_device_ids=local_device_ids)


def visible_devices(env: Mapping[str, str]) -> List[str]:
    visible = (env.get("TPU_VISIBLE_DEVICES")
               or env.get("NVIDIA_VISIBLE_DEVICES", ""))
    return [x.strip() for x in visible.split(",") if x.strip() != ""]


def visible_device_names(env: Mapping[str, str]) -> List[str]:
    """The env's visible devices when it names them by id rather than by
    ordinal (``GPU02``, ``GPU-<uuid>``), else []: the list a launcher
    puts in ``CUDA_VISIBLE_DEVICES`` where no container runtime maps the
    ids to ordinals."""
    visible = visible_devices(env)
    if all(x.isdigit() for x in visible):
        return []
    return visible


def select_device_env(envs: Sequence[Mapping[str, str]]) -> Dict[str, str]:
    """Pick the device-bearing container env out of a pod's per-container
    allocation results: the container whose env names visible devices
    wins (sidecars and init containers may have empty allocations). Raises
    when no container carries a device env: a gang worker launched without
    its allocation env would silently run on default devices."""
    for cand in envs:
        if cand.get("TPU_VISIBLE_DEVICES") or cand.get(
                "NVIDIA_VISIBLE_DEVICES"):
            return dict(cand)
    raise ValueError(
        "no container env carries TPU_VISIBLE_DEVICES/NVIDIA_VISIBLE_DEVICES "
        "— the pod's allocation env is missing or the injection regressed")


def gang_launch_configs(cluster, placed_pods,
                        coordinator_port: int = 8476) -> List[LaunchConfig]:
    """One LaunchConfig per gang worker, from a ``schedule_gang`` result:
    runs each pod's container allocation on *cluster* (any object with
    ``allocate(pod_name) -> {container: (mounts, devices, env)}``, such as
    the scheduler's ``Cluster``). Gang rank = position in the placed list,
    not the host's worker id (a partial-slice gang's host indices are not
    contiguous)."""
    hosts = [p.node_name for p in placed_pods]
    configs: List[LaunchConfig] = []
    for rank, pod in enumerate(placed_pods):
        results = cluster.allocate(pod.name)
        env = select_device_env([cand for _, _, cand in results.values()])
        configs.append(launch_config(env, hosts, rank=rank,
                                     coordinator_port=coordinator_port))
    return configs


def initialize_distributed(config: Optional[LaunchConfig], backend: str,
                           local_rank: int = 0,
                           timeout_s: float = 600.0) -> None:
    """Join the gang's process group as local rank *local_rank* of this
    worker, over *backend* ("nccl" or "gloo"); a no-op for a one-rank
    gang. A peer that never arrives, or a collective that never
    completes, raises after *timeout_s* instead of hanging."""
    if config is None or config.world_size() <= 1:
        return
    import torch.distributed as dist

    dist.init_process_group(timeout=datetime.timedelta(seconds=timeout_s),
                            **config.initialize_kwargs(backend, local_rank))


def run_gang_worker(config: Optional[LaunchConfig], backend: str,
                    device=None, local_rank: int = 0,
                    seed: int = 0) -> Dict[str, object]:
    """The inside-the-container body of one gang rank: join the process
    group, then run ONE data-parallel train step over a ``{"dp": world}``
    mesh. Every rank contributes its own batch shard (seeded by its rank)
    to the global batch and the loss is the global mean, so a finite loss,
    identical on every rank, proves the env contract end to end
    (coordinator reachability, rank order, device visibility). *device*:
    the rank's card (``cuda:<local device id>``) by default, or "cpu".
    Returns the JAX package's report, {"process_index": the worker's gang
    rank, "process_count": the gang size, "global_devices": the world's
    ranks, "loss"}, with this rank's "rank" and the "backend"."""
    import torch
    import torch.distributed as dist

    from kubetpu_torch.jobs.meshjob import make_mesh
    from kubetpu_torch.jobs.model import ModelConfig, resolve_device
    from kubetpu_torch.jobs.train import init_state, make_train_step

    if device is None and config is not None and config.local_device_ids:
        device = f"cuda:{config.local_device_ids[local_rank]}"
    device = resolve_device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    initialize_distributed(config, backend, local_rank)
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    cfg = ModelConfig(vocab=128, d_model=64, n_layers=2, n_heads=4,
                      d_ff=128, max_seq=64)
    mesh = make_mesh({"dp": world}, device=device) if world > 1 else None
    gen = torch.Generator(device=device).manual_seed(seed)
    state, opt = init_state(gen, cfg, device=device, mesh=mesh)
    step = make_train_step(cfg, opt, attention="dense", device=device,
                           mesh=mesh)
    # every rank's shard, seeded by rank: rank r's rows are shard r
    shards = [np.random.default_rng(seed + 1 + r).integers(
        0, cfg.vocab, (1, 32)) for r in range(world)]
    tokens = np.concatenate(shards)
    state, loss = step(state, tokens, np.roll(tokens, -1, axis=1))
    loss = float(loss)
    if not np.isfinite(loss):  # not assert: python -O must not skip this
        raise RuntimeError(f"non-finite gang loss {loss}")
    return {"process_index": 0 if config is None else config.process_id,
            "process_count": 1 if config is None else config.num_processes,
            "global_devices": world, "rank": rank, "backend": backend,
            "loss": loss}


# a gang member's wall-clock limit for all its local ranks' reports (the
# launcher's shared deadline is usually the shorter one)
MEMBER_TIMEOUT_S = 600.0


def _member_rank(config, backend, device, local_rank, seed, q) -> None:
    """One local rank of a gang member, in a process of its own: its
    ``run_gang_worker`` report (or its failure) goes to *q*."""
    try:
        q.put((local_rank, run_gang_worker(config, backend, device=device,
                                           local_rank=local_rank,
                                           seed=seed)))
    except BaseException as e:
        q.put((local_rank, {"error": f"{type(e).__name__}: {e}"}))
        raise


def run_gang_member(config: LaunchConfig, backend: str, device=None,
                    seed: int = 0) -> Dict:
    """One gang member, the port's idiom of one process a device: a member
    that names n devices runs its n local ranks, each in a process of its
    own (one runs here when n is 1), and reports once, as the JAX
    package's worker does: its gang rank, the gang size, the world's ranks
    and the all-reduced loss, which every local rank must agree on. A
    local rank that fails, or a member past ``MEMBER_TIMEOUT_S``, raises; every
    process it starts is stopped. *device*: "cpu", or None for each local
    rank's ``cuda:<local device id>``."""
    import multiprocessing as mp
    import queue
    import time

    n = config.ranks_per_process()
    if n == 1:
        reports = [run_gang_worker(config, backend, device=device,
                                   seed=seed)]
    else:
        ctx = mp.get_context("spawn")
        q = ctx.Queue()
        procs = [ctx.Process(target=_member_rank,
                             args=(config, backend, device, i, seed, q),
                             daemon=True) for i in range(n)]
        for p in procs:
            p.start()
        got: Dict[int, dict] = {}
        deadline = time.monotonic() + MEMBER_TIMEOUT_S
        try:
            while len(got) < n and time.monotonic() < deadline:
                try:
                    i, rep = q.get(timeout=0.5)
                except queue.Empty:
                    if any(p.exitcode not in (None, 0) for p in procs):
                        break
                    continue
                got[i] = rep
        finally:
            for p in procs:
                p.join(timeout=max(0.1, deadline - time.monotonic())
                       if len(got) == n else 0.1)
                if p.is_alive():
                    p.kill()
                    p.join()
        errors = [f"local rank {i}: {got[i]['error']}" for i in sorted(got)
                  if "error" in got[i]]
        missing = sorted(set(range(n)) - set(got))
        if missing:
            errors.append(f"local ranks {missing}: no report (exit codes "
                          f"{[p.exitcode for p in procs]})")
        if errors:
            raise RuntimeError("gang member failed: " + "; ".join(errors))
        reports = [got[i] for i in range(n)]
    losses = {r["loss"] for r in reports}
    if len(losses) != 1:
        raise RuntimeError(f"local ranks disagree on the all-reduced loss: "
                           f"{sorted(losses)}")
    return {"process_index": config.process_id,
            "process_count": config.num_processes,
            "global_devices": config.world_size(), "loss": reports[0]["loss"],
            "backend": backend, "local_ranks": n,
            "ranks": [r["rank"] for r in reports]}
