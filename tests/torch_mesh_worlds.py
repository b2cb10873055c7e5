"""Worlds of gloo ranks on the CPU for the port's multi-device tests.

``spawn(name, world, tmp_path, payload)`` starts *world* fresh
interpreters, each one rank of a gloo process group joined through a
``file://`` store under *tmp_path*, runs the worker *name* of this module
on *payload* (numpy arrays and plain values, pickled) and returns every
rank's result, in rank order. A payload with ``device="cuda"`` puts every
rank on ``cuda:0`` (the card tests' one-card world). A rank that fails, or a world that outlives
its time limit, fails the call with the ranks' output.

This module imports neither jax nor kubetpu (the ranks run the port
alone; each result carries the foreign modules its rank had loaded, which
the tests hold empty), and no test collects it.
"""

from __future__ import annotations

import os
import pickle
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def spawn(name: str, world: int, tmp_path, payload, timeout: float = 240.0,
          init: bool = True):
    """Run worker *name* on *world* ranks -> their results, rank order.
    ``init=False`` leaves joining the process group to the worker (the
    gang launch does its own)."""
    tmp = str(tmp_path)
    os.makedirs(tmp, exist_ok=True)
    with open(os.path.join(tmp, "payload.pkl"), "wb") as f:
        pickle.dump(payload, f)
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = []
    for rank in range(world):
        log = open(os.path.join(tmp, f"rank{rank}.log"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), name, str(rank),
             str(world), tmp, str(int(init))],
            cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT), log))
    deadline = time.time() + timeout
    for p, _log in procs:
        try:
            p.wait(timeout=max(1.0, deadline - time.time()))
        except subprocess.TimeoutExpired:
            pass
    for p, log in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
        log.close()
    codes = [p.returncode for p, _ in procs]
    if codes != [0] * world:
        logs = "".join(open(os.path.join(tmp, f"rank{r}.log")).read()[-3000:]
                       for r in range(world))
        raise RuntimeError(f"world {name!r} exit codes {codes}:\n{logs}")
    out = []
    for rank in range(world):
        with open(os.path.join(tmp, f"result{rank}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


# -- the workers (each runs on every rank of its world) -----------------------


def _cfg(kw):
    from kubetpu_torch.jobs.model import ModelConfig

    return ModelConfig(**kw)


def _block(x, mesh, axis: str, dim: int):
    """This rank's block of numpy *x* along *dim* over mesh *axis*."""
    from kubetpu_torch.jobs import collectives as col

    n, i = col.axis_size(mesh, axis), col.axis_index(mesh, axis)
    size = x.shape[dim] // n
    index = [slice(None)] * x.ndim
    index[dim] = slice(i * size, (i + 1) * size)
    return x[tuple(index)]


def _flash_counts():
    from kubetpu_torch.ops import flash_attention as fa

    return {"forward": fa.flash_forward.launches,
            "dq": fa.flash_backward.dq_launches,
            "dkv": fa.flash_backward.dkv_launches}


def ring(payload):
    """Every ring case of the payload on a {"sp": world} mesh on the
    payload's device (the CPU by default): this rank's block of the output
    and of the gradients of sum(out * cot), and the flash launches."""
    import torch

    from kubetpu_torch.jobs.meshjob import make_mesh
    from kubetpu_torch.jobs.ring_attention import make_ring_attention

    device = payload.get("device", "cpu")
    mesh = make_mesh({"sp": payload["world"]}, device=device)
    results = []
    for case in payload["cases"]:
        q, k, v, cot = (torch.from_numpy(np.ascontiguousarray(
            _block(case[n], mesh, "sp", 1))).to(
                device, getattr(torch, case.get("dtype", "float32")))
            for n in ("q", "k", "v", "cot"))
        q, k, v = (t.requires_grad_(True) for t in (q, k, v))
        core = make_ring_attention(mesh, impl=case["impl"],
                                   causal=case["causal"],
                                   window=case["window"])
        before = _flash_counts()
        out = core(q, k, v)
        grads = torch.autograd.grad((out * cot).sum(), (q, k, v))
        launches = {k: n - before[k] for k, n in _flash_counts().items()}
        results.append({"out": out.detach().float().cpu().numpy(),
                        "grads": [g.float().cpu().numpy() for g in grads],
                        "launches": launches})
    if "encoder" in payload:
        results.append(_encoder(payload["encoder"], mesh))
    return results


def _encoder(case, mesh):
    """encoder_forward on this rank's block under the bidirectional ring,
    RoPE at the block's global positions."""
    import torch

    from kubetpu_torch.jobs import collectives as col
    from kubetpu_torch.jobs.convert import params_from_numpy
    from kubetpu_torch.jobs.encoder import encoder_forward
    from kubetpu_torch.jobs.ring_attention import make_ring_attention

    cfg = _cfg(case["cfg"])
    params = params_from_numpy(case["params"], cfg, device="cpu")
    tokens = torch.from_numpy(_block(case["tokens"], mesh, "sp", 1)).long()
    s = tokens.shape[1]
    first = col.axis_index(mesh, "sp") * s
    positions = torch.arange(first, first + s, dtype=torch.int32)
    ring = make_ring_attention(mesh, causal=False)
    return {"logits": encoder_forward(params, tokens, cfg, attn_fn=ring,
                                      positions=positions).numpy()}


def _mesh(spec, device="cpu"):
    from kubetpu_torch.jobs.meshjob import make_mesh, make_multislice_mesh

    axes = dict(spec)
    if "dcn" in axes:
        return make_multislice_mesh(axes, device=device)
    return make_mesh(axes, device=device)


def train(payload):
    """Each case: the sharded step on its mesh from the payload's weights
    (``convert.shard_params``) -> step losses and the gathered weights."""
    import torch

    from kubetpu_torch.jobs import collectives as col
    from kubetpu_torch.jobs import train as ttrain
    from kubetpu_torch.jobs.convert import gather_params, shard_params

    device = payload.get("device", "cpu")
    results = []
    for case in payload["cases"]:
        cfg = _cfg(case["cfg"])
        mesh = _mesh(case["mesh"], device)
        opt = ttrain.make_optimizer(**case.get("opt", {}))
        params = shard_params(case["params"], cfg, mesh, device=device)
        if case.get("plant_inf") and col.axis_index(mesh, "tp") == 1:
            with torch.no_grad():     # one tp rank's head shard only
                params.head[0, 0] = float("inf")
        state = ttrain.state_from_params(params, opt)
        probe = None
        if case.get("probe"):
            groups = col.MeshGroups(mesh)
            probe = _grad_probe(case, cfg, mesh, state.params, device,
                                ttrain._mesh_loss_fn(
                                    cfg, ttrain._resolve_attention(
                                        case["attention"], cfg.window, mesh),
                                    groups),
                                ttrain.grad_sync(cfg, groups))
        step = ttrain.make_train_step(
            cfg, opt, attention=case["attention"],
            accum_steps=case.get("accum_steps", 1),
            skip_nonfinite=case.get("skip_nonfinite", False),
            weighted="weights" in case, device=device, mesh=mesh)
        col.reset_counters()
        before = _flash_counts()
        losses = []
        for batch in case["batches"]:
            state, loss = step(state, *batch)
            losses.append(float(loss))
        results.append({"losses": losses,
                        "params": gather_params(state.params, cfg, mesh),
                        "count": int(state.opt_state.count),
                        "launches": {k: n - before[k] for k, n in
                                     _flash_counts().items()},
                        "staged_bytes": col.stage_through_host.bytes,
                        "axis_bytes": dict(col.axis_bytes),
                        "probe": probe})
    return results


def _grad_probe(case, cfg, mesh, params, device, loss_fn, sync,
                pp=False):
    """The gradient a sharded step hands its optimizer for the case's
    first batch at the initial weights (*loss_fn*'s gradient summed by
    *sync*, the step's ``GradSync``), gathered into the whole model's
    tree, and the clip's global norm (``GradSync.sq_norm``)."""
    import torch

    from kubetpu_torch.jobs import train as ttrain
    from kubetpu_torch.jobs.convert import gather_params, shard_params

    tokens, targets, *weights = case["batches"][0]
    batch = [torch.as_tensor(tokens).to(device, torch.int64),
             torch.as_tensor(targets).to(device, torch.int64),
             *(torch.as_tensor(w).to(device, torch.float32)
               for w in weights)]
    leaves = ttrain._trained_leaves(params)
    grads = sync.reduce(list(torch.autograd.grad(loss_fn(params, *batch),
                                                 leaves)))
    norm = float(torch.sqrt(sync.sq_norm(grads)))
    holder = shard_params(case["params"], cfg, mesh, device=device, pp=pp)
    with torch.no_grad():
        for p, g in zip(holder.parameters(), grads):
            p.copy_(g)
    return {"grads": gather_params(holder, cfg, mesh, pp=pp), "norm": norm}


def pipeline(payload):
    """Each case: the pipelined forward's logits (this rank's block) or
    the pipelined step's losses and gathered weights, and the gradient
    probe (``_grad_probe``) at the initial weights."""
    from kubetpu_torch.jobs import collectives as col
    from kubetpu_torch.jobs import pipeline as tpipe
    from kubetpu_torch.jobs import train as ttrain
    from kubetpu_torch.jobs.convert import gather_params, shard_params

    results = []
    for case in payload["cases"]:
        cfg = _cfg(case["cfg"])
        mesh = _mesh(case["mesh"])
        params = shard_params(case["params"], cfg, mesh, device="cpu",
                              pp=True)
        if case["kind"] == "forward":
            fwd = tpipe.make_pipeline_forward(
                cfg, mesh, case["microbatches"], ring_impl=case["impl"],
                device="cpu")
            results.append({"logits": fwd(params, case["tokens"]).numpy()})
            continue
        opt = ttrain.make_optimizer(**case.get("opt", {}))
        state = ttrain.state_from_params(params, opt)
        groups = col.MeshGroups(mesh)
        probe = _grad_probe(case, cfg, mesh, state.params, "cpu",
                            tpipe.pipeline_loss_fn(
                                cfg, groups, case["microbatches"],
                                ring_impl=case["impl"]),
                            ttrain.grad_sync(cfg, groups, pp=True), pp=True)
        step = tpipe.make_pipeline_train_step(
            cfg, mesh, case["microbatches"], opt, ring_impl=case["impl"],
            device="cpu")
        losses = []
        for tokens, targets in case["batches"]:
            state, loss = step(state, tokens, targets)
            losses.append(float(loss))
        results.append({"losses": losses, "probe": probe,
                        "params": gather_params(state.params, cfg, mesh,
                                                pp=True)})
    return results


def meshes(payload):
    """Each mesh spec built over the world: its rank grid, axis names, and
    this rank's sub-group of every axis (global ranks)."""
    import torch.distributed as dist

    from kubetpu_torch.jobs import meshjob

    out = []
    for kind, args in payload["meshes"]:
        mesh = getattr(meshjob, kind)(*args, device="cpu")
        out.append({"grid": mesh.mesh.tolist(),
                    "names": tuple(mesh.mesh_dim_names),
                    "groups": {n: dist.get_process_group_ranks(
                        mesh.get_group(n)) for n in mesh.mesh_dim_names}})
    return out


def gang(payload):
    """``launch.run_gang_worker`` with a config of one local rank a
    process over a tcp coordinator (it joins the group itself)."""
    from kubetpu_torch.jobs.launch import LaunchConfig, run_gang_worker

    cfg = LaunchConfig(payload["coordinator"], payload["world"],
                       payload["rank"], [])
    return run_gang_worker(cfg, "gloo", device="cpu", seed=payload["seed"])


def _main(argv) -> None:
    name, rank, world, tmp, init = (argv[0], int(argv[1]), int(argv[2]),
                                    argv[3], bool(int(argv[4])))
    import datetime

    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    with open(os.path.join(tmp, "payload.pkl"), "rb") as f:
        payload = pickle.load(f)
    payload = dict(payload, rank=rank, world=world)
    if payload.get("device", "cpu") != "cpu":
        torch.cuda.set_device(0)     # every rank of a one-card world
    if init:
        dist.init_process_group(
            "gloo", init_method=f"file://{os.path.join(tmp, 'store')}",
            world_size=world, rank=rank,
            timeout=datetime.timedelta(seconds=120))
    result = globals()[name](payload)
    foreign = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "kubetpu"))
    if isinstance(result, dict):
        result = dict(result, foreign=foreign)
    else:
        result = {"cases": result, "foreign": foreign}
    with open(os.path.join(tmp, f"result{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)
    if dist.is_initialized():
        dist.destroy_process_group()


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    _main(sys.argv[1:])
