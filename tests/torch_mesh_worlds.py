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


class MeshStub:
    """Stands in for a DeviceMesh where only its axes and their sizes are
    read (``train.check_mesh``): ``MeshStub(tp=3)``."""

    def __init__(self, **axes) -> None:
        self.mesh_dim_names = tuple(axes)
        self._sizes = tuple(axes.values())

    def size(self, dim: int) -> int:
        return self._sizes[dim]


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


def _servers():
    from kubetpu_torch.jobs import multi_lora, paged, serving, spec_serving

    return {"dense": serving.DecodeServer,
            "paged": paged.PagedDecodeServer,
            "spec": spec_serving.PagedSpeculativeDecodeServer,
            "lora_dense": multi_lora.MultiLoraDecodeServer,
            "lora_paged": multi_lora.PagedMultiLoraDecodeServer}


def build_server(case, models, mesh, device):
    """The case's server (``case["kind"]`` of ``_servers``) over *models*
    (``port_models``) on *mesh* (None: one device)."""
    from kubetpu_torch.jobs.lora import LoraConfig
    from kubetpu_torch.jobs.multi_lora import stack_adapters

    kind, kw = case["kind"], dict(case["kw"], device=device, mesh=mesh)
    cls = _servers()[kind]
    cfg, params = models["cfg"], models["params"]
    if kind == "spec":
        return cls(cfg, models["dcfg"], params, models["draft"], **kw)
    if kind.startswith("lora"):
        lcfg = LoraConfig(**models["lcfg"])
        ads = models["adapters"]
        if kind == "lora_dense":
            return cls(cfg, params, lcfg, stack_adapters(lcfg, ads), **kw)
        return cls(cfg, params, lcfg, ads, **kw)
    return cls(cfg, params, **kw)


def staggered(server, case):
    """``_dryrun_serving``'s lifecycle: two requests submitted (or
    enqueued), one step, a third enqueued, drain -> the results in order
    and each step's emissions."""
    prompts, picks = case["prompts"], case.get("picks")
    extra = [] if picks is None else [{"adapter": a} for a in picks]
    extra = extra or [{}] * len(prompts)
    put = server.submit if case.get("submit", True) else server.enqueue
    rids = [put(p, **x) for p, x in zip(prompts[:2], extra[:2])]
    steps = [server.step()]
    rids.append(server.enqueue(prompts[2], **extra[2]))
    while not server._idle():
        steps.append(server.step())
    return {"tokens": [server.result(r) for r in rids],
            "steps": [{int(k): v for k, v in st.items()} for st in steps]}


def port_models(payload, device):
    """The payload's numpy trees as the port's models on *device*."""
    from kubetpu_torch.jobs.convert import lora_from_numpy, params_from_numpy

    cfg = _cfg(payload["cfg"])
    out = {"cfg": cfg,
           "params": params_from_numpy(payload["params"], cfg,
                                       device=device)}
    if "draft" in payload:
        out["dcfg"] = _cfg(payload["dcfg"])
        out["draft"] = params_from_numpy(payload["draft"], out["dcfg"],
                                         device=device)
    if "adapters" in payload:
        out["lcfg"] = payload["lcfg"]
        out["adapters"] = [lora_from_numpy(a, device=device)
                           for a in payload["adapters"]]
    return out


def serve_case(case, models, mesh, device):
    """One serving case -> its results: a server's staggered lifecycle,
    a snapshot of a decoding slot (then the server's continuation), or
    ``make_generate``'s tokens."""
    import dataclasses

    import torch

    from kubetpu_torch.jobs.decode import make_generate

    if case["kind"] == "generate":
        cfg = dataclasses.replace(models["cfg"], window=case["window"])
        gen = make_generate(cfg, mesh=mesh)
        out = gen(models["params"], torch.from_numpy(np.array(
            case["prompt"], np.int64)).to(device), case["seed"],
            case["steps"])
        return {"tokens": out.cpu().numpy()}
    server = build_server(case, models, mesh, device)
    if case.get("snapshot"):
        rid = server.submit(case["prompts"][0])
        for _ in range(case["snapshot"]):
            server.step()
        snap = server.snapshot_slot(rid)
        server.drain()
        return {"snap": snap, "tokens": [server.result(rid)]}
    out = staggered(server, case)
    server.check_lockstep()
    if hasattr(server, "check_invariants"):
        server.check_invariants()
        out["prefix_hits"] = server.prefix_cache_stats().get(
            "requests_hit", 0)
    return out


def _paged_counts():
    from kubetpu_torch.ops import paged_attention as pa

    return {c: getattr(pa.paged_attention, c) for c in (
        "split_launches", "combine_launches", "wgmma_launches",
        "wgmma_int8_launches", "simt_launches")}


def serving(payload):
    """Every serving case of the payload on its mesh (dp x tp): each
    case's ``serve_case`` results on this rank, with the paged kernels'
    launches during it (nonzero only on the card)."""
    device = payload.get("device", "cpu")
    mesh = _mesh(payload["mesh"], device)
    models = port_models(payload, device)
    out = {}
    for case in payload["cases"]:
        before = _paged_counts()
        out[case["name"]] = serve_case(case, models, mesh, device)
        out[case["name"]]["launches"] = {
            k: n - before[k] for k, n in _paged_counts().items()}
    return out


def _prefetch(case, device="cpu"):
    """``prefetch_to_mesh`` over the case's batches on its mesh: the
    blocks it yields and ``local_batch``'s blocks of the same batches."""
    from kubetpu_torch.jobs.data import prefetch_to_mesh
    from kubetpu_torch.jobs.train import local_batch

    mesh = _mesh(case["mesh"], device)
    got = [[t.cpu().numpy() for t in b] for b in prefetch_to_mesh(
        iter(case["batches"]), mesh, depth=case.get("depth", 2),
        device=device)]
    want = [[np.asarray(local_batch(np.asarray(x), mesh)) for x in b]
            for b in case["batches"]]
    return {"got": got, "want": want}


def _prefetched_step(case, device="cpu"):
    """The sharded step fed by ``prefetch_to_mesh`` -> its losses."""
    from kubetpu_torch.jobs import train as ttrain
    from kubetpu_torch.jobs.convert import shard_params
    from kubetpu_torch.jobs.data import prefetch_to_mesh

    cfg = _cfg(case["cfg"])
    mesh = _mesh(case["mesh"], device)
    opt = ttrain.make_optimizer(**case.get("opt", {}))
    state = ttrain.state_from_params(
        shard_params(case["params"], cfg, mesh, device=device), opt)
    step = ttrain.make_train_step(cfg, opt, attention=case["attention"],
                                  device=device, mesh=mesh)
    losses = []
    for tokens, targets in prefetch_to_mesh(iter(case["batches"]), mesh,
                                            device=device):
        state, loss = step(state, tokens, targets)
        losses.append(float(loss))
    return losses


def moe_ep(payload):
    """The expert-axis cases: the sharded steps (``train``), the
    pipelined ones (``pipeline``), ``prefetch_to_mesh``'s blocks and the
    step it feeds."""
    return {"train": train(dict(payload, cases=payload["train"])),
            "pipeline": pipeline(dict(payload, cases=payload["pipeline"])),
            "prefetch": [_prefetch(c) for c in payload["prefetch"]],
            "prefetched_step": _prefetched_step(payload["prefetched_step"])}


def lora_train(payload):
    """The sharded LoRA step from the payload's base and adapter: each
    step's loss, the adapter gathered whole after the steps, and the
    gradient ``lora_grad_sync`` hands the optimizer at the first batch
    (gathered) with its global norm."""
    import torch

    from kubetpu_torch.jobs import collectives as col
    from kubetpu_torch.jobs import lora as tlora
    from kubetpu_torch.jobs import train as ttrain
    from kubetpu_torch.jobs.convert import lora_from_numpy, shard_params

    cfg = _cfg(payload["cfg"])
    lcfg = tlora.LoraConfig(**payload["lcfg"])
    mesh = _mesh(payload["mesh"])
    base = shard_params(payload["params"], cfg, mesh, device="cpu")
    lora = tlora.shard_lora(lora_from_numpy(payload["lora"], device="cpu"),
                            mesh)
    for v in lora["blocks"].values():
        v.requires_grad_(True)
    opt = ttrain.make_optimizer(**payload.get("opt", {}))
    state = ttrain.TrainState(lora, opt.init(ttrain._trained_leaves(lora)))

    def whole(tree):
        out = {}
        for k, v in tree["blocks"].items():
            spec = tlora._leaf_spec(k)
            t = v.detach()
            if "tp" in spec:
                t = col.all_gather(t, col.group_of(mesh, "tp"), "gather",
                                   spec.index("tp"))
            out[k] = t.float().numpy()
        return {"blocks": out}

    attn = ttrain._resolve_attention(payload["attention"], cfg.window, mesh)
    mesh_loss = ttrain._mesh_loss_fn(cfg, attn, col.groups_of(mesh))
    sync = tlora.lora_grad_sync(lora, mesh)
    tokens, targets = (torch.as_tensor(x).long()
                       for x in payload["batches"][0])
    leaves = ttrain._trained_leaves(lora)
    grads = sync.reduce(list(torch.autograd.grad(mesh_loss(
        tlora._merged_view(base, lora, lcfg), tokens, targets), leaves)))
    norm = float(torch.sqrt(sync.sq_norm(grads)))
    probe = whole({"blocks": dict(zip(sorted(lora["blocks"]), grads))})
    step = tlora.make_lora_train_step(cfg, lcfg, opt,
                                      attention=payload["attention"],
                                      device="cpu", mesh=mesh)
    before = _flash_counts()
    losses = []
    for batch in payload["batches"]:
        state, loss = step(state, base, *batch)
        losses.append(float(loss))
    return {"losses": losses, "lora": whole(state.params),
            "probe": {"grads": probe, "norm": norm},
            "launches": {k: n - before[k] for k, n in
                         _flash_counts().items()}}


# -- the other families on a mesh (tests/test_torch_mesh_families.py) ---------


def _probe(loss_fn, sync, params, batch, gather):
    """The gradient a sharded family step hands its optimizer at *params*
    on *batch* (*loss_fn*'s gradient summed by *sync*), gathered whole by
    *gather* (a function of a shard-shaped module), and the clip's global
    norm (``GradSync.sq_norm``)."""
    import copy

    import torch

    leaves = list(params.parameters())
    grads = sync.reduce(list(torch.autograd.grad(loss_fn(params, *batch),
                                                 leaves)))
    norm = float(torch.sqrt(sync.sq_norm(grads)))
    holder = copy.deepcopy(params)
    with torch.no_grad():
        for p, g in zip(holder.parameters(), grads):
            p.copy_(g)
    return {"grads": gather(holder), "norm": norm}


def _steps(step, state, batches, *extra):
    losses = []
    for batch in batches:
        state, loss = step(state, *extra, *batch)
        losses.append(float(loss))
    return state, losses


def _vit_cfg(kw):
    from kubetpu_torch.jobs.vision import VitConfig

    kw = dict(kw)
    return VitConfig(model=_cfg(kw.pop("model")), **kw)


def _fam_mlm(case, device):
    """The sharded masked-LM step: losses, weights after, the probe, and
    the probe under the sync that also sums over sp (the planted fault)."""
    import torch

    from kubetpu_torch.jobs import collectives as col
    from kubetpu_torch.jobs import encoder
    from kubetpu_torch.jobs import train as ttrain
    from kubetpu_torch.jobs.convert import gather_params, shard_params

    cfg, mesh = _cfg(case["cfg"]), _mesh(case["mesh"], device)
    opt = ttrain.make_optimizer(**case["opt"])
    state = ttrain.state_from_params(
        shard_params(case["params"], cfg, mesh, device=device), opt)
    attn = encoder.bidirectional_attention(case["attention"], "encoder")
    loss_fn, sync = encoder.mlm_mesh_parts(cfg, case["mask_id"], attn, mesh)
    tokens, mask = case["batches"][0]
    batch = (torch.as_tensor(tokens).long().to(device),
             torch.as_tensor(mask).bool().to(device))
    gather = lambda m: gather_params(m, cfg, mesh)          # noqa: E731
    probe = _probe(loss_fn, sync, state.params, batch, gather)
    fault = _probe(loss_fn, ttrain.grad_sync(cfg, col.groups_of(mesh)),
                   state.params, batch, gather)["norm"]
    step = encoder.make_mlm_train_step(cfg, case["mask_id"], opt,
                                       attention=case["attention"],
                                       mesh=mesh, device=device)
    state, losses = _steps(step, state, case["batches"])
    return {"losses": losses, "params": gather(state.params),
            "probe": probe, "fault_norm": fault}


def _fam_vit(case, device):
    import torch

    from kubetpu_torch.jobs import encoder, vision
    from kubetpu_torch.jobs import train as ttrain
    from kubetpu_torch.jobs.convert import gather_vit_params, shard_vit_params

    cfg, mesh = _vit_cfg(case["cfg"]), _mesh(case["mesh"], device)
    opt = ttrain.make_optimizer(**case["opt"])
    state = ttrain.state_from_params(
        shard_vit_params(case["params"], cfg, mesh, device=device), opt)
    attn = encoder.bidirectional_attention(case["attention"], "vit")
    loss_fn, sync = vision.vit_mesh_parts(cfg, attn, mesh)
    images, labels = case["batches"][0]
    batch = (torch.as_tensor(images).float().to(device),
             torch.as_tensor(labels).long().to(device))
    gather = lambda m: gather_vit_params(m, cfg, mesh)      # noqa: E731
    probe = _probe(loss_fn, sync, state.params, batch, gather)
    step = vision.make_vit_train_step(cfg, opt, attention=case["attention"],
                                      mesh=mesh, device=device)
    state, losses = _steps(step, state, case["batches"])
    return {"losses": losses, "params": gather(state.params),
            "probe": probe}


def _fam_seq2seq(case, device):
    import torch

    from kubetpu_torch.jobs import seq2seq
    from kubetpu_torch.jobs import train as ttrain
    from kubetpu_torch.jobs.convert import (gather_seq2seq_params,
                                            shard_seq2seq_params)

    cfg, mesh = _cfg(case["cfg"]), _mesh(case["mesh"], device)
    opt = ttrain.make_optimizer(**case["opt"])
    state = ttrain.state_from_params(
        shard_seq2seq_params(case["params"], cfg, mesh, device=device), opt)
    loss_fn, sync = seq2seq.seq2seq_mesh_parts(cfg, mesh)
    batch = tuple(torch.as_tensor(x).long().to(device)
                  for x in case["batches"][0])
    gather = lambda m: gather_seq2seq_params(m, cfg, mesh)  # noqa: E731
    probe = _probe(loss_fn, sync, state.params, batch, gather)
    step = seq2seq.make_seq2seq_train_step(
        cfg, opt, accum_steps=case["accum_steps"], mesh=mesh, device=device)
    state, losses = _steps(step, state, case["batches"])
    return {"losses": losses, "params": gather(state.params),
            "probe": probe}


def _fam_distill(case, device):
    import torch

    from kubetpu_torch.jobs import collectives as col
    from kubetpu_torch.jobs import distill
    from kubetpu_torch.jobs import train as ttrain
    from kubetpu_torch.jobs.convert import gather_params, shard_params

    tcfg, dcfg = _cfg(case["tcfg"]), _cfg(case["dcfg"])
    mesh = _mesh(case["mesh"], device)
    target = shard_params(case["target"], tcfg, mesh, device=device)
    opt = ttrain.make_optimizer(**case["opt"])
    state = ttrain.state_from_params(
        shard_params(case["draft"], dcfg, mesh, device=device), opt)
    kw = dict(temperature=case["temperature"],
              hard_weight=case["hard_weight"])
    attention = "ring_flash" if col.axis_size(mesh, "sp") > 1 else "flash"
    teacher, loss_fn, sync = distill.distill_mesh_parts(
        tcfg, dcfg, kw["temperature"], kw["hard_weight"], mesh, attention)
    tokens, targets = (torch.as_tensor(x).long().to(device)
                       for x in case["batches"][0])
    gather = lambda m: gather_params(m, dcfg, mesh)          # noqa: E731
    probe = _probe(loss_fn, sync, state.params,
                   (tokens, targets, teacher(target, tokens)), gather)
    step, _ = distill.make_distill_step(tcfg, dcfg, opt, device=device,
                                        mesh=mesh, **kw)
    state, losses = _steps(step, state, case["batches"], target)
    return {"losses": losses, "params": gather(state.params),
            "probe": probe}


def _fam_beam(case, device):
    """Beam search on the mesh from the whole model and from its shard."""
    import torch

    from kubetpu_torch.jobs import beam
    from kubetpu_torch.jobs.convert import params_from_numpy, shard_params

    cfg, mesh = _cfg(case["cfg"]), _mesh(case["mesh"], device)
    search = beam.make_beam_search(cfg, case["k"], mesh=mesh,
                                   device=device, **case["kw"])
    prompt = torch.as_tensor(case["prompt"]).long()
    out = {}
    for name, model in (
            ("whole", params_from_numpy(case["params"], cfg, device=device)),
            ("shard", shard_params(case["params"], cfg, mesh,
                                   device=device))):
        seq, scores = search(model, prompt, case["steps"])
        out[name] = {"seq": seq.cpu().numpy(),
                     "scores": scores.cpu().numpy()}
    return out


def _same_as_cut(local, whole, specs, mesh, first_layer=0) -> list:
    """The names of *local*'s leaves that differ, bit for bit, from this
    rank's cut of *whole*'s."""
    from kubetpu_torch.jobs import train as ttrain

    wholes = dict(whole.named_parameters())
    return [name for name, p in local.named_parameters()
            if not torch_equal(p, ttrain._take(
                wholes[ttrain.global_name(name, first_layer)],
                ttrain.local_spec(specs, name), mesh))]


def torch_equal(a, b) -> bool:
    import torch

    return a.shape == b.shape and a.dtype == b.dtype and bool(
        torch.equal(a.detach(), b.detach()))


def _fam_init(case, device):
    """Every sharded init against cutting the whole model of the same seed
    (the names of the leaves that differ), and ``shard_model`` of a shard
    returning it as it is."""
    import torch

    from kubetpu_torch.jobs import pipeline as tpipe
    from kubetpu_torch.jobs import seq2seq, vision
    from kubetpu_torch.jobs import train as ttrain
    from kubetpu_torch.jobs.hf_import import params_from_hf
    from kubetpu_torch.jobs.model import init_params

    def gen():
        return torch.Generator(device=device).manual_seed(case["seed"])

    out = {}
    for name, kw, axes, pp in case["models"]:
        cfg, mesh = _cfg(kw), _mesh(axes, device)
        if pp:
            local = tpipe.init_pipeline_state(gen(), cfg, mesh,
                                              device=device)[0].params
        else:
            local = ttrain.init_state(gen(), cfg, device=device,
                                      mesh=mesh)[0].params
        whole = init_params(gen(), cfg, device)
        cut = ttrain.shard_model(whole, cfg, mesh, pp)
        out[name] = {
            "differ": _same_as_cut(local, whole, ttrain.param_specs(cfg, pp),
                                   mesh, ttrain.stage_layers(cfg,
                                                             mesh).start),
            "differ_cut": [n for (n, a), b in zip(
                local.named_parameters(), cut.parameters())
                if not torch_equal(a, b)],
            "kept": ttrain.shard_model(local, cfg, mesh, pp) is local}
    vcfg, mesh = _vit_cfg(case["vit"]), _mesh(case["vit_mesh"], device)
    out["vit"] = {"differ": _same_as_cut(
        vision.init_vit_state(gen(), vcfg, mesh=mesh, device=device)[0]
        .params, vision.init_vit_params(gen(), vcfg, device),
        vision.vit_param_specs(vcfg), mesh)}
    scfg, mesh = _cfg(case["seq2seq"]), _mesh(case["seq2seq_mesh"], device)
    out["seq2seq"] = {"differ": _same_as_cut(
        seq2seq.init_seq2seq_state(gen(), scfg, mesh=mesh, device=device)[0]
        .params, seq2seq.init_seq2seq_params(gen(), scfg, device),
        seq2seq.seq2seq_param_specs(scfg), mesh)}
    hcfg, mesh = _cfg(case["hf_cfg"]), _mesh(case["hf_mesh"], device)
    sd = {k: torch.from_numpy(v) for k, v in case["hf_sd"].items()}
    local, _ = params_from_hf(sd, hcfg, device=device, mesh=mesh)
    whole, _ = params_from_hf(sd, hcfg, device=device)
    out["hf"] = {"differ": _same_as_cut(local, whole,
                                        ttrain.param_specs(hcfg), mesh),
                 "kept": ttrain.shard_model(local, hcfg, mesh) is local}
    return out


def _fam_server(case, device):
    """A paged and a dense server built from ``init_shard``'s shard and
    from the whole model of the same seed: their tokens."""
    import torch

    from kubetpu_torch.jobs import train as ttrain
    from kubetpu_torch.jobs.model import init_params

    cfg, mesh = _cfg(case["cfg"]), _mesh(case["mesh"], device)
    models = {
        "whole": init_params(torch.Generator(device=device).manual_seed(
            case["seed"]), cfg, device),
        "shard": ttrain.init_shard(torch.Generator(device=device).manual_seed(
            case["seed"]), cfg, mesh, device)}
    out = {}
    for kind in ("paged", "dense"):
        for name, model in models.items():
            server = build_server(dict(case, kind=kind), {"cfg": cfg,
                                                         "params": model},
                                  mesh, device)
            out[f"{kind}_{name}"] = staggered(server, case)["tokens"]
    return out


def families(payload):
    """Each case of the payload, by its kind (``_fam_<kind>``), on this
    rank."""
    device = payload.get("device", "cpu")
    return [globals()["_fam_" + case["kind"]](case, device)
            for case in payload["cases"]]


# -- sharded checkpoints (tests/test_torch_sharded_checkpoint.py) -------------


def _state_tree(state, cfg, mesh, pp=False):
    """A meshed train state gathered whole: parameters, moments (as trees
    of the parameters' shape), count and step, on every rank; copies (a
    replicated CPU leaf's array would share the live tensor's memory)."""
    import copy

    import torch

    from kubetpu_torch.jobs.convert import gather_params

    out = {"params": gather_params(state.params, cfg, mesh, pp=pp),
           "count": int(state.opt_state.count), "step": int(state.step)}
    for which in ("mu", "nu"):
        holder = copy.deepcopy(state.params)
        with torch.no_grad():
            for p, m in zip(holder.parameters(),
                            getattr(state.opt_state, which)):
                p.copy_(m)
        out[which] = gather_params(holder, cfg, mesh, pp=pp)
    return copy.deepcopy(out)


def _ckpt_run(cfg, mesh, seed, batches, attention="ring", pp=False,
              micro=2):
    """A fresh meshed state of *seed* (a pipeline stage's under *pp*) and
    its step; the state after *batches*."""
    import torch

    from kubetpu_torch.jobs import pipeline as tpipe
    from kubetpu_torch.jobs import train as ttrain

    gen = torch.Generator().manual_seed(seed)
    opt = ttrain.make_optimizer(lr=1e-2)
    if pp:
        state, opt = tpipe.init_pipeline_state(gen, cfg, mesh, opt,
                                               device="cpu")
        step = tpipe.make_pipeline_train_step(cfg, mesh, micro, opt,
                                              device="cpu")
    else:
        state, opt = ttrain.init_state(gen, cfg, opt, device="cpu",
                                       mesh=mesh)
        step = ttrain.make_train_step(cfg, opt, attention=attention,
                                      device="cpu", mesh=mesh)
    losses = []
    for tokens, targets in batches:
        state, loss = step(state, tokens, targets)
        losses.append(float(loss))
    return state, step, losses


def checkpoint(payload):
    """Every sharded-checkpoint case of the payload: what was saved and
    what came back, each gathered whole (``_state_tree``)."""
    import os

    from kubetpu_torch.jobs import checkpoint as ckpt

    tmp = payload["dir"]
    out = {}
    for case in payload["cases"]:
        cfg, name = _cfg(case["cfg"]), case["name"]
        pp = case.get("pp", False)
        path = os.path.join(tmp, name)
        res = {}
        if "restore_from" not in case:
            mesh = _mesh(case["mesh"])
            state, step, losses = _ckpt_run(cfg, mesh, 0, case["batches"],
                                            pp=pp)
            res["losses"] = losses
            if case.get("async"):
                saver = ckpt.AsyncCheckpointer()
                saver.save(path, state)
                res["saved"] = _state_tree(state, cfg, mesh, pp)
                state, _ = step(state, *case["batches"][0])  # in place
                saver.close()
            else:
                ckpt.save_checkpoint(path, state)
                res["saved"] = _state_tree(state, cfg, mesh, pp)
        else:
            path = case["restore_from"]
        tmesh = _mesh(case.get("target_mesh", case.get("mesh")))
        tpp = case.get("target_pp", pp)
        fresh, step, _ = _ckpt_run(cfg, tmesh, 9, [], pp=tpp)
        ckpt.restore_checkpoint(path, fresh)
        res["restored"] = _state_tree(fresh, cfg, tmesh, tpp)
        if case.get("next_batch") is not None:
            _, loss = step(fresh, *case["next_batch"])
            res["next_loss"] = float(loss)
        out[name] = res
    return out


def shard_memory(payload):
    """Peak device memory (over what was allocated before) while this
    rank builds its shard: ``init_shard``'s parameters, or a meshed train
    state restored from a checkpoint the world saved first; with the
    bytes built and the model's largest whole leaf."""
    import torch

    from kubetpu_torch.jobs import checkpoint as ckpt
    from kubetpu_torch.jobs import train as ttrain
    from kubetpu_torch.jobs.model import Transformer

    device = payload["device"]
    cfg, mesh = _cfg(payload["cfg"]), _mesh(payload["mesh"], device)

    def gen(seed):
        return torch.Generator(device=device).manual_seed(seed)

    largest = max(p.numel() * p.element_size() for p in Transformer(
        cfg, torch.device("meta")).parameters())
    if payload["build"] == "restore":
        state, _ = ttrain.init_state(gen(0), cfg, device=device, mesh=mesh)
        ckpt.save_checkpoint(payload["path"], state)
        del state
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    if payload["build"] == "init":
        built = list(ttrain.init_shard(gen(0), cfg, mesh, device)
                     .parameters())
    else:
        state, _ = ttrain.init_state(gen(1), cfg, device=device, mesh=mesh)
        ckpt.restore_checkpoint(payload["path"], state)
        built = ckpt._leaves(state)
    torch.cuda.synchronize()
    return {"peak": torch.cuda.max_memory_allocated() - base,
            "built": sum(t.numel() * t.element_size() for t in built),
            "largest": largest}


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


# -- a meshed server behind the replica wire ---------------------------------


def _http(url, path, body=None, key=None, timeout=60.0):
    """(code, JSON answer) of one request to a replica (a POST when
    *body* is given); an HTTP error answers with its code."""
    import json
    import urllib.error
    import urllib.request

    headers = {"Content-Type": "application/json"}
    if key:
        headers["Idempotency-Key"] = key
    req = urllib.request.Request(
        url + path, headers=headers,
        data=None if body is None else json.dumps(body).encode(),
        method="GET" if body is None else "POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read() or b"{}")
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


class Fleet:
    """Replicas by name, in this process. ``generate`` chases a 409 (the
    stream migrated) to the new owner with the same key, as a router
    does."""

    def __init__(self) -> None:
        self.urls, self.reps = {}, {}

    def add(self, rep):
        self.urls[rep.name] = rep.start()
        self.reps[rep.name] = rep
        return rep

    def generate(self, name, prompt, key, **extra) -> dict:
        # the client waits past the replica's own deadline
        wait = float(extra.get("timeout") or 30.0) + 60.0
        code, body = _http(self.urls[name], "/generate",
                           dict(extra, prompt=list(prompt)), key=key,
                           timeout=wait)
        hops = [name]
        while code == 409 and "migrated" in body:
            name = body["migrated"]["replica"]
            hops.append(name)
            code, body = _http(self.urls[name], "/generate",
                               {"prompt": list(prompt)}, key=key)
        return {"code": code, "tokens": body.get("tokens"), "hops": hops}

    def post(self, name, path, body):
        return _http(self.urls[name], path, body)

    def wait_decoding(self, name, n, timeout=60.0) -> int:
        """Until *n* streams of replica *name* may migrate (decoding,
        first token out), or it has none left -> how many may."""
        rep, end = self.reps[name], time.time() + timeout
        while time.time() < end:
            with rep._cv:
                ready = len(rep.server.migratable_rids())
                if ready >= n or (rep.server._idle()
                                  and not rep.server.unfinished_rids()):
                    return ready
            time.sleep(0.001)
        raise TimeoutError(f"{name}: {n} streams never decoding")

    def shutdown(self) -> dict:
        """Stop every replica -> the meshed one's lockstep stats."""
        stats = None
        for rep in self.reps.values():
            rep.shutdown()
            stats = stats or rep.lockstep_stats()
        return stats


class StepGate:
    """Park a replica's step loop once *count* of its streams are
    mid-decode (*n* tokens out), until ``release``: every further step
    waits on the replica's condition (releasing it) and advances nothing,
    so a handoff or a drain always lands mid-stream however loaded the
    machine is (tests/test_torch_migration.py's gate). A parked meshed
    replica sends its followers no step."""

    def __init__(self, rep, count: int = 1, n: int = 3) -> None:
        import threading

        self.rep, self.count, self.n = rep, count, n
        self.held = threading.Event()
        self._released = False
        self._step = rep.server.step
        rep.server.step = self._gated

    def _gated(self):
        srv = self.rep.server
        if not self._released and (self.held.is_set() or sum(
                len(srv._emitted.get(r, ())) >= self.n
                for r in srv.migratable_rids()) >= self.count):
            self.held.set()
            self.rep._cv.wait(timeout=0.005)
            return {}
        return self._step()

    def wait(self, timeout: float = 60.0) -> None:
        if not self.held.wait(timeout):
            raise TimeoutError("streams never reached mid-decode")

    def release(self, until_idle: bool = False) -> None:
        """Open the gate (first, with *until_idle*, wait until every
        stream left the replica, as a drain's handoffs do)."""
        rep = self.rep
        with rep._cv:
            if until_idle and not rep._cv.wait_for(
                    rep.server._idle, timeout=60.0):
                raise TimeoutError("streams never left the replica")
            self._released = True
            rep.server.step = self._step
            rep._cv.notify_all()


def concurrently(*calls) -> list:
    """Run ``(fn, args, kwargs)`` calls on threads -> results, in order."""
    import threading

    out, errors = [None] * len(calls), []

    def run(i, fn, args, kwargs):
        try:
            out[i] = fn(*args, **kwargs)
        except BaseException as e:  # noqa: BLE001 — raised below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i, *c))
               for i, c in enumerate(calls)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return out


def _call(fn, *args, **kwargs):
    return fn, args, kwargs


def _replica_script(case, fleet, server, models, device) -> dict:
    """Rank 0's HTTP calls for one case; "mesh" is the meshed replica,
    the others one-device port replicas of the same server."""
    from kubetpu_torch.router.replica import ReplicaServer

    P, gen = case["prompts"], fleet.generate
    out = {}

    def peer(name, role="both"):
        one = build_server(case, models, None, device)
        return fleet.add(ReplicaServer(one, name, role=role))

    def midstream(name, count, path, body, *gens):
        """Run *gens* on replica *name*; once *count* of its streams are
        mid-decode (its loop parked), POST *path* there, then let it go
        on (after its streams left, for a handoff) -> (the generates'
        answers, the POST's answer)."""
        gate = StepGate(fleet.reps[name], count)
        box = {}

        def act():
            gate.wait()
            box["answer"] = fleet.post(name, path, body)
            gate.release(until_idle=path == "/migrate_out"
                         or bool(body.get("migrate_to")))

        answers = concurrently(_call(act), *gens)[1:]
        return answers, box["answer"]

    script = case["script"]
    if script == "generate":
        # a deadline past a first call's kernel build on the card
        out["gens"] = concurrently(*[_call(gen, "mesh", p, f"g{i}",
                                           timeout=600)
                                     for i, p in enumerate(P)])
    elif script == "prefix":
        out["first"] = [gen("mesh", P[0], "p0")]
        out["then"] = concurrently(_call(gen, "mesh", P[1], "p1"),
                                   _call(gen, "mesh", P[2], "p2"))
        out["hits"] = server.prefix_cache_stats()["requests_hit"]
        code, body = fleet.post("mesh", "/prefix_fetch",
                                {"prompt": P[2], "from_page": 0})
        out["fetch"] = (code, body.get("matched_tokens"), body.get("n_pages"))
        d = peer("D")
        out["peer"] = gen("D", P[2], "d2", prefix_peer=fleet.urls["mesh"])
        out["peer_hits"] = d.server.obs.counter(
            "kubetpu_peer_prefix_fetch_total", result="hit").value
    elif script == "int8":
        out["all"] = concurrently(*[_call(gen, "mesh", p, f"a{i}")
                                    for i, p in enumerate(P)])
        # a deadline already past at its first check: canceled queued
        out["cancel"] = gen("mesh", P[1], "c1", timeout=1e-6)["code"]
        # a drain without a target: the stream in flight finishes here
        out["drained"], out["drain_answer"] = midstream(
            "mesh", 1, "/drain", {}, _call(gen, "mesh", P[0], "b0"))
        out["after_drain"] = gen("mesh", P[1], "late")["code"]
    elif script == "dense":
        out["pair"] = concurrently(_call(gen, "mesh", P[0], "q0"),
                                   _call(gen, "mesh", P[1], "q1"))
        out["third"] = [gen("mesh", P[2], "q2")]
        # the drain-timeout sweep (drain_timeout_s 0): the stream in
        # flight is canceled as expired on every rank
        swept, _ = midstream("mesh", 1, "/drain", {},
                             _call(gen, "mesh", P[1], "x1"))
        out["swept"] = swept[0]["code"]
    elif script == "lora":
        code, body = fleet.post("mesh", "/adapters", {
            "action": "load", "name": "t3", "adapter": case["wire"]})
        out["load"] = (code, body.get("resident"))
        out["gens"] = concurrently(
            _call(gen, "mesh", P[0], "l0", adapter="t3"),
            _call(gen, "mesh", P[1], "l1", adapter=1),
            _call(gen, "mesh", P[2], "l2", adapter=0))
        code, body = fleet.post("mesh", "/adapters",
                                {"action": "evict", "name": "t3"})
        out["evict"] = (code, body.get("evicted"))
    elif script == "migrate":
        peer("B")
        peer("C")
        # a stream migrated IN: C hands its stream to the meshed replica
        out["in"], (_, moved) = midstream(
            "C", 1, "/migrate_out", {"target": fleet.urls["mesh"]},
            _call(gen, "C", P[2], "m2"))
        out["in_moved"] = moved.get("migrated")
        # streams migrated OUT: /migrate_out, then a drain with a target
        out["out"], (_, moved) = midstream(
            "mesh", 2, "/migrate_out", {"target": fleet.urls["B"]},
            _call(gen, "mesh", P[0], "m0"), _call(gen, "mesh", P[1], "m1"))
        out["out_moved"] = moved.get("migrated")
        out["drain"], _ = midstream(
            "mesh", 1, "/drain", {"migrate_to": fleet.urls["B"]},
            _call(gen, "mesh", P[0], "n0"))
    elif script == "prefill":
        peer("D", role="decode")
        out["handoff"] = concurrently(*[
            _call(gen, "mesh", P[i], f"h{i}", decode_target=fleet.urls["D"],
                  decode_name="D") for i in (0, 2)])
    return out


def mesh_replica(payload):
    """Each case's meshed server on the payload's mesh behind the port's
    ``ReplicaServer`` on rank 0 (``_replica_script``'s HTTP calls), the
    other ranks following (``follow_replica``); then ``check_lockstep``
    on every rank -> each case's answers (rank 0) or follower stats."""
    from kubetpu_torch.router.replica import ReplicaServer, follow_replica

    device = payload.get("device", "cpu")
    mesh = _mesh(payload["mesh"], device)
    models = port_models(payload, device)
    out = {}
    for case in payload["cases"]:
        server = build_server(case, models, mesh, device)
        before = _paged_counts()
        if payload["rank"] == 0:
            fleet = Fleet()
            fleet.add(ReplicaServer(server, "mesh", **case.get("replica",
                                                              {})))
            try:
                res = _replica_script(case, fleet, server, models, device)
            finally:
                res_stats = fleet.shutdown()
            res = dict(res, lockstep=res_stats)
        else:
            res = {"lockstep": follow_replica(server)}
        server.check_lockstep()
        # every launch of this rank in the case (rank 0's one-device
        # replicas' too)
        res["launches"] = {k: n - before[k]
                           for k, n in _paged_counts().items()}
        out[case["name"]] = res
    return out


def dead_follower(payload):
    """A meshed paged server behind the wire whose last rank fails its
    step ``fail_at`` and leaves the process group: rank 0's answers (a
    generate before, one across the failure, ``/healthz``) and what its
    ``shutdown`` raised."""
    import torch.distributed as dist

    from kubetpu_torch.router import replica
    from kubetpu_torch.router.replica import ReplicaServer, follow_replica

    replica.LOCKSTEP_TIMEOUT_S = 20.0
    mesh = _mesh(payload["mesh"], "cpu")
    models = port_models(payload, "cpu")
    case = payload["case"]
    server = build_server(case, models, mesh, "cpu")
    rank, last = payload["rank"], payload["world"] - 1
    if rank == last:
        steps = []

        def failing_step():
            steps.append(1)
            if len(steps) == payload["fail_at"]:
                raise RuntimeError("planted rank failure")
            return type(server).step(server)

        server.step = failing_step
    if rank == 0:
        fleet = Fleet()
        rep = fleet.add(ReplicaServer(server, "mesh"))
        first = fleet.generate("mesh", case["prompts"][0], "g0")
        second = fleet.generate("mesh", case["prompts"][1], "g1")
        health = _http(fleet.urls["mesh"], "/healthz")
        try:
            rep.shutdown()
            raised = None
        except Exception as e:  # noqa: BLE001 — reported
            raised = type(e).__name__
        dist.destroy_process_group()
        return {"first": first, "second": second, "healthz": health,
                "shutdown_raised": raised}
    try:
        follow_replica(server)
        raised = None
    except Exception as e:  # noqa: BLE001 — reported
        raised = type(e).__name__
    dist.destroy_process_group()
    return {"raised": raised}


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
