"""The port's ``DecodeServer`` and the ``overlap`` pipeline, on trained
weights: the staggered lifecycle equals the JAX package's ``DecodeServer``
(f32 and int8 caches), chunked prefill equals monolithic admission (greedy
and seeded), ``overlap=True`` equals ``overlap=False`` on the dense and the
paged server (with prefix reuse and EOS retirement too), a dispatched step
makes no host sync and a routed step exactly one, and the migration legs
refuse an unflushed pipeline."""

import jax
import numpy as np
import pytest
import torch

from kubetpu.jobs.serving import DecodeServer as JaxDecodeServer
from kubetpu_torch.jobs import model as tmodel
from kubetpu_torch.jobs.convert import params_from_numpy
from kubetpu_torch.jobs.paged import PagedDecodeServer
from kubetpu_torch.jobs.serving import DecodeServer
from kubetpu_torch.router import ReplicaServer

torch.set_num_threads(1)

# __graft_entry__.py's staggered lifecycle prompts
LIFECYCLE = {"a": [3, 14, 15, 9], "b": [26, 5], "c": [7, 7, 7]}


def port_cfg(jcfg):
    return tmodel.ModelConfig(
        vocab=jcfg.vocab, d_model=jcfg.d_model, n_layers=jcfg.n_layers,
        n_heads=jcfg.n_heads, d_ff=jcfg.d_ff, max_seq=jcfg.max_seq)


@pytest.fixture(scope="module")
def both(trained_small):
    """(jax cfg, jax params, port cfg, port model, corpus prompts)."""
    jcfg, params, data = trained_small
    cfg = port_cfg(jcfg)
    model = params_from_numpy(jax.tree.map(np.asarray, params), cfg,
                              device="cpu")
    rows = np.asarray(data[1][0])
    prompts = [rows[i, :n].tolist() for i, n in enumerate((5, 13, 9, 21,
                                                           3, 17))]
    return jcfg, params, cfg, model, prompts


def lifecycle(server):
    """Two admitted, one step, one queued mid-flight, drain."""
    ra = server.submit(LIFECYCLE["a"])
    rb = server.submit(LIFECYCLE["b"])
    server.step()
    rc = server.enqueue(LIFECYCLE["c"])
    server.drain()
    return {k: server.result(r) for k, r in zip("abc", (ra, rb, rc))}


@pytest.mark.parametrize("kv_int8", [False, True], ids=["f32", "int8"])
def test_staggered_lifecycle_equals_the_reference(both, kv_int8):
    jcfg, params, cfg, model, _ = both
    kw = dict(n_slots=2, max_seq=64, max_new_tokens=6, kv_int8=kv_int8)
    want = lifecycle(JaxDecodeServer(jcfg, params, **kw))
    got = lifecycle(DecodeServer(cfg, model, device="cpu", **kw))
    assert got == want


def storm(server, prompts, sampling=None):
    """Two waves of enqueued prompts through the slots, drained."""
    half = len(prompts) // 2
    rids = [server.enqueue(p, sampling=sampling) for p in prompts[:half]]
    server.step()
    rids += [server.enqueue(p, sampling=sampling) for p in prompts[half:]]
    server.drain()
    out = [server.pop_result(r) for r in rids]
    assert server._idle() and server._inflight is None
    return out


@pytest.mark.parametrize("sampling", [None, {"temperature": 3.0}],
                         ids=["greedy", "seeded"])
def test_chunked_prefill_equals_monolithic(both, sampling):
    _, _, cfg, model, prompts = both
    outs = [storm(DecodeServer(cfg, model, n_slots=3, max_seq=64,
                               max_new_tokens=8, prefill_budget=budget,
                               seed=2, device="cpu"), prompts, sampling)
            for budget in (0, 4)]
    assert outs[0] == outs[1]


def _server(kind, cfg, model, overlap, **kw):
    if kind == "dense":
        return DecodeServer(cfg, model, device="cpu", overlap=overlap, **kw)
    if kind == "paged_prefix":
        kw.update(prefix_cache_pages=16)
    return PagedDecodeServer(cfg, model, page_size=4, device="cpu",
                             overlap=overlap, **kw)


@pytest.mark.parametrize("kind", ["dense", "paged", "paged_prefix"])
def test_overlap_equals_no_overlap(both, kind):
    """Emission lags one step under overlap; every stream's tokens stay
    the same, EOS retirement included (the trained model emits token 33
    often), and the paged pool ends free with its oracle holding."""
    _, _, cfg, model, prompts = both
    if kind == "paged_prefix":       # a shared 8-token head: reuse hits
        prompts = [prompts[3][:8] + p for p in prompts]
    outs = []
    for overlap in (False, True):
        server = _server(kind, cfg, model, overlap, n_slots=3, max_seq=64,
                         max_new_tokens=10, eos_id=33, prefill_budget=8)
        outs.append(storm(server, prompts))
        if kind != "dense":
            server.check_invariants()
        if kind == "paged_prefix":
            assert server.prefix_cache_stats()["requests_hit"] > 0
    assert outs[0] == outs[1]
    assert any(o[-1] == 33 for o in outs[0])


_SYNCS = ("item", "cpu", "tolist", "nonzero", "__bool__", "__int__",
          "__float__")


@pytest.mark.parametrize("overlap", [False, True], ids=["plain", "overlap"])
@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_dispatched_step_makes_no_host_sync(both, kind, overlap,
                                            monkeypatch):
    """A counter of the calls that wait for the device (``.item()``,
    ``.cpu()``, ``.tolist()``, ``nonzero`` and a tensor's bool, int or
    float) reads 0 inside every dispatched step and 1 in every routed
    step."""
    _, _, cfg, model, prompts = both
    server = _server(kind, cfg, model, overlap, n_slots=3, max_seq=64,
                     max_new_tokens=10)
    window = {"name": None}
    counts = {"dispatch": [], "route": []}

    def counting(name, fn):
        def wrapper(*args, **kwargs):
            if window["name"] is not None:
                counts[window["name"]][-1] += 1
            return fn(*args, **kwargs)
        return wrapper

    for name in _SYNCS:
        monkeypatch.setattr(torch.Tensor, name,
                            counting(name, getattr(torch.Tensor, name)))
    monkeypatch.setattr(torch, "nonzero", counting("nonzero", torch.nonzero))

    def windowed(name, leg):
        def run(*args):
            counts[name].append(0)
            window["name"] = name
            try:
                return leg(*args)
            finally:
                window["name"] = None
        return run

    server._dispatch_step = windowed("dispatch", server._dispatch_step)
    server._route_step = windowed("route", server._route_step)
    rids = [server.enqueue(p) for p in prompts[:3]]
    server.drain()
    assert all(server.finished(r) for r in rids)
    assert len(counts["dispatch"]) >= 9
    assert counts["dispatch"] == [0] * len(counts["dispatch"])
    assert counts["route"] == [1] * len(counts["dispatch"])


def test_overlap_refuses_migration_until_flushed(both):
    """With a step in flight no stream is migratable and freeze/snapshot
    refuse; once drained the legs work again."""
    _, _, cfg, model, prompts = both
    server = _server("paged", cfg, model, True, n_slots=2, max_seq=64,
                     max_new_tokens=10)
    rid = server.enqueue(prompts[1])
    for _ in range(3):
        server.step()
    assert server._inflight is not None
    assert server.migratable_rids() == []
    with pytest.raises(ValueError, match="overlap"):
        server.freeze_slot(rid)
    with pytest.raises(ValueError, match="overlap"):
        server.snapshot_slot(rid)
    with pytest.raises(AssertionError, match="warmup"):
        server.warmup()
    server.drain()
    assert server.finished(rid) and server._inflight is None
    assert server.migratable_rids() == []


def test_dense_server_warmup_kv_views_and_migration_skip(both):
    """``warmup()`` leaves the tokens as they were; ``k_cache`` exists only
    on the dense layout; a dense replica's migration is a per-stream skip
    (``snapshot_slot`` raises NotImplementedError) and the stream finishes
    locally with the quiet run's tokens."""
    _, _, cfg, model, prompts = both
    quiet = DecodeServer(cfg, model, n_slots=2, max_seq=64,
                         max_new_tokens=8, device="cpu")
    want = storm(quiet, prompts[:2])
    warm = DecodeServer(cfg, model, n_slots=2, max_seq=64, max_new_tokens=8,
                        device="cpu")
    warm.warmup()
    assert storm(warm, prompts[:2]) == want
    assert warm.k_cache.shape == (cfg.n_layers, 2, 64, cfg.kv_heads,
                                  cfg.head_dim)
    int8 = DecodeServer(cfg, model, n_slots=2, max_seq=64, kv_int8=True,
                        device="cpu")
    with pytest.raises(AttributeError, match="kv_int8"):
        int8.k_cache
    rep = ReplicaServer(warm, "dense0")
    rid = warm.enqueue(prompts[0])
    while not warm.migratable_rids():
        warm.step()
    with pytest.raises(NotImplementedError):
        warm.snapshot_slot(rid)
    assert rep.migrate_rid(rid, "http://127.0.0.1:9") is False
    warm.drain()
    assert warm.pop_result(rid) == want[0]
