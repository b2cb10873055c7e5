"""A meshed port server behind the port's replica wire, against the JAX
package's ``ReplicaServer`` over the JAX meshed server of the same kind,
on ``trained_small``: one 4-rank gloo world on the CPU over {dp 2, tp 2}
(the JAX servers on 4 of conftest's 8 virtual devices), spawned once.

Rank 0 serves (``router.replica.ReplicaServer``), ranks 1-3 follow
(``follow_replica``), and rank 0's HTTP calls come from
``torch_mesh_worlds._replica_script``. Greedy tokens equal the JAX
replica's exactly for ``/generate`` on the paged server (f32 with prefix
reuse, int8), ``DecodeServer`` with slots on dp, the paged speculative
server and the paged multi-LoRA server after a ``POST /adapters`` load;
``/prefix_fetch`` serves a one-device peer's fetch; a cancel, the
drain-timeout sweep and drains
with and without a target; ``/migrate_out`` and a drain handing streams
to a one-device port replica, and a ``/migrate_in`` from one, all
token-exact; a prefill-role meshed replica hands its streams to a
one-device decode replica. Every rank's host state agrees at each case's
end (``check_lockstep``), and every follower saw rank 0's ticks. A world
whose follower fails mid-stream stops the replica: 503s, and ``shutdown``
raises."""

import dataclasses
import threading

import jax
import numpy as np
import pytest

from kubetpu.jobs import init_params as jax_init_params
from kubetpu.jobs import lora as jlora
from kubetpu.jobs import multi_lora as jml
from kubetpu.jobs.meshjob import make_mesh
from kubetpu.jobs.paged import PagedDecodeServer as JaxPaged
from kubetpu.jobs.serving import DecodeServer as JaxDense
from kubetpu.jobs.spec_serving import PagedSpeculativeDecodeServer as JaxSpec
from kubetpu.router.adapters import encode_adapter
from kubetpu.router.replica import ReplicaServer as JaxReplica

from torch_mesh_worlds import _http, spawn

MESH = {"dp": 2, "tp": 2}
PS = 8
PROMPTS = [list(range(1, 2 * PS + 2)), [5, 6, 7, 9, 11],
           list(range(1, 2 * PS + 2)) + [3]]
LORA = {"rank": 4, "alpha": 8.0}
PAGED = dict(n_slots=2, max_seq=64, max_new_tokens=8, page_size=PS)

# name: (server kind, server options, script, ReplicaServer options)
CASES = {
    "paged_prefix": ("paged", dict(PAGED, prefix_cache_pages=8), "prefix",
                     {}),
    "paged_int8": ("paged", dict(PAGED, kv_int8=True, max_new_tokens=24),
                   "int8", {}),
    "dense_dp": ("dense", dict(n_slots=2, max_seq=64, max_new_tokens=24),
                 "dense", {"drain_timeout_s": 0.0}),
    "spec": ("spec", PAGED, "generate", {}),
    "lora": ("lora_paged", dict(PAGED, max_adapters=3), "lora", {}),
    "migrate": ("paged", dict(PAGED, max_seq=128, max_new_tokens=40),
                "migrate", {}),
    "prefill": ("paged", dict(PAGED, prefill_budget=PS), "prefill",
                {"role": "prefill"}),
}
LORA_PICKS = ["t3", 1, 0]        # the wire-loaded adapter, then the stack's


def _jax_adapter(seed, jcfg, jlcfg):
    """A JAX adapter with a real effect: B drawn N(0, 0.05)."""
    lora = jlora.init_lora_params(jax.random.PRNGKey(seed), jcfg, jlcfg)
    keys = jax.random.split(jax.random.PRNGKey(seed + 100), 4)
    for i, t in enumerate(jlcfg.targets):
        b = lora["blocks"][f"{t}_b"]
        lora["blocks"][f"{t}_b"] = (
            jax.random.normal(keys[i], b.shape, b.dtype) * 0.05)
    return lora


def _kw(cfg):
    return dict(vocab=cfg.vocab, d_model=cfg.d_model, n_layers=cfg.n_layers,
                n_heads=cfg.n_heads, d_ff=cfg.d_ff, max_seq=cfg.max_seq)


def _case(name):
    kind, kw, script, rkw = CASES[name]
    return dict(name=name, kind=kind, kw=kw, script=script, replica=rkw,
                prompts=PROMPTS)


def _jax_tokens(jx, name) -> list:
    """The JAX replica's greedy tokens for each prompt (the multi-LoRA
    server's after the same ``/adapters`` load, under ``LORA_PICKS``)."""
    jcfg, jparams, jlcfg, jads, wire, jdcfg, jdraft = jx
    kind, kw, _script, _rkw = CASES[name]
    kw = dict(kw, mesh=make_mesh(MESH))
    if kind == "dense":
        server = JaxDense(jcfg, jparams, **kw)
    elif kind == "spec":
        server = JaxSpec(jcfg, jdcfg, jparams, jdraft, **kw)
    elif kind == "paged":
        server = JaxPaged(jcfg, jparams, **kw)
    else:
        server = jml.PagedMultiLoraDecodeServer(jcfg, jparams, jlcfg, jads,
                                                **kw)
    rep = JaxReplica(server, "jax")
    url = rep.start()
    try:
        extra = [{}] * len(PROMPTS)
        if kind == "lora_paged":
            code, _ = _http(url, "/adapters", {"action": "load",
                                               "name": "t3",
                                               "adapter": wire})
            assert code == 200
            extra = [{"adapter": a} for a in LORA_PICKS]
        out = []
        for p, x in zip(PROMPTS, extra):
            code, body = _http(url, "/generate", dict(x, prompt=p))
            assert code == 200, body
            out.append(body["tokens"])
        return out
    finally:
        rep.shutdown()


@pytest.fixture(scope="module")
def trained(trained_small):
    jcfg, jparams, _data = trained_small
    jlcfg = jlora.LoraConfig(**LORA)
    jads = [_jax_adapter(s, jcfg, jlcfg) for s in (1, 2)]
    wire = encode_adapter(_jax_adapter(3, jcfg, jlcfg))
    jdcfg = dataclasses.replace(jcfg, d_model=32, n_layers=1, n_heads=2,
                                d_ff=64)
    jdraft = jax_init_params(jax.random.PRNGKey(7), jdcfg)
    payload = {"cfg": _kw(jcfg), "params": jax.tree.map(np.asarray, jparams),
               "dcfg": _kw(jdcfg), "draft": jax.tree.map(np.asarray, jdraft),
               "lcfg": LORA,
               "adapters": [jax.tree.map(np.asarray, a) for a in jads]}
    return {"jax": (jcfg, jparams, jlcfg, jads, wire, jdcfg, jdraft),
            "payload": payload, "wire": wire}


@pytest.fixture(scope="module")
def world_and_oracle(trained, tmp_path_factory):
    """The port's world (subprocesses) runs while this process computes
    the JAX replicas' tokens."""
    cases = [dict(_case(n), wire=trained["wire"]) for n in CASES]
    box = {}

    def run_world():
        try:
            box["world"] = spawn(
                "mesh_replica", 4, tmp_path_factory.mktemp("replica"),
                dict(trained["payload"], mesh=MESH, cases=cases))
        except BaseException as e:  # noqa: BLE001 — re-raised below
            box["error"] = e

    t = threading.Thread(target=run_world)
    t.start()
    try:
        oracle = {n: _jax_tokens(trained["jax"], n) for n in CASES}
    finally:
        t.join()
    if "error" in box:
        raise box["error"]
    world = box["world"]
    assert all(r["foreign"] == [] for r in world)
    return world, oracle


@pytest.fixture(scope="module")
def world(world_and_oracle):
    return world_and_oracle[0]


@pytest.fixture(scope="module")
def oracle(world_and_oracle):
    return world_and_oracle[1]


def _ok(answers):
    assert all(a["code"] == 200 for a in answers), answers
    return [a["tokens"] for a in answers]


@pytest.mark.parametrize("name,key,picks", [
    ("paged_prefix", "first", [0]), ("paged_prefix", "then", [1, 2]),
    ("paged_int8", "all", [0, 1, 2]), ("dense_dp", "pair", [0, 1]),
    ("dense_dp", "third", [2]), ("spec", "gens", [0, 1, 2]),
    ("lora", "gens", [0, 1, 2])])
def test_generate_matches_the_jax_replica(world, oracle, name, key, picks):
    """``POST /generate`` (concurrent where the script sends several) on
    the meshed replica: the JAX replica's greedy tokens exactly."""
    got = _ok(world[0][name][key])
    assert got == [oracle[name][i] for i in picks]


def test_prefix_reuse_and_fetch_over_the_mesh(world, oracle):
    """The third prompt hits the first one's published pages on the mesh;
    ``/prefix_fetch`` exports its two pages (gathered over tp), and a
    one-device peer that fetches them serves the JAX tokens."""
    r = world[0]["paged_prefix"]
    assert r["hits"] == 1
    assert r["fetch"] == (200, 2 * PS, 2)
    assert _ok([r["peer"]]) == [oracle["paged_prefix"][2]]
    assert r["peer_hits"] == 1


def test_cancel_and_drain_without_a_target(world, oracle):
    """A generate past its deadline is canceled (503) on every rank; a
    drain without a target lets the stream in flight finish here with the
    JAX tokens, and refuses what comes after it."""
    r = world[0]["paged_int8"]
    assert r["cancel"] == 503
    assert r["drain_answer"] == (200, {"draining": True})
    assert _ok(r["drained"]) == [oracle["paged_int8"][0]]
    assert r["after_drain"] == 503


def test_drain_timeout_sweep_cancels_on_every_rank(world):
    """A drain whose timeout (0 s) passed cancels the decoding stream as
    expired: a retryable 503, replayed by every follower
    (``cancel_expired``)."""
    assert world[0]["dense_dp"]["swept"] == 503


def test_adapters_load_and_evict_over_the_mesh(world):
    """``POST /adapters`` loads the wire adapter into every rank's stack
    (each keeps its tp slices) and evicts it again."""
    r = world[0]["lora"]
    assert r["load"][0] == 200 and "t3" in r["load"][1]
    assert r["evict"] == (200, True)


def test_migrations_in_and_out_are_token_exact(world, oracle):
    """A one-device replica's ``/migrate_out`` into the meshed one (its
    ``/migrate_in``), the meshed one's ``/migrate_out`` and its drain with
    ``migrate_to`` a one-device replica: each stream, chased by its key,
    ends with the JAX tokens."""
    r, want = world[0]["migrate"], oracle["migrate"]
    assert r["in_moved"] == 1 and r["in"][0]["hops"] == ["C", "mesh"]
    assert _ok(r["in"]) == [want[2]]
    assert r["out_moved"] == 2
    assert [a["hops"] for a in r["out"]] == [["mesh", "B"]] * 2
    assert _ok(r["out"]) == want[:2]
    assert r["drain"][0]["hops"] == ["mesh", "B"]
    assert _ok(r["drain"]) == [want[0]]


def test_prefill_role_hands_off_to_a_decode_replica(world, oracle):
    """A prefill-role meshed replica chunk-prefills, streams the KV spans
    (gathered over tp) and hands each stream to a one-device decode
    replica, which emits the JAX tokens."""
    r = world[0]["prefill"]
    assert [a["hops"] for a in r["handoff"]] == [["mesh", "D"]] * 2
    assert _ok(r["handoff"]) == [oracle["prefill"][0], oracle["prefill"][2]]


@pytest.mark.parametrize("name", list(CASES))
def test_every_follower_took_rank_0s_ticks(world, name):
    """Each follower received and applied every tick and call rank 0 sent
    (the world's ``check_lockstep`` passed after each case)."""
    lead = world[0][name]["lockstep"]
    assert lead["ticks"]["step"] > 0 and lead["ticks"]["stop"] == 1
    for r in world[1:]:
        assert r[name]["lockstep"] == lead


def test_a_failed_follower_stops_the_replica(trained, tmp_path_factory):
    """A follower that fails mid-stream and leaves the group: rank 0's
    step fails with it, the generate in flight answers 503, ``/healthz``
    503, and ``shutdown`` raises; nothing is served from one rank."""
    res = spawn("dead_follower", 2, tmp_path_factory.mktemp("dead"),
                dict(trained["payload"], mesh={"dp": 1, "tp": 2},
                     fail_at=12, case=dict(_case("paged_prefix"),
                                           kw=PAGED)))
    r0 = res[0]
    assert r0["first"]["code"] == 200
    assert r0["second"]["code"] == 503
    assert r0["healthz"][0] == 503 and r0["healthz"][1]["ok"] is False
    assert r0["shutdown_raised"] == "LockstepError"
    assert res[1]["raised"] == "RuntimeError"
