"""The port's meshed servers against the JAX package's, on ``trained_small``,
in one 4-rank gloo world on the CPU over {dp 2, tp 2} (the JAX servers on
4 of conftest's 8 virtual devices): the counterparts of
tests/test_serving.py's and tests/test_paged.py's
``test_mesh_sharded_*_matches_unsharded`` and of ``_dryrun_serving``'s
staggered lifecycle (two requests submitted, one step, one enqueued,
drain). Each case's greedy tokens on every rank equal the JAX meshed
server's and the port's one-device server's exactly:

- ``DecodeServer`` with slots on dp (2 slots) and replicated over dp (3);
- ``PagedDecodeServer`` over an f32 and an int8 pool, each with and
  without prefix reuse (a third prompt hits the first one's published
  pages), the f32 one also with chunked prefill;
- the paged speculative server (the target sharded, the draft whole);
- the dense and the paged multi-LoRA servers (two adapters in one batch);
- ``make_generate(mesh=)``, plain and at window 8 (tests/test_decode.py's
  and ``_dryrun_decode``'s legs).

Every rank's scheduler holds the same state (``check_lockstep``), and a
meshed paged server's ``snapshot_slot`` (the kv heads gathered over tp)
restores into a one-device port server that continues token-exactly."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from kubetpu.jobs import init_params as jax_init_params
from kubetpu.jobs import lora as jlora
from kubetpu.jobs import multi_lora as jml
from kubetpu.jobs.decode import make_generate as jax_make_generate
from kubetpu.jobs.meshjob import make_mesh
from kubetpu.jobs.paged import PagedDecodeServer as JaxPaged
from kubetpu.jobs.serving import DecodeServer as JaxDense
from kubetpu.jobs.spec_serving import PagedSpeculativeDecodeServer as JaxSpec
from kubetpu_torch.jobs.paged import PagedDecodeServer

from torch_mesh_worlds import port_models, serve_case, spawn

torch.set_num_threads(1)

MESH = {"dp": 2, "tp": 2}
PS = 8
PROMPTS = [list(range(1, 2 * PS + 2)), [5, 6, 7, 9, 11],
           list(range(1, 2 * PS + 2)) + [3]]
PICKS = [0, 1, 1]
LORA = {"rank": 4, "alpha": 8.0}
DENSE = dict(max_seq=64, max_new_tokens=6)
PAGED = dict(n_slots=2, max_seq=64, max_new_tokens=8, page_size=PS)

# name: (kind, server options, options of the JAX server only)
CASES = {
    "dense_dp_slots": ("dense", dict(DENSE, n_slots=2), {}),
    "dense_replicated": ("dense", dict(DENSE, n_slots=3), {}),
    "paged": ("paged", PAGED, {}),
    "paged_chunked_prefix": ("paged", dict(PAGED, prefill_budget=PS,
                                           prefix_cache_pages=8), {}),
    "paged_int8": ("paged", dict(PAGED, kv_int8=True), {}),
    "paged_int8_prefix": ("paged", dict(PAGED, kv_int8=True,
                                        prefix_cache_pages=8), {}),
    "spec": ("spec", PAGED, {}),
    "lora_dense": ("lora_dense", dict(DENSE, n_slots=2), {}),
    "lora_paged": ("lora_paged", PAGED, {}),
}
NAMES = list(CASES)
GEN = {"generate": 0, "generate_window8": 8}
PROMPT = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (4, 16), 0,
                                       64))


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


@pytest.fixture(scope="module")
def trained(trained_small):
    jcfg, jparams, _data = trained_small
    jlcfg = jlora.LoraConfig(**LORA)
    jads = [_jax_adapter(s, jcfg, jlcfg) for s in (1, 2)]
    jdcfg = dataclasses.replace(jcfg, d_model=32, n_layers=1, n_heads=2,
                                d_ff=64)
    jdraft = jax_init_params(jax.random.PRNGKey(7), jdcfg)
    payload = {"cfg": _kw(jcfg), "params": jax.tree.map(np.asarray, jparams),
               "dcfg": _kw(jdcfg), "draft": jax.tree.map(np.asarray, jdraft),
               "lcfg": LORA,
               "adapters": [jax.tree.map(np.asarray, a) for a in jads]}
    return {"jax": (jcfg, jparams, jlcfg, jads, jdcfg, jdraft),
            "payload": payload}


def _case(name):
    kind, kw, _jkw = CASES[name]
    return dict(name=name, kind=kind, kw=kw, prompts=PROMPTS,
                picks=PICKS if kind.startswith("lora") else None)


def _gen_case(name):
    return dict(name=name, kind="generate", window=GEN[name], prompt=PROMPT,
                seed=2, steps=8)


@pytest.fixture(scope="module")
def world(trained, tmp_path_factory):
    cases = [_case(n) for n in NAMES] + [_gen_case(n) for n in GEN]
    cases.append(dict(_case("paged_int8"), name="snapshot", snapshot=3))
    res = spawn("serving", 4, tmp_path_factory.mktemp("serving"),
                dict(trained["payload"], mesh=MESH, cases=cases))
    assert all(r["foreign"] == [] for r in res)
    return res


def _jax_staggered(server, picks):
    extra = [{}] * 3 if picks is None else [{"adapter": a} for a in picks]
    rids = [server.submit(p, **x) for p, x in zip(PROMPTS[:2], extra[:2])]
    server.step()
    rids.append(server.enqueue(PROMPTS[2], **extra[2]))
    server.drain()
    return [server.result(r) for r in rids]


def _jax_tokens(trained, name):
    jcfg, jparams, jlcfg, jads, jdcfg, jdraft = trained["jax"]
    kind, kw, jkw = CASES[name]
    kw = dict(kw, **jkw, mesh=make_mesh(MESH))
    if kind == "dense":
        server = JaxDense(jcfg, jparams, **kw)
    elif kind == "paged":
        server = JaxPaged(jcfg, jparams, **kw)
    elif kind == "spec":
        server = JaxSpec(jcfg, jdcfg, jparams, jdraft, **kw)
    elif kind == "lora_dense":
        server = jml.MultiLoraDecodeServer(
            jcfg, jparams, jlcfg, jml.stack_adapters(jlcfg, jads), **kw)
    else:
        server = jml.PagedMultiLoraDecodeServer(jcfg, jparams, jlcfg, jads,
                                                **kw)
    return _jax_staggered(server, PICKS if kind.startswith("lora") else None)


@pytest.fixture(scope="module")
def one_device(trained):
    """The port's one-device models (``mesh=None``)."""
    return port_models(trained["payload"], "cpu")


@pytest.mark.parametrize("name", NAMES)
def test_meshed_server_matches_jax_and_one_device(world, trained,
                                                  one_device, name):
    """Every rank's greedy tokens equal the JAX meshed server's and the
    port's one-device server's, and every rank emitted them on the same
    steps."""
    got = [r[name] for r in world]
    for r in got:
        assert r["tokens"] == got[0]["tokens"]
        assert r["steps"] == got[0]["steps"]
    assert got[0]["tokens"] == _jax_tokens(trained, name)
    one = serve_case(_case(name), one_device, None, "cpu")
    assert got[0]["tokens"] == one["tokens"]
    assert got[0]["steps"] == one["steps"]


@pytest.mark.parametrize("name", ["paged_chunked_prefix",
                                  "paged_int8_prefix"])
def test_prefix_reuse_hits_on_the_mesh(world, name):
    """The third prompt is admitted past the first one's two published
    pages on every rank (the tree and the table alike everywhere: the
    tokens above, and ``check_lockstep`` in the world)."""
    for r in world:
        assert r[name]["prefix_hits"] == 1


@pytest.mark.parametrize("name", list(GEN))
def test_meshed_generate_matches_jax(world, trained, one_device, name):
    """``make_generate(mesh=)``: the rows on dp, the cache's kv heads on
    tp, the generated rows gathered: every rank returns the JAX meshed
    generate's tokens, and the port's one-device ones."""
    jcfg = trained["jax"][0]
    wcfg = dataclasses.replace(jcfg, window=GEN[name])
    want = np.asarray(jax_make_generate(wcfg, make_mesh(MESH))(
        trained["payload"]["params"], jax.numpy.asarray(PROMPT),
        jax.random.PRNGKey(3), 8))
    for r in world:
        np.testing.assert_array_equal(r[name]["tokens"], want)
    one = serve_case(_gen_case(name), one_device, None, "cpu")
    np.testing.assert_array_equal(one["tokens"], want)


def test_meshed_snapshot_restores_on_one_device(world, one_device):
    """A meshed paged server's snapshot (int8 pool) carries the whole
    kv-head axis; a one-device port server restores it and continues
    token-exactly to the meshed server's result."""
    snaps = [r["snapshot"]["snap"] for r in world]
    for s in snaps[1:]:
        for k, v in s["pages"].items():
            np.testing.assert_array_equal(np.asarray(v),
                                          np.asarray(snaps[0]["pages"][k]))
    snap = snaps[0]
    cfg = one_device["cfg"]
    assert snap["pages"]["k_q"].shape[3] == cfg.kv_heads
    server = PagedDecodeServer(cfg, one_device["params"], device="cpu",
                               **CASES["paged_int8"][1])
    rid = server.restore_slot(snap)
    server.drain()
    assert server.result(rid) == world[0]["snapshot"]["tokens"][0]
