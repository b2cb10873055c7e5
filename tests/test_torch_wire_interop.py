"""The port on the wire beside the JAX package: one protocol, one format.

- **Codec bytes**: the port's codec and ``kubetpu.router.migration``
  write the same manifest and blob for the same f32, int8 and bf16
  snapshots and span payloads, and each decodes the other's (bf16 through
  ml_dtypes on the JAX side, through a 16-bit view in the port).
- **Config rendering**: the ``cfg_fp`` a port snapshot carries is
  ``repr(kubetpu.jobs.model.ModelConfig(...))`` of the same config.
- **Hops**: a stream hops from a ``kubetpu`` replica (JAX
  ``PagedDecodeServer``, f32) to a ``kubetpu_torch`` replica over
  ``/migrate_out``, another hops back, and each finishes with the
  unmigrated JAX run's greedy tokens.
- **Routing, both ways**: the JAX package's ``RouterServer`` fronts two
  port replicas, and the port's ``RouterServer`` two JAX replicas; routed
  greedy tokens equal a direct serial run of the replicas' server, and no
  request is admitted twice. ``python -m kubetpu.cli.obs`` renders the
  port router's section and its ``--trace`` the router hop above the
  replica leg.
- **Disaggregated handoff** (the port of ``tests/test_disagg.py:61-216``):
  a port prefill replica streams completed KV spans to a port decode
  replica, behind the JAX router: ``snapshot_pages`` equals the full
  snapshot, token and seeded parity hold, int8 ships quantized, warm pages
  never cross the wire.

Weights: ``trained_small`` (greedy parity across frameworks needs trained
weights). Wire waits are on state, with deadlines of at least 60 s."""

import copy
import dataclasses
import json
import os
import subprocess
import sys
import threading
import urllib.error

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from kubetpu.jobs.model import ModelConfig as JaxModelConfig
from kubetpu.jobs.paged import PagedDecodeServer as JaxPagedServer
from kubetpu.router import ReplicaServer as JaxReplicaServer
from kubetpu.router import RouterServer
from kubetpu.router import migration as jax_codec
from kubetpu.wire.httpcommon import request_json
from kubetpu_torch.jobs import model as tmodel
from kubetpu_torch.jobs.convert import params_from_numpy
from kubetpu_torch.jobs.paged import PagedDecodeServer
from kubetpu_torch.obs import span
from kubetpu_torch.router import ReplicaServer
from kubetpu_torch.router import RouterServer as PortRouterServer
from kubetpu_torch.router import migration as codec
from kubetpu_torch.router.migration import assemble_spans, span_name
from kubetpu_torch.wire.httpcommon import request_json as port_request_json

torch.set_num_threads(1)

PS = 8
WAIT = 60.0
PROMPT = [(i * 7) % 60 + 1 for i in range(19)]


@pytest.fixture(scope="module")
def both(trained_small):
    jcfg, params, _ = trained_small
    cfg = tmodel.ModelConfig(
        vocab=jcfg.vocab, d_model=jcfg.d_model, n_layers=jcfg.n_layers,
        n_heads=jcfg.n_heads, d_ff=jcfg.d_ff, max_seq=jcfg.max_seq)
    model = params_from_numpy(jax.tree.map(np.asarray, params), cfg,
                              device="cpu")
    return jcfg, params, cfg, model


def port_server(both, cfg=None, model=None, **kw):
    kw.setdefault("n_slots", 2)
    kw.setdefault("max_seq", 64)
    kw.setdefault("max_new_tokens", 12)
    kw.setdefault("page_size", PS)
    return PagedDecodeServer(cfg or both[2], model or both[3], device="cpu",
                             **kw)


def jax_server(both, **kw):
    kw.setdefault("n_slots", 2)
    kw.setdefault("max_seq", 64)
    kw.setdefault("max_new_tokens", 12)
    kw.setdefault("page_size", PS)
    return JaxPagedServer(both[0], both[1], **kw)


def serial(server, prompts, sampling=None):
    out = []
    for p in prompts:
        rid = server.enqueue(p, sampling=sampling)
        server.drain()
        out.append(server.pop_result(rid))
    return out


def decode_until(server, rid, n_emitted):
    for _ in range(200):
        if len(server._emitted.get(rid, [])) >= n_emitted:
            return
        server.step()
    raise AssertionError(f"never reached {n_emitted} emitted tokens")


def bits(arr) -> np.ndarray:
    """The raw bytes of a page array as uint8 (numpy, ml_dtypes or a
    torch tensor)."""
    if isinstance(arr, torch.Tensor):
        t = arr.contiguous()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        arr = t.numpy()
    return np.ascontiguousarray(arr).view(np.uint8)


# -- codec bytes ----------------------------------------------------------------


def _bf16_model(both):
    cfg = dataclasses.replace(both[2], dtype=torch.bfloat16)
    return cfg, copy.deepcopy(both[3]).to(torch.bfloat16)


def _port_snapshot(both, pool):
    if pool == "bf16":
        cfg, model = _bf16_model(both)
        server = port_server(both, cfg=cfg, model=model)
    else:
        server = port_server(both, kv_int8=pool == "int8")
    rid = server.enqueue(PROMPT)
    decode_until(server, rid, 3)
    return server.snapshot_slot(rid)


def _as_jax_array(arr):
    """A port page array as the JAX side holds it (bf16 as ml_dtypes)."""
    if isinstance(arr, torch.Tensor):
        return arr.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return arr


@pytest.mark.parametrize("pool", ["f32", "int8", "bf16"])
def test_codecs_write_the_same_bytes_and_decode_each_other(both, pool):
    snap = _port_snapshot(both, pool)
    meta, blob = codec.encode_snapshot(snap)
    jsnap = dict(snap, pages={k: _as_jax_array(v)
                              for k, v in snap["pages"].items()})
    jmeta, jblob = jax_codec.encode_snapshot(jsnap)
    assert meta == jmeta
    assert blob == jblob
    dtypes = {a["name"]: a["dtype"] for a in meta["arrays"]}
    assert dtypes == {"f32": {"k": "float32", "v": "float32"},
                      "int8": {"k_q": "int8", "k_s": "float32",
                               "v_q": "int8", "v_s": "float32"},
                      "bf16": {"k": "bfloat16", "v": "bfloat16"}}[pool]
    # the port's blob under the JAX codec, and the JAX blob under the port's
    jback = jax_codec.decode_snapshot(meta, blob)
    back = codec.decode_snapshot(jmeta, jblob)
    for name, arr in snap["pages"].items():
        assert np.array_equal(bits(jback["pages"][name]), bits(arr))
        assert np.array_equal(bits(back["pages"][name]), bits(arr))
        if pool == "bf16":
            assert jback["pages"][name].dtype == ml_dtypes.bfloat16
            assert back["pages"][name].dtype == torch.bfloat16
        else:
            assert back["pages"][name].dtype == arr.dtype
    # span payloads: the peer-fetch body and the streamed handoff's spans
    payload = codec.encode_span_payload(snap["pages"], 2,
                                        chunk_bytes=1000)
    assert payload == jax_codec.encode_span_payload(jsnap["pages"], 2,
                                                    chunk_bytes=1000)
    for dec in (codec.decode_span_payload,
                jax_codec.decode_span_payload):
        got = dec(payload)
        for name, arr in snap["pages"].items():
            assert np.array_equal(bits(got[name]), bits(arr))
    with pytest.raises(ValueError, match="truncated"):
        codec.decode_snapshot(jmeta, jblob[:-1])


def test_jax_snapshot_restores_into_the_port(both):
    """A snapshot the JAX server makes, through both codecs, restores into
    the port's server and finishes with the JAX run's greedy tokens."""
    want = serial(jax_server(both), [PROMPT])[0]
    src = jax_server(both)
    rid = src.enqueue(PROMPT)
    decode_until(src, rid, 4)
    meta, blob = jax_codec.encode_snapshot(src.snapshot_slot(rid))
    dst = port_server(both)
    rid2 = dst.restore_slot(codec.decode_snapshot(meta, blob))
    dst.drain()
    assert dst.pop_result(rid2) == want
    dst.check_invariants()


# -- config rendering -------------------------------------------------------------


@pytest.mark.parametrize("case", ["test_f32", "flagship_bf16", "bench_bf16",
                                  "gqa_window_f16"])
def test_cfg_fp_is_the_jax_config_repr(both, case):
    """The port renders the JAX package's ``repr(ModelConfig)`` of the
    same config: the test config in f32, the flagship in bf16 as
    chip_smoke.py serves it and as bench_model.py trains it, and a GQA /
    windowed / llama3-RoPE config in f16."""
    j = both[0]
    small = dict(vocab=j.vocab, d_model=j.d_model, n_layers=j.n_layers,
                 n_heads=j.n_heads, d_ff=j.d_ff, max_seq=j.max_seq)
    flagship = dict(vocab=32000, d_model=2048, n_layers=12, n_heads=16,
                    d_ff=5632)
    kw, dtype = {
        "test_f32": (small, None),
        "flagship_bf16": (dict(flagship, max_seq=2048), "bfloat16"),
        "bench_bf16": (dict(flagship, max_seq=4096, remat=True),
                       "bfloat16"),
        "gqa_window_f16": (dict(small, n_kv_heads=2, window=8,
                                rope_theta=500000.0,
                                rope_llama3_scaling=(8.0, 1.0, 4.0, 8192)),
                           "float16"),
    }[case]
    jcfg = JaxModelConfig(**kw, **({"dtype": getattr(jnp, dtype)}
                                   if dtype else {}))
    tcfg = tmodel.ModelConfig(**kw, **({"dtype": getattr(torch, dtype)}
                                       if dtype else {}))
    assert tmodel.reference_config_repr(tcfg) == repr(jcfg)


# -- hops between the packages ----------------------------------------------------


class StepGate:
    """Park a replica's step loop once a stream has *n* emitted tokens
    (the step waits on the replica's condition and advances nothing), so a
    handoff lands mid-flight however loaded the machine is."""

    def __init__(self, rep, n: int = 3) -> None:
        self.rep = rep
        self.n = n
        self.held = threading.Event()
        self._step = rep.server.step
        rep.server.step = self._gated_step

    def _gated_step(self):
        srv = self.rep.server
        if self.held.is_set() or any(
                len(srv._emitted.get(r, ())) >= self.n
                for r in srv.migratable_rids()):
            self.held.set()
            self.rep._cv.wait(timeout=0.005)
            return {}
        return self._step()

    def wait_midstream(self) -> None:
        assert self.held.wait(WAIT), "stream never reached mid-decode"

    def release(self) -> None:
        with self.rep._cv:
            self.rep.server.step = self._step
            self.rep._cv.notify_all()


def _generate_async(addr, prompt, key):
    out = {}

    def go():
        try:
            out["body"] = request_json(
                addr + "/generate", {"prompt": prompt, "timeout": WAIT},
                idempotency_key=key, timeout=WAIT)
            out["code"] = 200
        except urllib.error.HTTPError as e:
            out["code"] = e.code
            out["body"] = json.loads(e.read() or b"{}")

    t = threading.Thread(target=go, daemon=True)
    t.start()
    return t, out


def _hop(src, dst, prompt, key):
    """Generate on *src*, migrate the stream to *dst* mid-decode, chase
    the 409 there with the same key -> the adopted stream's tokens."""
    gate = StepGate(src)
    t, out = _generate_async(src.address, prompt, key)
    gate.wait_midstream()
    res = request_json(src.address + "/migrate_out",
                       {"target": dst.address, "reason": "hop"},
                       idempotency_key=key + "-mo", timeout=WAIT)
    assert res == {"migrated": 1, "failed": 0}
    gate.release()          # the source may serve what comes next
    t.join(WAIT)
    assert not t.is_alive()
    assert out["code"] == 409, out
    assert out["body"]["migrated"]["replica"] == dst.name
    body = request_json(dst.address + "/generate",
                        {"prompt": prompt, "timeout": WAIT},
                        idempotency_key=key, timeout=WAIT)
    assert body["replica"] == dst.name
    return body["tokens"]


def test_streams_hop_between_the_jax_and_the_port_replica(both):
    """kubetpu -> kubetpu_torch and back over /migrate_out: each stream
    finishes on the other package's replica with the unmigrated JAX run's
    greedy tokens, and each side adopted (not re-admitted) its arrival."""
    prompt2 = [(i * 11) % 60 + 1 for i in range(21)]
    want = serial(jax_server(both, max_new_tokens=16), [PROMPT, prompt2])
    jrep = JaxReplicaServer(jax_server(both, max_new_tokens=16), "jax0",
                            idle_wait=0.002)
    prep = ReplicaServer(port_server(both, max_new_tokens=16), "torch0",
                         idle_wait=0.002)
    jrep.start()
    prep.start()
    try:
        assert _hop(jrep, prep, PROMPT, "hop-j2t") == want[0]
        assert _hop(prep, jrep, prompt2, "hop-t2j") == want[1]
        for rep in (jrep, prep):
            assert int(rep.server.obs.counter(
                "kubetpu_replica_generate_adopted_total").value) == 1
            assert int(rep.server.obs.counter(
                "kubetpu_migrations_in_total",
                result="committed").value) == 1
            with rep._cv:
                rep.server.check_invariants()
    finally:
        jrep.shutdown(graceful=False)
        prep.shutdown(graceful=False)


# -- the JAX router in front of port replicas --------------------------------------


def storm_prompts():
    """Three shared-prefix families x tails + a sub-page loner
    (``scripts/router_check.py``'s storm)."""
    prompts = []
    for f, seed in enumerate((5, 7, 11)):
        fam = [(i * seed) % 60 + 1 for i in range(2 * PS)]
        for tail in range(3):
            prompts.append(fam + [f * 10 + tail + 1])
    prompts.append([63] * 3)
    return prompts


def routed_server(both):
    return port_server(both, max_new_tokens=5, prefill_budget=PS,
                       prefix_cache_pages=16)


def test_jax_router_fronts_port_replicas_token_exact(both):
    prompts = storm_prompts()
    want = serial(routed_server(both), prompts)
    reps = [ReplicaServer(routed_server(both), f"tr{i}", idle_wait=0.002)
            for i in range(2)]
    router = RouterServer(load_refresh_s=0.1)
    for rep in reps:
        rep.start()
    router.start()
    try:
        for rep in reps:
            router.register_replica(rep.address)
        bodies = [request_json(router.address + "/generate",
                               {"prompt": p, "timeout": WAIT},
                               idempotency_key=f"route-{i}", timeout=WAIT)
                  for i, p in enumerate(prompts)]
        assert [b["tokens"] for b in bodies] == want
        assert {b["replica"] for b in bodies} <= {"tr0", "tr1"}
        admits = sum(len(r.server.events.events(kind="admit"))
                     for r in reps)
        assert admits == len(prompts)       # nothing admitted twice
        text = router.metrics_text()
        assert "kubetpu_replica_generate_requests_total" in text
        for rep in reps:
            with rep._cv:
                rep.server.check_invariants()
    finally:
        router.shutdown()
        for rep in reps:
            rep.shutdown(graceful=False)


def test_port_router_fronts_jax_replicas_token_exact(both):
    """The port's router in front of two JAX replicas: routed greedy
    tokens equal a direct serial run of the JAX server, nothing is
    admitted twice, and the federated ``/metrics`` carries the replicas'
    series."""
    prompts = storm_prompts()
    kw = dict(max_new_tokens=5, prefill_budget=PS, prefix_cache_pages=16)
    want = serial(jax_server(both, **kw), prompts)
    reps = [JaxReplicaServer(jax_server(both, **kw), f"jr{i}",
                             idle_wait=0.002) for i in range(2)]
    router = PortRouterServer(load_refresh_s=0.1)
    for rep in reps:
        rep.start()
    router.start()
    try:
        for rep in reps:
            router.register_replica(rep.address)
        bodies = [request_json(router.address + "/generate",
                               {"prompt": p, "timeout": WAIT},
                               idempotency_key=f"proute-{i}", timeout=WAIT)
                  for i, p in enumerate(prompts)]
        assert [b["tokens"] for b in bodies] == want
        assert {b["replica"] for b in bodies} <= {"jr0", "jr1"}
        admits = sum(len(r.server.events.events(kind="admit"))
                     for r in reps)
        assert admits == len(prompts)
        assert sum(r.server.prefix_cache_stats()["requests_hit"]
                   for r in reps) > 0
        text = router.metrics_text()
        assert 'replica="jr0"' in text and 'replica="jr1"' in text
        for rep in reps:
            with rep._cv:
                rep.server.check_invariants()
    finally:
        router.shutdown()
        for rep in reps:
            rep.shutdown(graceful=False)


def _cli_obs(*args):
    """``python -m kubetpu.cli.obs ARGS`` in a subprocess -> stdout."""
    env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-m", "kubetpu.cli.obs", *args],
                          capture_output=True, text=True, timeout=120,
                          env=env)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return proc.stdout


def test_cli_obs_renders_the_port_router(both):
    """The JAX package's operator CLI, run for real against the port's
    router over two port replicas: ``--scrape`` renders the router
    section, the replica breaker states and each replica's load line;
    ``--controller URL --trace ID`` renders ``[router]`` above a
    ``[replica:*]`` leg."""
    reps = [ReplicaServer(routed_server(both), f"tr{i}", idle_wait=0.002)
            for i in range(2)]
    router = PortRouterServer(load_refresh_s=0.1)
    for rep in reps:
        rep.start()
    router.start()
    try:
        for rep in reps:
            router.register_replica(rep.address)
        with span("cli-port-router") as root:
            # the port's client: its trace context is the port tracer's
            port_request_json(router.address + "/generate",
                              {"prompt": [4] * 40, "timeout": WAIT},
                              idempotency_key="cli-port-1", timeout=WAIT)
            tid = root.trace_id
        out = _cli_obs("--scrape", router.address)
        assert "router    routed=1" in out
        assert "replicas healthy=2" in out
        assert "replica   tr0:" in out and "replica   tr1:" in out
        lines = _cli_obs("--controller", router.address,
                         "--trace", tid).splitlines()
        r_i = next(i for i, ln in enumerate(lines) if "[router]" in ln)
        rep_i = next(i for i, ln in enumerate(lines) if "[replica:" in ln)
        assert r_i < rep_i
    finally:
        router.shutdown()
        for rep in reps:
            rep.shutdown(graceful=False)


# -- the disaggregated prefill -> decode handoff -------------------------------------


MAX_NEW = 10


def disagg_server(both, kv_int8=False, cache_pages=16):
    return port_server(both, n_slots=4, max_seq=128, max_new_tokens=MAX_NEW,
                       prefill_budget=16, kv_int8=kv_int8,
                       prefix_cache_pages=cache_pages)


def family_prompts(n, fam_tokens=40):
    fam = [(i * 5) % 60 + 1 for i in range(fam_tokens)]
    return [fam + [i + 1] for i in range(n)]


def test_snapshot_pages_matches_full_snapshot(both):
    """The streaming gather equals the full snapshot's view of the same
    pages: spans + tail reassemble into exactly what a full snapshot
    ships; a gap refuses."""
    srv = disagg_server(both, cache_pages=0)
    rid = srv.enqueue([(i * 3) % 60 + 1 for i in range(40)])
    while len(srv._emitted.get(rid, [])) < 2:
        srv.step()
    full = srv.snapshot_slot(rid)
    assert int(full["n_live_pages"]) >= 3
    early = srv.snapshot_pages(rid, 0, 2)
    tail = srv.snapshot_slot(rid, from_page=2)
    for field in ("k", "v"):
        np.testing.assert_array_equal(early[field],
                                      full["pages"][field][:, :2])
        np.testing.assert_array_equal(tail["pages"][field],
                                      full["pages"][field][:, 2:])
    spans = {span_name(f, 0): early[f] for f in ("k", "v")}
    spans.update({span_name(f, 2): tail["pages"][f] for f in ("k", "v")})
    stitched = assemble_spans(spans, 0)
    for field in ("k", "v"):
        np.testing.assert_array_equal(stitched[field],
                                      full["pages"][field])
    with pytest.raises(ValueError):
        assemble_spans({span_name("k", 1): early["k"]}, 0)
    srv.drain()
    srv.check_invariants()


def test_prefill_progress_only_mid_prefill(both):
    srv = disagg_server(both, cache_pages=0)
    rid = srv.enqueue([1] * 40)
    assert srv.prefill_progress(rid) is None        # still queued
    srv.step()
    prog = srv.prefill_progress(rid)
    assert prog is not None and 0 < prog[0] < prog[1] == 40
    assert prog[0] % PS == 0                        # page-aligned
    srv.drain()
    assert srv.prefill_progress(rid) is None        # finished


@pytest.fixture()
def disagg_fleet(both):
    """The JAX router + a port prefill replica + a port decode replica."""
    made = {}

    def build(kv_int8=False):
        reps = []
        for i, role in enumerate(("prefill", "decode")):
            rep = ReplicaServer(disagg_server(both, kv_int8=kv_int8),
                                f"t{role}{i}", role=role, idle_wait=0.002)
            rep.start()
            reps.append(rep)
        router = RouterServer(load_refresh_s=0.1)
        router.start()
        for rep in reps:
            router.register_replica(rep.address)
        made["fleet"] = (router, reps)
        return router, reps

    yield build
    router, reps = made["fleet"]
    router.shutdown()
    for rep in reps:
        rep.shutdown(graceful=False)


def _drive(router, prompts, tag, sampling=None):
    bodies = []
    for i, p in enumerate(prompts):
        req = {"prompt": p, "timeout": WAIT}
        if sampling is not None:
            req["sampling"] = sampling
        bodies.append(request_json(router.address + "/generate", req,
                                   idempotency_key=f"disagg-{tag}-{i}",
                                   timeout=WAIT))
    return bodies


def test_disagg_token_parity_and_pipelining(both, disagg_fleet):
    """Routed tokens equal a quiet colocated run; every request admits
    once (on the prefill replica) and restores once (on the decode
    replica); some KV bytes shipped before the prefill finished."""
    prompts = family_prompts(4)
    expected = serial(disagg_server(both), prompts)
    router, (pre, dec) = disagg_fleet()
    bodies = _drive(router, prompts, "parity")
    for body, want in zip(bodies, expected):
        assert body["tokens"] == want
        assert body["replica"] == dec.name
    assert int(pre.server.obs.counter(
        "kubetpu_handoffs_total", result="committed").value) == len(prompts)
    assert len(pre.server.events.events(kind="admit")) == len(prompts)
    assert len(dec.server.events.events(kind="admit")) == 0
    assert len(dec.server.events.events(kind="migrate_in")) == len(prompts)
    assert pre._handoff_early_bytes > 0
    assert pre._handoff_bytes > pre._handoff_early_bytes
    assert int(pre.server.obs.counter(
        "kubetpu_handoff_pages_streamed_total").value) > 0
    with pre._cv:
        pre.server.check_invariants()
    with dec._cv:
        dec.server.check_invariants()
    text = router.metrics_text()
    assert 'kubetpu_serving_role{role="prefill"' in text
    assert 'kubetpu_handoffs_total{result="committed"' in text


def test_disagg_seeded_sampling_parity(both, disagg_fleet):
    """Sampled streams survive the handoff exactly: the raw request key
    ships with the snapshot."""
    prompts = family_prompts(2)
    sampling = {"temperature": 0.8, "top_k": 8}
    expected = serial(disagg_server(both), prompts, sampling=sampling)
    router, _ = disagg_fleet()
    bodies = _drive(router, prompts, "seeded", sampling=sampling)
    for body, want in zip(bodies, expected):
        assert body["tokens"] == want


def test_disagg_kv_int8_ships_quantized(both, disagg_fleet):
    prompts = family_prompts(2)
    expected = serial(disagg_server(both, kv_int8=True), prompts)
    router, (pre, dec) = disagg_fleet(kv_int8=True)
    bodies = _drive(router, prompts, "int8")
    for body, want in zip(bodies, expected):
        assert body["tokens"] == want
    assert int(pre.server.obs.counter(
        "kubetpu_handoffs_total", result="committed").value) == 2
    # every shipped page is int8 values + f32 scales for K and V (2
    # layers, page 8, 4 heads of 16): 2 x 8 x 4 x (16 + 4) x 2 bytes,
    # never a dequantized copy
    per_page = 2 * PS * 4 * (16 + 4) * 2
    pages = sum(e["pages"] for e in pre.events.events(kind="handoff_commit"))
    assert pages > 0
    assert int(pre.server.obs.counter(
        "kubetpu_migration_bytes_shipped_total").value) == pages * per_page


def test_disagg_warm_prefix_pages_never_cross_the_wire(both, disagg_fleet):
    """Once the decode replica's tree holds a family's prefix, later
    family members ship only the uncached suffix."""
    prompts = family_prompts(3)
    expected = serial(disagg_server(both), prompts)
    router, (pre, dec) = disagg_fleet()
    bodies = _drive(router, prompts, "warm")
    for body, want in zip(bodies, expected):
        assert body["tokens"] == want
    assert int(dec.server.obs.counter(
        "kubetpu_migration_pages_remapped_total").value) > 0
    with pre._cv:
        pre.server.check_invariants()
    with dec._cv:
        dec.server.check_invariants()
