"""The port's speculative servers (the port of ``tests/test_spec_serving.py``
and ``tests/test_spec_paged.py``): greedy tokens equal to the JAX package's
``PagedSpeculativeDecodeServer`` and ``SpeculativeDecodeServer`` on trained
weights with a seed-7 draft (f32 and int8 pools), and to the plain servers;
the self-draft ceiling; adaptive gamma walking down; chunked and
prefix-hit parity; a storm with the pool oracle after every drain; the
refusals; and a speculative stream migrated between two port replicas over
the port's wire.

Shapes stay aligned across tests (max_seq 64, page size 8, gamma_max 3 or
2) so that the JAX side compiles one set of rounds per pool."""

import dataclasses
import json
import threading
import urllib.error

import jax
import numpy as np
import pytest
import torch

from kubetpu.jobs import init_params as jax_init_params
from kubetpu.jobs.spec_serving import (
    PagedSpeculativeDecodeServer as JaxPagedSpec)
from kubetpu.jobs.spec_serving import SpeculativeDecodeServer as JaxDenseSpec
from kubetpu_torch.jobs import model as tmodel
from kubetpu_torch.jobs.convert import params_from_numpy
from kubetpu_torch.jobs.paged import PagedDecodeServer
from kubetpu_torch.jobs.serving import DecodeServer
from kubetpu_torch.jobs.spec_serving import (PagedSpeculativeDecodeServer,
                                             SpeculativeDecodeServer)
from kubetpu_torch.router import ReplicaServer
from kubetpu_torch.wire.httpcommon import request_json

torch.set_num_threads(1)

PS = 8
WAIT = 60.0
STAGGERED = [[3, 14, 15, 9, 2, 6], [26, 5], [35, 8, 9, 7, 9, 3, 2, 1, 4]]


def port_cfg(jcfg):
    return tmodel.ModelConfig(
        vocab=jcfg.vocab, d_model=jcfg.d_model, n_layers=jcfg.n_layers,
        n_heads=jcfg.n_heads, d_ff=jcfg.d_ff, max_seq=jcfg.max_seq)


@pytest.fixture(scope="module")
def pair(trained_small):
    """The trained target and a random seed-7 draft, in both packages:
    {"jax": (tcfg, dcfg, t, d), "port": (tcfg, dcfg, t, d)}."""
    jcfg, params, _data = trained_small
    jdraft = dataclasses.replace(jcfg, d_model=32, n_layers=1, n_heads=2,
                                 d_ff=64)
    dparams = jax_init_params(jax.random.PRNGKey(7), jdraft)
    tcfg, dcfg = port_cfg(jcfg), port_cfg(jdraft)
    t = params_from_numpy(jax.tree.map(np.asarray, params), tcfg,
                          device="cpu")
    d = params_from_numpy(jax.tree.map(np.asarray, dparams), dcfg,
                          device="cpu")
    return {"jax": (jcfg, jdraft, params, dparams),
            "port": (tcfg, dcfg, t, d)}


def spec(pair, draft="random", **kw):
    tcfg, dcfg, t, d = pair["port"]
    if draft == "self":
        dcfg, d = tcfg, t
    kw.setdefault("page_size", PS)
    kw.setdefault("max_seq", 64)
    return PagedSpeculativeDecodeServer(tcfg, dcfg, t, d, device="cpu", **kw)


def plain(pair, **kw):
    tcfg, _, t, _ = pair["port"]
    kw.setdefault("page_size", PS)
    kw.setdefault("max_seq", 64)
    return PagedDecodeServer(tcfg, t, device="cpu", **kw)


def staggered(server, prompts=STAGGERED):
    ra = server.submit(prompts[0])
    server.step()
    rb = server.submit(prompts[1])
    server.drain()
    rc = server.submit(prompts[2])
    server.drain()
    return [server.result(r) for r in (ra, rb, rc)]


@pytest.mark.parametrize("kv_int8", [False, True], ids=["f32", "int8"])
def test_paged_spec_equals_the_jax_server_and_the_plain_one(pair, kv_int8):
    jt, jd, jp, jdp = pair["jax"]
    kw = dict(n_slots=2, max_seq=64, max_new_tokens=12, page_size=PS,
              kv_int8=kv_int8, gamma_max=3)
    want = staggered(JaxPagedSpec(jt, jd, jp, jdp, **kw))
    server = spec(pair, **kw)
    got = staggered(server)
    assert got == want
    assert got == staggered(plain(pair, n_slots=2, max_new_tokens=12,
                                  kv_int8=kv_int8))
    assert server.mean_tokens_per_round() >= 1.0
    server.check_invariants()
    assert server.pages_in_use() == 0


def test_dense_spec_equals_the_jax_server_and_the_plain_one(pair):
    jt, jd, jp, jdp = pair["jax"]
    tcfg, dcfg, t, d = pair["port"]
    kw = dict(n_slots=2, max_seq=64, max_new_tokens=12, gamma=3)
    want = staggered(JaxDenseSpec(jt, jd, jp, jdp, **kw))
    got = staggered(SpeculativeDecodeServer(tcfg, dcfg, t, d, device="cpu",
                                            **kw))
    assert got == want
    assert got == staggered(DecodeServer(tcfg, t, n_slots=2, max_seq=64,
                                         max_new_tokens=12, device="cpu"))


def test_self_draft_hits_the_ceiling(pair):
    """The target as its own draft: every round emits gamma_max+1 tokens,
    gamma never leaves gamma_max, and the round count is the ceiling
    (regression for a hole in the draft cache); the dense server too."""
    tcfg, _, t, _ = pair["port"]
    srv = spec(pair, draft="self", n_slots=1, max_new_tokens=31, n_pages=8,
               gamma_max=2)
    rid = srv.submit([3, 14, 15, 9])
    rounds = 0
    while not srv.finished(rid):
        srv.step()
        rounds += 1
    assert rounds == 10, rounds          # 30 tokens after the first, 3 a round
    assert srv.mean_tokens_per_round() == 3.0
    assert srv.slot_gammas() == [2]
    quiet = plain(pair, n_slots=1, max_new_tokens=31, n_pages=8)
    rq = quiet.submit([3, 14, 15, 9])
    quiet.drain()
    assert srv.result(rid) == quiet.result(rq)
    dense = SpeculativeDecodeServer(tcfg, tcfg, t, t, n_slots=1, max_seq=64,
                                    max_new_tokens=31, gamma=2, device="cpu")
    rd = dense.submit([3, 14, 15, 9])
    dense.drain()
    assert dense.result(rd) == quiet.result(rq)
    assert dense.mean_tokens_per_round() == 3.0


def test_adaptive_gamma_converges_down_on_a_disagreeing_draft(pair):
    """The random draft walks the slot's gamma down to 1 within the
    request; the counters say proposed > 0 and accepted <= proposed; a new
    request on the slot starts at gamma_max again."""
    srv = spec(pair, n_slots=1, max_new_tokens=24, gamma_max=3)
    rid = srv.submit([5, 9, 3, 1, 7, 2])
    srv.drain()
    assert srv.finished(rid)
    assert srv.slot_gammas() == [1]
    text = srv.metrics_text()
    for name in ("kubetpu_spec_rounds_total",
                 "kubetpu_spec_accepted_tokens_total",
                 "kubetpu_spec_proposed_tokens_total",
                 "kubetpu_spec_mean_tokens_per_round", "kubetpu_spec_gamma"):
        assert name in text
    proposed = srv._c_spec_proposed.value
    assert proposed > 0 and 0 <= srv._c_spec_accepted.value <= proposed
    assert any(e["kind"] == "gamma" for e in srv.events.events())
    rid2 = srv.submit([1, 2, 3])
    assert srv.slot_gammas() == [3]
    srv.drain()
    assert srv.finished(rid2)


@pytest.mark.parametrize("kv_int8", [False, True], ids=["f32", "int8"])
def test_chunked_and_prefix_hit_parity(pair, kv_int8):
    """Chunked admission and shared-prefix hits (a hit skips the draft's
    prefill of the matched tokens too): the warm output equals the cold
    plain server's."""
    sys_p = [(i * 5) % 60 + 1 for i in range(24)]      # 3 full pages
    tails = [[7, 8], [9, 1], [11, 2], [13, 4]]

    def run(server):
        outs = []
        for tl in tails:
            rid = server.enqueue(sys_p + tl)
            server.drain()
            outs.append(server.pop_result(rid))
        return outs

    srv = spec(pair, n_slots=2, max_new_tokens=8, prefill_budget=8,
               prefix_cache_pages=8, kv_int8=kv_int8,
               gamma_max=2 if kv_int8 else 3)
    assert run(srv) == run(plain(pair, n_slots=2, max_new_tokens=8,
                                 kv_int8=kv_int8))
    stats = srv.prefix_cache_stats()
    assert stats["requests_hit"] >= 2 and stats["prefill_tokens_saved"] > 0
    srv.check_invariants()


def test_storm_keeps_pool_invariants(pair):
    """Chunked admissions, prefix families, pool churn and queue pressure:
    the pool oracle holds after every drain."""
    srv = spec(pair, n_slots=2, max_new_tokens=6, prefill_budget=8,
               prefix_cache_pages=8, gamma_max=3)
    fam_a = [(i * 5) % 60 + 1 for i in range(16)]
    fam_b = [(i * 11) % 60 + 1 for i in range(16)]
    waves = [[fam_a + [1], fam_b + [2], [9, 9, 9]],
             [fam_a + [3], fam_b + [4], fam_a + [5], [1] * 20],
             [fam_b + [6], [2] * 9, fam_a + [7]]]
    rids = []
    for wave in waves:
        rids.extend(srv.enqueue(p) for p in wave)
        srv.drain()
        srv.check_invariants()
    assert all(srv.finished(r) for r in rids)
    assert srv.metrics_summary()["admission_stall"]["count"] == len(rids)
    assert srv._c_spec_rounds.value > 0


def test_unaligned_max_seq_chunked_parity(pair):
    """A max_seq that is not page-aligned: the draft cache spans the
    padded table, the tokens equal the plain server's, and a self-draft
    stays at the ceiling."""
    srv = spec(pair, draft="self", n_slots=1, max_seq=57, max_new_tokens=6,
               page_size=16, n_pages=4, prefill_budget=16, gamma_max=4)
    assert srv._draft_len > 57 + 4
    quiet = plain(pair, n_slots=1, max_seq=57, max_new_tokens=6,
                  page_size=16, n_pages=4)
    prompt = [(i * 7) % 60 + 1 for i in range(50)]
    rp, rs = quiet.enqueue(prompt), srv.enqueue(prompt)
    quiet.drain()
    srv.drain()
    assert srv.result(rs) == quiet.result(rp)
    assert srv.mean_tokens_per_round() == 5.0
    srv.check_invariants()


def test_refuses_sampling_window_overlap_and_bad_gamma(pair):
    tcfg, dcfg, t, d = pair["port"]
    srv = spec(pair, n_slots=1, max_new_tokens=4)
    with pytest.raises(ValueError, match="greedy"):
        srv.submit([1, 2], sampling={"temperature": 1.0})
    with pytest.raises(ValueError, match="vocabulary"):
        PagedSpeculativeDecodeServer(
            tcfg, dataclasses.replace(dcfg, vocab=32), t, d, device="cpu")
    with pytest.raises(NotImplementedError,
                       match="ring table aliases logical pages"):
        PagedSpeculativeDecodeServer(dataclasses.replace(tcfg, window=8),
                                     dcfg, t, d, device="cpu")
    with pytest.raises(NotImplementedError, match="overlap"):
        PagedSpeculativeDecodeServer(tcfg, dcfg, t, d, overlap=True,
                                     device="cpu")
    with pytest.raises(ValueError, match="gamma_max"):
        PagedSpeculativeDecodeServer(tcfg, dcfg, t, d, gamma_max=0,
                                     device="cpu")
    dense = SpeculativeDecodeServer(tcfg, dcfg, t, d, n_slots=1,
                                    device="cpu")
    with pytest.raises(ValueError, match="greedy"):
        dense.enqueue([1, 2], sampling={"top_k": 3})
    with pytest.raises(ValueError, match="gamma"):
        SpeculativeDecodeServer(tcfg, dcfg, t, d, gamma=0, device="cpu")


def test_warmup_then_serve(pair):
    """``warmup()`` runs the draft's buckets and a round at every gamma,
    and leaves the server serviceable with the plain server's tokens."""
    srv = spec(pair, n_slots=2, max_seq=32, max_new_tokens=3,
               prefill_budget=8, gamma_max=2)
    srv.warmup()
    prompts = [[i + 1, i + 2] for i in range(3)]
    rids = [srv.enqueue(p) for p in prompts]
    srv.drain()
    quiet = plain(pair, n_slots=2, max_seq=32, max_new_tokens=3)
    qrids = [quiet.enqueue(p) for p in prompts]
    quiet.drain()
    assert [srv.result(r) for r in rids] == [quiet.result(r) for r in qrids]
    srv.check_invariants()
    assert srv.pages_in_use() == 0


# -- a speculative stream across two port replicas ----------------------------


class StepGate:
    """Park a replica's step loop once a stream is mid-decode (the port's
    migration tests' gate): the handoff always lands mid-flight."""

    def __init__(self, rep, n: int = 3) -> None:
        self.rep = rep
        self.n = n
        self.held = threading.Event()
        self._released = False
        self._step = rep.server.step
        rep.server.step = self._gated_step

    def _gated_step(self):
        srv = self.rep.server
        if not self._released and (self.held.is_set() or any(
                len(srv._emitted.get(r, ())) >= self.n
                for r in srv.migratable_rids())):
            self.held.set()
            self.rep._cv.wait(timeout=0.005)
            return {}
        return self._step()

    def wait_midstream(self) -> None:
        assert self.held.wait(WAIT), "stream never reached mid-decode"


def test_spec_stream_migrates_between_port_replicas(pair):
    """``/migrate_out`` ships a mid-decode speculative stream (pages and the
    slot's adaptive gamma) to a second port replica; the source's generate
    answers 409 with the new owner, and the same key at the target adopts
    the stream and returns the quiet plain run's tokens."""
    prompt = [(i * 7) % 60 + 1 for i in range(19)]
    quiet = plain(pair, n_slots=2, max_new_tokens=24)
    rq = quiet.enqueue(prompt)
    quiet.drain()
    want = quiet.result(rq)
    reps = [ReplicaServer(spec(pair, n_slots=2, max_new_tokens=24,
                               gamma_max=3), f"spec{i}", idle_wait=0.002)
            for i in range(2)]
    for rep in reps:
        rep.start()
    src, dst = reps
    try:
        gate = StepGate(src)
        out = {}

        def go():
            try:
                out["body"] = request_json(
                    src.address + "/generate",
                    {"prompt": prompt, "timeout": WAIT},
                    idempotency_key="spec-mig", timeout=WAIT)
                out["code"] = 200
            except urllib.error.HTTPError as e:
                out["code"] = e.code
                out["body"] = json.loads(e.read() or b"{}")

        th = threading.Thread(target=go, daemon=True)
        th.start()
        gate.wait_midstream()
        res = request_json(src.address + "/migrate_out",
                           {"target": dst.address, "reason": "test",
                            "wait": True},
                           idempotency_key="spec-mig-mo", timeout=WAIT)
        assert res == {"migrated": 1, "failed": 0}
        th.join(WAIT)
        assert not th.is_alive()
        assert out["code"] == 409
        assert out["body"]["migrated"]["replica"] == dst.name
        body = request_json(dst.address + "/generate",
                            {"prompt": prompt, "timeout": WAIT},
                            idempotency_key="spec-mig", timeout=WAIT)
        assert body["tokens"] == want
        with dst._cv:
            dst.server.check_invariants()
            (ev,) = dst.server.events.events(kind="migrate_in")
            assert ev["pages_shipped"] > 0
        with src._cv:
            src.server.check_invariants()
    finally:
        for rep in reps:
            rep.shutdown(graceful=False)
