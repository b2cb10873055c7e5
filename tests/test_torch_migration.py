"""Live KV migration in the port: token-exact slot handoff between the
port's paged servers, and the wire paths of its own ``ReplicaServer``
(the port of ``tests/test_migration.py``).

The serving-layer half drives the servers in-process: snapshot -> codec
-> restore round trips over f32 and kv_int8 pools, with and without a
prefix hit, seeded sampling, the refusals and the rollbacks. The wire
half runs two port ``ReplicaServer``s over HTTP: the 409 re-pin and the
adoption, the replayed commit, the epoch fence, prefix negotiation and
drain with migration. The servers are built from ``trained_small``'s
weights (``convert.params_from_numpy``).

Every wire test waits on state, never on a sleep: a source replica's step
loop is parked by ``StepGate`` once its stream is mid-decode, so the
handoff always lands mid-flight however loaded the machine is, and every
wait has a deadline of at least 60 s."""

import dataclasses
import json
import threading
import urllib.error

import jax
import numpy as np
import pytest
import torch

from kubetpu_torch.jobs import model as tmodel
from kubetpu_torch.jobs.convert import params_from_numpy
from kubetpu_torch.jobs.paged import PagedDecodeServer
from kubetpu_torch.jobs.serving import SlotServerBase
from kubetpu_torch.obs import trace as obs_trace
from kubetpu_torch.router import ReplicaServer
from kubetpu_torch.router.migration import (blob_chunks, chunk_b64,
                                            decode_snapshot, encode_snapshot)
from kubetpu_torch.wire.httpcommon import request_json

torch.set_num_threads(1)

PS = 8
WAIT = 60.0
PROMPT = [(i * 7) % 60 + 1 for i in range(19)]


@pytest.fixture(scope="module")
def model(trained_small):
    jcfg, params, _ = trained_small
    cfg = tmodel.ModelConfig(
        vocab=jcfg.vocab, d_model=jcfg.d_model, n_layers=jcfg.n_layers,
        n_heads=jcfg.n_heads, d_ff=jcfg.d_ff, max_seq=jcfg.max_seq)
    return cfg, params_from_numpy(jax.tree.map(np.asarray, params), cfg,
                                  device="cpu")


def make_server(model, cfg=None, **kw):
    kw.setdefault("n_slots", 2)
    kw.setdefault("max_seq", 64)
    kw.setdefault("max_new_tokens", 12)
    kw.setdefault("page_size", PS)
    return PagedDecodeServer(cfg or model[0], model[1], device="cpu", **kw)


def quiet_run(server, prompt):
    rid = server.enqueue(prompt)
    server.drain()
    lps = server.result_logprobs(rid)
    return server.pop_result(rid), lps


def decode_until(server, rid, n_emitted):
    for _ in range(200):
        if len(server._emitted.get(rid, [])) >= n_emitted:
            return
        server.step()
    raise AssertionError(f"never reached {n_emitted} emitted tokens")


def handoff(src, dst, rid, epoch=1):
    """The in-process spelling of one migration, through the wire codec:
    snapshot -> freeze -> encode/decode -> restore -> finish; returns the
    target-local rid."""
    snap = src.snapshot_slot(rid)
    src.freeze_slot(rid)
    rid2 = dst.restore_slot(decode_snapshot(*encode_snapshot(snap)))
    assert rid2 is not None
    src.finish_migrated(rid, {"replica": "dst", "rid": rid2,
                              "epoch": epoch})
    return rid2


def pool_pages(server, rid):
    """The slot's live pages gathered through its table, as stored."""
    slot = server._slot_rid.index(rid)
    n = server._pages_needed(int(server.pos[slot]) + 1)
    return server._gather_phys_pages(server._table[slot, :n])


def fam_prompts():
    fam = [(i * 5) % 60 + 1 for i in range(2 * PS)]
    return fam + [11], fam + [9]


# -- serving-layer round trips ------------------------------------------------


@pytest.mark.parametrize("kv_int8", [False, True], ids=["f32", "kv_int8"])
def test_snapshot_restore_token_exact(model, kv_int8):
    """A stream migrated mid-decode emits exactly the tokens and logprobs
    of an unmigrated run; the restored pages are the source's bytes."""
    want, want_lps = quiet_run(make_server(model, kv_int8=kv_int8), PROMPT)
    src = make_server(model, kv_int8=kv_int8)
    dst = make_server(model, kv_int8=kv_int8)
    rid = src.enqueue(PROMPT)
    decode_until(src, rid, 4)
    before = pool_pages(src, rid)
    rid2 = handoff(src, dst, rid)
    assert src.migrated_to(rid) == {"replica": "dst", "rid": rid2,
                                    "epoch": 1}
    after = pool_pages(dst, rid2)
    assert before.keys() == after.keys()
    for name in before:
        assert torch.equal(before[name], after[name]), name
    src.check_invariants()          # pages freed/published on the source
    while not dst.finished(rid2):
        dst.step()
    assert dst.result_logprobs(rid2) == want_lps
    assert dst.pop_result(rid2) == want
    dst.check_invariants()


def test_snapshot_int8_pages_stay_quantized(model):
    """A kv_int8 snapshot carries the stored int8 values and f32 scales,
    never a dequantized copy."""
    src = make_server(model, kv_int8=True)
    rid = src.enqueue(PROMPT)
    decode_until(src, rid, 2)
    snap = src.snapshot_slot(rid)
    assert set(snap["pages"]) == {"k_q", "k_s", "v_q", "v_s"}
    assert snap["pages"]["k_q"].dtype == np.int8
    assert snap["pages"]["k_s"].dtype == np.float32
    assert snap["pages"]["k_s"].shape[-1] == 1
    assert snap["n_live_pages"] == 3            # 19 + 2 tokens, page 8
    assert snap["pages"]["k_q"].shape[1] == 3


def test_seeded_sampling_continues_exactly_across_seeds(model):
    """The restored slot reuses the source's request key (shipped as two
    32-bit words), so seeded sampling continues identically on a target
    built with another server seed."""
    kw = dict(temperature=0.9, top_k=8)
    want, _ = quiet_run(make_server(model, seed=3, **kw), PROMPT)
    src = make_server(model, seed=3, **kw)
    dst = make_server(model, seed=999, **kw)
    rid = src.enqueue(PROMPT)
    decode_until(src, rid, 5)
    snap = src.snapshot_slot(rid)
    key = src._slot_reqkey[src._slot_rid.index(rid)]
    assert snap["reqkey"] == [key >> 32, key & 0xFFFFFFFF]
    rid2 = handoff(src, dst, rid)
    while not dst.finished(rid2):
        dst.step()
    assert dst.pop_result(rid2) == want


@pytest.mark.parametrize("kv_int8", [False, True], ids=["f32", "kv_int8"])
def test_restore_maps_prefix_cache_pages_readonly(model, kv_int8):
    """A target whose radix tree holds the prompt's prefix maps those pages
    read-only instead of writing shipped bytes: the remapped counter, the
    shared rows, byte-stable tree pages and balanced refcounts."""
    warm_prompt, mig_prompt = fam_prompts()
    want, _ = quiet_run(make_server(model, kv_int8=kv_int8), mig_prompt)
    src = make_server(model, kv_int8=kv_int8, prefix_cache_pages=16)
    dst = make_server(model, kv_int8=kv_int8, prefix_cache_pages=16)
    quiet_run(dst, warm_prompt)     # dst's tree now owns the family pages
    tree_pages = sorted(dst._prefix_cache.owned_pages())
    before = dst._gather_phys_pages(tree_pages)
    rid = src.enqueue(mig_prompt)
    decode_until(src, rid, 4)
    rid2 = handoff(src, dst, rid)
    assert int(dst.obs.counter(
        "kubetpu_migration_pages_remapped_total").value) == 2
    assert int(dst.obs.counter(
        "kubetpu_migration_pages_shipped_total").value) == 1
    assert dst._slot_shared[dst._slot_rid.index(rid2)] == 2
    while not dst.finished(rid2):
        dst.step()
    assert dst.pop_result(rid2) == want
    after = dst._gather_phys_pages(tree_pages)
    for name in before:
        assert torch.equal(before[name], after[name]), name
    src.check_invariants()
    dst.check_invariants()                  # refcounts balanced


def test_snapshot_refusals(model):
    """Migration only between rounds: queued, mid-chunked-prefill and
    deferred-first-token streams refuse to snapshot, nothing mutated."""
    src = make_server(model, prefill_budget=PS)
    long_prompt = [(i * 3) % 60 + 1 for i in range(3 * PS)]
    rid = src.enqueue(long_prompt)
    with pytest.raises(ValueError, match="queued"):
        src.snapshot_slot(rid)
    src.step()                               # first chunk only
    assert src._prefills, "prompt should still be mid-prefill"
    with pytest.raises(ValueError, match="mid-chunked-prefill"):
        src.snapshot_slot(rid)
    assert src.migratable_rids() == []
    while src._prefills:
        # the admitting step's first half: the final chunk has run, its
        # first token is still deferred to the step's routing
        src._schedule_prefills()
    with pytest.raises(ValueError, match="deferred"):
        src.snapshot_slot(rid)
    assert src.migratable_rids() == []
    src.drain()
    src.pop_result(rid)
    src.check_invariants()
    with pytest.raises(ValueError, match="holds no slot"):
        src.snapshot_slot(rid)


def test_ring_servers_refuse_migration(model):
    """Windowed (ring) servers have no shippable logical page view: the
    snapshot, the span gather and the restore all refuse."""
    cfg = dataclasses.replace(model[0], window=8)
    ring = make_server(model, cfg=cfg)
    rid = ring.enqueue(PROMPT)
    decode_until(ring, rid, 2)
    with pytest.raises(NotImplementedError, match="ring"):
        ring.snapshot_slot(rid)
    with pytest.raises(NotImplementedError, match="ring"):
        ring.snapshot_pages(rid, 0, 1)
    src = make_server(model)
    rid = src.enqueue(PROMPT)
    decode_until(src, rid, 2)
    with pytest.raises(NotImplementedError, match="ring"):
        ring.restore_slot(src.snapshot_slot(rid))


def test_restore_refuses_mismatched_config(model):
    """A snapshot restores only on a config-identical server: another
    token budget, or another model config (``cfg_fp``), refuses."""
    src = make_server(model)
    rid = src.enqueue(PROMPT)
    decode_until(src, rid, 2)
    snap = src.snapshot_slot(rid)
    with pytest.raises(ValueError, match="max_new_tokens"):
        make_server(model, max_new_tokens=20).restore_slot(snap)
    other = dataclasses.replace(model[0], rope_theta=500.0)
    dst = make_server(model, cfg=other)
    with pytest.raises(ValueError, match="cfg_fp"):
        dst.restore_slot(snap)
    dst.check_invariants()
    src.drain()                 # the source stream finishes normally
    assert len(src.pop_result(rid)) == len(PROMPT) + 12


def test_restore_returns_none_when_full_and_rolls_back(model):
    """A target with no free slot refuses with None and mutates nothing;
    a target whose pool cannot hold the stream rolls its prefix mapping
    back; the source resumes (unfreeze) token-exactly."""
    want, _ = quiet_run(make_server(model), PROMPT)
    src = make_server(model)
    dst = make_server(model, n_slots=1)
    blocker = dst.enqueue([5] * 4)
    dst.step()                                # occupies the only slot
    rid = src.enqueue(PROMPT)
    decode_until(src, rid, 3)
    snap = src.snapshot_slot(rid)
    src.freeze_slot(rid)
    assert dst.restore_slot(snap) is None
    dst.check_invariants()
    # a pool one page short of the stream's worst case, with the prompt's
    # two leading pages cached: the match pins them, the allocation fails
    # (the pinned pages cannot be reclaimed), and the pin is rolled back
    fam, _ = fam_prompts()
    prompt = fam[:2 * PS] + PROMPT[:3]
    small = make_server(model, n_pages=6, prefix_cache_pages=4)
    quiet_run(small, prompt)          # the tree holds 2 pages, 4 are free
    hog = small.enqueue([7] * 4)      # 3 pages for its worst case
    small.step()
    free_before = sorted(small._free)
    assert small.restore_slot(dict(snap, prompt=prompt)) is None
    assert sorted(small._free) == free_before
    assert small._prefix_cache.total_pages == 2
    small.check_invariants()          # no pin left behind
    src.unfreeze_slot(rid)
    src.drain()
    assert src.pop_result(rid) == want
    src.check_invariants()
    dst.drain()
    dst.pop_result(blocker)
    small.drain()
    small.pop_result(hog)


def test_frozen_slot_is_not_free_not_idle_not_snapshottable(model):
    """A frozen slot is mid-handoff: not reusable, not idle, not
    migratable, not snapshottable again and not cancelable, and /load
    reads it as occupied and migrating."""
    src = make_server(model)
    rid = src.enqueue(PROMPT)
    decode_until(src, rid, 2)
    slot = src._slot_rid.index(rid)
    free_before = src._free_slots()
    active_before = src.load_info()["active_slots"]
    src.freeze_slot(rid)
    assert slot not in src._free_slots()
    assert not src._idle() and not src._runnable()
    assert rid not in src.migratable_rids()
    assert rid in src.unfinished_rids()
    assert src.cancel(rid) is False
    with pytest.raises(ValueError, match="already frozen"):
        src.snapshot_slot(rid)
    snap = src.snapshot_slot(rid, allow_frozen=True)   # its owner may
    assert snap["pos"] == len(PROMPT) + 1
    src.check_invariants()          # a frozen slot keeps its pages
    info = src.load_info()
    assert info["migrating_slots"] == 1
    assert info["active_slots"] == active_before
    src.unfreeze_slot(rid)
    assert src._free_slots() == free_before
    assert src.load_info()["migrating_slots"] == 0
    src.drain()
    src.pop_result(rid)


def test_base_server_migration_degrades_to_skip(model):
    """A server without a page view raises NotImplementedError, and the
    wire layer's migrate leg turns that into a per-stream skip."""
    base = SlotServerBase(model[0], model[1], n_slots=2, max_seq=64,
                          max_new_tokens=8, eos_id=None, device="cpu")
    with pytest.raises(NotImplementedError, match="live migration"):
        base.snapshot_slot(0)
    with pytest.raises(NotImplementedError, match="live migration"):
        base.restore_slot({})
    rep = ReplicaServer(base, "base0", idle_wait=0.002)
    rep.start()
    try:
        assert rep.migrate_rid(0, "http://127.0.0.1:9",
                               reason="test") is False
        assert [e["kind"] for e in rep.events.events()] == ["migrate_skip"]
    finally:
        rep.shutdown(graceful=False)


def test_snapshot_codec_roundtrip_and_truncation():
    bf16 = torch.arange(6, dtype=torch.float32).reshape(2, 3).to(
        torch.bfloat16)
    snap = {
        "prompt": [1, 2, 3], "epoch": 2,
        "pages": {
            "k": np.arange(24, dtype=np.float32).reshape(2, 3, 4),
            "q8": np.arange(6, dtype=np.int8).reshape(2, 3),
            "h": np.arange(4, dtype=np.float16),
            "b": bf16,
        },
    }
    meta, blob = encode_snapshot(snap)
    assert [a["dtype"] for a in meta["arrays"]] == [
        "bfloat16", "float16", "float32", "int8"]
    chunks = blob_chunks(blob, 16)
    assert b"".join(chunks) == blob
    back = decode_snapshot(meta, blob)
    assert back["prompt"] == [1, 2, 3] and back["epoch"] == 2
    for name in ("k", "q8", "h"):
        np.testing.assert_array_equal(back["pages"][name],
                                      snap["pages"][name])
        assert back["pages"][name].dtype == snap["pages"][name].dtype
    assert back["pages"]["b"].dtype == torch.bfloat16
    assert torch.equal(back["pages"]["b"], bf16)
    with pytest.raises(ValueError, match="truncated"):
        decode_snapshot(meta, blob[:-1])
    with pytest.raises(ValueError, match="trailing"):
        decode_snapshot(meta, blob + b"x")
    assert blob_chunks(b"", 16) == [b""]    # empty manifest still commits


# -- wire-level paths ---------------------------------------------------------


class StepGate:
    """Park a replica's step loop once a stream is mid-decode: after the
    first step that leaves a migratable stream with at least *n* emitted
    tokens, every further step of the loop waits on the replica's
    condition (releasing it) and advances nothing, until ``release()``.
    The handoff under test then always lands mid-flight, and the loop
    never starves the handler threads of the lock. With *count* > 1 the
    loop steps nothing until *count* requests have arrived (so they are
    admitted together), and parks once *count* streams are mid-decode."""

    def __init__(self, rep, n: int = 3, count: int = 1) -> None:
        self.rep = rep
        self.n = n
        self.count = count
        self.held = threading.Event()
        self._released = False
        self._arrived = count == 1
        self._step = rep.server.step
        rep.server.step = self._gated_step

    def _gated_step(self):
        srv = self.rep.server
        self._arrived = (self._arrived
                         or len(srv.unfinished_rids()) >= self.count)
        if not self._released and (not self._arrived or self.held.is_set()
                                   or sum(len(srv._emitted.get(r, ()))
                                          >= self.n
                                          for r in srv.migratable_rids())
                                   >= self.count):
            if self._arrived:
                self.held.set()
            self.rep._cv.wait(timeout=0.005)
            return {}
        return self._step()

    def wait_midstream(self):
        """The held stream's rid (the *count* held rids when count > 1),
        once the gate holds them."""
        assert self.held.wait(WAIT), "stream never reached mid-decode"
        with self.rep._cv:
            rids = self.rep.server.migratable_rids()
        assert len(rids) == self.count, rids
        return rids[0] if self.count == 1 else rids

    def release(self) -> None:
        with self.rep._cv:
            self._released = True
            self.rep._cv.notify_all()


def wait_until(rep, pred, what: str) -> None:
    """Wait on *rep*'s condition (notified after every step) until *pred*
    holds under it."""
    with rep._cv:
        assert rep._cv.wait_for(pred, timeout=WAIT), what


@pytest.fixture()
def wire(model):
    """build(n, **server_kw) -> n started port ReplicaServers (port 0)."""
    made = []

    def build(n=2, **server_kw):
        server_kw.setdefault("max_new_tokens", 24)
        reps = []
        for i in range(n):
            rep = ReplicaServer(make_server(model, **server_kw), f"mig{i}",
                                idle_wait=0.002)
            rep.start()
            reps.append(rep)
        made.extend(reps)
        return reps

    yield build
    for rep in made:
        rep.shutdown(graceful=False)


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


def _join(t):
    t.join(WAIT)
    assert not t.is_alive(), "generate never answered"


def test_wire_migrate_409_and_adoption(model, wire):
    """/migrate_out hands the stream over; the source's open generate
    answers 409 with the new owner; a retry with the same key at the
    target adopts the restored stream (no re-admission) and returns the
    quiet run's tokens."""
    want, _ = quiet_run(make_server(model, max_new_tokens=24), PROMPT)
    src, dst = wire(2)
    gate = StepGate(src)
    t, out = _generate_async(src.address, PROMPT, "w-adopt")
    gate.wait_midstream()
    res = request_json(src.address + "/migrate_out",
                       {"target": dst.address, "reason": "test",
                        "wait": True},
                       idempotency_key="w-adopt-mo", timeout=WAIT)
    assert res == {"migrated": 1, "failed": 0}
    _join(t)
    assert out["code"] == 409
    assert out["body"]["migrated"]["replica"] == dst.name
    body = request_json(dst.address + "/generate",
                        {"prompt": PROMPT, "timeout": WAIT},
                        idempotency_key="w-adopt", timeout=WAIT)
    assert body["tokens"] == want
    assert int(dst.server.obs.counter(
        "kubetpu_replica_generate_adopted_total").value) == 1
    assert int(dst.server.obs.counter(
        "kubetpu_replica_generate_requests_total").value) == 0
    # a retry at the source deterministically re-learns the 409
    with pytest.raises(urllib.error.HTTPError) as ei:
        request_json(src.address + "/generate",
                     {"prompt": PROMPT, "timeout": WAIT},
                     idempotency_key="w-adopt", timeout=WAIT)
    assert ei.value.code == 409
    assert int(src.server.obs.counter(
        "kubetpu_migrations_total", reason="test",
        result="committed").value) == 1
    # the target's serving event of the restore carries the trace id of
    # the wire request it ran under: the source's migrate.out span
    (ev,) = dst.server.events.events(kind="migrate_in")
    ops = {sp["op"] for sp in obs_trace.tracer().spans(ev["trace_id"])}
    assert "migrate.out" in ops and "POST /migrate_in" in ops
    with src._cv:
        src.server.check_invariants()
    with dst._cv:
        dst.server.check_invariants()


def _ship(addr, tok, meta, blob, kbase):
    request_json(addr + "/migrate_in",
                 {"phase": "begin", "token": tok, "meta": meta},
                 idempotency_key=kbase + "-begin", timeout=WAIT)
    request_json(addr + "/migrate_in",
                 {"phase": "chunk", "token": tok, "seq": 0,
                  "data": chunk_b64(blob)},
                 idempotency_key=kbase + "-c0", timeout=WAIT)
    return {"phase": "commit", "token": tok, "n_chunks": 1,
            "arrays": meta["arrays"], "ship_from_page": 0}


def test_wire_commit_replay_never_double_restores(model, wire):
    """A re-sent commit (the same idempotency key: the lost-response
    retry) replays the committed ack: one restore, one active copy."""
    src, dst = wire(2)
    gate = StepGate(src)
    t, out = _generate_async(src.address, PROMPT, "w-replay")
    rid = gate.wait_midstream()
    with src._cv:
        snap = src.server.snapshot_slot(rid)
        src.server.freeze_slot(rid)
    snap["origin"] = [src.name, rid]
    snap["epoch"] = 1
    meta, blob = encode_snapshot(snap)
    meta["gen_key"] = "w-replay"
    tok = {"origin": [src.name, rid], "epoch": 1}
    kbase = f"mig-{src.name}-{rid}-e1"
    commit = _ship(dst.address, tok, meta, blob, kbase)
    ack1 = request_json(dst.address + "/migrate_in", commit,
                        idempotency_key=kbase + "-commit", timeout=WAIT)
    ack2 = request_json(dst.address + "/migrate_in", commit,
                        idempotency_key=kbase + "-commit", timeout=WAIT)
    assert ack1 == ack2                     # replay, not re-execution
    assert int(dst.server.obs.counter(
        "kubetpu_migrations_in_total", result="committed").value) == 1
    assert len(dst.server.events.events(kind="migrate_in")) == 1
    with src._cv:
        src.server.finish_migrated(
            rid, {"replica": ack1["replica"], "rid": ack1["rid"],
                  "epoch": 1})
        src._cv.notify_all()
    _join(t)
    assert out["code"] == 409


def test_wire_epoch_fence_refuses_stale_handoff(model, wire):
    """A duplicate handoff of the same (origin, rid) at an epoch the target
    already committed is fenced 409: at most one copy of a stream ever
    goes active."""
    src, dst = wire(2)
    gate = StepGate(src)
    t, out = _generate_async(src.address, PROMPT, "w-fence")
    rid = gate.wait_midstream()
    with src._cv:
        snap = src.server.snapshot_slot(rid)
    assert src.migrate_rid(rid, dst.address, reason="test")
    _join(t)
    assert out["code"] == 409
    # forge a second handoff of the same stream at the same epoch under
    # new idempotency keys (the replay window can't save us; the fence can)
    tok = {"origin": [src.name, rid], "epoch": 1}
    meta, blob = encode_snapshot(dict(snap, origin=[src.name, rid],
                                      epoch=1))
    commit = _ship(dst.address, tok, meta, blob, "forge")
    with pytest.raises(urllib.error.HTTPError) as ei:
        request_json(dst.address + "/migrate_in", commit,
                     idempotency_key="forge-commit", timeout=WAIT)
    assert ei.value.code == 409
    assert json.loads(ei.value.read())["fenced"] is True
    assert int(dst.server.obs.counter(
        "kubetpu_migrations_fenced_total").value) == 1
    assert int(dst.server.obs.counter(
        "kubetpu_migrations_in_total", result="committed").value) == 1
    with dst._cv:
        dst.server.check_invariants()


def test_prefix_negotiation_skips_shipping_matched_pages(model, wire):
    """The begin-phase prefix hint: pages the target maps from its own
    radix tree never cross the wire; the restore stays token-exact."""
    warm_prompt, mig_prompt = fam_prompts()
    want, _ = quiet_run(make_server(model, max_new_tokens=24), mig_prompt)
    src, dst = wire(2, prefix_cache_pages=16)
    with dst._cv:
        r = dst.server.enqueue(warm_prompt)
        dst._cv.notify_all()
    wait_until(dst, lambda: dst.server.finished(r), "warm request")
    with dst._cv:
        dst.server.pop_result(r)
        assert dst.server.migration_prefix_hint(mig_prompt) == 2
    gate = StepGate(src)
    t, out = _generate_async(src.address, mig_prompt, "w-skip")
    rid = gate.wait_midstream()
    with src._cv:
        full_bytes = len(encode_snapshot(
            {"pages": src.server.snapshot_slot(rid)["pages"]})[1])
    assert src.migrate_rid(rid, dst.address, reason="test")
    shipped = int(src.server.obs.counter(
        "kubetpu_migration_bytes_shipped_total").value)
    assert 0 < shipped < full_bytes
    assert shipped * 3 == full_bytes        # one of three pages shipped
    assert int(dst.server.obs.counter(
        "kubetpu_migration_pages_remapped_total").value) == 2
    _join(t)
    body = request_json(dst.address + "/generate",
                        {"prompt": mig_prompt, "timeout": WAIT},
                        idempotency_key="w-skip", timeout=WAIT)
    assert body["tokens"] == want
    with src._cv:
        src.server.check_invariants()
    with dst._cv:
        dst.server.check_invariants()


def test_drain_with_migration_completes_without_stream_end(model, wire):
    """drain(migrate_to=...) hands the in-flight stream off and goes idle
    while the stream is still mid-flight: the drain never waits for a
    stream's natural end; the target finishes it token-exactly."""
    want, _ = quiet_run(make_server(model, max_new_tokens=24), PROMPT)
    src, dst = wire(2)
    gate = StepGate(src)
    t, out = _generate_async(src.address, PROMPT, "w-drain")
    gate.wait_midstream()
    src.drain(migrate_to=dst.address, reason="scale_down")
    wait_until(src, src.server._idle, "drain did not complete by migration")
    _join(t)
    assert out["code"] == 409
    assert out["body"]["migrated"]["replica"] == dst.name
    assert int(src.server.obs.counter(
        "kubetpu_migrations_total", reason="scale_down",
        result="committed").value) == 1
    with src._cv:
        assert len(src.server._free) == src.server.pool_pages
        src.server.check_invariants()
    body = request_json(dst.address + "/generate",
                        {"prompt": PROMPT, "timeout": WAIT},
                        idempotency_key="w-drain", timeout=WAIT)
    assert body["tokens"] == want
    with dst._cv:
        dst.server.check_invariants()
