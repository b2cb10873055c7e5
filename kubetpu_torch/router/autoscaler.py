"""``ReplicaAutoscaler`` — SLO-driven replica scaling behind the router
(port of ``kubetpu/router/autoscaler.py``; stdlib only).

The SLO layer computes the judgment (burn rates, federated
percentiles, pool pressure); this loop ACTS on it. One reconcile pass
(``poll_once``) reads the federated signals — worst
replica queue-wait p99 and TTFT p50, pool free-page fraction, the
router's SLO fast-window burn — and folds them into a hot/cold verdict
with HYSTERESIS:

- **scale up** after ``up_after`` CONSECUTIVE hot passes (a single
  slow scrape must not buy hardware): ``launcher()`` is called (the
  operator's replica factory — boots a server, returns its URL) and
  the newcomer registers with the router, earning its ring arcs (which
  remaps only ~1/N prefix buckets — the hashring contract);
- **scale down** is MIGRATE -> DRAIN -> REMOVE:
  ``down_after`` consecutive cold passes pick the least-loaded
  routable victim, hand its in-flight streams live to the least-loaded
  ROLE-COMPATIBLE survivor (token-exact slot handoff —
  ``scale_down_migrate`` event), and drain it (routing stops
  immediately). Only when the victim's ``/load`` reads
  drained-and-idle is it removed from the ring and handed to
  ``terminator`` — a scale-down never drops a live stream AND never
  waits out a long one;
- **cooldown** after any action (``cooldown_s``) so a scale event's
  own disruption (warmup, cache cold start) can't trigger the next.

**Disaggregated fleets:** replicas carry a serving role
(``prefill`` / ``decode`` / ``both``), and the autoscaler reconciles
each role POOL independently from its OWN saturation signals — the
two halves of a disaggregated topology saturate on different things:

- the **prefill** pool is admission-bound: queue-wait p99, TTFT p50,
  fleet queue depth, the router's burn bit;
- the **decode** pool is stream-bound: inter-token latency p99 and the
  pool free-page floor (prompts never queue there — its queue/TTFT
  signals are structurally silent and must not gate scaling);
- ``both`` (colocated) replicas form the legacy pool with the original
  combined criteria — an undecomposed fleet scales exactly as before.

Each pool keeps its own hysteresis counters, cooldown, drain victim and
``ScalePolicy`` (``policies={"prefill": ..., "decode": ...}`` overrides
the shared default per role). ``launcher`` may optionally accept the
pool's role (``launcher(role) -> url``) so a scale-up boots a replica
of the starving kind; a zero-arg launcher keeps working for colocated
fleets.

Every decision is an event (``scale_up`` -> ... -> ``drain`` ->
``scale_down``, each carrying its pool's role) in the router's event
log — the ordering the acceptance test pins — plus counters/gauges on
the router registry.

The loop runs wherever the operator wants: call ``poll_once()`` from
your own scheduler, or ``start(interval)`` for the built-in daemon
thread. Stdlib only; no model state, no device work.
"""

from __future__ import annotations

import inspect
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

from kubetpu_torch.router.pool import DEAD, role_compatible
from kubetpu_torch.router.server import RouterServer


@dataclass(frozen=True)
class ScalePolicy:
    """The autoscaler's knobs. Thresholds compare against the WORST
    replica (ceilings) / the fleet aggregate (floors) — one degraded
    replica is a capacity problem even when the mean looks fine."""

    min_replicas: int = 1
    max_replicas: int = 4
    up_after: int = 3            # consecutive hot passes before scale-up
    down_after: int = 6          # consecutive cold passes before drain
    cooldown_s: float = 10.0     # quiet time after any scale action
    # hot when ANY of these trips (or the router's SLO fast window burns)
    queue_wait_p99_ms: float = 500.0
    ttft_p50_ms: float = 1000.0
    min_free_page_frac: float = 0.1
    queue_depth: int = 4         # fleet-total queued requests
    # decode-pool hot ceiling: worst replica inter-token
    # latency — the signal a pure-decode pool actually saturates on.
    # ALIGN this with any declared ITL SLO threshold: the router's
    # burn bit is fleet-global and (per the spec) drives only
    # the prefill/both pools, so a burning ITL objective TIGHTER than
    # this knob would scale the wrong pool while decode stays put
    itl_p99_ms: float = 250.0
    # cold when ALL of: queues empty, occupancy under this, not burning
    cold_active_frac: float = 0.25
    # vChips: the chip share each scale-up boots — passed to
    # ``launcher(role, frac)`` launchers so the autoscaler can scale
    # DENSITY (packed fractional replicas) and not just replica count;
    # 1.0 keeps whole-chip replicas and the legacy launcher shapes
    vchip_frac: float = 1.0
    # crash tolerance: when the breaker confirms a replica
    # DEAD and the reap removes it, immediately boot a replacement —
    # bypassing cooldown and hysteresis, which exist to damp LOAD
    # noise (a hard kill is not noise) — as long as the pool stays
    # under max_replicas. The peer prefix tier warms the
    # newcomer from the survivors' caches, so it joins warm not cold.
    crash_replace: bool = True

    def __post_init__(self):
        if not 1 <= self.min_replicas <= self.max_replicas:
            raise ValueError("need 1 <= min_replicas <= max_replicas")
        if self.up_after < 1 or self.down_after < 1:
            raise ValueError("up_after/down_after must be >= 1")
        if not 0.0 < self.vchip_frac <= 1.0:
            raise ValueError("vchip_frac must be in (0, 1]")


class ReplicaAutoscaler:
    """Reconcile each role pool's replica count against its federated
    signals."""

    def __init__(
        self,
        router: RouterServer,
        launcher: Callable[..., str],
        policy: ScalePolicy = ScalePolicy(),
        terminator: Optional[Callable[[str, str], None]] = None,
        policies: Optional[Dict[str, ScalePolicy]] = None,
    ) -> None:
        """*launcher*: boots one replica, returns its URL (raises on
        failure — the pass records the error and retries next time).
        May accept the pool's role (``launcher(role)``) so a
        disaggregated fleet scales the starving kind, and additionally
        the vChip share (``launcher(role, frac)``) so a
        scale-up boots a PACKED fractional replica sized to the pool's
        ``vchip_frac`` policy; zero-arg launchers keep the colocated
        whole-chip behavior — a one-arg launcher must never be handed a
        share it would silently drop. *terminator*: called with
        (name, url) AFTER a drained victim is removed, so the operator
        can reclaim the process/chips. *policies*: per-role
        ``ScalePolicy`` overrides (missing roles use *policy*)."""
        self.router = router
        self.launcher = launcher
        self.terminator = terminator
        self.policy = policy
        self.policies = dict(policies or {})
        try:
            sig = inspect.signature(launcher)
            nargs = 0
            var_positional = False
            frac_capable = False
            for p in sig.parameters.values():
                if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD):
                    nargs += 1
                    if nargs == 2:
                        # the share goes to a second positional only when
                        # the launcher clearly declared it: a REQUIRED
                        # second parameter, or one named for the share. A
                        # legacy `launcher(role, port_base=9000)` worked
                        # by being called with one arg —
                        # feeding 1.0 into its defaulted extra would
                        # silently misconfigure the replica.
                        frac_capable = (
                            p.default is p.empty
                            or p.name in ("frac", "vchip_frac", "share",
                                          "milli")
                        )
                elif p.kind == p.VAR_POSITIONAL:
                    var_positional = True
            if var_positional and nargs < 1:
                # a bare *args launcher keeps the legacy one-arg call
                # (it predates the share; silently handing it a second
                # positional would break `def launcher(*a): boot(*a)`
                # wrappers around one-parameter factories) — declare
                # (role, frac) explicitly to receive the share
                nargs = 1
            self._launcher_nargs = (
                2 if nargs >= 2 and frac_capable else min(nargs, 1))
        except (TypeError, ValueError):
            self._launcher_nargs = 0
        self.events = router.events
        self._lock = threading.Lock()
        self._known_pools: set = set()
        self._hot: Dict[str, int] = {}
        self._cold: Dict[str, int] = {}
        self._victim: Dict[str, str] = {}        # pool -> name mid-drain
        self._victim_url: Dict[str, str] = {}
        self._cooldown_until: Dict[str, float] = {}
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        reg = router.registry
        self._c_ups = reg.counter(
            "kubetpu_autoscaler_scale_ups_total")
        self._c_downs = reg.counter(
            "kubetpu_autoscaler_scale_downs_total")
        self._c_errors = reg.counter(
            "kubetpu_autoscaler_launch_errors_total")
        self._g_last = reg.gauge(
            "kubetpu_autoscaler_last_scale_ts",
            "wall-clock time of the last completed scale action")
        reg.gauge_fn("kubetpu_autoscaler_replicas",
                     lambda: len(router.pool.names()))
        # collect-time reads under the lock: poll_once grows these
        # dicts when a pool first appears, and a concurrent scrape
        # iterating bare .values() would raise dictionary-changed-size
        reg.gauge_fn("kubetpu_autoscaler_hot_passes",
                     lambda: self._peak(self._hot))
        reg.gauge_fn("kubetpu_autoscaler_cold_passes",
                     lambda: self._peak(self._cold))

    def _peak(self, counters: Dict[str, int]) -> int:
        with self._lock:
            return max(counters.values(), default=0)

    # -- pools ---------------------------------------------------------------

    def _pool_keys(self) -> List[str]:
        """The role pools to reconcile this pass: one per distinct role
        among ALIVE replicas (every replica belongs to exactly its own
        role's pool), any pool whose drain victim is still resolving,
        every role with a declared per-role policy, and every pool
        whose last replica this autoscaler itself REAPED
        (``_known_pools``) — a dedicated pool that crashed away must
        keep reconciling, or its ``min_replicas`` floor-heal could
        never fire and a disagg fleet that lost its whole decode pool
        would silently degrade to colocated forever. Pools emptied by
        OPERATOR removals never enter ``_known_pools`` (re-colocating
        a fleet must not fight the autoscaler), and an entry is
        discharged the moment the pool has an alive member again. An
        empty fleet with no history reads as the legacy ``both`` pool
        so floor-healing has somewhere to scale."""
        pool = self.router.pool
        alive = {pool.role(n) or "both" for n in pool.alive()}
        with self._lock:
            self._known_pools -= alive
            keys = (alive | set(self._victim) | set(self.policies)
                    | self._known_pools)
        return sorted(keys) if keys else ["both"]

    def _policy_for(self, key: str) -> ScalePolicy:
        return self.policies.get(key, self.policy)

    def _pool_names(self, key: str, names: List[str]) -> List[str]:
        pool = self.router.pool
        return [n for n in names if (pool.role(n) or "both") == key]

    # -- signals -------------------------------------------------------------

    def signals(self, role: Optional[str] = None) -> dict:
        """The federated decision inputs for one role pool (None = the
        whole fleet), from the pool's ``/load`` snapshots + the
        router's SLO engine: worst-replica queue-wait p99, TTFT p50 and
        ITL p99, fleet queue depth, occupancy, the tightest pool
        free-page fraction, and the burn bit."""
        pool = self.router.pool
        alive = pool.alive()
        routable = pool.routable()
        if role is not None:
            alive = self._pool_names(role, alive)
            routable = self._pool_names(role, routable)
        loads = [pool.snapshot(n) for n in routable]
        loads = [ld for ld in loads if ld]
        out = {
            # ALIVE capacity, not registrations: a dead handle must not
            # hold the max_replicas gate shut while the fleet burns
            "replicas": len(alive),
            "routable": len(routable),
            "burning": self.router._burning(),
            "queue_depth": sum(int(ld.get("queue_depth", 0))
                               for ld in loads),
            "queue_wait_p99_ms": max(
                (float(ld.get("queue_wait_p99_ms", 0.0)) for ld in loads),
                default=0.0),
            "ttft_p50_ms": max(
                (float(ld.get("ttft_p50_ms", 0.0)) for ld in loads),
                default=0.0),
            "itl_p99_ms": max(
                (float(ld.get("itl_p99_ms", 0.0)) for ld in loads),
                default=0.0),
        }
        active = sum(int(ld.get("active_slots", 0)) for ld in loads)
        slots = sum(int(ld.get("n_slots", 0)) for ld in loads)
        out["active_frac"] = (active / slots) if slots else 0.0
        fracs = [int(ld["pages_free"]) / max(1, int(ld["pool_pages"]))
                 for ld in loads
                 if ld.get("pages_free") is not None
                 and ld.get("pool_pages")]
        out["free_page_frac"] = min(fracs) if fracs else 1.0
        return out

    def _hot_cold(self, key: str, sig: dict):
        """Per-pool temperature: each role saturates on its
        own signals — judging a decode pool by queue depth (always 0)
        or a prefill pool by ITL (structurally tiny: one same-step
        sample per stream before handoff) would read permanently
        cold/hot regardless of real load."""
        p = self._policy_for(key)
        if key == "prefill":
            hot = (sig["burning"]
                   or sig["queue_wait_p99_ms"] > p.queue_wait_p99_ms
                   or sig["ttft_p50_ms"] > p.ttft_p50_ms
                   or sig["queue_depth"] >= p.queue_depth)
        elif key == "decode":
            hot = (sig["itl_p99_ms"] > p.itl_p99_ms
                   or sig["free_page_frac"] < p.min_free_page_frac)
        else:
            hot = (sig["burning"]
                   or sig["queue_wait_p99_ms"] > p.queue_wait_p99_ms
                   or sig["ttft_p50_ms"] > p.ttft_p50_ms
                   or sig["free_page_frac"] < p.min_free_page_frac
                   or sig["queue_depth"] >= p.queue_depth)
        cold = (not hot
                and sig["queue_depth"] == 0
                and sig["active_frac"] < p.cold_active_frac)
        return hot, cold

    # -- one reconcile pass --------------------------------------------------

    def poll_once(self) -> dict:
        """One reconcile pass over every role pool: refresh signals,
        advance each pool's hysteresis counters, maybe act. Returns
        {signals, pools, hot, cold, action, actions} — ``signals`` /
        ``hot`` / ``cold`` describe the FIRST pool (the whole fleet
        when colocated, the legacy shape), ``pools`` carries every
        pool's verdict, ``action`` the first action taken (``actions``
        all of them: independent pools may both act in one pass)."""
        self.router.pool.refresh(0.0)
        self.router.evaluate_slos(0.0)
        actions: List[str] = []
        with self._lock:
            cur_victims = set(self._victim.values())
        # reap DEAD replicas (breaker-confirmed gone): their streams
        # are lost either way, and a dead registration would otherwise
        # pin ring arcs and the max_replicas gate forever. A current
        # drain victim is left for _finish_scale_down, which owns its
        # scale_down event and terminator call.
        for name in self.router.pool.names():
            if (name not in cur_victims
                    and self.router.pool.state(name) == DEAD):
                # remember the reaped replica's pool: if this was its
                # last member, the pool must keep reconciling so the
                # floor-heal can restore it (crash-reap only — operator
                # removals go through remove_replica directly and must
                # not be fought)
                role = self.router.pool.role(name) or "both"
                with self._lock:
                    self._known_pools.add(role)
                self.router.remove_replica(name)
                self.events.emit("reap", replica=name)
                replaced = self._crash_replace(role, reaped=name)
                if replaced is not None:
                    actions.append(replaced)
        pools: Dict[str, dict] = {}
        now = time.monotonic()
        keys = self._pool_keys()
        for key in keys:
            p = self._policy_for(key)
            sig = self.signals(role=key)
            hot, cold = self._hot_cold(key, sig)
            with self._lock:
                self._hot[key] = self._hot.get(key, 0) + 1 if hot else 0
                self._cold[key] = (self._cold.get(key, 0) + 1
                                   if cold else 0)
                hot_n, cold_n = self._hot[key], self._cold[key]
                victim = self._victim.get(key)
                in_cooldown = now < self._cooldown_until.get(key, 0.0)
            action = None
            if victim is not None:
                # a drain in flight FINISHES regardless of temperature:
                # the victim is already cordoned, leaving it
                # half-drained helps no one. (A pool gone hot mid-drain
                # scales back up next pass — the counters keep
                # counting.)
                action = self._finish_scale_down(key, victim)
            elif sig["replicas"] < p.min_replicas:
                # FLOOR healing, before cooldown and without
                # hysteresis: a reaped/crashed pool below min_replicas
                # produces no hot signals (no traffic -> no latency
                # samples, SLIs absent), so waiting for heat would
                # leave "no routable replica" outages standing forever.
                # A failed launch counts an error and retries next
                # pass.
                action = self._scale_up(key, sig)
            elif in_cooldown:
                pass
            elif (hot_n >= p.up_after
                    and sig["replicas"] < p.max_replicas):
                action = self._scale_up(key, sig)
            elif (cold_n >= p.down_after
                    and sig["routable"] > p.min_replicas):
                action = self._begin_scale_down(key, sig)
            pools[key] = {"signals": sig, "hot": hot, "cold": cold,
                          "action": action}
            if action is not None:
                actions.append(action)
        first = pools[keys[0]] if pools else {
            "signals": {}, "hot": False, "cold": False}
        return {"signals": first["signals"], "hot": first["hot"],
                "cold": first["cold"], "pools": pools,
                "action": actions[0] if actions else None,
                "actions": actions}

    def _crash_replace(self, key: str, reaped: str) -> Optional[str]:
        """Reap follow-up: a breaker-confirmed crash just
        took a replica out of pool *key* — boot its replacement NOW
        instead of waiting for the pool to reheat through hysteresis
        or fall under the ``min_replicas`` floor. Bounded by
        ``max_replicas``; a failed launch counts a ``scale_error`` and
        the pool re-heals through the usual floor/heat paths. Returns
        the ``scale_up:`` action so the poll reports it."""
        p = self._policy_for(key)
        if not p.crash_replace:
            return None
        sig = self.signals(role=key)
        if sig["replicas"] >= p.max_replicas:
            return None
        action = self._scale_up(key, sig)
        if action is not None:
            self.events.emit("crash_replace", role=key, reaped=reaped,
                             replacement=action.split(":", 1)[1])
        return action

    def _scale_up(self, key: str, sig: dict) -> Optional[str]:
        if key not in ("both", None) and self._launcher_nargs < 1:
            # a zero-arg launcher cannot boot a DEDICATED role replica:
            # launching anyway would register a "both" node, leave this
            # pool at zero, and the floor-heal would buy hardware every
            # pass forever — fail loudly instead
            self._c_errors.inc()
            self.events.emit(
                "scale_error", role=key,
                error=f"pool {key!r} needs replicas but the launcher "
                      f"takes no role — pass launcher(role)")
            return None
        frac = self._policy_for(key).vchip_frac
        if frac < 1.0 and self._launcher_nargs < 2:
            # a fractional policy with a launcher that cannot
            # receive the share would silently boot WHOLE-chip replicas
            # — the fleet would look packed in config while stranding
            # 1-frac of every chip. Fail loudly, like the role case.
            self._c_errors.inc()
            self.events.emit(
                "scale_error", role=key,
                error=f"pool {key!r} wants vchip_frac={frac} but the "
                      f"launcher takes no share — pass "
                      f"launcher(role, frac)")
            return None
        try:
            if self._launcher_nargs >= 2:
                url = self.launcher(key, frac)
            elif self._launcher_nargs == 1:
                url = self.launcher(key)
            else:
                url = self.launcher()
            name = self.router.register_replica(url)
            got = self.router.pool.role(name) or "both"
            if key not in ("both", None) and got != key:
                # the launcher booted the WRONG kind: keeping it would
                # grow the fleet while this pool stays empty (the
                # floor-heal would then launch again, unbounded) —
                # treat it as a failed launch and roll it back
                self.router.remove_replica(name)
                if self.terminator is not None:
                    self.terminator(name, url)
                raise RuntimeError(
                    f"launcher({key!r}) returned a replica with role "
                    f"{got!r}")
        except Exception as e:  # noqa: BLE001 — record, retry next pass
            self._c_errors.inc()
            self.events.emit("scale_error", error=str(e), role=key)
            return None
        self._c_ups.inc()
        self._g_last.set(time.time())
        self.events.emit("scale_up", replica=name, url=url, role=key,
                         replicas=sig["replicas"] + 1,
                         reason=self._reason(key, sig))
        with self._lock:
            self._hot[key] = 0
            self._cooldown_until[key] = (time.monotonic()
                                         + self._policy_for(key).cooldown_s)
        return f"scale_up:{name}"

    def _begin_scale_down(self, key: str, sig: dict) -> Optional[str]:
        # least-loaded routable victim IN THIS POOL: fewest active
        # slots, then shallowest queue — the cheapest drain
        names = self._pool_names(key, self.router.pool.routable())
        if len(names) <= self._policy_for(key).min_replicas:
            return None

        def load_key(n):
            ld = self.router.pool.snapshot(n) or {}
            return (int(ld.get("active_slots", 0)),
                    int(ld.get("queue_depth", 0)), n)

        victim = min(names, key=load_key)
        url = self.router.pool.url(victim)
        # scale-down is migrate -> drain -> remove. The
        # victim's in-flight streams hand off live to the least-loaded
        # ROLE-COMPATIBLE survivor (a prefill victim's
        # streams go to another prefill or "both" replica, never a
        # decode-only one), so removal never waits out a long stream
        # (and the drain-timeout backstop never has to cancel one).
        # With no compatible survivor the drain falls back to waiting.
        pool = self.router.pool
        survivors = [n for n in pool.routable()
                     if n != victim
                     and role_compatible(pool.role(victim),
                                         pool.role(n))]
        target = min(survivors, key=load_key) if survivors else None
        target_url = pool.url(target) if target is not None else None
        if target_url is not None:
            self.events.emit("scale_down_migrate", replica=victim,
                             target=target, role=key)
        pool.drain(victim, migrate_to=target_url, reason="scale_down")
        self.events.emit("drain", replica=victim, reason="scale_down",
                         role=key)
        with self._lock:
            self._cold[key] = 0
            self._victim[key] = victim
            self._victim_url[key] = url
        return f"drain:{victim}"

    def _finish_scale_down(self, key: str, victim: str) -> Optional[str]:
        if not self.router.pool.drained(victim):
            return None            # still finishing in-flight work
        with self._lock:
            url = self._victim_url.pop(key, None)
            self._victim.pop(key, None)
        self.router.remove_replica(victim)
        self._c_downs.inc()
        self._g_last.set(time.time())
        self.events.emit("scale_down", replica=victim, role=key,
                         replicas=len(self.router.pool.names()))
        if self.terminator is not None and url is not None:
            try:
                self.terminator(victim, url)
            except Exception as e:  # noqa: BLE001 — reclaim best-effort
                self.events.emit("scale_error", error=str(e))
        with self._lock:
            self._cooldown_until[key] = (time.monotonic()
                                         + self._policy_for(key).cooldown_s)
        return f"scale_down:{victim}"

    def _reason(self, key: str, sig: dict) -> str:
        p = self._policy_for(key)
        if key == "decode":
            if sig["itl_p99_ms"] > p.itl_p99_ms:
                return "itl"
            return "pool_pressure"
        if sig["burning"]:
            return "slo_burn"
        if sig["queue_depth"]:
            return "queue_depth"
        if sig["free_page_frac"] < 1.0:
            return "pool_pressure"
        return "latency"

    # -- daemon loop ---------------------------------------------------------

    def start(self, interval: float = 1.0) -> None:
        """Run ``poll_once`` every *interval* seconds on a daemon
        thread until ``shutdown``."""
        self._stop.clear()

        def run():
            while not self._stop.wait(interval):
                try:
                    self.poll_once()
                except Exception as e:  # noqa: BLE001 — the loop survives
                    self._c_errors.inc()
                    self.events.emit("scale_error", error=str(e))

        self._thread = threading.Thread(
            target=run, name="kubetpu-autoscaler", daemon=True)
        self._thread.start()

    def shutdown(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
