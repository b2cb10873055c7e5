"""``python -m kubetpu_torch.cli.gang_launch`` — turn a scheduled gang into
a real ``torch.distributed`` process group (port of
``kubetpu/cli/gang_launch.py``).

The launcher half of the multi-host story: the controller returns each
placed pod's injected env over the wire, and this launcher

1. fetches every gang member's launcher env from the control plane
   (``GET /pods/<name>``, the payload a container runtime would inject)
   before it spawns anything;
2. spawns one ``kubetpu_torch.cli.gang_worker`` OS process per member,
   rank = position in the gang, with that env; a member that names its
   devices by id (``GPU-<uuid>``) gets them as ``CUDA_VISIBLE_DEVICES``,
   the mapping a container runtime would make;
3. waits under one deadline shared by every rank and checks that every
   worker reports the SAME finite loss: the proof that the cross-process
   all-reduce (and therefore the env contract: coordinator reachability,
   rank order, device visibility) works end to end.

The backend is the launcher's choice: gloo under ``--platform cpu`` or
where two members name the same device (ranks sharing one card, which
NCCL refuses), NCCL otherwise; every report names it.

Single-machine by design (every worker spawns locally): the CI and smoke
path. On a real multi-host slice, run rank i's command on host i; the
printed ``commands`` list is exactly what to run where.

    python -m kubetpu_torch.cli.gang_launch --controller URL [--token T]
        [--platform cpu] [--timeout S] POD [POD ...]
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import socket
import subprocess
import sys
import time
from typing import Dict, List, Optional

from kubetpu_torch.jobs.launch import (select_device_env, visible_device_names,
                                       visible_devices)
from kubetpu_torch.wire.httpcommon import RetryPolicy, request_json

# env fetches ride the shared retrying client: a transient controller blip
# (reconcile hiccup, restart) costs a backoff, not an aborted launch
FETCH_RETRY = RetryPolicy(attempts=4, base_delay=0.1, max_delay=2.0,
                          deadline=60.0)
# the package root, so every worker imports the package this launcher runs
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _fetch_pod_env(controller: str, pod: str,
                   token: Optional[str]) -> Dict[str, str]:
    """The device-bearing container's injected env for a placed pod.
    Raises (via select_device_env) when no container carries a device
    env: a worker silently launched on default devices would mask the
    env-contract breakage this launcher exists to certify."""
    body = request_json(controller.rstrip("/") + f"/pods/{pod}",
                        token=token, timeout=30, retry=FETCH_RETRY)
    envs = [result.get("env", {}) if isinstance(result, dict) else {}
            for result in body.get("containers", {}).values()]
    return select_device_env(envs)


def choose_backend(pod_envs: List[Dict[str, str]],
                   platform: Optional[str]) -> str:
    """gloo on the CPU, or where two members of this machine name the
    same device (ranks sharing one card: NCCL refuses two ranks on one
    device); NCCL otherwise."""
    if platform == "cpu":
        return "gloo"
    named = [d for env in pod_envs for d in visible_devices(env)]
    return "gloo" if len(named) != len(set(named)) else "nccl"


def launch_gang(
    controller: str,
    pod_names: List[str],
    token: Optional[str] = None,
    platform: Optional[str] = None,
    coordinator_port: Optional[int] = None,
    timeout: float = 240.0,
) -> dict:
    """Spawn one worker process per gang member and collect their reports.

    Returns {"workers": [per-worker report...], "loss": common loss,
    "commands": the argv each rank ran, "trace_id": the launch's trace id}
    and raises RuntimeError when a worker fails, times out or prints no
    report, or the losses disagree (a broken cross-process all-reduce)."""
    from kubetpu_torch.obs import trace as obs_trace

    with obs_trace.span("gang_launch", component="gang-launch",
                        pods=len(pod_names)) as _root:
        out = _launch_gang_inner(controller, pod_names, token, platform,
                                 coordinator_port, timeout)
        out["trace_id"] = _root.trace_id
        return out


def _kill(p: subprocess.Popen) -> None:
    """Stop a worker and every local rank it started (its session's
    process group, which outlives a worker that died first)."""
    try:
        os.killpg(p.pid, signal.SIGKILL)
    except (ProcessLookupError, PermissionError):
        pass
    if p.returncode is None:
        p.communicate()


def _launch_gang_inner(controller, pod_names, token, platform,
                       coordinator_port, timeout) -> dict:
    port = coordinator_port or _free_port()
    # fetch EVERY env before spawning anything: a 404 on a later member
    # must not leave earlier workers orphaned at the coordinator barrier
    pod_envs = [_fetch_pod_env(controller, pod, token) for pod in pod_names]
    backend = choose_backend(pod_envs, platform)
    envs = []
    for pod_env in pod_envs:
        env = dict(os.environ)
        env.update(pod_env)
        names = visible_device_names(pod_env)
        if names and platform != "cpu":
            env["CUDA_VISIBLE_DEVICES"] = ",".join(names)
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (_ROOT, env.get("PYTHONPATH")) if p)
        envs.append(env)
    procs: List[subprocess.Popen] = []
    commands: List[List[str]] = []
    reports = []
    errors = []
    try:
        for rank, env in enumerate(envs):
            cmd = [
                sys.executable, "-m", "kubetpu_torch.cli.gang_worker",
                "--coordinator", f"127.0.0.1:{port}",
                "--num-processes", str(len(pod_names)),
                "--rank", str(rank), "--backend", backend,
            ]
            if platform:
                cmd += ["--platform", platform]
            commands.append(cmd)
            procs.append(subprocess.Popen(
                cmd, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True, start_new_session=True))
        # ONE shared deadline across ranks: a hung coordinator must cost
        # ~timeout total, not timeout x N (the other ranks are blocked on
        # the same barrier and die the moment it is gone)
        deadline = time.monotonic() + timeout
        for rank, p in enumerate(procs):
            try:
                out, err = p.communicate(
                    timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                _kill(p)
                errors.append(f"rank {rank}: timeout (shared {timeout}s "
                              f"deadline)")
                continue
            if p.returncode != 0:
                errors.append(f"rank {rank}: exit {p.returncode}: "
                              f"{err.strip()[-500:]}")
                continue
            lines = [ln for ln in out.splitlines() if ln.startswith("{")]
            if not lines:
                errors.append(f"rank {rank}: exit 0 but no JSON report")
                continue
            reports.append(json.loads(lines[-1]))
    finally:
        for p in procs:  # reap stragglers on any error path
            _kill(p)
    if errors:
        raise RuntimeError("gang launch failed: " + "; ".join(errors))
    losses = sorted({round(r["loss"], 6) for r in reports})
    if len(losses) != 1:
        raise RuntimeError(
            f"workers disagree on the all-reduced loss: {losses} — the "
            "cross-process all-reduce is broken")
    return {
        "workers": sorted(reports, key=lambda r: r["process_index"]),
        "loss": losses[0],
        "commands": commands,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--controller", required=True, help="controller base URL")
    ap.add_argument("--token", default=os.environ.get("KUBETPU_WIRE_TOKEN"))
    ap.add_argument("--platform", default=None, choices=("cpu",),
                    help="worker platform pin ('cpu' = hardware-free; "
                         "default: the card)")
    ap.add_argument("--timeout", type=float, default=240.0)
    ap.add_argument("pods", nargs="+",
                    help="gang member pod names, rank order")
    args = ap.parse_args(argv)
    out = launch_gang(
        args.controller, args.pods, token=args.token,
        platform=args.platform, timeout=args.timeout,
    )
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
