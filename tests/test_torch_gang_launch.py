"""The port's gang-launch CLI (``kubetpu_torch.cli.gang_launch`` and
``gang_worker``) on a gang placed by the JAX package's controller, as
tests/test_gang_launch.py runs the JAX package's: two node agents over
fake TPU managers (hosts 0 and 2 of a v5e-64), a gang of two pods of two
chips each, launched on the CPU (gloo). Each member names two devices, so
it runs two local ranks, and the world has four; the reports carry the
JAX package's meaning (``process_index`` the member's gang rank,
``process_count`` the gang size, ``global_devices`` the chips the JAX
package's workers would see) and one finite loss, equal on every member.

A pod the controller does not know raises before any worker spawns; a
failing rank is named. A GPU pod placed on a fake NVIDIA node carries
``GPU-<uuid>`` ids, the device manager's form: the port's
``launch_config`` gives one local rank per id (it raised on them
before) and the JAX package's coordinator and ranks."""

import json
import math
import subprocess
import sys
import uuid

import pytest

from kubetpu.api.types import ContainerInfo, PodInfo
from kubetpu.device import make_fake_tpus_info, new_fake_tpu_dev_manager
from kubetpu.device.nvidia import new_fake_nvidia_gpu_manager
from kubetpu.device.nvidia.types import (GpuInfo, GpusInfo, MemoryInfo,
                                         PciInfo, TopologyInfo, VersionInfo)
from kubetpu.jobs import launch as jlaunch
from kubetpu.plugintypes import ResourceGPU, ResourceTPU
from kubetpu.wire import NodeAgentServer
from kubetpu.wire.controller import ControllerServer, pod_to_json
from kubetpu_torch.cli import gang_launch
from kubetpu_torch.jobs import launch as tlaunch

from test_controller import _get, _post

CHIPS = 2


def _pod(name, resource, n):
    return PodInfo(name=name, running_containers={
        "main": ContainerInfo(requests={resource: n})})


@pytest.fixture(scope="module")
def gang():
    """A controller with two TPU agents and a placed gang w0, w1 of
    ``CHIPS`` chips each -> (controller URL, the JAX global device
    count for the same /pods payloads)."""
    agents = [NodeAgentServer(new_fake_tpu_dev_manager(
        make_fake_tpus_info("v5e-64", host_index=h)), f"h{h}")
        for h in (0, 2)]
    for a in agents:
        a.start()
    controller = ControllerServer(poll_interval=3600)
    controller.start()
    try:
        for a in agents:
            _post(controller.address + "/nodes", {"url": a.address})
        out = _post(controller.address + "/pods", {"gang": [
            pod_to_json(_pod(f"w{i}", ResourceTPU, CHIPS))
            for i in range(2)]})
        assert len(out["placements"]) == 2
        jax_devices = 0
        for name in ("w0", "w1"):
            body = _get(controller.address + f"/pods/{name}")
            env = jlaunch.select_device_env(
                [c["env"] for c in body["containers"].values()])
            jax_devices += len(env["TPU_VISIBLE_DEVICES"].split(","))
        yield controller.address, jax_devices
    finally:
        controller.shutdown()
        for a in agents:
            a.shutdown()


def _check_reports(out, jax_devices):
    workers = out["workers"]
    assert [w["process_index"] for w in workers] == [0, 1]
    assert all(w["process_count"] == 2 for w in workers)
    assert all(w["global_devices"] == jax_devices == 2 * CHIPS
               for w in workers)
    assert [w["ranks"] for w in workers] == [[0, 1], [2, 3]]
    assert all(w["local_ranks"] == CHIPS and w["backend"] == "gloo"
               for w in workers)
    assert math.isfinite(out["loss"])
    assert len({w["loss"] for w in workers}) == 1


def test_launch_gang_runs_each_member_as_its_local_ranks(gang):
    url, jax_devices = gang
    out = gang_launch.launch_gang(url, ["w0", "w1"], platform="cpu",
                                  timeout=120)
    _check_reports(out, jax_devices)
    assert out["trace_id"]
    cmds = out["commands"]
    assert [c[c.index("--rank") + 1] for c in cmds] == ["0", "1"]
    assert all(c[-4:] == ["--backend", "gloo", "--platform", "cpu"]
               for c in cmds)


def test_gang_launch_cli_as_a_process(gang):
    url, jax_devices = gang
    proc = subprocess.run(
        [sys.executable, "-m", "kubetpu_torch.cli.gang_launch",
         "--controller", url, "--platform", "cpu", "--timeout", "120",
         "w0", "w1"], capture_output=True, text=True, timeout=180)
    assert proc.returncode == 0, proc.stderr[-800:]
    _check_reports(json.loads(proc.stdout.splitlines()[-1]), jax_devices)


def test_an_unknown_pod_raises_before_any_worker_spawns(gang, monkeypatch):
    spawned = []
    monkeypatch.setattr(gang_launch.subprocess, "Popen",
                        lambda *a, **k: spawned.append(a))
    with pytest.raises(Exception, match="404"):
        gang_launch.launch_gang(gang[0], ["w0", "nope"], platform="cpu",
                                timeout=30)
    assert spawned == []


def test_a_failing_rank_is_named(gang):
    """Without ``--platform cpu`` every worker defaults to the card: on a
    host without one each rank fails, and the error names them."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the workers would run")
    with pytest.raises(RuntimeError,
                       match=r"(?s)rank 0: exit \d+.*CUDA.*rank 1: exit"):
        gang_launch.launch_gang(gang[0], ["w0", "w1"], timeout=120)


@pytest.fixture(scope="module")
def gpu_env():
    """A GPU pod of two cards placed on a fake NVIDIA node by the
    controller -> its injected env (``GPU-<uuid>`` ids)."""
    ids = [f"GPU-{uuid.UUID(int=i + 1)}" for i in range(4)]
    bus = [f"0000:{i:02X}:00.0" for i in range(4)]
    gpus = [GpuInfo(id=ids[i], model="Fake H100", path=f"/dev/nvidia{i}",
                    memory=MemoryInfo(global_mib=81559),
                    pci=PciInfo(bus_id=bus[i], bandwidth=15760),
                    topology=[TopologyInfo(bus_id=bus[j], link=5)
                              for j in range(4) if j != i])
            for i in range(4)]
    agent = NodeAgentServer(new_fake_nvidia_gpu_manager(GpusInfo(
        version=VersionInfo(driver="550", cuda="12.4"), gpus=gpus)), "gpu0")
    agent.start()
    controller = ControllerServer(poll_interval=3600)
    controller.start()
    try:
        _post(controller.address + "/nodes", {"url": agent.address})
        _post(controller.address + "/pods",
              {"pod": pod_to_json(_pod("g", ResourceGPU, 2))})
        yield gang_launch._fetch_pod_env(controller.address, "g", None)
    finally:
        controller.shutdown()
        agent.shutdown()


def test_named_gpu_ids_give_one_local_rank_each(gpu_env):
    names = gpu_env["NVIDIA_VISIBLE_DEVICES"].split(",")
    assert len(names) == 2 and all(n.startswith("GPU-") for n in names)
    hosts = ["a", "b"]
    t = tlaunch.launch_config(gpu_env, hosts, rank=1)
    j = jlaunch.launch_config(gpu_env, hosts, rank=1)
    assert t.local_device_ids == [0, 1]
    assert (t.coordinator_address, t.num_processes, t.process_id) == (
        j.coordinator_address, j.num_processes, j.process_id)
    assert t.world_size() == 4 and t.rank(1) == 3
    assert tlaunch.visible_device_names(gpu_env) == names


def test_the_launcher_picks_the_backend(gpu_env):
    """gloo on the CPU or where two members name the same card, NCCL
    where every member has cards of its own."""
    other = {"NVIDIA_VISIBLE_DEVICES": "GPU-other-a,GPU-other-b"}
    assert gang_launch.choose_backend([gpu_env, other], None) == "nccl"
    assert gang_launch.choose_backend([gpu_env, gpu_env], None) == "gloo"
    assert gang_launch.choose_backend([gpu_env, other], "cpu") == "gloo"
    assert gang_launch.choose_backend(
        [{"NVIDIA_VISIBLE_DEVICES": "0"}, {"NVIDIA_VISIBLE_DEVICES": "1"}],
        None) == "nccl"
