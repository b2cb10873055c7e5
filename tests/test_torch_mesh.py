"""The port's mesh layout and gang launch against the JAX package's: the
axis factoring, the rank grids of ``make_mesh``, ``make_multislice_mesh``
(slice grouping and its errors) and ``mesh_from_allocation`` (the lexsort
of the torus coordinates) on the same device lists, the launch configs of
one scheduled gang, and, in one 8-rank gloo world on the CPU, the
DeviceMeshes those layouts build; then ``run_gang_worker`` on 2 ranks."""

import socket

import jax
import numpy as np
import pytest

from kubetpu.api.types import ContainerInfo, PodInfo
from kubetpu.core import Cluster
from kubetpu.device import make_fake_tpus_info, new_fake_tpu_dev_manager
from kubetpu.jobs import launch as jlaunch
from kubetpu.jobs import meshjob as jmesh
from kubetpu.plugintypes import ResourceTPU
from kubetpu_torch.jobs import launch as tlaunch
from kubetpu_torch.jobs import meshjob as tmesh

from torch_mesh_worlds import spawn


class FakeDev:
    def __init__(self, i, s):
        self.id, self.slice_index = i, s


def _ids(grid):
    return [d.id for d in np.asarray(grid).flat]


@pytest.mark.parametrize("n", list(range(1, 17)) + [24, 32, 64])
def test_factor_axes_matches_jax(n):
    assert tmesh.factor_axes(n) == jmesh.factor_axes(n)
    assert (tmesh.factor_axes(n, ("dp", "tp"))
            == jmesh.factor_axes(n, ("dp", "tp")))


@pytest.mark.parametrize("axes", [{"dp": 2, "sp": 2, "tp": 2},
                                  {"dp": 4, "tp": 2}, {"sp": 8},
                                  {"dp": 1, "pp": 2, "sp": 2, "tp": 2}])
def test_mesh_layout_matches_make_mesh(axes):
    devs = jax.devices()[::-1]        # a non-trivial order
    want = jmesh.make_mesh(axes, devices=devs)
    assert _ids(tmesh.mesh_layout(axes, devs)) == _ids(want.devices)
    assert tmesh.mesh_layout(axes, list(range(8))).shape == want.devices.shape


MULTISLICE = [
    ({"dcn": 2, "dp": 1, "sp": 2, "tp": 2}, lambda: jax.devices(), False),
    ({"tp": 2, "dcn": 2}, lambda: jax.devices()[:4], True),
    ({"dcn": 2, "tp": 2}, lambda: [FakeDev(i, i // 2) for i in (3, 2, 1, 0)],
     True),
    ({"dcn": 2, "sp": 2}, lambda: [FakeDev(i, 1 - i // 2) for i in range(4)],
     True),
]


@pytest.mark.parametrize("axes,devices,explicit", MULTISLICE)
def test_multislice_layout_matches_jax(axes, devices, explicit):
    """dcn outermost whatever the dict order; slice groups by
    ``slice_index`` then id; a flat list cut into contiguous chunks."""
    devs = devices()
    want = jmesh.make_multislice_mesh(axes, devices=devs if explicit
                                      else None)
    names, grid = tmesh.multislice_layout(axes, devs, explicit=explicit)
    assert names == tuple(want.axis_names)
    assert _ids(grid) == _ids(want.devices)


MULTISLICE_ERRORS = [
    ({"dp": 2, "tp": 2}, lambda: jax.devices(), "dcn"),
    ({"dcn": 4, "tp": 4}, lambda: jax.devices(), "need 16"),
    ({"dcn": 2, "tp": 2}, lambda: jax.devices(), "truncat"),
    ({"dcn": 2, "tp": 2}, lambda: [FakeDev(i, i // 2) for i in range(6)],
     "3"),
    ({"dcn": 2, "tp": 2}, lambda: [FakeDev(0, 0), FakeDev(1, 0),
                                   FakeDev(2, 0), FakeDev(3, 1),
                                   FakeDev(4, 1)], "idle"),
    ({"dcn": 2, "tp": 2}, lambda: [FakeDev(0, 0), FakeDev(1, 0),
                                   FakeDev(2, 1)], "inner axes need"),
    ({"dcn": 3, "tp": 1}, lambda: [FakeDev(0, 0), FakeDev(1, 1)],
     "span only"),
]


@pytest.mark.parametrize("axes,devices,match", MULTISLICE_ERRORS)
def test_multislice_errors_match_jax(axes, devices, match):
    """Too few devices, and on an explicit list too many: both packages
    raise ValueError with the same message."""
    devs = devices()
    with pytest.raises(ValueError, match=match) as jerr:
        jmesh.make_multislice_mesh(axes, devices=devs)
    with pytest.raises(ValueError, match=match) as terr:
        tmesh.multislice_layout(axes, devs)
    assert str(terr.value) == str(jerr.value)


ALLOCATIONS = [
    ([(1, 0), (0, 0), (1, 1), (0, 1)], {"dp": 1, "sp": 2, "tp": 2}),
    ([(0, 1, 0), (0, 0, 1), (1, 0, 0), (0, 0, 0), (1, 1, 1), (0, 1, 1),
      (1, 0, 1), (1, 1, 0)], None),
    ([(3, 2), (2, 2), (3, 3), (2, 3)], {"dp": 2, "tp": 2}),
]


@pytest.mark.parametrize("coords,axes", ALLOCATIONS)
def test_mesh_from_allocation_order_matches_jax(coords, axes):
    devs = jax.devices()[:len(coords)]
    want = jmesh.mesh_from_allocation(coords, axes, devices=devs)
    order = tmesh.allocation_order(coords)
    assert [devs[i].id for i in order] == _ids(want.devices)


def _gang_cluster():
    cluster = Cluster()
    for h in range(4):
        cluster.register_node(f"host{h}", device=new_fake_tpu_dev_manager(
            make_fake_tpus_info("v5e-64", host_index=h)))
    return cluster


@pytest.mark.parametrize("n_workers,chips", [(2, 8), (4, 8), (2, 4)])
def test_gang_launch_configs_match_jax(n_workers, chips):
    """One scheduled gang: the port's configs (from the same Cluster) are
    the JAX package's field by field; the port's world has one rank a
    local device."""
    cluster = _gang_cluster()
    placed = cluster.schedule_gang([PodInfo(
        name=f"w{i}", running_containers={"m": ContainerInfo(
            requests={ResourceTPU: chips})}) for i in range(n_workers)])
    want = jlaunch.gang_launch_configs(cluster, placed)
    got = tlaunch.gang_launch_configs(cluster, placed)
    for g, w in zip(got, want):
        assert (g.coordinator_address, g.num_processes, g.process_id,
                g.local_device_ids) == (w.coordinator_address,
                                        w.num_processes, w.process_id,
                                        w.local_device_ids)
        assert g.world_size() == n_workers * chips
        kw = g.initialize_kwargs("nccl", local_rank=1)
        assert kw == {"backend": "nccl",
                      "init_method": f"tcp://{w.coordinator_address}",
                      "world_size": n_workers * chips,
                      "rank": w.process_id * chips + 1}


ENVS = [
    [{}, {"TPU_VISIBLE_DEVICES": "0,1", "TPU_WORKER_ID": "1"}],
    [{"NVIDIA_VISIBLE_DEVICES": "2,3"}],
    # the device manager's form: GPU ids, one local rank each
    [{"NVIDIA_VISIBLE_DEVICES": "GPU02,GPU05"}],
    [{"X": "1"}, {}],
]
# a GPU container's local devices for the port: ordinals as named, ids
# as the ordinals 0 .. n-1 a container runtime exposes them at
GPU_LOCAL = {"2,3": [2, 3], "GPU02,GPU05": [0, 1]}


@pytest.mark.parametrize("envs", ENVS)
def test_select_device_env_and_launch_config_match_jax(envs):
    try:
        want = jlaunch.select_device_env(envs)
    except ValueError as e:
        with pytest.raises(ValueError, match="no container env"):
            tlaunch.select_device_env(envs)
        assert "no container env" in str(e)
        return
    assert tlaunch.select_device_env(envs) == want
    hosts = ["a", "b", "c"]
    j = jlaunch.launch_config(want, hosts)
    t = tlaunch.launch_config(want, hosts)
    assert (t.coordinator_address, t.num_processes, t.process_id) == (
        j.coordinator_address, j.num_processes, j.process_id)
    if "TPU_VISIBLE_DEVICES" in want:
        assert t.local_device_ids == j.local_device_ids
    else:       # a GPU container names its devices for the port
        assert t.local_device_ids == GPU_LOCAL[want["NVIDIA_VISIBLE_DEVICES"]]
    with pytest.raises(ValueError, match="outside"):
        tlaunch.launch_config(want, hosts, rank=3)
    with pytest.raises(ValueError, match="outside"):
        jlaunch.launch_config(want, hosts, rank=3)


def test_initialize_distributed_is_a_noop_for_one_rank():
    tlaunch.initialize_distributed(None, "gloo")
    tlaunch.initialize_distributed(
        tlaunch.LaunchConfig("x:1", num_processes=1, process_id=0,
                             local_device_ids=[0]), "gloo")
    tlaunch.initialize_distributed(
        tlaunch.LaunchConfig("x:1", num_processes=1, process_id=0,
                             local_device_ids=[]), "nccl")


# -- the DeviceMeshes, built in one 8-rank world ------------------------------

WORLD_MESHES = [
    ("make_mesh", ({"dp": 2, "sp": 2, "tp": 2},)),
    ("make_mesh", ({"dp": 1, "pp": 2, "sp": 2, "tp": 2},)),
    ("make_multislice_mesh", ({"tp": 2, "dcn": 2, "sp": 2},)),
    ("mesh_from_allocation", (ALLOCATIONS[1][0],)),
]


@pytest.fixture(scope="module")
def mesh_world(tmp_path_factory):
    return spawn("meshes", 8, tmp_path_factory.mktemp("meshes"),
                 {"meshes": WORLD_MESHES})


@pytest.mark.parametrize("i", range(len(WORLD_MESHES)))
def test_device_meshes_hold_the_layout(mesh_world, i):
    """Every rank's DeviceMesh has the JAX package's rank grid and names,
    and its sub-group of each axis is the grid's line through the rank."""
    kind, args = WORLD_MESHES[i]
    devs = jax.devices()
    if kind == "make_mesh":
        want = jmesh.make_mesh(*args, devices=devs)
    elif kind == "make_multislice_mesh":
        want = jmesh.make_multislice_mesh(*args, devices=devs)
    else:
        want = jmesh.mesh_from_allocation(*args, devices=devs)
    grid = np.asarray([d.id for d in want.devices.flat]).reshape(
        want.devices.shape)
    for rank, res in enumerate(mesh_world):
        assert res["foreign"] == []
        got = res["cases"][i]
        assert got["names"] == tuple(want.axis_names)
        assert got["grid"] == grid.tolist()
        where = tuple(int(x[0]) for x in np.nonzero(grid == rank))
        for ax, name in enumerate(want.axis_names):
            line = list(where)
            line[ax] = slice(None)
            assert got["groups"][name] == sorted(grid[tuple(line)].tolist())


@pytest.fixture(scope="module")
def gang_world(tmp_path_factory):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    return spawn("gang", 2, tmp_path_factory.mktemp("gang"),
                 {"coordinator": f"127.0.0.1:{port}", "seed": 0},
                 init=False)


@pytest.mark.parametrize("rank", [0, 1])
def test_run_gang_worker_gives_one_finite_loss(gang_world, rank):
    """Two ranks joined through a tcp coordinator: each reports its rank
    of a world of 2 and the same finite global loss."""
    res = gang_world[rank]
    assert res["foreign"] == []
    assert (res["process_index"], res["process_count"],
            res["global_devices"]) == (rank, 2, 2)
    assert np.isfinite(res["loss"])
    assert res["loss"] == gang_world[0]["loss"]
