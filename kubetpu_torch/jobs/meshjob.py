"""Allocation -> ``torch.distributed`` DeviceMesh (port of
``kubetpu/jobs/meshjob.py``).

The scheduler places a gang on a contiguous block of chips; inside the job
this module turns the process group's ranks into a DeviceMesh whose axis
order respects the physical layout: the tensor-parallel axis on the
innermost (fastest-varying, physically adjacent) ranks, sequence
parallelism the next ring, data parallelism the outermost. A multislice
mesh puts ``dcn`` (the data-center network between slices) outermost.

The mesh is built over the ranks of the default process group, one rank a
device, in the JAX package's axis names; sub-groups come from
``mesh.get_group(name)``. The rank layout is computed by pure functions
(``factor_axes``, ``mesh_layout``, ``slice_groups``,
``multislice_layout``, ``allocation_order``) that take any device-like
items: ranks (ints), or objects with ``id`` and ``slice_index`` such as
JAX's devices, so the tests can hold them against the JAX package's
meshes in one process. Only ``make_mesh``, ``make_multislice_mesh`` and
``mesh_from_allocation`` touch ``torch.distributed``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

Coord = Tuple[int, ...]
DEFAULT_AXES = ("dp", "sp", "tp")


def factor_axes(n_devices: int,
                axes: Sequence[str] = DEFAULT_AXES) -> Dict[str, int]:
    """Split n devices over the mesh axes, balanced: prime factors assigned
    round-robin starting at the innermost axis (tp gets the first factor).
    n=8 -> dp=2, sp=2, tp=2."""
    sizes = {a: 1 for a in axes}
    factors: List[int] = []
    rest, d = n_devices, 2
    while rest > 1:
        while rest % d == 0:
            factors.append(d)
            rest //= d
        d += 1
    cycle = list(reversed(list(axes)))  # innermost first
    for i, f in enumerate(factors):
        sizes[cycle[i % len(cycle)]] *= f
    return sizes


def _rank(device) -> int:
    """A device-like item's rank: the int itself, or its ``id``."""
    return device if isinstance(device, (int, np.integer)) else device.id


def mesh_layout(axis_sizes: Dict[str, int], devices: Sequence) -> np.ndarray:
    """The first prod(sizes) devices, row-major in the axes' order."""
    shape = tuple(axis_sizes[a] for a in axis_sizes)
    n = int(np.prod(shape))
    devs = list(devices)
    if len(devs) < n:
        raise ValueError(f"need {n} devices for mesh {axis_sizes}, have "
                         f"{len(devs)}")
    arr = np.empty(n, dtype=object)
    arr[:] = devs[:n]
    return arr.reshape(shape)


def slice_groups(devices: Sequence) -> List[List]:
    """Group devices by the physical slice they belong to (their
    ``slice_index``, 0 when absent): groups in slice order, devices by id
    (a rank's id is the rank) within each."""
    by_slice: Dict[int, List] = {}
    for d in devices:
        by_slice.setdefault(getattr(d, "slice_index", 0) or 0, []).append(d)
    return [sorted(by_slice[s], key=_rank) for s in sorted(by_slice)]


def multislice_layout(axis_sizes: Dict[str, int], devices: Sequence,
                      explicit: bool = True
                      ) -> Tuple[Tuple[str, ...], np.ndarray]:
    """(axis names, device grid) of a multislice mesh: ``dcn`` outermost,
    whatever the dict order, then the other axes. Devices are grouped by
    ``slice_groups``; a flat list is cut into ``dcn`` equal contiguous
    chunks. An *explicit* device list must fit exactly: more slices, or a
    group larger than the inner axes, raises as too few does (a truncated
    allocation would leave scheduled chips idle)."""
    if "dcn" not in axis_sizes:
        raise ValueError("make_multislice_mesh needs a 'dcn' axis (n_slices)")
    n_slices = axis_sizes["dcn"]
    inner = {a: s for a, s in axis_sizes.items() if a != "dcn"}
    per_slice = int(np.prod(list(inner.values()))) if inner else 1
    devs = list(devices)
    groups = slice_groups(devs)
    if len(groups) == 1 and n_slices > 1:
        flat = groups[0]
        if len(flat) < n_slices * per_slice:
            raise ValueError(
                f"need {n_slices * per_slice} devices for mesh {axis_sizes}, "
                f"have {len(flat)}")
        if explicit and len(flat) > n_slices * per_slice:
            raise ValueError(
                f"mesh {axis_sizes} uses {n_slices * per_slice} devices but "
                f"{len(flat)} were supplied — truncating would leave "
                f"allocated chips idle")
        groups = [flat[i * per_slice:(i + 1) * per_slice]
                  for i in range(n_slices)]
    if len(groups) < n_slices:
        raise ValueError(f"mesh wants dcn={n_slices} slices but devices "
                         f"span only {len(groups)}")
    if explicit and len(groups) > n_slices:
        raise ValueError(
            f"mesh wants dcn={n_slices} slices but the supplied devices "
            f"span {len(groups)} — truncating would drop whole slices")
    for g in groups[:n_slices]:
        if len(g) < per_slice:
            raise ValueError(f"slice group has {len(g)} devices, inner axes "
                             f"need {per_slice}")
        if explicit and len(g) > per_slice:
            raise ValueError(
                f"slice group has {len(g)} devices but the inner axes use "
                f"{per_slice} — truncating would leave allocated chips idle")
    flat = [d for g in groups[:n_slices] for d in g[:per_slice]]
    arr = np.empty(len(flat), dtype=object)
    arr[:] = flat
    names = ("dcn",) + tuple(inner)
    return names, arr.reshape((n_slices,) + tuple(inner.values()))


def allocation_order(coords: Sequence[Coord]) -> List[int]:
    """Indices of *coords* in row-major order of the sorted coordinate
    block (the lexsort of the torus coordinates, last dimension
    fastest)."""
    return [int(i) for i in
            np.lexsort(np.array([list(c) for c in coords]).T[::-1])]


def _world_ranks() -> List[int]:
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError("a mesh needs an initialized process group "
                           "(launch.initialize_distributed or "
                           "torch.distributed.init_process_group)")
    return list(range(dist.get_world_size()))


def _device_mesh(names: Tuple[str, ...], grid: np.ndarray, device):
    import torch
    from torch.distributed.device_mesh import DeviceMesh

    from kubetpu_torch.jobs.model import resolve_device

    ranks = torch.tensor(np.vectorize(_rank, otypes=[np.int64])(grid))
    return DeviceMesh(resolve_device(device).type, ranks,
                      mesh_dim_names=names)


def make_mesh(axis_sizes: Dict[str, int], ranks: Optional[Sequence] = None,
              device=None):
    """DeviceMesh over the first prod(sizes) ranks of the process group
    (or of *ranks*), row-major, with the axes' names. *device* is where the
    mesh's tensors live: the card by default, ``"cpu"`` for a CPU world.
    Every rank of the world calls it (sub-groups are made collectively)."""
    grid = mesh_layout(axis_sizes, ranks if ranks is not None
                       else _world_ranks())
    return _device_mesh(tuple(axis_sizes), grid, device)


def make_multislice_mesh(axis_sizes: Dict[str, int],
                         ranks: Optional[Sequence] = None, device=None):
    """DeviceMesh whose outermost axis ``dcn`` spans physical slices (only
    its collectives cross the data-center network); see
    ``multislice_layout`` for the grouping. *ranks* may be ints or objects
    with ``id`` (the rank) and ``slice_index``; an explicit list must fit
    the mesh exactly, the default (every rank of the world) takes what
    fits."""
    names, grid = multislice_layout(
        axis_sizes, ranks if ranks is not None else _world_ranks(),
        explicit=ranks is not None)
    return _device_mesh(names, grid, device)


def mesh_from_allocation(coords: Sequence[Coord],
                         axis_sizes: Optional[Dict[str, int]] = None,
                         ranks: Optional[Sequence] = None, device=None):
    """DeviceMesh for a scheduled allocation: rank k sits at chip
    ``coords[k]``, and the mesh walks the ranks in row-major order of the
    sorted coordinate block, so mesh-adjacent ranks are torus-adjacent
    chips (the innermost mesh axis walks the innermost torus dimension)."""
    n = len(coords)
    if axis_sizes is None:
        axis_sizes = factor_axes(n)
    devs = list(ranks) if ranks is not None else _world_ranks()
    if int(np.prod(list(axis_sizes.values()))) != n:
        raise ValueError(f"mesh {axis_sizes} does not cover the "
                         f"allocation's {n} chips")
    if len(devs) < n:
        raise ValueError(f"allocation has {n} chips but only {len(devs)} "
                         f"devices visible")
    ordered = [devs[i] for i in allocation_order(coords)]
    return _device_mesh(tuple(axis_sizes), mesh_layout(axis_sizes, ordered),
                        device)
