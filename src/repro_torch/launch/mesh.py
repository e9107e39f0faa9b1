"""Device meshes (PyTorch port of ``repro/launch/mesh.py``).

A :class:`Mesh` is this process's view of a grid of ranks: the axis
names, their sizes, this rank's coordinate on each axis and one
``torch.distributed`` group per axis, holding the ranks that differ from
this one only along it; where the mesh has both batch axes (``pod`` and
``data``), also one group of the two together, holding the ranks that
share this one's model coordinate, pod major (a batch's rows are cut
over them).  Ranks are laid out row-major over the axes (the
last axis fastest), as ``jax.make_mesh`` lays out devices.  The kernels
are ``ctypes`` calls on local tensors, so nothing propagates layouts
between them: each layer holds its slice and calls the collective it
needs on the axis group (``core.context.all_reduce`` and friends).

Functions, not module-level constants: importing this module touches no
process group.
"""
from __future__ import annotations

import dataclasses
import math
import os
from datetime import timedelta

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``shape`` maps each axis name to its size, ``coord`` to this rank's
    index along it, ``groups`` to the process group of that axis (None
    for an axis of one rank, or without a process group); ``joint`` maps
    a tuple of axes to the group of those axes together
    (:data:`BATCH_AXES`)."""
    axis_names: tuple[str, ...]
    shape: dict
    coord: dict
    groups: dict
    joint: dict = dataclasses.field(default_factory=dict)

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def group_of(self, axes: tuple[str, ...]):
        """The process group of ``axes`` together (None for one rank):
        ranks in the order of their index over ``axes``, the first axis
        major."""
        axes = tuple(a for a in axes if self.shape[a] > 1)
        if not axes:
            return None
        if len(axes) == 1:
            return self.groups[axes[0]]
        return self.joint.get(axes)


# the batch axes, in the order of ``models.sharding.make_policy``
BATCH_AXES = ("pod", "data")


def init_rank(rank: int, world: int, store_path: str, device,
              timeout_s: float = 600.0, *, local_world: int | None = None,
              init_method: str | None = None) -> str:
    """Join the process group of ``world`` ranks that meet through the
    ``file://`` store at ``store_path`` (a path in a fresh temporary
    directory), or through ``init_method`` (``tcp://host:port``) when
    given.  The backend is NCCL where every rank has its own card, gloo
    where the ranks run on the CPU or share one card (NCCL refuses two
    ranks on one device): the ranks on this host (``local_world``,
    default ``world``) are counted against its cards.  Returns the
    backend."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    backend = "gloo" if device.type != "cuda" \
        or torch.cuda.device_count() < (local_world or world) else "nccl"
    dist.init_process_group(backend,
                            init_method=init_method
                            or f"file://{store_path}",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=timeout_s))
    return backend


def init_from_env(coordinator: str, device=None,
                  timeout_s: float = 600.0) -> tuple[int, int, torch.device]:
    """Join a process group through ``tcp://coordinator`` (``host:port``)
    as one rank: the rank and world size from ``RANK`` and
    ``WORLD_SIZE``, the card from ``LOCAL_RANK`` (the CPU under
    ``device="cpu"``), the ranks on this host from ``LOCAL_WORLD_SIZE``,
    as ``torchrun`` sets them.  Returns (rank, world, device)."""
    try:
        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    except KeyError as e:
        raise SystemExit(f"--coordinator needs {e.args[0]} in the "
                         "environment (RANK, WORLD_SIZE and LOCAL_RANK, as "
                         "torchrun sets them)") from None
    local = int(os.environ.get("LOCAL_RANK", 0))
    if device is not None and torch.device(device).type == "cpu":
        device = torch.device("cpu")
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device (pass device='cpu')")
        device = torch.device("cuda", local % torch.cuda.device_count())
    init_rank(rank, world, "", device, timeout_s,
              local_world=int(os.environ.get("LOCAL_WORLD_SIZE", world)),
              init_method=f"tcp://{coordinator}")
    return rank, world, device


def make_mesh(shape: dict) -> Mesh:
    """The mesh of the initialised process group: ``shape`` (axis name ->
    size, in major-to-minor order) must multiply to the world size.
    Every rank calls this with the same shape: each axis group is made
    with ``dist.new_group``, which every rank must call for every
    group."""
    names = tuple(shape)
    sizes = dict(shape)
    world = math.prod(sizes.values())
    batch = [a for a in names if a in BATCH_AXES]
    if batch != [a for a in BATCH_AXES if a in names]:
        raise ValueError(f"mesh {sizes}: the batch axes go in the order "
                         f"{BATCH_AXES} (a batch's rows are cut pod major)")
    if dist.is_initialized():
        have, rank = dist.get_world_size(), dist.get_rank()
    else:
        have, rank = 1, 0
    if have != world:
        raise ValueError(f"mesh {sizes} needs {world} ranks, the process "
                         f"group has {have}")
    coord, rest = {}, rank
    for a in reversed(names):
        coord[a] = rest % sizes[a]
        rest //= sizes[a]
    coord = {a: coord[a] for a in names}
    strides, s = {}, 1
    for a in reversed(names):
        strides[a] = s
        s *= sizes[a]

    def group(axes):
        """This rank's group of ``axes`` together: every rank calls
        ``dist.new_group`` for every line of ranks along them, in the same
        order (``new_group`` sorts its ranks, and the first axis is the
        major one, so a group rank is the index over ``axes``)."""
        others = [b for b in names if b not in axes]
        n = math.prod(sizes[a] for a in axes)
        mine = None
        for idx in range(world // n):
            base, rest = 0, idx
            for b in reversed(others):
                base += (rest % sizes[b]) * strides[b]
                rest //= sizes[b]
            ranks = []
            for j in range(n):
                off, rest = 0, j
                for a in reversed(axes):
                    off += (rest % sizes[a]) * strides[a]
                    rest //= sizes[a]
                ranks.append(base + off)
            g = dist.new_group(sorted(ranks))
            if rank in ranks:
                mine = g
        return mine

    live = dist.is_initialized()
    groups = {a: group((a,)) if live and sizes[a] > 1 else None
              for a in names}
    batch = tuple(a for a in BATCH_AXES if a in names and sizes[a] > 1)
    joint = {batch: group(batch)} if live and len(batch) > 1 else {}
    return Mesh(axis_names=names, shape=sizes, coord=coord, groups=groups,
                joint=joint)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(dict(zip(axes, shape)))


def make_debug_mesh(data: int = 2, model: int = 4, pod: int = 0) -> Mesh:
    """Small mesh for tests (same axis names as production)."""
    if pod:
        return make_mesh({"pod": pod, "data": data, "model": model})
    return make_mesh({"data": data, "model": model})


def parse_mesh(spec: str) -> dict:
    """``"data=1,model=2"`` -> ``{"data": 1, "model": 2}``."""
    out = {}
    for kv in spec.split(","):
        name, _, n = kv.partition("=")
        if not name or not n.isdigit() or int(n) < 1:
            raise ValueError(f"bad mesh axis {kv!r} in {spec!r} (expected "
                             "name=size, e.g. data=1,model=2)")
        out[name.strip()] = int(n)
    return out


def abstract_mesh(shape: dict, coord: dict | None = None) -> Mesh:
    """A mesh without process groups (specs and slices only): ``coord``
    defaults to the origin."""
    names = tuple(shape)
    return Mesh(axis_names=names, shape=dict(shape),
                coord=dict(coord or {a: 0 for a in names}),
                groups={a: None for a in names})
