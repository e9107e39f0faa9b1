"""HPTMT execution context (PyTorch port of ``repro/core/context.py``).

Loosely-synchronous execution (paper §2.2): every rank runs the same
program and synchronises only at communication operators.  In the port a
rank is one process holding one device; the collectives are
``torch.distributed`` calls on the context's process group (gloo on the
CPU, NCCL on the card).  At world size 1 no process group is needed: the
exchange and the reduction are the identity.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from .kernel_backend import resolve_device


@dataclasses.dataclass(frozen=True)
class HptmtContext:
    """One rank's view of the row decomposition: its device, the number
    of table partitions (``world_size``), its own ``rank`` and the process
    group the collectives run on (``None`` = the default group)."""

    device: torch.device
    world_size: int = 1
    rank: int = 0
    group: object = None

    def all_to_all(self, send: torch.Tensor) -> torch.Tensor:
        """Block ``d`` of axis 0 goes to rank ``d``; block ``s`` of the
        result came from rank ``s``."""
        if self.world_size == 1:
            return send
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send.contiguous(), group=self.group)
        return recv

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """Sum of ``x`` over all ranks."""
        if self.world_size == 1:
            return x
        x = x.clone()
        dist.all_reduce(x, group=self.group)
        return x

    def all_gather(self, x: torch.Tensor) -> list[torch.Tensor]:
        """Every rank's ``x`` (equal shapes), in rank order."""
        if self.world_size == 1:
            return [x]
        out = [torch.empty_like(x) for _ in range(self.world_size)]
        dist.all_gather(out, x.contiguous(), group=self.group)
        return out


def make_context(device=None, group=None) -> HptmtContext:
    """Context on ``device`` (``None`` = the CUDA card, raising when there
    is none).  World size and rank come from ``group`` when
    ``torch.distributed`` is initialised, else the world is this process."""
    device = resolve_device(device)
    if dist.is_available() and dist.is_initialized():
        world = dist.get_world_size(group)
        rank = dist.get_rank(group)
    else:
        world, rank = 1, 0
    return HptmtContext(device=device, world_size=world, rank=rank,
                        group=group)
