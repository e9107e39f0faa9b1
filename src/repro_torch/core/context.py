"""HPTMT execution context (PyTorch port of ``repro/core/context.py``).

Loosely-synchronous execution (paper §2.2): every rank runs the same
program and synchronises only at communication operators.  In the port a
rank is one process holding one device; the collectives are
``torch.distributed`` calls on the context's process group (gloo on the
CPU, NCCL on the card).  At world size 1 no process group is needed: the
exchange and the reduction are the identity.

A gloo group may also hold CUDA tensors: ranks that share one card
cannot form an NCCL group.  Gloo does not take CUDA tensors in every
collective (``all_to_all_single`` refuses them), so :func:`all_to_all`,
:func:`all_reduce` and :func:`all_gather` stage a CUDA tensor of a gloo
group through pinned host buffers: the exchange runs on the host, the
compute around it stays on the card.  With NCCL nothing is staged.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from .kernel_backend import resolve_device


def _staged(t: torch.Tensor, group) -> bool:
    """Whether ``t`` goes through host buffers: a CUDA tensor on gloo."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _pinned(like: torch.Tensor) -> torch.Tensor:
    """An empty pinned host buffer shaped as ``like`` (``empty_like`` of
    a pinned tensor is not pinned, and a pageable buffer turns the copy
    back to the card into a slow synchronous one)."""
    return torch.empty(like.shape, dtype=like.dtype, pin_memory=True)


def _host(t: torch.Tensor) -> torch.Tensor:
    out = _pinned(t)
    out.copy_(t)
    return out


def all_to_all(send: torch.Tensor, group=None) -> torch.Tensor:
    """Block ``d`` of axis 0 goes to rank ``d`` of ``group``; block ``s``
    of the result came from rank ``s``."""
    send = send.contiguous()
    if _staged(send, group):
        hs = _host(send)
        hr = _pinned(hs)
        dist.all_to_all_single(hr, hs, group=group)
        return hr.to(send.device, non_blocking=True)
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return recv


def all_reduce(x: torch.Tensor, group=None) -> torch.Tensor:
    """Sum of ``x`` over ``group``, as a new tensor (every rank gets the
    same bits)."""
    if _staged(x, group):
        h = _host(x)
        dist.all_reduce(h, group=group)
        return h.to(x.device, non_blocking=True)
    x = x.clone()
    dist.all_reduce(x, group=group)
    return x


def all_gather(x: torch.Tensor, group=None) -> list[torch.Tensor]:
    """Every rank's ``x`` (equal shapes), in rank order."""
    x = x.contiguous()
    world = dist.get_world_size(group)
    if _staged(x, group):
        h = _host(x)
        out = [_pinned(h) for _ in range(world)]
        dist.all_gather(out, h, group=group)
        return [o.to(x.device, non_blocking=True) for o in out]
    out = [torch.empty_like(x) for _ in range(world)]
    dist.all_gather(out, x, group=group)
    return out


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
        return all_to_all(send, self.group)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """Sum of ``x`` over all ranks."""
        if self.world_size == 1:
            return x
        return all_reduce(x, self.group)

    def all_gather(self, x: torch.Tensor) -> list[torch.Tensor]:
        """Every rank's ``x`` (equal shapes), in rank order."""
        if self.world_size == 1:
            return [x]
        return all_gather(x, self.group)


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
