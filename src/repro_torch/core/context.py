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
:func:`all_reduce`, :func:`all_gather` and :func:`broadcast` stage a
CUDA tensor of a gloo group through pinned host buffers: the exchange
runs on the host, the compute around it stays on the card.  With NCCL
nothing is staged.

Those four run with no gradient (serving, the table operators).
Training's collectives carry one: :func:`grad_all_to_all` (its backward
is the same exchange of the gradient), the model axis's pair
:func:`copy_to_group` (forward identity, backward sum over the group:
the input of column-parallel layers) and :func:`sum_over_group` (forward
sum, backward identity: the output of row-parallel layers),
:func:`gather_dim` (forward all-gather along a dim, backward the rank's
own block) and :func:`gather_params` (forward all-gather along a dim,
backward :func:`reduce_scatter`: an FSDP weight gather).  Where the
backend has no reduce-scatter (gloo before it had one), or the split is
uneven, :func:`reduce_scatter` is an all-reduce of which the rank keeps
its block.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.distributed as dist

from .kernel_backend import resolve_device

# observers of the collectives (the dry-run's cost counter,
# ``roofline/cost.py``): each is called with the collective's name (as
# HLO names it), the bytes of its result on this rank and its group
observers: list = []


def _observe(op: str, result: torch.Tensor, group, world: int = 1) -> None:
    """Tell the observers of one collective whose result on this rank is
    ``world`` tensors of ``result``'s size."""
    if observers:
        nbytes = world * result.numel() * result.element_size()
        for observe in observers:
            observe(op, nbytes, group)


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
    _observe("all-to-all", send, group)
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
    _observe("all-reduce", x, group)
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
    _observe("all-gather", x, group, world)
    if _staged(x, group):
        h = _host(x)
        out = [_pinned(h) for _ in range(world)]
        dist.all_gather(out, h, group=group)
        return [o.to(x.device, non_blocking=True) for o in out]
    out = [torch.empty_like(x) for _ in range(world)]
    dist.all_gather(out, x, group=group)
    return out


def broadcast(x: torch.Tensor, group, src: int = 0) -> torch.Tensor:
    """Rank ``src`` of ``group``'s ``x`` on every rank of it, as a new
    tensor (the same bits everywhere)."""
    root = dist.get_global_rank(group, src)
    _observe("broadcast", x, group)
    if _staged(x, group):
        h = _host(x)
        dist.broadcast(h, root, group=group)
        return h.to(x.device, non_blocking=True)
    x = x.clone(memory_format=torch.contiguous_format)
    dist.broadcast(x, root, group=group)
    return x


# backends found to lack a reduce-scatter (gloo before it had one)
_NO_REDUCE_SCATTER: set = set()


def reduce_scatter(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The sum of ``x`` over ``group``, of which this rank keeps block
    ``rank`` of ``dim`` (``ceil(n / world)`` rows each, the last ones
    shorter).  An even split is reduce-scattered where the backend can;
    else (an uneven split, or a gloo without it) it is an all-reduce of
    which the rank keeps its block.  A CUDA tensor of a gloo group goes
    through pinned host buffers, and only its block comes back."""
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    backend = dist.get_backend(group)
    n = x.shape[dim]
    per = math.ceil(n / world)
    lo = min(rank * per, n)
    size = min(n, lo + per) - lo
    send = x.movedim(dim, 0).contiguous()
    staged = _staged(x, group)
    if staged:
        send = _host(send)
    out = None
    if n % world == 0 and backend not in _NO_REDUCE_SCATTER:
        out = torch.empty((per,) + send.shape[1:], dtype=send.dtype,
                          device=send.device, pin_memory=staged)
        try:
            dist.reduce_scatter_tensor(out, send, group=group)
            _observe("reduce-scatter", out, group)
        except RuntimeError as e:
            if "support" not in str(e):
                raise
            _NO_REDUCE_SCATTER.add(backend)
            out = None
    if out is None:
        if staged:
            _observe("all-reduce", send, group)
            dist.all_reduce(send, group=group)     # the host copy
        else:
            send = all_reduce(send, group)
        out = send[lo:lo + size]
        if not staged:
            out = out.clone()
    if staged:
        out = out.to(x.device, non_blocking=True)
    return out.movedim(0, dim)


def _own_block(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """This rank's block of ``dim`` of an even split over ``group``."""
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    per = x.shape[dim] // world
    return x.narrow(dim, rank * per, per)


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.float(), ctx.group).to(g.dtype), None


class _SumOverGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_to_all(g, ctx.group), None


class _GatherDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, grad_sum):
        ctx.group, ctx.dim, ctx.grad_sum = group, dim, grad_sum
        return torch.cat(all_gather(x, group), dim=dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.grad_sum:
            g = reduce_scatter(g.float(), ctx.group, ctx.dim).to(g.dtype)
        else:
            g = _own_block(g, ctx.group, ctx.dim)
        return g, None, None, None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` as it is; in the backward its gradient is summed over
    ``group`` (in float32): a tensor replicated over the group that each
    rank uses for its own part of a product."""
    return _CopyToGroup.apply(x, group)


def sum_over_group(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group`` (every rank the same bits); the
    gradient passes through to each rank's ``x`` as it is."""
    return _SumOverGroup.apply(x, group)


def grad_all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """:func:`all_to_all` whose backward is the same exchange of the
    gradient (block ``s`` goes back to rank ``s``)."""
    return _AllToAll.apply(x, group)


def gather_dim(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The ranks' ``x`` (equal shapes) concatenated along ``dim`` in rank
    order; the gradient of the result replicated over the group, each
    rank's ``x`` gets its own block of it."""
    return _GatherDim.apply(x, group, dim, False)


def gather_params(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """An FSDP gather: the ranks' blocks of a weight (equal shapes)
    concatenated along ``dim``; in the backward each rank's gradient of
    the whole weight (from its own rows) is summed over the group and the
    rank keeps its block (:func:`reduce_scatter`, in float32)."""
    return _GatherDim.apply(x, group, dim, True)


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
