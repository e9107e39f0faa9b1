"""Distributed tensor/matrix operators (PyTorch port of
``repro/core/tensor_ops.py``; paper Tables 3–5, tensor column).

The paper's Table 5 examples:

* vector addition -> ``AllReduce`` with SUM (:func:`allreduce_sum`);
* matrix multiply -> communication + local multiply
  (:func:`matmul_rowsharded`, :func:`matmul_allgather`);

plus the Horovod-style compressed gradient collective (§3.3.1):
:func:`quantized_psum` is an allreduce with an int8 wire format,
reduce-scatter by ``all_to_all`` and all-gather, with per-chunk scales
(about a quarter of the float32 bytes).  Error feedback lives in
``repro_torch.optim.compression``.

The reference's functions run inside ``shard_map`` over mesh axes; here
each takes the rank's :class:`~repro_torch.core.context.HptmtContext`
and calls its collectives (``psum``, ``all_to_all``, ``all_gather``),
which are the identity at world 1.  The int8 planes go over the wire as
int8 on every backend (gloo and NCCL both take it).
"""
from __future__ import annotations

import torch

from .context import HptmtContext

F32 = torch.float32


def allreduce_sum(x: torch.Tensor, ctx: HptmtContext) -> torch.Tensor:
    return ctx.psum(x)


def allreduce_mean(x: torch.Tensor, ctx: HptmtContext) -> torch.Tensor:
    return ctx.psum(x) / ctx.world_size


def matmul_rowsharded(a_local: torch.Tensor,
                      b_replicated: torch.Tensor) -> torch.Tensor:
    """A row-sharded (m/W, k) x B replicated (k, n) -> C row-sharded:
    no communication, the paper's 'local operator' case."""
    return a_local @ b_replicated


def matmul_allgather(a_local: torch.Tensor, b_colsharded: torch.Tensor,
                     ctx: HptmtContext) -> torch.Tensor:
    """A row-sharded (m/W, k) x B col-sharded (k, n/W) -> C row-sharded
    (m/W, n): all-gather B then multiply locally (comm ∘ local)."""
    return a_local @ torch.cat(ctx.all_gather(b_colsharded), dim=1)


def quantize_chunks(parts: torch.Tensor):
    """(world, chunk) float32 -> (int8 planes, float32 scales (world, 1)):
    symmetric per-row quantisation, ``round`` half to even as
    ``jnp.round``."""
    scale = (parts.abs().amax(dim=1, keepdim=True) / 127.0).clamp(min=1e-30)
    q = torch.round(parts / scale).clamp(-127, 127).to(torch.int8)
    return q, scale


def int8_allreduce(parts: torch.Tensor, ctx: HptmtContext):
    """The int8 reduce-scatter + all-gather of (world, chunk) float32 rows
    (row d is rank d's share): returns (the summed rows as (world *
    chunk,) float32, this rank's int8 planes before the exchange and
    their scales)."""
    world = ctx.world_size
    q, scale = quantize_chunks(parts)
    # reduce-scatter: row d of every rank reaches rank d, which sums them
    mine = (ctx.all_to_all(q).to(F32) * ctx.all_to_all(scale)).sum(dim=0)
    q2, s2 = quantize_chunks(mine[None])
    gq = torch.cat(ctx.all_gather(q2[0]))                   # (world*chunk,)
    gs = torch.cat(ctx.all_gather(s2[0]))                   # (world,)
    out = (gq.reshape(world, -1).to(F32) * gs.reshape(world, 1)).reshape(-1)
    return out, q, scale


def split_chunks(flat: torch.Tensor, world: int) -> torch.Tensor:
    """(n,) -> (world, ceil(n / world)), zero-padded."""
    n = flat.shape[0]
    chunk = -(-n // world)
    return torch.nn.functional.pad(flat, (0, world * chunk - n)) \
        .reshape(world, chunk)


def quantized_psum(x: torch.Tensor, ctx: HptmtContext,
                   bits: int = 8) -> torch.Tensor:
    """Allreduce(SUM) with the int8 wire format (reduce-scatter +
    all-gather).

    Each rank flattens, pads to ``world`` chunks, quantises each chunk
    symmetrically to int8, exchanges planes (int8) and scales (float32)
    by ``all_to_all``, sums its chunk, re-quantises it and all-gathers.
    The compression error is deterministic and the same on every rank;
    pair with error feedback (``repro_torch.optim.compression``).  At
    world 1 the exchange is the identity but both quantisations run."""
    if bits != 8:
        raise ValueError("int8 is the implemented wire format")
    flat = x.to(F32).reshape(-1)
    out, _, _ = int8_allreduce(split_chunks(flat, ctx.world_size), ctx)
    return out[:flat.shape[0]].reshape(x.shape).to(x.dtype)


def psum_pytree(tree: dict, ctx: HptmtContext) -> dict:
    return {k: ctx.psum(v) for k, v in tree.items()}


def quantized_psum_pytree(tree: dict, ctx: HptmtContext) -> dict:
    return {k: quantized_psum(v, ctx) for k, v in tree.items()}
