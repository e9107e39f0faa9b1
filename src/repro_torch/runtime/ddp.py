"""Explicit BSP distributed-data-parallel training (PyTorch port of
``repro/runtime/ddp.py``; paper §3.3, Listings 4/6): the Horovod /
PyTorch-DDP pattern, one process per rank.

Parameters are replicated; each rank computes the gradients of its
block of the batch with ``torch.autograd``; gradients are averaged with
``psum / world`` (exact) or the compressed error-feedback allreduce
(the paper's Horovod compression); the AdamW update is computed on every
rank alike (classic DDP).  This is the path of UNOMT stage 4.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..core.context import HptmtContext
from ..optim import adamw, compression


def make_ddp_train_step(loss_fn: Callable, opt_cfg: adamw.AdamWConfig,
                        ctx: HptmtContext, *, compress: bool = False):
    """``loss_fn(params, batch) -> (loss, metrics dict of scalars)``.

    Returns ``step(params, opt_state, residuals, global_batch) ->
    (params, opt_state, residuals, metrics)``.  Every rank is given the
    whole ``global_batch`` (a dict of tensors with the batch first) and
    takes its block of rows, the block ``shard_map`` gives device r in
    the reference; its leading size must divide by the world size.
    ``metrics["loss"]`` is the mean over ranks of the local losses (the
    reference's ``pmean(loss)``), not the global masked mean."""
    world, rank = ctx.world_size, ctx.rank

    def step(params, opt_state, residuals, global_batch):
        n = next(iter(global_batch.values())).shape[0]
        if n % world:
            raise ValueError(f"a batch of {n} rows does not split over "
                             f"{world} ranks")
        per = n // world
        batch = {k: v[rank * per:(rank + 1) * per]
                 for k, v in global_batch.items()}
        leaves = {k: p.detach().requires_grad_(True)
                  for k, p in params.items()}
        loss, metrics = loss_fn(leaves, batch)
        grads = dict(zip(leaves, torch.autograd.grad(
            loss, list(leaves.values()))))
        if compress:
            grads, residuals = compression.compressed_grad_allreduce(
                grads, residuals, ctx)
        else:
            grads = {k: ctx.psum(g) / world for k, g in grads.items()}
        params, opt_state, om = adamw.update(params, grads, opt_state,
                                             opt_cfg)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics.update(om)
        metrics["loss"] = ctx.psum(loss.detach()) / world
        return params, opt_state, residuals, metrics

    return step
