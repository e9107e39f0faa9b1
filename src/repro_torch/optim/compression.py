"""Horovod-style gradient compression with error feedback (PyTorch port
of ``repro/optim/compression.py``; paper §3.3.1).

:func:`compressed_grad_allreduce` averages gradients over the ranks with
the int8 wire format of ``core.tensor_ops`` (reduce-scatter by
``all_to_all`` + all-gather, about a quarter of the float32 bytes).  The
local quantisation error is carried in a residual dict and re-injected
next step (EF-SGD, Karimireddy et al. 2019), so compression stays
unbiased in the long run.  The second-stage re-quantisation error after
the local sum belongs to no single rank and is left uncorrected.  The
reference's ``_quant_chunks`` is ``core.tensor_ops.quantize_chunks``,
which the int8 allreduce of both modules shares.
"""
from __future__ import annotations

import torch

from ..core.context import HptmtContext
from ..core.tensor_ops import int8_allreduce, split_chunks

F32 = torch.float32


def init_residuals(params: dict) -> dict:
    return {k: torch.zeros(p.shape, dtype=F32, device=p.device)
            for k, p in params.items()}


def _compressed_mean_leaf(g: torch.Tensor, e: torch.Tensor,
                          ctx: HptmtContext):
    """(mean of the ranks' gradients, approximately; the new residual)."""
    world = ctx.world_size
    shape = g.shape
    flat = (g.to(F32) + e).reshape(-1)
    n = flat.shape[0]
    padded = split_chunks(flat, world)
    out, q, scale = int8_allreduce(padded, ctx)
    resid = (padded - q.to(F32) * scale).reshape(-1)[:n].reshape(shape)
    return (out[:n].reshape(shape) / world).to(g.dtype), resid


def compressed_grad_allreduce(grads: dict, residuals: dict,
                              ctx: HptmtContext):
    """Per leaf; returns (mean grads, new residuals), keyed as given."""
    outs = {k: _compressed_mean_leaf(g, residuals[k], ctx)
            for k, g in grads.items()}
    return ({k: o[0] for k, o in outs.items()},
            {k: o[1] for k, o in outs.items()})
