"""Mixture-of-Experts layers (PyTorch port of ``repro/models/moe.py``).

The paper's central operator, the table Shuffle (hash partition +
``all_to_all``), *is* MoE token dispatch: rows are tokens, the partition
key is the routed expert, the destination shard is the expert's owner.
Three paths, chosen by :func:`moe_apply` as the reference chooses them:

* ``moe_dense``   — every expert on every token, gates zero outside each
  token's top-k: without a policy (world 1), and where the experts or the
  sequence do not split over the model axis.  :func:`_expert_ffn` is the
  per-expert FFN of all three paths; ``moe_dense`` runs it on the tokens
  broadcast to every expert (the reference's ``td,edf->tef`` products, as
  batched products that read each expert's weights once);
* ``moe_shuffle`` — expert parallelism for prefill: each model rank takes
  its ``S / world`` slice of the sequence, ranks the routed rows within
  their expert on the ``hash_partition`` kernel, scatters them into
  ``(owner, local expert, capacity)`` slots (a trash slot past the
  capacity), exchanges them with one ``all_to_all`` over the model group,
  runs its local experts, sends the rows back and combines them with the
  gates; the ranks then all-gather their slices;
* ``moe_decode``  — the decode step's few tokens stay replicated: each
  rank serves its local experts (the same kernel ranks its rows) and an
  all-reduce over the model group combines them.

On a data axis of several ranks each data rank runs either path on its
own rows of the batch (every row where they do not split over the data
ranks, as a slot prefill's one row: the reference's ``_batch_axes_for``),
its exchanges over the model group of its data row; ``moe_decode``'s
capacity comes from the rank's rows, so what drops depends on the split,
as in the reference.

A call of either dispatch path appends its rows dropped past the
capacity (a device scalar, this rank's count) to :data:`drop_log` when
that is a list, and a call made again by a remat recompute appends it as
:class:`Recomputed`, so the log keeps one plain entry per forward call;
the reference discards the count.

Both dispatch paths train: their exchanges are ``core.context``'s
collectives with gradients (``grad_all_to_all``, the all-gather of the
sequence slices by ``gather_dim``), the replicated input and router
enter through ``copy_to_group`` (each rank's gradient covers its own
tokens or experts and is summed over the model group), and the payload
scatter and the gated combine are autograd ops (``moe_shuffle`` sums a
token's k rows over a dim: the same bits on every run, so a step
repeats exactly on the card, where ``index_add_`` adds by atomics).
``aux`` is the
mean over the model ranks (with its gradient); the data ranks' mean is
the train step's.  Uneven expert counts
are parameter-padded to a multiple of 16 (:func:`n_experts_padded`;
``cfg.n_experts`` stays the routing width and the pads receive no
rows).  The router is float32 in serving and in training and its product
runs in float32; the expert products run in bf16 and round to bf16
before the float32 combine, as the reference's.
"""
from __future__ import annotations

import contextlib
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..core.context import all_reduce, copy_to_group, gather_dim, \
    grad_all_to_all, sum_over_group
from ..kernels.hash_partition.ops import radix_histogram_ranks
from . import layers as Ly
from . import sharding

F32 = torch.float32

# None, or a list each dispatch call appends its dropped-row count to
drop_log: list | None = None
_recomputing = False


class Recomputed(NamedTuple):
    """A :data:`drop_log` entry of a call made by a remat recompute."""
    dropped: torch.Tensor


@contextlib.contextmanager
def recompute():
    """Mark the dispatch calls made inside as a recompute's."""
    global _recomputing
    before, _recomputing = _recomputing, True
    try:
        yield
    finally:
        _recomputing = before


def n_experts_padded(cfg) -> int:
    E = cfg.n_experts
    return math.ceil(E / 16) * 16 if E >= 16 else E


def moe_init(gen: torch.Generator, cfg, n: int, dtype=Ly.BF16) -> dict:
    """``n`` stacked MoE FFNs: the float32 router ``(n, d, n_experts)``
    and the experts ``(n, E_pad, d, f)`` / ``(n, E_pad, f, d)`` in
    ``dtype``, drawn with the reference's scales."""
    d = cfg.d_model
    E = n_experts_padded(cfg)
    f = cfg.d_expert_ff or cfg.d_ff
    std = Ly.INIT_STD
    return {
        "router": Ly.normal(gen, (n, d, cfg.n_experts), std, F32),
        "e_gate": Ly.normal(gen, (n, E, d, f), std, dtype),
        "e_up": Ly.normal(gen, (n, E, d, f), std, dtype),
        "e_down": Ly.normal(gen, (n, E, f, d),
                            std / math.sqrt(2 * cfg.n_layers), dtype),
    }


def _route(router, x2d, top_k: int):
    """x2d (T, d) -> (weights (T,k) f32, ids (T,k) int32, aux scalar): the
    top-k of the float32 router's softmax, largest first, renormalised;
    ``aux = E * sum(frac * pmean)`` with ``frac`` the share of tokens whose
    first choice is each expert."""
    logits = x2d.float() @ router.float()
    probs = torch.softmax(logits, dim=-1)
    vals, ids = torch.topk(probs, top_k, dim=-1, sorted=True)
    w = vals / torch.clamp(vals.sum(dim=-1, keepdim=True), min=1e-9)
    E = router.shape[1]
    frac = F.one_hot(ids[:, 0], E).to(F32).mean(dim=0)
    pmean = probs.mean(dim=0)
    aux = E * torch.sum(frac * pmean)
    return w, ids.to(torch.int32), aux


def _expert_ffn(eg, eu, ed, xb):
    """xb (E_loc, C, d) -> (E_loc, C, d); bf16 products, one per expert."""
    bf = Ly.BF16
    xb = xb.to(bf)
    g = F.silu(torch.matmul(xb, eg.to(bf)))
    u = torch.matmul(xb, eu.to(bf))
    return torch.matmul(g * u, ed.to(bf))


class _BatchMean(torch.autograd.Function):
    """The mean of ``x`` over a group (the same bits on every rank); its
    gradient passes to each rank's ``x`` whole: every rank's loss holds
    the mean and the train step averages the ranks' gradients, so the
    mean's gradient reaches each ``x`` with weight 1 / D, as the whole
    batch's loss gives it."""

    @staticmethod
    def forward(ctx, x, group, D):
        return all_reduce(x, group) / D

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def _batch_aux(router, x2d, ids, policy):
    """The reference's ``aux`` of ``moe_dense`` under a mesh, whose
    compiler takes ``frac`` and ``pmean`` over the whole batch: this
    rank's (its rows, ``ids`` as routed), averaged over the batch
    group (equal blocks of rows)."""
    probs = torch.softmax(x2d.float() @ router.float(), dim=-1)
    E = router.shape[1]
    group, D = policy.batch_group, policy.world_d
    frac = all_reduce(F.one_hot(ids[:, 0].long(), E).to(F32).mean(dim=0),
                      group) / D
    pmean = _BatchMean.apply(probs.mean(dim=0), group, D)
    return E * torch.sum(frac * pmean)


def _global_aux(policy, router) -> bool:
    """Whether a dense MoE layer takes :func:`_batch_aux`: on batch axes
    of several ranks, where the aux reaches a loss (the router takes a
    gradient; serving discards the aux)."""
    return policy is not None and policy.world_d > 1 \
        and torch.is_grad_enabled() and router.requires_grad


def moe_dense(p, cfg, x, policy=None):
    """x (B, S, d) -> (y (B, S, d) in x's dtype, aux): every one of the
    ``cfg.n_experts`` experts on every token, combined in float32 with
    the gates, which are zero outside each token's top-k.  Under a
    ``policy`` on batch axes of several ranks, in training, ``aux`` is
    the whole batch's (:func:`_batch_aux`)."""
    B, S, d = x.shape
    E = cfg.n_experts
    x2 = x.reshape(B * S, d)
    w, ids, aux = _route(p["router"], x2, cfg.top_k)
    if _global_aux(policy, p["router"]):
        aux = _batch_aux(p["router"], x2, ids, policy)
    gates = torch.zeros((B * S, E), dtype=F32, device=x.device) \
        .scatter(1, ids.long(), w)                            # (T, E)
    o = _expert_ffn(p["e_gate"][:E], p["e_up"][:E], p["e_down"][:E],
                    x2.to(Ly.BF16).expand(E, B * S, d))       # (E, T, d)
    y = torch.einsum("etd,te->td", o.float(), gates)
    return y.reshape(B, S, d).to(x.dtype), aux


# --------------------------------------------------------------------------
# shuffle-dispatch expert parallelism (prefill) — the paper's operator
# --------------------------------------------------------------------------


def _log_drops(n: torch.Tensor) -> None:
    if drop_log is not None:
        drop_log.append(Recomputed(n) if _recomputing else n)


def _dense_fallback(p, cfg, x, policy):
    """``moe_dense`` where a dispatch path falls back: under a sharded
    model axis on this rank's block of the experts (its slice from
    ``shard_params``), summed over the model group."""
    if not policy.sharded:
        return moe_dense(p, cfg, x, policy)
    B, S, d = x.shape
    E = cfg.n_experts
    group = policy.model_group
    lo = sharding.block(n_experts_padded(cfg), policy.world_m,
                        policy.model_rank).start
    hi = min(lo + p["e_gate"].shape[0], E)
    x2 = x.reshape(B * S, d)
    w, ids, aux = _route(p["router"], x2, cfg.top_k)
    if _global_aux(policy, p["router"]):
        aux = _batch_aux(p["router"], x2, ids, policy)
    # every rank routes every token alike; the gates' and the tokens'
    # gradients from its own experts are summed over the group
    gates = copy_to_group(torch.zeros((B * S, E), dtype=F32,
                                      device=x.device)
                          .scatter(1, ids.long(), w), group)[:, lo:hi]
    n = hi - lo
    o = _expert_ffn(p["e_gate"][:n], p["e_up"][:n], p["e_down"][:n],
                    copy_to_group(x2, group).to(Ly.BF16)
                    .expand(n, B * S, d))
    y = torch.einsum("etd,te->td", o.float(), gates)
    y = sum_over_group(y, group)
    return y.reshape(B, S, d).to(x.dtype), aux


def moe_shuffle(p, cfg, x, policy, capacity_factor: float = 1.25):
    """x (B, S, d), replicated over the model axis -> (y (B, S, d), aux).
    ``p`` holds this rank's ``E_pad / world`` experts (``shard_params``).
    Falls back to ``moe_dense`` where the reference does."""
    world_m = policy.world_m
    E = cfg.n_experts
    E_pad = n_experts_padded(cfg)
    B, S, d = x.shape
    if world_m == 1 or E_pad % world_m != 0 or S % world_m != 0:
        return _dense_fallback(p, cfg, x, policy)
    group = policy.model_group
    r = policy.model_rank
    E_loc = E_pad // world_m
    s = S // world_m
    # each rank's gradient of x and of the router covers its own tokens
    x_loc = copy_to_group(x, group)[:, r * s:(r + 1) * s]
    T = B * s
    k = cfg.top_k
    C_send = max(1, math.ceil(T * k / E * capacity_factor))
    slots = E_loc * C_send
    x2 = x_loc.reshape(T, d)
    w, ids, aux = _route(copy_to_group(p["router"], group), x2, k)

    # the shuffle plan: the stable rank of each routed row in its expert
    eid = ids.reshape(-1)                                     # (T*k,)
    src = torch.arange(T, device=x.device).repeat_interleave(k)
    wf = w.reshape(-1).float()
    _, ranks = radix_histogram_ranks(eid, E)
    eid, ranks = eid.long(), ranks.long()
    owner, le = eid // E_loc, eid % E_loc
    ok = ranks < C_send
    _log_drops((~ok).sum())
    flat = torch.where(ok, owner * slots + le * C_send + ranks,
                       world_m * slots)
    payload = torch.zeros((world_m * slots + 1, d), dtype=Ly.BF16,
                          device=x.device)
    payload[flat] = x2.to(Ly.BF16)[src]
    payload = payload[:-1].reshape(world_m, slots, d)

    recv = grad_all_to_all(payload, group)           # (world, slots, d)
    xb = recv.reshape(world_m, E_loc, C_send, d).transpose(0, 1) \
        .reshape(E_loc, world_m * C_send, d)
    h = _expert_ffn(p["e_gate"], p["e_up"], p["e_down"], xb)
    h = h.reshape(E_loc, world_m, C_send, d).transpose(0, 1) \
        .reshape(world_m, slots, d)
    y_rows = grad_all_to_all(h, group).reshape(world_m * slots, d)

    g = y_rows[flat.clamp(max=world_m * slots - 1)].float()
    contrib = g * (wf * ok)[:, None]
    # the gated sum of each token's k rows (the reference's scatter-add
    # over src, whose k rows a token are adjacent): a sum over a dim, in
    # the same order on every run, where index_add_'s atomics are not
    y = contrib.reshape(T, k, d).sum(dim=1)
    y = gather_dim(y.reshape(B, s, d).to(x.dtype), group, 1)
    return y, sum_over_group(aux, group) / world_m


# --------------------------------------------------------------------------
# decode: replicated tokens, local experts, all-reduce combine
# --------------------------------------------------------------------------


def moe_decode(p, cfg, x, policy, capacity_factor: float = 4.0):
    """x (B, S, d) replicated -> (y, aux): each rank's experts on the rows
    routed to them, summed over the model group."""
    world_m = policy.world_m
    E = cfg.n_experts
    E_pad = n_experts_padded(cfg)
    if world_m == 1 or E_pad % world_m != 0:
        return _dense_fallback(p, cfg, x, policy)
    group = policy.model_group
    r = policy.model_rank
    B, S, d = x.shape
    T = B * S
    k = cfg.top_k
    E_loc = E_pad // world_m
    C = max(8, math.ceil(T * k / E * capacity_factor))
    x2 = x.reshape(T, d)
    w, ids, aux = _route(p["router"], x2, k)
    eid = ids.reshape(-1).long()
    src = torch.arange(T, device=x.device).repeat_interleave(k)
    # every rank routes every token alike; the gates' and the tokens'
    # gradients from its own experts are summed over the group
    wf = copy_to_group(w.reshape(-1).float(), group)
    x2 = copy_to_group(x2, group)
    le = eid - r * E_loc
    mine = (le >= 0) & (le < E_loc)
    le_or_trash = torch.where(mine, le, E_loc)
    _, ranks = radix_histogram_ranks(le_or_trash.to(torch.int32), E_loc + 1)
    ranks = ranks.long()
    ok = mine & (ranks < C)
    _log_drops((mine & ~ok).sum())
    flat = torch.where(ok, le_or_trash * C + ranks, E_loc * C)
    xb = torch.zeros((E_loc * C + 1, d), dtype=Ly.BF16, device=x.device)
    xb[flat] = x2.to(Ly.BF16)[src]
    xb = xb[:-1].reshape(E_loc, C, d)
    h = _expert_ffn(p["e_gate"], p["e_up"], p["e_down"], xb)
    g = h.reshape(E_loc * C, d).float()[flat.clamp(max=E_loc * C - 1)]
    contrib = g * (wf * ok)[:, None]
    part = torch.zeros((T, d), dtype=F32, device=x.device) \
        .index_add_(0, src, contrib)
    y = sum_over_group(part, group)
    # every rank routed the same rows, so its aux is already the mean
    return y.reshape(B, S, d).to(x.dtype), aux


def moe_apply(p, cfg, x, policy=None, *, decode: bool = False,
              capacity_factor: float = 1.25):
    """The MoE FFN: ``moe_dense`` without a sharded model axis (world 1,
    in train, prefill and decode), else ``moe_decode`` for a decode step
    or a sequence shorter than the axis and ``moe_shuffle`` for the
    rest, as the reference's ``moe_apply``."""
    if policy is None or not policy.sharded:
        return moe_dense(p, cfg, x, policy)
    if decode or x.shape[1] < policy.world_m:
        return moe_decode(p, cfg, x, policy)
    return moe_shuffle(p, cfg, x, policy, capacity_factor)
