"""Mixture-of-Experts layers (PyTorch port of ``repro/models/moe.py``).

The reference has three paths: ``moe_dense`` (every expert on every
token, gates zero outside each token's top-k), ``moe_shuffle`` (expert
parallelism through the table Shuffle: hash partition of the routed rows
by expert, ``all_to_all`` over the model axis) and ``moe_decode``
(replicated tokens, local experts, ``psum``).  Without a mesh, which is
world 1, it runs ``moe_dense`` for both; the port runs at world 1, so
:func:`moe_apply` is ``moe_dense`` and the two dispatch paths come with
the sharded slice.  :func:`_expert_ffn` is their per-expert FFN, and
``moe_dense`` computes its experts through it on the tokens broadcast to
every expert (the reference's ``td,edf->tef`` products, as batched
products that read each expert's weights once).

Uneven expert counts are parameter-padded to a multiple of 16
(:func:`n_experts_padded`; ``cfg.n_experts`` stays the routing width and
the pads are never computed).  The router is float32 in serving and in
training and its product runs in float32; the expert products run in
bf16 and round to bf16 before the float32 combine, as the reference's.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import layers as Ly

F32 = torch.float32


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


def moe_dense(p, cfg, x):
    """x (B, S, d) -> (y (B, S, d) in x's dtype, aux): every one of the
    ``cfg.n_experts`` experts on every token, combined in float32 with
    the gates, which are zero outside each token's top-k."""
    B, S, d = x.shape
    E = cfg.n_experts
    x2 = x.reshape(B * S, d)
    w, ids, aux = _route(p["router"], x2, cfg.top_k)
    gates = torch.zeros((B * S, E), dtype=F32, device=x.device) \
        .scatter(1, ids.long(), w)                            # (T, E)
    o = _expert_ffn(p["e_gate"][:E], p["e_up"][:E], p["e_down"][:E],
                    x2.to(Ly.BF16).expand(E, B * S, d))       # (E, T, d)
    y = torch.einsum("etd,te->td", o.float(), gates)
    return y.reshape(B, S, d).to(x.dtype), aux


def moe_apply(p, cfg, x):
    """The MoE FFN at world 1: ``moe_dense`` (the reference's
    ``moe_apply`` without a mesh, in train, prefill and decode)."""
    return moe_dense(p, cfg, x)
