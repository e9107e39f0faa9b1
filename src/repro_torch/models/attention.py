"""Attention compute paths (PyTorch port of ``repro/models/attention.py``).

Three implementations share one contract (``q (B,Hq,Sq,D)``, ``k/v
(B,Hkv,Skv,D)`` -> ``(B,Hq,Sq,D)``):

* ``full``    — one einsum; used when the score matrix is small;
* ``chunked`` — online softmax over (q-chunk, kv-chunk) tiles as two Python
  loops (the reference's two ``lax.scan``s); the JAX package calls these
  two the ``xla`` path, and the port keeps the name;
* ``cuda``    — the hand-written flash-attention kernel
  (``kernels/flash_attention``), the counterpart of the reference's
  ``pallas`` path; forward only, so a call that wants gradients raises.

GQA is computed without repeating KV: q is grouped as ``(B, Hkv, G, Sq,
D)`` and contracted against ungrouped KV.  ``decode_attention`` has no
kernel behind it in either package and stays plain PyTorch.
"""
from __future__ import annotations

import torch

from ..kernels.flash_attention import ops as _flash
from ..kernels.flash_attention.ref import attention_ref

NEG_INF = -1e30


def _causal_mask(sq: int, skv: int, q_off: int, k_off: int, device):
    qi = torch.arange(sq, device=device)[:, None] + q_off
    kj = torch.arange(skv, device=device)[None, :] + k_off
    return kj <= qi                                       # (sq, skv) bool


def full_attention(q, k, v, *, causal: bool = True, scale=None):
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = scale if scale is not None else D ** -0.5
    qg = q.reshape(B, Hkv, G, Sq, D).float() * scale
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float())
    if causal:
        s = torch.where(_causal_mask(Sq, Skv, Skv - Sq, 0, q.device),
                        s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())
    return o.reshape(B, Hq, Sq, D).to(q.dtype)


def _divisor_chunk(n: int, target: int) -> int:
    c = min(target, n)
    while n % c != 0:
        c -= 1
    return c


def chunked_attention(q, k, v, *, causal: bool = True, q_chunk: int = 1024,
                      k_chunk: int = 1024, scale=None):
    """Flash-style online softmax over (q-chunk, kv-chunk) tiles."""
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qc = _divisor_chunk(Sq, q_chunk)
    kc = _divisor_chunk(Skv, k_chunk)
    scale = scale if scale is not None else D ** -0.5
    qg = q.reshape(B, Hkv, G, Sq, D).float() * scale
    kf, vf = k.float(), v.float()
    outs = []
    for q0 in range(0, Sq, qc):
        qb = qg[:, :, :, q0:q0 + qc]                  # (B,Hkv,G,qc,D)
        m = torch.full(qb.shape[:-1], NEG_INF, device=q.device)
        l = torch.zeros(qb.shape[:-1], device=q.device)
        acc = torch.zeros(qb.shape, device=q.device)
        for k0 in range(0, Skv, kc):
            kb, vb = kf[:, :, k0:k0 + kc], vf[:, :, k0:k0 + kc]
            s = torch.einsum("bhgqd,bhkd->bhgqk", qb, kb)
            if causal:
                mask = _causal_mask(qc, kc, q0 + (Skv - Sq), k0, q.device)
                s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bhgqk,bhkd->bhgqd", p, vb)
            m = m_new
        outs.append(acc / torch.clamp(l, min=1e-30)[..., None])
    o = torch.cat(outs, dim=3)                        # (B,Hkv,G,Sq,D)
    return o.reshape(B, Hq, Sq, D).to(q.dtype)


def attention(q, k, v, *, causal: bool = True, impl: str = "xla",
              q_chunk: int = 1024, k_chunk: int = 1024):
    """Dispatching entry point used by the model layers: ``cuda`` (the
    flash kernel), ``ref`` (its plain version) or ``xla`` (full or
    chunked attention, as the reference picks them)."""
    if impl == "cuda":
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in (q, k, v)):
            raise ValueError("the flash_attention kernel has no backward; "
                             "train with attn_impl='xla'")
        return _flash.flash_attention(q.contiguous(), k.contiguous(),
                                      v.contiguous(), causal=causal)
    if impl == "ref":
        return attention_ref(q, k, v, causal=causal)
    if impl != "xla":
        raise ValueError(f"unknown attention impl {impl!r} "
                         "(expected 'xla', 'cuda' or 'ref')")
    Sq, Skv = q.shape[2], k.shape[2]
    if Sq <= q_chunk and Skv <= k_chunk:
        return full_attention(q, k, v, causal=causal)
    return chunked_attention(q, k, v, causal=causal, q_chunk=q_chunk,
                             k_chunk=k_chunk)


def decode_attention(q, k_cache, v_cache, cache_len):
    """Single-token decode: q (B,Hq,1,D) vs cache (B,Hkv,S,D).

    Positions ``> cache_len`` (beyond the just-written token) are masked.
    ``cache_len`` is a scalar (whole batch at one position) or a ``(B,)``
    tensor (continuous batching: every slot at its own position)."""
    B, Hq, _, D = q.shape
    Hkv, S = k_cache.shape[1], k_cache.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, Hkv, G, D).float() * (D ** -0.5)
    s = torch.einsum("bhgd,bhkd->bhgk", qg, k_cache.float())
    cl = torch.as_tensor(cache_len, device=q.device)
    if cl.dim():                      # per-slot lengths: (B,) -> (B,1,1,1)
        cl = cl[:, None, None, None]
    live = torch.arange(S, device=q.device)[None, None, None, :] <= cl
    s = torch.where(live, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgk,bhkd->bhgd", p, v_cache.float())
    return o.reshape(B, Hq, 1, D).to(q.dtype)
