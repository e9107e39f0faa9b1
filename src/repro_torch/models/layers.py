"""Composable model layers (PyTorch port of ``repro/models/layers.py``).

Functional, with parameters in nested dicts as in the reference.  Compute
dtype is bf16; softmax, norms and the logits run in float32.  The
reference keeps float32 master weights and casts them to bf16 at every
use.  For serving the port holds the matmul weights and the embedding as
bf16 once, at load (``model.params_from_jax`` / ``model.init_params``):
the numbers that reach each product are the same.  Training holds
float32 masters (the init functions' ``dtype``) and casts them at use, as
the reference does.  Norm scales stay float32.  Dense weights are
``(d_in, d_out)`` as in the reference.

Tensor parallelism (``policy`` with a model axis of more than one rank;
``models/sharding.py``): each rank holds the slices ``shard_params``
gives it.  ``wq``/``wk``/``wv``/``w_gate``/``w_up``/``w_in`` are split on
the output dim (column-parallel), so a rank computes its own heads or
its own part of the MLP's hidden dim; ``wo``/``w_down``/``w_out`` are
split on the input dim (row-parallel) and their partial products are
summed over the model group in float32 (:func:`dense_rows`).  Head
counts are read from the local weights' widths, so one code path serves
world 1 and the sharded layout.  The embedding is vocab-parallel: a rank
looks up the tokens in its rows, zeros elsewhere, and the ranks sum;
``logits_out`` gives the rank's vocab columns, which the model gathers.

The model axis's collectives carry gradients (``core.context``): the
input of the column-parallel products passes through ``copy_to_group``
(its gradient, a partial sum on each rank, is summed over the model
group) and the row-parallel sums through ``sum_over_group`` (forward
sum, backward identity), so the same code trains under tensor
parallelism.  Without a gradient they compute what the forward-only
collectives do.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..core.context import copy_to_group, sum_over_group
from . import attention as A

INIT_STD = 0.02
BF16 = torch.bfloat16


# --------------------------------------------------------------------------
# init (stacked over ``n`` layers; weights drawn from a torch.Generator)
# --------------------------------------------------------------------------


def normal(gen: torch.Generator, shape, std: float, dtype=BF16):
    """``std``-scaled standard normal draws of ``shape`` on the
    generator's device, each leading index's slice drawn in place
    (``normal_``: no float32 temporary).  On the ``meta`` device nothing
    is drawn: the tree of shapes and dtypes alone (``launch/specs.py``)."""
    out = torch.empty(shape, dtype=dtype, device=gen.device)
    if out.is_meta:
        return out
    for i in range(shape[0]):
        out[i].normal_(0.0, std, generator=gen)
    return out


def dense_init(gen, n: int, d_in: int, d_out: int, bias: bool = False,
               std: float = INIT_STD, dtype=BF16):
    p = {"w": normal(gen, (n, d_in, d_out), std, dtype)}
    if bias:
        p["b"] = torch.zeros((n, d_out), device=gen.device)
    return p


def rms_norm_init(gen, n: int, d: int):
    return {"scale": torch.ones((n, d), device=gen.device)}


def attn_init(gen, cfg, n: int, dtype=BF16):
    d, hq, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    p = {
        "wq": dense_init(gen, n, d, hq * dh, bias=cfg.qkv_bias,
                         dtype=dtype),
        "wk": dense_init(gen, n, d, hkv * dh, bias=cfg.qkv_bias,
                         dtype=dtype),
        "wv": dense_init(gen, n, d, hkv * dh, bias=cfg.qkv_bias,
                         dtype=dtype),
        "wo": dense_init(gen, n, hq * dh, d,
                         std=INIT_STD / math.sqrt(2 * cfg.n_layers),
                         dtype=dtype),
    }
    if cfg.qk_norm:
        p["q_norm"] = rms_norm_init(gen, n, dh)
        p["k_norm"] = rms_norm_init(gen, n, dh)
    return p


def swiglu_init(gen, n: int, d: int, f: int, n_layers: int, dtype=BF16):
    return {
        "w_gate": dense_init(gen, n, d, f, dtype=dtype),
        "w_up": dense_init(gen, n, d, f, dtype=dtype),
        "w_down": dense_init(gen, n, f, d,
                             std=INIT_STD / math.sqrt(2 * n_layers),
                             dtype=dtype),
    }


def gelu_mlp_init(gen, n: int, d: int, f: int, n_layers: int, dtype=BF16):
    return {
        "w_in": dense_init(gen, n, d, f, dtype=dtype),
        "w_out": dense_init(gen, n, f, d,
                            std=INIT_STD / math.sqrt(2 * n_layers),
                            dtype=dtype),
    }


# --------------------------------------------------------------------------
# apply
# --------------------------------------------------------------------------


def dense(p, x):
    y = x.to(BF16) @ p["w"].to(BF16)
    if "b" in p:
        y = y + p["b"].to(BF16)
    return y


def model_sum(y, policy):
    """``y`` summed over the model group in float32, back in its dtype
    (``y`` itself without a sharded model axis); the gradient passes to
    each rank's partial ``y``."""
    if policy is None or not policy.sharded:
        return y
    return sum_over_group(y.float(), policy.model_group).to(y.dtype)


def model_copy(x, policy):
    """``x``, replicated over the model axis, as the input of this rank's
    part of a product: its gradient is summed over the model group."""
    if policy is None or not policy.sharded:
        return x
    return copy_to_group(x, policy.model_group)


def dense_rows(p, x, policy=None):
    """A row-parallel ``dense``: this rank's rows of ``w`` against its
    slice of ``x``'s last dim, the partial products summed over the model
    group, then the (replicated) bias."""
    y = model_sum(x.to(BF16) @ p["w"].to(BF16), policy)
    if "b" in p:
        y = y + p["b"].to(BF16)
    return y


def rms_norm(p, x, eps: float = 1e-5):
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps) * p["scale"].float()
    return y.to(x.dtype)


def rope(x, positions, theta: float):
    """x: (B, H, S, D), positions: (B, S), (B, 1) or a scalar."""
    B, H, S, D = x.shape
    half = D // 2
    freq = theta ** (-torch.arange(half, dtype=torch.float32,
                                   device=x.device) / half)
    pos = torch.as_tensor(positions, device=x.device)
    if pos.dim() == 0:
        pos = pos.expand(B, S)
    ang = pos.float()[:, None, :, None] * freq            # (B,1,S,half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def _split_heads(y, n_heads: int, d_head: int):
    B, S, _ = y.shape
    return y.reshape(B, S, n_heads, d_head).transpose(1, 2)


def _heads(p, cfg) -> tuple[int, int]:
    """(q heads, KV heads) of the attention weights held here: the
    config's at world 1, this rank's under tensor parallelism."""
    return (p["wq"]["w"].shape[-1] // cfg.d_head,
            p["wk"]["w"].shape[-1] // cfg.d_head)


def attn_apply(p, cfg, x, positions, *, causal: bool = True, kv_x=None,
               attn_impl: str = "xla", q_chunk: int = 1024,
               k_chunk: int = 1024, policy=None):
    """Full-sequence attention (train / prefill); ``kv_x`` (B, Skv, d)
    makes it cross-attention: q from ``x``, k and v from ``kv_x`` and no
    RoPE on either side (``positions`` unused).  Returns (y, (k, v)) with
    k, v in the (B, Hkv, Skv, D) cache layout (this rank's heads under
    tensor parallelism)."""
    x = model_copy(x, policy)
    kv_src = x if kv_x is None else model_copy(kv_x, policy)
    hq, hkv = _heads(p, cfg)
    q = _split_heads(dense(p["wq"], x), hq, cfg.d_head)
    k = _split_heads(dense(p["wk"], kv_src), hkv, cfg.d_head)
    v = _split_heads(dense(p["wv"], kv_src), hkv, cfg.d_head)
    if cfg.qk_norm:
        q = rms_norm(p["q_norm"], q, cfg.norm_eps)
        k = rms_norm(p["k_norm"], k, cfg.norm_eps)
    if kv_x is None:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    o = A.attention(q, k, v, causal=causal, impl=attn_impl,
                    q_chunk=q_chunk, k_chunk=k_chunk)
    B, S = x.shape[:2]
    y = o.transpose(1, 2).reshape(B, S, hq * cfg.d_head)
    return dense_rows(p["wo"], y, policy), (k, v)


def attn_decode(p, cfg, x, cache, cache_len, *, cross: bool = False,
                policy=None):
    """One-token decode.  ``cache = {"k", "v"}`` (B, Hkv, S, D); the new
    token's k and v are written at ``cache_len`` IN PLACE (the reference
    returns a new cache and donates the old buffer; here the caller's
    tensors change).  ``cache_len`` is a scalar or a ``(B,)`` tensor of
    per-slot positions, each ``< S``.  With ``cross`` the cache is the
    (static) encoder memory: only q is projected, without RoPE, nothing
    is written and every one of its S positions is attended to."""
    hq, hkv = _heads(p, cfg)
    q = _split_heads(dense(p["wq"], x), hq, cfg.d_head)
    if cfg.qk_norm:
        q = rms_norm(p["q_norm"], q, cfg.norm_eps)
    kc, vc = cache["k"], cache["v"]
    if cross:
        live_len = kc.shape[2] - 1               # the whole encoder memory
    else:
        cl = torch.as_tensor(cache_len, device=x.device).long()
        pos = cl if cl.dim() == 0 else cl[:, None]       # rope: (B,1)
        k_new = _split_heads(dense(p["wk"], x), hkv, cfg.d_head)
        v_new = _split_heads(dense(p["wv"], x), hkv, cfg.d_head)
        if cfg.qk_norm:
            k_new = rms_norm(p["k_norm"], k_new, cfg.norm_eps)
        q = rope(q, pos, cfg.rope_theta)
        k_new = rope(k_new, pos, cfg.rope_theta)
        if cl.dim() == 0:            # no host read of the position
            kc.index_copy_(2, cl.reshape(1), k_new.to(kc.dtype))
            vc.index_copy_(2, cl.reshape(1), v_new.to(vc.dtype))
        else:                        # per-slot write position
            rows = torch.arange(x.shape[0], device=x.device)
            kc[rows, :, cl] = k_new[:, :, 0].to(kc.dtype)
            vc[rows, :, cl] = v_new[:, :, 0].to(vc.dtype)
        live_len = cache_len
    o = A.decode_attention(q, kc, vc, live_len)
    B = x.shape[0]
    y = o.transpose(1, 2).reshape(B, 1, hq * cfg.d_head)
    return dense_rows(p["wo"], y, policy), cache


def swiglu(p, x, policy=None):
    x = model_copy(x, policy)
    g = F.silu(dense(p["w_gate"], x))
    u = dense(p["w_up"], x)
    return dense_rows(p["w_down"], g * u, policy)


def gelu_mlp(p, x, policy=None):
    x = model_copy(x, policy)
    h = F.gelu(dense(p["w_in"], x), approximate="tanh")  # jax.nn.gelu
    return dense_rows(p["w_out"], h, policy)


# --------------------------------------------------------------------------
# embedding / logits
# --------------------------------------------------------------------------


def embed_lookup(p, tokens, policy=None):
    """bf16 embeddings of ``tokens``; vocab-parallel under a sharded
    model axis: the rank's rows (its even block of the padded vocab) are
    looked up, other tokens give zeros, and the ranks' results are
    summed (exact: one term is not zero)."""
    emb = p["embed"].to(BF16)
    if policy is None or not policy.sharded:
        return emb[tokens.long()]
    lo = policy.model_rank * emb.shape[0]
    t = tokens.long() - lo
    mine = (t >= 0) & (t < emb.shape[0])
    x = torch.where(mine[..., None], emb[t.clamp(0, emb.shape[0] - 1)], 0)
    return model_sum(x, policy)


def logits_out(p_head, x, tied_embed=None):
    """x (B,S,d) -> float32 logits (B,S,V): bf16 operands, float32
    products and sums, as the reference's ``preferred_element_type``.
    Under tensor parallelism the head (or the tied embedding) holds the
    rank's vocab block, and so do the logits."""
    if tied_embed is not None:
        w = tied_embed["embed"].to(BF16).T
    else:
        w = p_head["w"].to(BF16)
    return x.to(BF16).float() @ w.float()
