"""Model assembly for serving (PyTorch port of ``repro/models/model.py``):
parameters, prefill, slot prefill, the decode step and the cache layout.

Training (``ce_loss``, ``make_train_step``) is a later slice.  Parameters
are the reference's nested dicts with every layer leaf stacked over the
layers; the matmul weights and the embedding are held as bf16 (the
reference casts its float32 masters to bf16 at every use, so the numbers
in each product are the same) and norm scales and biases as float32.
:func:`params_from_jax` carries the reference's weights across.

``attn_impl=None`` picks the attention path from the tokens' device
(``kernel_backend.attention_impl``): the flash kernel on the card, plain
attention on the CPU.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from ..core.kernel_backend import attention_impl
from . import layers as Ly
from . import transformer as Tf
from .transformer import StackOpts

CACHE_DTYPE = torch.bfloat16


def opts_from_cfg(cfg, tokens, *, decode_len: int = 0,
                  attn_impl: str | None = None) -> StackOpts:
    """The stack's knobs; ``attn_impl=None`` is the path the tokens'
    device implies."""
    t = cfg.train
    return StackOpts(attn_impl=attn_impl or attention_impl(tokens.device),
                     q_chunk=t.attn_q_chunk, k_chunk=t.attn_k_chunk,
                     decode_len=decode_len)


# --------------------------------------------------------------------------
# params
# --------------------------------------------------------------------------


def init_params(gen: torch.Generator, cfg) -> dict:
    """Random weights at the config's widths, drawn from ``gen`` on its
    device (the reference's initialisers and scales; torch's random
    numbers, not JAX's)."""
    Tf.check_supported(cfg)
    V = cfg.padded_vocab()
    params: dict[str, Any] = {
        "embed": {"embed": Ly.normal(gen, (V, cfg.d_model), Ly.INIT_STD)},
        "layers": Tf.stack_init(gen, cfg),
        "final_norm": {"scale": torch.ones(cfg.d_model, device=gen.device)},
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = {"w": Ly.normal(gen, (cfg.d_model, V),
                                            Ly.INIT_STD)}
    return params


def _is_matmul_weight(name: str, a: np.ndarray) -> bool:
    return name in ("w", "embed") and a.ndim >= 2


def params_from_jax(tree: Mapping, cfg, device) -> dict:
    """The port's parameters from the reference's ``init_params`` tree
    given as numpy arrays (layer leaves stacked over the layers, as the
    reference's ``vmap`` makes them): matmul weights and the embedding to
    bf16 (round to nearest even, as ``astype(bfloat16)``), the rest
    float32, all on ``device``."""
    Tf.check_supported(cfg)

    def conv(node):
        out = {}
        for name, a in node.items():
            if isinstance(a, Mapping):
                out[name] = conv(a)
                continue
            a = np.array(a, np.float32)          # a writable copy
            t = torch.from_numpy(a).to(device)
            out[name] = t.to(torch.bfloat16) \
                if _is_matmul_weight(name, a) else t
        return out

    return conv(tree)


# --------------------------------------------------------------------------
# forward
# --------------------------------------------------------------------------


def _positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, dtype=torch.int32,
                        device=device)[None].expand(B, S)


def backbone(params, cfg, batch, opts: StackOpts, *, want_cache=False):
    """Embed -> stack -> final norm.  Returns (x, caches, n_prefix); no
    frontend prepends tokens in this slice, so n_prefix is 0."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = Ly.embed_lookup(params["embed"], tokens)
    x, caches = Tf.stack_apply(params["layers"], cfg, x,
                               _positions(B, S, tokens.device), opts,
                               causal=True, want_cache=want_cache)
    x = Ly.rms_norm(params["final_norm"], x, cfg.norm_eps)
    return x, caches, 0


def _logits(params, cfg, x):
    return Ly.logits_out(
        params.get("lm_head"), x,
        tied_embed=params["embed"] if cfg.tie_embeddings else None)


def make_prefill(cfg, *, decode_len: int, attn_impl: str | None = None):
    """``(params, batch) -> (logits (B,V) at the last position, caches)``
    with caches padded to ``decode_len``."""
    def prefill(params, batch):
        opts = opts_from_cfg(cfg, batch["tokens"], decode_len=decode_len,
                             attn_impl=attn_impl)
        x, caches, _ = backbone(params, cfg, batch, opts, want_cache=True)
        return _logits(params, cfg, x[:, -1:])[:, 0], caches
    return prefill


def make_serve_step(cfg):
    """One decode step: ``(params, caches, tokens (B,1), cache_len) ->
    (logits (B,V), caches)``; ``caches`` are updated in place (the
    reference donates them).

    ``cache_len`` is a scalar (the one-shot loop: the whole batch at one
    position) or a ``(B,)`` array of per-slot positions (the engine's
    continuous batching), every value below the cache length.  A decode
    step's attention is plain PyTorch on every device (the reference has
    no kernel there either), so it takes no ``attn_impl``."""
    def serve_step(params, caches, tokens, cache_len):
        S = caches["k"].shape[3]
        cl = cache_len if isinstance(cache_len, torch.Tensor) \
            else torch.as_tensor(np.array(cache_len))
        if int(cl.min()) < 0 or int(cl.max()) >= S:
            raise ValueError(f"cache_len {cl.tolist()} outside [0, {S})")
        cl = cl.to(tokens.device)
        x = Ly.embed_lookup(params["embed"], tokens)      # (B,1,d)
        x, caches = Tf.stack_decode(params["layers"], cfg, x, caches, cl)
        x = Ly.rms_norm(params["final_norm"], x, cfg.norm_eps)
        return _logits(params, cfg, x)[:, 0], caches
    return serve_step


def make_slot_prefill(cfg, *, decode_len: int,
                      attn_impl: str | None = None):
    """Prefill for one continuous-batching slot refill.

    ``(params, batch, length) -> (logits (B,V), caches)`` where
    ``batch['tokens']`` is a fixed-shape right-padded prompt ``(B,P)`` and
    ``length`` the true prompt length: logits are taken at position
    ``n_prefix + length - 1`` (the last real token, which attends only to
    real positions under the causal mask).  Padding rows land in cache
    positions ``>= length``, stay masked at decode and are overwritten
    token by token."""
    def slot_prefill(params, batch, length):
        opts = opts_from_cfg(cfg, batch["tokens"], decode_len=decode_len,
                             attn_impl=attn_impl)
        x, caches, n_prefix = backbone(params, cfg, batch, opts,
                                       want_cache=True)
        idx = n_prefix + int(length) - 1
        return _logits(params, cfg, x[:, idx:idx + 1])[:, 0], caches
    return slot_prefill


def write_cache_slot(caches, one, slot: int):
    """Write a batch-1 cache (as ``make_slot_prefill`` gives it) into the
    running batch cache at batch index ``slot``, in place: every cache
    leaf is stacked ``(n_layers, B, ...)``, so the slot axis is 1."""
    for name, buf in caches.items():
        buf[:, slot:slot + 1] = one[name].to(buf.dtype)
    return caches


# --------------------------------------------------------------------------
# cache layout
# --------------------------------------------------------------------------


def cache_struct(cfg, batch_size: int, decode_len: int) -> dict:
    """``{"k", "v"}`` -> (shape, dtype) of the stacked cache that
    ``stack_apply`` emits: (n_layers, B, Hkv, decode_len, D) bf16."""
    Tf.check_supported(cfg)
    kv = (cfg.n_layers, batch_size, cfg.n_kv_heads, decode_len, cfg.d_head)
    return {"k": (kv, CACHE_DTYPE), "v": (kv, CACHE_DTYPE)}


def init_caches(cfg, batch_size: int, decode_len: int, device) -> dict:
    """Zero caches of :func:`cache_struct`'s layout on ``device``."""
    return {k: torch.zeros(shape, dtype=dtype, device=device)
            for k, (shape, dtype) in
            cache_struct(cfg, batch_size, decode_len).items()}
