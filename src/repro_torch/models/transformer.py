"""Layer stacks (PyTorch port of ``repro/models/transformer.py``).

A *layer* = (norm -> attention -> residual) + (norm -> ffn -> residual).
Parameters stay stacked over layers (a leading ``n_layers`` axis on every
leaf, the reference's ``vmap``-ed init) and so do the caches, ``(n_layers,
B, Hkv, S, D)``; the reference's ``lax.scan`` over the stack is a loop
over that axis.  Two traversal modes share the layer definitions:
``prefill`` (emit per-layer cache) and ``decode`` (consume and update the
cache, one token).  This slice serves dense decoder-only stacks; layers
that need MoE, Mamba, cross-attention or a frontend raise
``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F

from . import layers as Ly


@dataclasses.dataclass(frozen=True)
class StackOpts:
    """Runtime knobs threaded through the stack (from TrainSettings)."""
    attn_impl: str = "xla"
    q_chunk: int = 1024
    k_chunk: int = 1024
    decode_len: int = 0          # static cache length for decode/prefill


def layer_kind(cfg, i: int) -> tuple[str, str, bool]:
    """(mixer, ffn, cross) for layer i."""
    mixer = "mamba" if not cfg._layer_has_attention(i) else "attn"
    if cfg._layer_has_moe(i):
        ffn = "moe"
    elif cfg.d_ff > 0:
        ffn = "gelu" if cfg.family == "audio" else "mlp"
    else:
        ffn = "none"
    return mixer, ffn, cfg.is_encdec


def check_supported(cfg) -> None:
    """Raise for a config whose layers this slice does not port yet."""
    if cfg.frontend != "none":
        raise NotImplementedError(f"{cfg.name}: the {cfg.frontend} "
                                  "frontend comes with the VLM/audio slice")
    if cfg.is_encdec:
        raise NotImplementedError(f"{cfg.name}: encoder and "
                                  "cross-attention come with the audio "
                                  "slice")
    for i in range(cfg.n_layers):
        mixer, ffn, _ = layer_kind(cfg, i)
        if mixer == "mamba":
            raise NotImplementedError(f"{cfg.name}: Mamba layers come with "
                                      "the Mamba slice (mamba_scan)")
        if ffn == "moe":
            raise NotImplementedError(f"{cfg.name}: MoE layers come with "
                                      "the MoE slice")


def layer_at(stack: dict, i: int) -> dict:
    """Layer ``i`` of a stacked tree: a view of every leaf at index i (so
    in-place cache writes land in the stack)."""
    return {k: layer_at(v, i) if isinstance(v, dict) else v[i]
            for k, v in stack.items()}


# --------------------------------------------------------------------------
# single layer
# --------------------------------------------------------------------------


def layer_init(gen: torch.Generator, cfg, n: int) -> dict:
    """``n`` stacked dense layers (attention + swiglu or gelu MLP)."""
    check_supported(cfg)
    _, ffn, _ = layer_kind(cfg, 0)
    p: dict[str, Any] = {"ln1": Ly.rms_norm_init(gen, n, cfg.d_model),
                         "attn": Ly.attn_init(gen, cfg, n)}
    if ffn != "none":
        p["ln2"] = Ly.rms_norm_init(gen, n, cfg.d_model)
        if ffn == "gelu":
            p["ffn_gelu"] = Ly.gelu_mlp_init(gen, n, cfg.d_model, cfg.d_ff,
                                             cfg.n_layers)
        else:
            p["ffn_mlp"] = Ly.swiglu_init(gen, n, cfg.d_model, cfg.d_ff,
                                          cfg.n_layers)
    return p


def _apply_ffn(p, cfg, x):
    if "ffn_gelu" in p:
        x = x + Ly.gelu_mlp(p["ffn_gelu"],
                            Ly.rms_norm(p["ln2"], x, cfg.norm_eps))
    elif "ffn_mlp" in p:
        x = x + Ly.swiglu(p["ffn_mlp"],
                          Ly.rms_norm(p["ln2"], x, cfg.norm_eps))
    return x


def _cache_pad(k, decode_len: int):
    """Grow prefill kv (B,H,S,D) to the static decode capacity."""
    if decode_len and k.shape[2] < decode_len:
        k = F.pad(k, (0, 0, 0, decode_len - k.shape[2]))
    return k


def layer_apply(p, cfg, x, positions, opts: StackOpts, *,
                causal: bool = True, want_cache: bool = False):
    """Full-sequence layer (prefill).  Returns (x, cache) — cache is {}
    unless want_cache."""
    cache = {}
    h = Ly.rms_norm(p["ln1"], x, cfg.norm_eps)
    y, (k, v) = Ly.attn_apply(p["attn"], cfg, h, positions, causal=causal,
                              attn_impl=opts.attn_impl,
                              q_chunk=opts.q_chunk, k_chunk=opts.k_chunk)
    x = x + y
    if want_cache:
        cache["k"] = _cache_pad(k, opts.decode_len)
        cache["v"] = _cache_pad(v, opts.decode_len)
    return _apply_ffn(p, cfg, x), cache


def layer_decode(p, cfg, x, cache, cache_len):
    """One-token decode through one layer; ``cache`` is updated in place.
    Returns (x, cache)."""
    h = Ly.rms_norm(p["ln1"], x, cfg.norm_eps)
    y, cache = Ly.attn_decode(p["attn"], cfg, h, cache, cache_len)
    return _apply_ffn(p, cfg, x + y), cache


# --------------------------------------------------------------------------
# stacks
# --------------------------------------------------------------------------


def stack_init(gen: torch.Generator, cfg) -> dict:
    return layer_init(gen, cfg, cfg.n_layers)


def stack_apply(stack_params, cfg, x, positions, opts: StackOpts, *,
                causal: bool = True, want_cache: bool = False):
    """Run the stack.  Returns (x, stacked caches | None): caches are
    ``{"k", "v"}`` of shape (n_layers, B, Hkv, S, D)."""
    n = cfg.n_layers
    caches = []
    for i in range(n):
        x, cache = layer_apply(layer_at(stack_params, i), cfg, x, positions,
                               opts, causal=causal, want_cache=want_cache)
        caches.append(cache)
    if not want_cache:
        return x, None
    return x, {k: torch.stack([c[k] for c in caches]) for k in ("k", "v")}


def stack_decode(stack_params, cfg, x, caches, cache_len):
    """Decode one token through the whole stack; ``caches`` are stacked
    as ``stack_apply(want_cache=True)`` makes them and are updated in
    place.  Returns (x, caches)."""
    for i in range(cfg.n_layers):
        x, _ = layer_decode(layer_at(stack_params, i), cfg, x,
                            layer_at(caches, i), cache_len)
    return x, caches
