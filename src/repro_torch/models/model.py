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
attention on the CPU; ``mamba_impl=None`` likewise the scan
(``kernel_backend.mamba_impl``): the selective-scan kernel on the card,
the plain scan on the CPU.  A stack with Mamba layers is always
prefilled at the prompt's true length (see :func:`make_slot_prefill`).
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from ..core import kernel_backend as KB
from . import layers as Ly
from . import transformer as Tf
from .transformer import StackOpts

CACHE_DTYPE = torch.bfloat16


def opts_from_cfg(cfg, tokens, *, decode_len: int = 0,
                  attn_impl: str | None = None,
                  mamba_impl: str | None = None) -> StackOpts:
    """The stack's knobs; an ``*_impl=None`` is the path the tokens'
    device implies."""
    t = cfg.train
    return StackOpts(attn_impl=attn_impl or KB.attention_impl(tokens.device),
                     mamba_impl=mamba_impl or KB.mamba_impl(tokens.device),
                     q_chunk=t.attn_q_chunk, k_chunk=t.attn_k_chunk,
                     decode_len=decode_len)


def has_mamba(cfg) -> bool:
    """Whether any layer of the stack is a Mamba block."""
    return any(Tf.layer_kind(cfg, i)[0] == "mamba"
               for i in range(cfg.n_layers))


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


def _is_matmul_weight(parent: str, name: str, a: np.ndarray) -> bool:
    """The leaves the reference casts to bf16 at use: matmul weights but
    ``dt_proj.w``, which stays float32 (``_cast_weights_bf16``), and the
    embedding."""
    return ((name == "w" and parent != "dt_proj") or name == "embed") \
        and a.ndim >= 2


def params_from_jax(tree: Mapping, cfg, device) -> dict:
    """The port's parameters from the reference's ``init_params`` tree
    given as numpy arrays (layer leaves stacked over the layers, as the
    reference's ``vmap`` makes them): matmul weights and the embedding to
    bf16 (round to nearest even, as ``astype(bfloat16)``), the rest
    float32, all on ``device``."""
    Tf.check_supported(cfg)

    def conv(node, parent=""):
        out = {}
        for name, a in node.items():
            if isinstance(a, Mapping):
                out[name] = conv(a, name)
                continue
            a = np.array(a, np.float32)          # a writable copy
            t = torch.from_numpy(a).to(device)
            out[name] = t.to(torch.bfloat16) \
                if _is_matmul_weight(parent, name, a) else t
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


def make_prefill(cfg, *, decode_len: int, attn_impl: str | None = None,
                 mamba_impl: str | None = None):
    """``(params, batch) -> (logits (B,V) at the last position, caches)``
    with attention caches padded to ``decode_len``."""
    def prefill(params, batch):
        opts = opts_from_cfg(cfg, batch["tokens"], decode_len=decode_len,
                             attn_impl=attn_impl, mamba_impl=mamba_impl)
        x, caches, _ = backbone(params, cfg, batch, opts, want_cache=True)
        return _logits(params, cfg, x[:, -1:])[:, 0], caches
    return prefill


def make_serve_step(cfg):
    """One decode step: ``(params, caches, tokens (B,1), cache_len) ->
    (logits (B,V), caches)``; ``caches`` are updated in place (the
    reference donates them).

    ``cache_len`` is a scalar (the one-shot loop: the whole batch at one
    position) or a ``(B,)`` array of per-slot positions (the engine's
    continuous batching), every value below the attention cache's length
    (a Mamba layer's state has no positions and ignores it).  A decode
    step's attention and Mamba step are plain PyTorch on every device (the
    reference has no kernel there either), so it takes no ``*_impl``."""
    def serve_step(params, caches, tokens, cache_len):
        cl = cache_len if isinstance(cache_len, torch.Tensor) \
            else torch.as_tensor(np.array(cache_len))
        if "k" in caches:
            S = caches["k"].shape[3]
            if int(cl.min()) < 0 or int(cl.max()) >= S:
                raise ValueError(f"cache_len {cl.tolist()} outside "
                                 f"[0, {S})")
        cl = cl.to(tokens.device)
        x = Ly.embed_lookup(params["embed"], tokens)      # (B,1,d)
        x, caches = Tf.stack_decode(params["layers"], cfg, x, caches, cl)
        x = Ly.rms_norm(params["final_norm"], x, cfg.norm_eps)
        return _logits(params, cfg, x)[:, 0], caches
    return serve_step


def make_slot_prefill(cfg, *, decode_len: int,
                      attn_impl: str | None = None,
                      mamba_impl: str | None = None):
    """Prefill for one continuous-batching slot refill.

    ``(params, batch, length) -> (logits (B,V), caches)`` where
    ``batch['tokens']`` is a fixed-shape right-padded prompt ``(B,P)`` and
    ``length`` the true prompt length: logits are taken at position
    ``n_prefix + length - 1`` (the last real token, which attends only to
    real positions under the causal mask).  In a dense stack the padding
    rows land in cache positions ``>= length``, stay masked at decode and
    are overwritten token by token.  A stack with Mamba layers is
    prefilled on ``tokens[:, :length]`` alone: a Mamba state has no
    positions to mask, and one that ran on through the padding would not
    be the prompt's (the JAX engine pads there, so its Mamba states
    differ from its own ``make_prefill`` at the true length)."""
    mamba = has_mamba(cfg)

    def slot_prefill(params, batch, length):
        if mamba:
            batch = dict(batch, tokens=batch["tokens"][:, :int(length)])
        opts = opts_from_cfg(cfg, batch["tokens"], decode_len=decode_len,
                             attn_impl=attn_impl, mamba_impl=mamba_impl)
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
    """name -> (shape, dtype) of the stacked cache that ``stack_apply``
    emits: ``{"k", "v"}`` (n_layers, B, Hkv, decode_len, D) bf16 for an
    attention stack, ``{"conv" (n_layers, B, K-1, E), "ssm" (n_layers, B,
    E, N)}`` float32 for a Mamba stack."""
    Tf.check_supported(cfg)
    L, B = cfg.n_layers, batch_size
    if has_mamba(cfg):
        return {"conv": ((L, B, cfg.ssm_conv - 1, cfg.d_inner),
                         torch.float32),
                "ssm": ((L, B, cfg.d_inner, cfg.ssm_state), torch.float32)}
    kv = (L, B, cfg.n_kv_heads, decode_len, cfg.d_head)
    return {"k": (kv, CACHE_DTYPE), "v": (kv, CACHE_DTYPE)}


def init_caches(cfg, batch_size: int, decode_len: int, device) -> dict:
    """Zero caches of :func:`cache_struct`'s layout on ``device``."""
    return {k: torch.zeros(shape, dtype=dtype, device=device)
            for k, (shape, dtype) in
            cache_struct(cfg, batch_size, decode_len).items()}
