"""Layer stacks (PyTorch port of ``repro/models/transformer.py``).

A *layer* = (norm -> mixer -> residual) [+ (norm -> ffn -> residual)]
where the mixer is GQA attention or a Mamba block and the ffn swiglu,
gelu, MoE or none.  Parameters stay stacked over layers (a leading
``n_layers`` axis on every leaf, the reference's ``vmap``-ed init) and so
do the caches: ``{"k", "v"}`` (n_layers, B, Hkv, S, D) bf16 for attention
layers, ``{"conv" (n_layers, B, K-1, E), "ssm" (n_layers, B, E, N)}``
float32 for Mamba layers; an enc-dec decoder's layers also keep their
cross-attention's ``{"ck", "cv"}`` (n_layers, B, Hkv, Senc, D) bf16, the
encoder memory's k and v, which decode reads and never writes; the
reference's ``lax.scan`` over the stack is a loop over that axis.  A
period stack (Jamba: attention on the last layer of every
``attn_period``, MoE on the odd layers) is stacked over its
``n_layers // attn_period`` periods instead: its tree holds one
``{"sub{j}": ...}`` entry for each layer ``j`` of a period, of the kind
of layer ``j``, and so do its caches; the loop runs the periods, and the
sub-layers in order inside each.  Three
traversal modes share the layer definitions: ``train`` (no cache; each
layer's body under ``torch.utils.checkpoint`` as ``StackOpts.remat``
says, the reference's ``jax.checkpoint`` of its scan body), ``prefill``
(emit per-layer cache) and ``decode`` (consume and update the cache, one
token).  ``train`` and
``prefill`` also return the sum over the layers of the MoE layers'
auxiliary load-balancing loss (0 without MoE layers); ``decode`` drops
it, as the reference does.  The port runs uniform stacks (dense, MoE or
Mamba), period stacks, an enc-dec config's encoder stack (attention and
the family's MLP, not causal) and its decoder (self-attention, then
cross-attention on the encoder's output, then the MLP).

Every function takes the reference's ``policy`` (default ``None``, world
1).  Under a policy whose model axis spans several ranks the layers
compute on this rank's slices (``models/layers.py``; an encoder layer
and a cross-attention on this rank's heads, as a decoder's
self-attention), a Mamba block on
this rank's channels (``models/mamba.py``), a MoE FFN runs
``moe_shuffle`` in train and prefill and ``moe_decode`` in a decode step,
with ``StackOpts.moe_capacity`` as the shuffle's capacity factor.
The data axis adds nothing inside a layer but, under ``fsdp_tp``, the
gather of the layer's 2D leaves over the data group
(``sharding.gather_data``) just before the layer runs, one layer at a
time (serving never holds two layers' gathered weights); in training
it is made inside the remat body (one layer, or one period of a period
stack, as the reference's scan body), so that the recompute gathers
again.  Each batch rank (pod x data) runs its block of the batch's
rows (all of them where they do not split: a slot prefill's one row).  Every collective carries its gradient, so
a rematerialised layer re-issues its collectives in the backward, in
the same order on every rank.  :func:`check_supported` refuses what the
sharded path does not run yet.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from . import layers as Ly
from . import mamba as Mb
from . import moe as Moe
from .sharding import gather_data, kv_head_block

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class StackOpts:
    """Runtime knobs threaded through the stack (from TrainSettings)."""
    attn_impl: str = "xla"
    mamba_impl: str = "xla"
    q_chunk: int = 1024
    k_chunk: int = 1024
    remat: str = "full"          # none | full | dots
    mamba_chunk: int = 128
    decode_len: int = 0          # static cache length for decode/prefill
    moe_capacity: float = 1.25   # moe_shuffle's capacity factor


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


def _period(cfg) -> int:
    """Layers one group of the stack holds: ``attn_period`` for a period
    stack, else 1 (the reference's ``_period``)."""
    return cfg.attn_period if cfg.attn_period > 1 else 1


def check_supported(cfg, policy=None, *, train: bool = False) -> None:
    """Raise, under a ``policy`` over several ranks, for heads that do not
    split over the model axis, a block of q heads that spans KV heads
    unevenly, Mamba channels that do not split and a padded vocabulary
    that does not.  Every stack runs at world 1 (uniform, period and
    enc-dec stacks).  Both batch axes (``pod`` x ``data``) run, and KV
    heads shared by model ranks run in serving and training (``train``
    is kept for the callers: nothing is refused for training alone).
    Encoder and vision configs run at every mesh these allow (the
    encoder's and the cross-attention's heads split as the decoder's
    do)."""
    if policy is None or policy.mesh is None or not policy.sharded:
        return
    kv_head_block(cfg.n_heads, cfg.n_kv_heads, policy.world_m, 0)
    if any(layer_kind(cfg, i)[0] == "mamba" for i in range(cfg.n_layers)) \
            and cfg.d_inner % policy.world_m:
        raise ValueError(f"{cfg.name}: {cfg.d_inner} Mamba channels do not "
                         f"split over a model axis of {policy.world_m}")
    if cfg.padded_vocab() % policy.world_m:
        raise ValueError(f"{cfg.name}: a padded vocabulary of "
                         f"{cfg.padded_vocab()} does not split over a "
                         f"model axis of {policy.world_m}")


def layer_at(stack: dict, i: int) -> dict:
    """Layer ``i`` of a stacked tree: a view of every leaf at index i (so
    in-place cache writes land in the stack)."""
    return {k: layer_at(v, i) if isinstance(v, dict) else v[i]
            for k, v in stack.items()}


# --------------------------------------------------------------------------
# single layer
# --------------------------------------------------------------------------


def layer_init(gen: torch.Generator, cfg, n: int, dtype=Ly.BF16, *,
               i: int = 0, encoder: bool = False) -> dict:
    """``n`` stacked layers of the kind of layer ``i`` (attention or a
    Mamba block, then swiglu, gelu MLP, MoE or nothing; an enc-dec
    decoder's with cross-attention after the self-attention;
    ``encoder``: attention and the family's MLP, no cross-attention),
    matmul weights in ``dtype`` (a MoE router stays float32)."""
    mixer, ffn, cross = layer_kind(cfg, i)
    if encoder:
        mixer, ffn, cross = "attn", ("gelu" if cfg.family == "audio"
                                     else "mlp"), False
    p: dict[str, Any] = {"ln1": Ly.rms_norm_init(gen, n, cfg.d_model)}
    if mixer == "attn":
        p["attn"] = Ly.attn_init(gen, cfg, n, dtype)
    else:
        p["mamba"] = Mb.mamba_init(gen, cfg, n, dtype)
    if cross:
        p["ln_cross"] = Ly.rms_norm_init(gen, n, cfg.d_model)
        p["cross"] = Ly.attn_init(gen, cfg, n, dtype)
    if ffn != "none":
        p["ln2"] = Ly.rms_norm_init(gen, n, cfg.d_model)
        if ffn == "moe":
            p["ffn_moe"] = Moe.moe_init(gen, cfg, n, dtype)
        elif ffn == "gelu":
            p["ffn_gelu"] = Ly.gelu_mlp_init(gen, n, cfg.d_model, cfg.d_ff,
                                             cfg.n_layers, dtype)
        else:
            p["ffn_mlp"] = Ly.swiglu_init(gen, n, cfg.d_model, cfg.d_ff,
                                          cfg.n_layers, dtype)
    return p


def _apply_ffn(p, cfg, x, policy, *, decode: bool,
               capacity_factor: float = 1.25):
    """(x after the layer's ffn, its MoE auxiliary loss or None)."""
    aux = None
    if "ffn_moe" in p:
        y, aux = Moe.moe_apply(p["ffn_moe"], cfg,
                               Ly.rms_norm(p["ln2"], x, cfg.norm_eps),
                               policy, decode=decode,
                               capacity_factor=capacity_factor)
        x = x + y
    elif "ffn_gelu" in p:
        x = x + Ly.gelu_mlp(p["ffn_gelu"],
                            Ly.rms_norm(p["ln2"], x, cfg.norm_eps), policy)
    elif "ffn_mlp" in p:
        x = x + Ly.swiglu(p["ffn_mlp"],
                          Ly.rms_norm(p["ln2"], x, cfg.norm_eps), policy)
    return x, aux


def _cache_pad(k, decode_len: int):
    """Grow prefill kv (B,H,S,D) to the static decode capacity."""
    if decode_len and k.shape[2] < decode_len:
        k = F.pad(k, (0, 0, 0, decode_len - k.shape[2]))
    return k


def _cross_block(p, cfg, x, enc_out, opts: StackOpts, policy=None):
    """A decoder layer's cross-attention on the encoder's output (its own
    norm, no mask, no RoPE) -> (y, (ck, cv)), ck and cv unpadded (this
    rank's heads under a sharded model axis, whose ``enc_out`` gradient
    is summed over the model group)."""
    h = Ly.rms_norm(p["ln_cross"], x, cfg.norm_eps)
    return Ly.attn_apply(p["cross"], cfg, h, None, causal=False,
                         kv_x=enc_out, attn_impl=opts.attn_impl,
                         q_chunk=opts.q_chunk, k_chunk=opts.k_chunk,
                         policy=policy)


def layer_apply(p, cfg, x, positions, opts: StackOpts, *,
                causal: bool = True, enc_out=None,
                want_cache: bool = False, policy=None):
    """Full-sequence layer (train / prefill / encoder); a layer with
    cross-attention reads ``enc_out`` (B, Senc, d).  Returns (x, aux,
    cache) — aux is None without an MoE FFN, cache is {} unless
    want_cache."""
    cache = {}
    h = Ly.rms_norm(p["ln1"], x, cfg.norm_eps)
    if "attn" in p:
        y, (k, v) = Ly.attn_apply(p["attn"], cfg, h, positions,
                                  causal=causal, attn_impl=opts.attn_impl,
                                  q_chunk=opts.q_chunk,
                                  k_chunk=opts.k_chunk, policy=policy)
        if want_cache:
            cache["k"] = _cache_pad(k, opts.decode_len)
            cache["v"] = _cache_pad(v, opts.decode_len)
    else:
        y, state = Mb.mamba_apply(p["mamba"], cfg, h, impl=opts.mamba_impl,
                                  scan_chunk=opts.mamba_chunk,
                                  return_state=want_cache, policy=policy)
        if want_cache:
            cache.update(state)
    x = x + y
    if "cross" in p:
        if enc_out is None:
            raise ValueError("a layer with cross-attention needs enc_out")
        y, (ck, cv) = _cross_block(p, cfg, x, enc_out, opts, policy)
        x = x + y
        if want_cache:
            cache["ck"], cache["cv"] = ck, cv
    x, aux = _apply_ffn(p, cfg, x, policy, decode=False,
                        capacity_factor=opts.moe_capacity)
    return x, aux, cache


def layer_decode(p, cfg, x, cache, cache_len, policy=None):
    """One-token decode through one layer; ``cache`` is updated in place
    (but for its cross-attention's ``ck``/``cv``, which are only read).
    Returns (x, cache); a MoE layer's auxiliary loss is dropped."""
    h = Ly.rms_norm(p["ln1"], x, cfg.norm_eps)
    if "attn" in p:
        y, cache = Ly.attn_decode(p["attn"], cfg, h, cache, cache_len,
                                  policy=policy)
    else:
        y, cache = Mb.mamba_step(p["mamba"], cfg, h, cache, policy)
    x = x + y
    if "cross" in p:
        hc = Ly.rms_norm(p["ln_cross"], x, cfg.norm_eps)
        y, _ = Ly.attn_decode(p["cross"], cfg, hc,
                              {"k": cache["ck"], "v": cache["cv"]},
                              cache_len, cross=True, policy=policy)
        x = x + y
    x, _aux = _apply_ffn(p, cfg, x, policy, decode=True)
    return x, cache


# --------------------------------------------------------------------------
# stacks
# --------------------------------------------------------------------------


def stack_init(gen: torch.Generator, cfg, dtype=Ly.BF16, *,
               encoder: bool = False) -> dict:
    """The decoder stack (``cfg.n_layers``), or with ``encoder`` an
    enc-dec config's encoder stack (``cfg.encoder_layers``).  A period
    stack is ``{"sub{j}": ...}``, sub-layer ``j`` of the kind of layer
    ``j``, each stacked over the ``n_layers // attn_period`` periods (the
    reference's ``init_period``)."""
    n = cfg.encoder_layers if encoder else cfg.n_layers
    per = 1 if encoder else _period(cfg)
    if per == 1:
        return layer_init(gen, cfg, n, dtype, encoder=encoder)
    return {f"sub{j}": layer_init(gen, cfg, n // per, dtype, i=j)
            for j in range(per)}


def sub_layers(group: dict) -> list[tuple[str | None, dict]]:
    """The layers of one group of a stacked tree (parameters or caches),
    in order: ``(f"sub{j}", its tree)`` for each sub-layer of a period,
    ``[(None, group)]`` for a uniform stack's one layer."""
    if "sub0" not in group:
        return [(None, group)]
    return [(f"sub{j}", group[f"sub{j}"]) for j in range(len(group))]


def _stack_trees(trees: list[dict]) -> dict:
    """Trees of the same layout -> one tree, each leaf stacked over
    them."""
    return {k: _stack_trees([t[k] for t in trees])
            if isinstance(trees[0][k], dict)
            else torch.stack([t[k] for t in trees]) for k in trees[0]}


def unstack(stack: dict) -> list[dict]:
    """The layers of a stacked tree as views, from one ``unbind`` per leaf
    (whose backward stacks the layers' gradients in one op, where a
    ``select`` per layer would each give a stack-sized gradient)."""
    leaves = {k: unstack(v) if isinstance(v, dict) else v.unbind(0)
              for k, v in stack.items()}
    n = len(next(iter(leaves.values())))
    return [{k: v[i] for k, v in leaves.items()} for i in range(n)]


_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    """``remat="dots"``: keep the matmul outputs, recompute the rest (the
    reference's ``checkpoint_dots`` policy)."""
    return CheckpointPolicy.MUST_SAVE if op in _DOTS \
        else CheckpointPolicy.PREFER_RECOMPUTE


def _requires_grad(tree: dict) -> bool:
    return any(_requires_grad(v) if isinstance(v, dict) else v.requires_grad
               for v in tree.values())


def _marking_recompute(fn):
    """``fn``, whose calls after the first (a remat recompute) run under
    ``moe.recompute()``."""
    calls = [0]

    def run(*args):
        calls[0] += 1
        if calls[0] == 1:
            return fn(*args)
        with Moe.recompute():
            return fn(*args)
    return run


def _wrap_remat(fn, remat: str, grads: bool):
    """``fn`` under ``torch.utils.checkpoint`` as ``remat`` says: ``none``
    saves every activation, ``full`` only ``fn``'s inputs, ``dots`` the
    inputs and the matmul outputs.  ``fn`` itself when no gradients are
    wanted (serving)."""
    if remat not in ("none", "full", "dots"):
        raise ValueError(f"unknown remat {remat!r} (expected 'none', "
                         "'full' or 'dots')")
    if remat == "none" or not grads:
        return fn
    fn = _marking_recompute(fn)
    kw = {}
    if remat == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _save_dots)
    return functools.partial(checkpoint, fn, use_reentrant=False, **kw)


def stack_apply(stack_params, cfg, x, positions, opts: StackOpts, *,
                causal: bool = True, enc_out=None,
                want_cache: bool = False, policy=None):
    """Run the stack (an encoder stack with ``causal=False``; a decoder
    with cross-attention on ``enc_out``), one group (a layer, or a period
    of sub-layers) at a time, each group one remat body.  Returns (x, the
    MoE auxiliary loss summed over the MoE layers, stacked caches | None):
    each layer's cache leaves stacked over the groups, a period's under
    its ``sub{j}`` (see the module docstring)."""
    def body(p, x, enc_out):
        auxes, caches = [], {}
        for name, sub in sub_layers(p):
            x, a, cache = layer_apply(gather_data(sub, policy), cfg, x,
                                      positions, opts, causal=causal,
                                      enc_out=enc_out,
                                      want_cache=want_cache, policy=policy)
            if a is not None:
                auxes.append(a)
            if name is None:
                caches = cache
            else:
                caches[name] = cache
        return x, auxes, caches

    grads = torch.is_grad_enabled() and (x.requires_grad
                                         or _requires_grad(stack_params))
    aux = torch.zeros((), dtype=F32, device=x.device)
    caches = []
    for p in unstack(stack_params):
        x, auxes, cache = _wrap_remat(body, opts.remat, grads)(p, x,
                                                               enc_out)
        for a in auxes:                  # the reference's order of sums
            aux = aux + a
        caches.append(cache)
    if not want_cache:
        return x, aux, None
    return x, aux, _stack_trees(caches)


def stack_decode(stack_params, cfg, x, caches, cache_len, policy=None):
    """Decode one token through the whole stack; ``caches`` are stacked
    as ``stack_apply(want_cache=True)`` makes them and are updated in
    place.  Under ``fsdp_tp`` each layer's 2D leaves are gathered over
    the data group just before the layer runs.  Returns (x, caches)."""
    groups = cfg.n_layers // _period(cfg)
    for g in range(groups):
        cache = layer_at(caches, g)
        for name, sub in sub_layers(layer_at(stack_params, g)):
            x, _ = layer_decode(gather_data(sub, policy), cfg, x,
                                cache if name is None else cache[name],
                                cache_len, policy)
    return x, caches
