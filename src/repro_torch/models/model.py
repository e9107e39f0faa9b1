"""Model assembly (PyTorch port of ``repro/models/model.py``):
parameters, the loss and the train step, prefill, slot prefill, the
decode step and the cache layout.

Parameters are the reference's nested dicts with every layer leaf
stacked over the layers.  For serving the matmul weights, the MoE
experts and the embedding are held as bf16 (the reference casts its
float32 masters to bf16 at every use, so the numbers in each product are
the same) and norm scales, biases and MoE routers as float32.  Training
holds every leaf as a float32 master (``master=True``), casts the matmul
weights to bf16 at the top of the loss (``_cast_weights_bf16``) and
updates the masters with AdamW (:func:`make_train_step`).  :func:`params_from_jax` carries the
reference's weights across.

``attn_impl=None`` picks the attention path from the tokens' device
(``kernel_backend.attention_impl``): the flash kernel on the card, plain
attention on the CPU; ``mamba_impl=None`` likewise the scan
(``kernel_backend.mamba_impl``): the selective-scan kernel on the card,
the plain scan on the CPU.  A stack with Mamba layers is always
prefilled at the prompt's true length (see :func:`make_slot_prefill`).

Serving takes the reference's ``policy`` (``models/sharding.py``;
``None`` is world 1).  Under a policy over several ranks each rank
holds its slice of the parameters (:func:`params_from_jax` with
``policy``, or ``sharding.shard_params`` of :func:`init_params`' tree;
under ``fsdp_tp`` at a data axis of several ranks a 2D slice, gathered
over the data group a layer at a time in every forward, and the
top-level leaves once a forward), its heads' caches and, on batch axes
of several ranks (``pod`` and ``data``), its block of the batch's rows
(``sharding.batch_block``, pod major; every row where they do not
split, as a slot prefill's one row): :func:`cache_struct` holds that
block, and the prefill and decode functions take the whole batch, run
the rank's rows and return the logits of every row.  The logits' vocab
blocks are gathered over the model group and the rows' blocks over the
batch group (where the rows do not split, batch rank 0's logits are
broadcast over it), so every rank holds the same full logits, bit for
bit, and takes the same greedy tokens.  Weights are cut over ``data``
only and are whole over ``pod``.

Training takes it too (:func:`make_train_step`, the reference's
signature): each batch rank computes the loss over its rows (its block
of the batch, ``sharding.shard_batch``), the model axis as in serving
with every collective carrying its gradient, and the gradients, averaged
over pod x data, land in the 2D layout of ``param_specs(for_opt=
True)``, where AdamW keeps its moments (ZeRO-1, ``sharding.Zero1``: cut
over ``data``, whole over ``pod``).  Model ranks that share a KV head
sum its gradient first.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..core import kernel_backend as KB
from ..optim import adamw
from ..core.context import all_reduce, broadcast, gather_dim
from . import layers as Ly
from . import sharding
from . import transformer as Tf
from .transformer import StackOpts

CACHE_DTYPE = torch.bfloat16
F32 = torch.float32


def opts_from_cfg(cfg, tokens, *, decode_len: int = 0,
                  attn_impl: str | None = None,
                  mamba_impl: str | None = None) -> StackOpts:
    """The stack's knobs; an ``*_impl=None`` is the path the tokens'
    device implies."""
    t = cfg.train
    return StackOpts(attn_impl=attn_impl or KB.attention_impl(tokens.device),
                     mamba_impl=mamba_impl or KB.mamba_impl(tokens.device),
                     q_chunk=t.attn_q_chunk, k_chunk=t.attn_k_chunk,
                     decode_len=decode_len,
                     moe_capacity=t.moe_capacity_factor)


def has_mamba(cfg) -> bool:
    """Whether any layer of the stack is a Mamba block."""
    return any(Tf.layer_kind(cfg, i)[0] == "mamba"
               for i in range(cfg.n_layers))


# --------------------------------------------------------------------------
# params
# --------------------------------------------------------------------------


def init_params(gen: torch.Generator, cfg, *, master: bool = False) -> dict:
    """Random weights at the config's widths, drawn from ``gen`` on its
    device (the reference's initialisers and scales; torch's random
    numbers, not JAX's).  The matmul weights, the MoE experts and the
    embedding are bf16 for serving, float32 masters with ``master`` (the
    same draws); MoE routers are float32 in both."""
    Tf.check_supported(cfg)
    V = cfg.padded_vocab()
    dtype = F32 if master else Ly.BF16
    params: dict[str, Any] = {
        "embed": {"embed": Ly.normal(gen, (V, cfg.d_model), Ly.INIT_STD,
                                     dtype)},
        "layers": Tf.stack_init(gen, cfg, dtype),
        "final_norm": {"scale": torch.ones(cfg.d_model, device=gen.device)},
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = {"w": Ly.normal(gen, (cfg.d_model, V),
                                            Ly.INIT_STD, dtype)}
    if cfg.is_encdec:
        params["encoder"] = {
            "layers": Tf.stack_init(gen, cfg, dtype, encoder=True),
            "norm": {"scale": torch.ones(cfg.d_model, device=gen.device)},
        }
    return params


# matmul weights that every layer casts to bf16 at use anyway, beside the
# leaves named ``w``: casting them once gives the same numbers (the
# reference's reason is its weight gathers and gradient collectives; here
# it is one cast per leaf a training step, and the tied embedding's two
# uses share it; serving holds them as bf16)
_BF16_CASTABLE = ("embed", "e_gate", "e_up", "e_down")


def _is_matmul_weight(parent: str, name: str, ndim: int) -> bool:
    """The leaves the reference casts to bf16 at use: matmul weights
    (``w``) but ``dt_proj.w``, which stays float32, the embedding and the
    MoE experts, of two dims or more.  A MoE router stays float32."""
    return ((name == "w" and parent != "dt_proj")
            or name in _BF16_CASTABLE) and ndim >= 2


def params_from_jax(tree: Mapping, cfg, device, *,
                    master: bool = False, policy=None) -> dict:
    """The port's parameters from the reference's ``init_params`` tree
    given as numpy arrays (layer leaves stacked over the layers, as the
    reference's ``vmap`` makes them): matmul weights and the embedding to
    bf16 (round to nearest even, as ``astype(bfloat16)``), the rest
    float32, all on ``device``; with ``master`` every leaf float32 (the
    reference's training masters).  Under a ``policy`` over several ranks
    each leaf is this rank's slice (``sharding.shard_params``), cut on the
    host; masters are for training, which takes a data axis."""
    Tf.check_supported(cfg, policy, train=master)
    if policy is not None and policy.mesh is not None \
            and policy.mesh.size > 1:
        tree = sharding.shard_params(_to_numpy(tree), policy, cfg=cfg)

    def conv(node, parent=""):
        out = {}
        for name, a in node.items():
            if isinstance(a, Mapping):
                out[name] = conv(a, name)
                continue
            a = np.array(a, np.float32)          # a writable copy
            t = torch.from_numpy(a).to(device)
            out[name] = t.to(torch.bfloat16) \
                if not master and _is_matmul_weight(parent, name, a.ndim) \
                else t
        return out

    return conv(tree)


def _to_numpy(node):
    return {k: _to_numpy(v) if isinstance(v, Mapping) else np.asarray(v)
            for k, v in node.items()}


# --------------------------------------------------------------------------
# forward
# --------------------------------------------------------------------------


def _positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, dtype=torch.int32,
                        device=device)[None].expand(B, S)


def _encode(params, cfg, frames, opts: StackOpts, policy=None):
    """An enc-dec config's encoder over the stub frame embeddings (B,
    Senc, d): bf16, positions 0 .. Senc - 1, the stack not causal, then
    the encoder's own norm.  Under ``policy`` each layer runs on this
    rank's heads and hidden units and, under ``fsdp_tp``, gathers its
    own 2D leaves over the data group, as a decoder layer does."""
    x = frames.to(Ly.BF16)
    x, _, _ = Tf.stack_apply(params["encoder"]["layers"], cfg, x,
                             _positions(x.shape[0], x.shape[1], x.device),
                             opts, causal=False, policy=policy)
    return Ly.rms_norm(params["encoder"]["norm"], x, cfg.norm_eps)


def backbone(params, cfg, batch, opts: StackOpts, *, want_cache=False,
             policy=None):
    """Embed -> stack -> final norm.  Returns (x, aux, caches, n_prefix):
    ``aux`` is the MoE layers' auxiliary loss summed over the stack.  A
    vision config's ``batch["patch_embeds"]`` (B, P, d) go in front of
    the tokens (n_prefix = P, positions over P + S); an enc-dec config's
    decoder attends to the encoder's output over ``batch["frames"]``."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = Ly.embed_lookup(params["embed"], tokens, policy)
    n_prefix = 0
    if cfg.frontend == "vision":
        patches = batch["patch_embeds"].to(x.dtype)
        x = torch.cat([patches, x], dim=1)
        n_prefix = patches.shape[1]
    enc_out = _encode(params, cfg, batch["frames"], opts, policy) \
        if cfg.is_encdec else None
    x, aux, caches = Tf.stack_apply(
        params["layers"], cfg, x, _positions(B, x.shape[1], tokens.device),
        opts, causal=True, enc_out=enc_out, want_cache=want_cache,
        policy=policy)
    x = Ly.rms_norm(params["final_norm"], x, cfg.norm_eps)
    return x, aux, caches, n_prefix


def _logits(params, cfg, x, policy=None, split: bool = False):
    """Float32 logits over the whole vocabulary: under a sharded model
    axis the ranks' vocab blocks, gathered in rank order.  On batch
    axes of several ranks ``x`` holds this rank's rows of the batch:
    with ``split`` its block (``sharding.batch_block``), and the batch
    ranks' blocks are gathered in batch-rank order; else the whole
    batch, and batch rank 0's logits are broadcast.  Either way every rank holds the
    same bits."""
    logits = Ly.logits_out(
        params.get("lm_head"), x,
        tied_embed=params["embed"] if cfg.tie_embeddings else None)
    if policy is None:
        return logits
    if policy.sharded:
        logits = gather_dim(logits, policy.model_group, -1)
    if policy.world_d > 1:
        logits = gather_dim(logits, policy.batch_group, 0) if split \
            else broadcast(logits, policy.batch_group)
    return logits


def _top_gathered(params, policy):
    """``params`` with the leaves outside the layer stacks gathered over
    the data group under ``fsdp_tp`` (``sharding.gather_data``; the
    decoder's and an encoder's layers gather their own, a layer at a
    time)."""
    top = {k: v for k, v in params.items() if k not in ("layers",
                                                        "encoder")}
    if "encoder" in params:
        top["encoder"] = {k: v for k, v in params["encoder"].items()
                          if k != "layers"}
    out = dict(sharding.gather_data(top, policy), layers=params["layers"])
    if "encoder" in params:
        out["encoder"] = dict(out["encoder"],
                              layers=params["encoder"]["layers"])
    return out


def _rows_of(batch: dict, policy):
    """(this data rank's rows of every array of ``batch``
    (``sharding.batch_block``), whether they are a block of it, not the
    whole batch)."""
    B = next(iter(batch.values())).shape[0]
    rows = sharding.batch_block(policy, B)
    return {k: v[rows] for k, v in batch.items()}, \
        rows.stop - rows.start < B


def make_prefill(cfg, policy=None, *, decode_len: int,
                 attn_impl: str | None = None,
                 mamba_impl: str | None = None):
    """``(params, batch) -> (logits (B,V) at the last position, caches)``
    with attention caches padded to ``decode_len`` (a vision config's
    count its P patch positions: the first decode step is at P + S);
    cross-attention caches stay at the encoder's length.  On a data axis
    of several ranks the caches hold this rank's rows of the batch."""
    Tf.check_supported(cfg, policy)

    def prefill(params, batch):
        params = _top_gathered(params, policy)
        batch, split = _rows_of(batch, policy)
        opts = opts_from_cfg(cfg, batch["tokens"], decode_len=decode_len,
                             attn_impl=attn_impl, mamba_impl=mamba_impl)
        x, _, caches, _ = backbone(params, cfg, batch, opts,
                                   want_cache=True, policy=policy)
        return _logits(params, cfg, x[:, -1:], policy, split)[:, 0], \
            caches
    return prefill


def make_serve_step(cfg, policy=None):
    """One decode step: ``(params, caches, tokens (B,1), cache_len) ->
    (logits (B,V), caches)``; ``caches`` are updated in place (the
    reference donates them).

    ``cache_len`` is a scalar (the one-shot loop: the whole batch at one
    position) or a ``(B,)`` array of per-slot positions (the engine's
    continuous batching), every value below the self-attention cache's
    length (a Mamba layer's state has no positions and ignores it; an
    enc-dec decoder's cross-attention reads its whole ``ck``/``cv``).  A
    decode step's attention and Mamba step are plain PyTorch on every
    device (the reference has no kernel there either), so it takes no
    ``*_impl``.  On a data axis of several ranks ``tokens`` and
    ``cache_len`` are the whole batch's and ``caches`` this rank's rows
    of it (:func:`cache_struct`); the logits are every row's."""
    Tf.check_supported(cfg, policy)

    def serve_step(params, caches, tokens, cache_len):
        cl = cache_len if isinstance(cache_len, torch.Tensor) \
            else torch.as_tensor(np.array(cache_len))
        leaves = dict(cache_leaves(caches))
        if "k" in leaves:
            S = leaves["k"].shape[3]
            if int(cl.min()) < 0 or int(cl.max()) >= S:
                raise ValueError(f"cache_len {cl.tolist()} outside "
                                 f"[0, {S})")
        rows = sharding.batch_block(policy, tokens.shape[0])
        split = rows.stop - rows.start < tokens.shape[0]
        tokens = tokens[rows]
        cl = (cl[rows] if cl.dim() else cl).to(tokens.device)
        held = next(iter(leaves.values())).shape[1]
        if held != tokens.shape[0]:
            raise ValueError(f"caches of {held} rows for this rank's "
                             f"{tokens.shape[0]} rows of the batch")
        params = _top_gathered(params, policy)
        x = Ly.embed_lookup(params["embed"], tokens, policy)  # (B,1,d)
        x, caches = Tf.stack_decode(params["layers"], cfg, x, caches, cl,
                                    policy)
        x = Ly.rms_norm(params["final_norm"], x, cfg.norm_eps)
        return _logits(params, cfg, x, policy, split)[:, 0], caches
    return serve_step


def make_slot_prefill(cfg, policy=None, *, decode_len: int,
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
    differ from its own ``make_prefill`` at the true length).  On a data
    axis of several ranks the rows split as in :func:`make_prefill`: the
    engine's one row does not, so every data rank prefills it whole."""
    Tf.check_supported(cfg, policy)
    mamba = has_mamba(cfg)

    def slot_prefill(params, batch, length):
        if mamba:
            batch = dict(batch, tokens=batch["tokens"][:, :int(length)])
        params = _top_gathered(params, policy)
        batch, split = _rows_of(batch, policy)
        opts = opts_from_cfg(cfg, batch["tokens"], decode_len=decode_len,
                             attn_impl=attn_impl, mamba_impl=mamba_impl)
        x, _, caches, n_prefix = backbone(params, cfg, batch, opts,
                                          want_cache=True, policy=policy)
        idx = n_prefix + int(length) - 1
        return _logits(params, cfg, x[:, idx:idx + 1], policy,
                       split)[:, 0], caches
    return slot_prefill


def write_cache_slot(caches, one, slot: int, rows: slice | None = None):
    """Write a batch-1 cache (as ``make_slot_prefill`` gives it) into the
    running batch cache at batch index ``slot``, in place: every cache
    leaf is stacked ``(groups, B, ...)`` (a period stack's under its
    ``sub{j}``), so the slot axis is 1.
    ``rows``, the slots this rank's cache holds
    (``sharding.batch_block``; default all): a slot outside them is not
    written, one inside at its index among them."""
    if rows is not None:
        if not rows.start <= slot < rows.stop:
            return caches
        slot -= rows.start
    for name, buf in caches.items():
        if isinstance(buf, dict):          # a period stack's sub-layer
            write_cache_slot(buf, one[name], slot)
        else:
            buf[:, slot:slot + 1] = one[name].to(buf.dtype)
    return caches


# --------------------------------------------------------------------------
# loss (seq-chunked cross entropy: caps live logits at (B, S/chunks, V))
# --------------------------------------------------------------------------


def _head_weight(params, cfg):
    if cfg.tie_embeddings:
        return params["embed"]["embed"].T
    return params["lm_head"]["w"]


def _chunk_loss(xc, yc, w, policy=None):
    """(sum of the unmasked tokens' cross entropy, their count): bf16
    operands, float32 logits (B,c,V); under a sharded model axis ``w``
    holds the rank's vocab columns and the logits are gathered."""
    if policy is not None and policy.sharded:
        # the copy after the cast: the ranks' float32 gradients of xc are
        # summed, then rounded to bf16 once, as world 1 rounds its one
        # product (before it, each rank's part would be rounded first)
        logits = gather_dim(Ly.model_copy(xc.to(Ly.BF16).float(), policy)
                            @ w.float(), policy.model_group, -1)
    else:
        logits = xc.to(Ly.BF16).float() @ w.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1,
                        torch.clamp(yc, min=0).long()[..., None])[..., 0]
    mask = (yc >= 0).to(F32)
    return torch.sum((lse - gold) * mask), torch.sum(mask)


def ce_loss(params, cfg, x, labels, chunks: int = 1, policy=None):
    """x (B,S,d) float or bf16, labels (B,S) int (-1 = masked).  The
    sequence is cut into the largest divisor of S not above ``chunks``;
    each chunk's logits are recomputed in the backward
    (``torch.utils.checkpoint``), so at most one chunk's live.  Under a
    sharded model axis the head holds the rank's vocab block and each
    chunk's logits are gathered (with their gradient)."""
    B, S, d = x.shape
    w = _head_weight(params, cfg).to(Ly.BF16)
    chunks = max(1, min(chunks, S))
    while S % chunks != 0:
        chunks -= 1
    c = S // chunks
    total = count = 0
    for i in range(chunks):
        t = slice(i * c, (i + 1) * c)
        loss, n = checkpoint(_chunk_loss, x[:, t], labels[:, t], w,
                             policy, use_reentrant=False)
        total, count = total + loss, count + n
    return total / torch.clamp(count, min=1.0)


def _cast_weights_bf16(params):
    """The tree with its float32 matmul weights (``_is_matmul_weight``)
    as bf16; every other leaf as it is."""
    def cast(node, parent=""):
        out = {}
        for name, p in node.items():
            if isinstance(p, Mapping):
                out[name] = cast(p, name)
                continue
            out[name] = p.to(Ly.BF16) if p.dtype == F32 \
                and _is_matmul_weight(parent, name, p.dim()) else p
        return out
    return cast(params)


def make_loss_fn(cfg, policy, opts: StackOpts, aux_coeff: float = 0.01):
    """``loss_fn(params, batch) -> (loss + aux_coeff * moe_aux, {"loss",
    "moe_aux"})``: ``moe_aux`` is the MoE layers' auxiliary loss summed
    over the stack (0 without MoE layers).  Under ``policy`` both are this
    rank's: over its rows, ``moe_aux`` averaged over the model ranks; the
    matmul weights are cast to bf16 before any gather over data, and the
    leaves outside the layer stack are gathered here (the layers gather
    their own)."""
    def loss_fn(params, batch):
        if cfg.train.bf16_weight_cast:
            params = _cast_weights_bf16(params)
        params = _top_gathered(params, policy)
        x, aux, _, n_prefix = backbone(params, cfg, batch, opts,
                                       policy=policy)
        labels = batch["labels"]
        if n_prefix:
            x = x[:, n_prefix:]
        loss = ce_loss(params, cfg, x, labels, cfg.train.loss_seq_chunks,
                       policy)
        return loss + aux_coeff * aux, {"loss": loss, "moe_aux": aux}
    return loss_fn


# --------------------------------------------------------------------------
# train step (microbatched grad accumulation + AdamW)
# --------------------------------------------------------------------------


def make_train_step(cfg, policy, opt_cfg: adamw.AdamWConfig, *,
                    donate: bool = False):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)`` on float32 masters (``init_params(..., master=True)``)
    and ``opt_state = adamw.init(adamw.flatten_params(params), opt_cfg)``.
    The batch's rows are split into ``cfg.train.microbatches``
    microbatches whose float32 gradients and losses are averaged.
    Attention and the scan run their plain paths on every device (the
    kernels are forward only; the reference trains with
    ``attn_impl="xla"`` too); layers are rematerialised as
    ``cfg.train.remat`` says.

    Under ``policy`` (a mesh of several ranks) ``params`` are this
    rank's slices in the flavor's layout (``sharding.shard_params``),
    ``batch`` its rows (``sharding.shard_batch``) and ``opt_state`` the
    moments of its 2D slices (``adamw.init`` of ``Zero1.local`` of each
    parameter: ZeRO-1).  The gradients are averaged over the batch
    ranks (pod x data) into that 2D layout (a KV head shared by model
    ranks summed over them first), AdamW updates the 2D slices (the
    global norm over the whole mesh) and, under ``tp``, the new
    parameters are gathered back over data.  The reported ``loss`` and
    ``moe_aux`` are means over the batch ranks.

    With ``donate`` the step writes the new parameters and AdamW state
    into the tensors it is given (``adamw.update``: the reference's
    launcher donates them, ``donate_argnums=(0, 1)``), so the old and
    the new state are never held whole side by side; without it the
    caller's tensors are left as they were."""
    Tf.check_supported(cfg, policy, train=True)
    t = cfg.train
    opts = StackOpts(attn_impl="xla", mamba_impl="xla",
                     q_chunk=t.attn_q_chunk, k_chunk=t.attn_k_chunk,
                     remat=t.remat, moe_capacity=t.moe_capacity_factor)
    loss_fn = make_loss_fn(cfg, policy, opts)
    n_micro = max(1, t.microbatches)
    meshed = policy is not None and policy.mesh is not None \
        and policy.mesh.size > 1

    def train_step(params, opt_state, batch):
        flat = adamw.flatten_params(params)
        leaves = {k: p.detach().requires_grad_(True)
                  for k, p in flat.items()}
        tree = adamw.unflatten_params(leaves)
        if n_micro == 1:
            total, metrics = loss_fn(tree, batch)
            grads = dict(zip(leaves, torch.autograd.grad(
                total, list(leaves.values()))))
        else:
            rows = next(iter(batch.values())).shape[0]
            if rows % n_micro:
                raise ValueError(f"a batch of {rows} rows does not split "
                                 f"into {n_micro} microbatches")
            grads = {k: torch.zeros(v.shape, dtype=F32, device=v.device)
                     for k, v in leaves.items()}
            loss_sum = aux_sum = 0
            for i in range(n_micro):
                mb = {k: v.reshape((n_micro, rows // n_micro)
                                   + v.shape[1:])[i]
                      for k, v in batch.items()}
                total, met = loss_fn(tree, mb)
                for k, g in zip(leaves, torch.autograd.grad(
                        total, list(leaves.values()))):
                    grads[k] += g.to(F32)
                loss_sum = loss_sum + met["loss"].detach()
                aux_sum = aux_sum + met["moe_aux"].detach()
            grads = {k: g / n_micro for k, g in grads.items()}
            metrics = {"loss": loss_sum / n_micro,
                       "moe_aux": aux_sum / n_micro}
        metrics = {k: v.detach() for k, v in metrics.items()}
        zero = None
        if meshed:
            zero = sharding.Zero1(policy, flat, cfg)
            grads = {k: zero.grad(k, g) for k, g in grads.items()}
            if policy.world_d > 1:
                metrics = {k: all_reduce(v, policy.batch_group)
                           / policy.world_d for k, v in metrics.items()}
        flat, opt_state, om = adamw.update(flat, grads, opt_state, opt_cfg,
                                           zero=zero, donate=donate)
        return adamw.unflatten_params(flat), opt_state, dict(metrics, **om)

    return train_step


# --------------------------------------------------------------------------
# cache layout
# --------------------------------------------------------------------------


def cache_struct(cfg, batch_size: int, decode_len: int,
                 enc_len: int = 0, policy=None) -> dict:
    """name -> (shape, dtype) of the stacked cache that ``stack_apply``
    emits, the reference's layout: for each layer kind ``{"k", "v"}``
    (groups, B, Hkv, decode_len, D) bf16 for attention, and for an
    enc-dec decoder also ``{"ck", "cv"}`` (groups, B, Hkv, enc_len, D)
    bf16; ``{"conv" (groups, B, K-1, E), "ssm" (groups, B, E, N)}``
    float32 for a Mamba layer.  The groups are the layers of a uniform
    stack, and the periods of a period stack, whose tree holds one
    ``{"sub{j}": ...}`` of these a layer of the period.  Under a sharded
    ``policy`` Hkv is the KV heads this rank holds and E its E/M
    channels, and on batch axes of several ranks B its rows of
    ``batch_size`` (``sharding.batch_block``)."""
    Tf.check_supported(cfg, policy)
    rows = sharding.batch_block(policy, batch_size)
    per = Tf._period(cfg)
    L, B = cfg.n_layers // per, rows.stop - rows.start

    def one(i):
        mixer, _, cross = Tf.layer_kind(cfg, i)
        if mixer == "mamba":
            E = cfg.d_inner // (1 if policy is None else policy.world_m)
            c = {"conv": ((L, B, cfg.ssm_conv - 1, E), F32),
                 "ssm": ((L, B, E, cfg.ssm_state), F32)}
        else:
            kv = (L, B, sharding.local_kv_heads(cfg, policy), decode_len,
                  cfg.d_head)
            c = {"k": (kv, CACHE_DTYPE), "v": (kv, CACHE_DTYPE)}
        if cross:
            ckv = (L, B, sharding.local_kv_heads(cfg, policy), enc_len,
                   cfg.d_head)
            c.update(ck=(ckv, CACHE_DTYPE), cv=(ckv, CACHE_DTYPE))
        return c

    return one(0) if per == 1 else {f"sub{j}": one(j) for j in range(per)}


def init_caches(cfg, batch_size: int, decode_len: int, device,
                enc_len: int = 0, policy=None) -> dict:
    """Zero caches of :func:`cache_struct`'s layout on ``device``."""
    def zeros(node):
        return {k: zeros(v) if isinstance(v, dict)
                else torch.zeros(v[0], dtype=v[1], device=device)
                for k, v in node.items()}
    return zeros(cache_struct(cfg, batch_size, decode_len, enc_len, policy))


def cache_leaves(caches: dict):
    """(name, leaf) of every leaf of a cache tree, in order; a period
    stack's ``sub{j}`` levels are walked through."""
    for name, v in caches.items():
        if isinstance(v, dict):
            yield from cache_leaves(v)
        else:
            yield name, v
