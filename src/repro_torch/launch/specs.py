"""Per-rank stand-ins for every (arch × shape) cell, on the ``meta``
device (PyTorch port of ``repro/launch/specs.py``).

The reference describes each input as a ``ShapeDtypeStruct`` with the
``NamedSharding`` its compiler places it by.  The port has no compiler
to place tensors: each stand-in here is what one rank of the port holds,
as ``meta`` tensors (shapes and dtypes, no storage), made by the code the
run itself uses:

* parameters: ``model.init_params`` on ``meta`` (nothing is drawn,
  ``layers.normal``), then ``sharding.shard_params``: the flavor's layout,
  attention's k / v columns by ``sharding.KVHeads`` where the KV heads do
  not split over the model axis; bf16 matmul weights for serving, float32
  masters for training;
* AdamW state: ``adamw.init`` of ``sharding.Zero1.local`` of each
  parameter (the 2D layout, ZeRO-1), flat and keyed by dotted path, in
  the config's moment dtype;
* a training batch: the rank's rows (``sharding.batch_block``);
* a prefill batch and decode tokens: the whole batch, which the serving
  functions take on every rank before they run their block of rows;
* caches: ``model.init_caches``: the rank's rows, KV heads and Mamba
  channels (the reference cuts the cached sequence over ``model``);
* decode's ``cache_len``: a CPU int32 scalar, the last position (the
  decode step checks it on the host).

The resident bytes of a rank are the sum of these (:func:`resident`).
"""
from __future__ import annotations

import types
from typing import Any

import torch

from ..configs import SHAPES, ArchConfig
from ..models import model as M
from ..models import sharding as Sh
from ..optim import adamw

META = torch.device("meta")
# what ``model.init_params`` reads of its generator on ``meta``
_SHAPES_ONLY = types.SimpleNamespace(device=META)


def shape_cell(cell):
    """A cell of ``SHAPES`` by name, or a ``ShapeCell`` as it is."""
    return SHAPES[cell] if isinstance(cell, str) else cell


def _empty(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def opt_config(cfg: ArchConfig) -> adamw.AdamWConfig:
    """The reference's dry-run optimiser: moments in ``opt_dtype``."""
    return adamw.AdamWConfig(moment_dtype=getattr(torch,
                                                  cfg.train.opt_dtype))


def train_batch_specs(cfg: ArchConfig, cell, policy):
    """This rank's rows of a training batch."""
    sh = shape_cell(cell)
    rows, S = Sh.batch_block(policy, sh.global_batch), sh.seq_len
    b = rows.stop - rows.start
    d = {"tokens": _empty((b, S), torch.int32),
         "labels": _empty((b, S), torch.int32)}
    if cfg.frontend == "vision":
        d["patch_embeds"] = _empty((b, cfg.frontend_tokens, cfg.d_model),
                                   torch.bfloat16)
    if cfg.is_encdec:
        d["frames"] = _empty((b, S // cfg.enc_len_ratio, cfg.d_model),
                             torch.bfloat16)
    return d


def prefill_batch_specs(cfg: ArchConfig, cell):
    """The whole prefill batch, as every rank takes it."""
    d = train_batch_specs(cfg, cell, None)
    d.pop("labels")
    return d


def cache_specs(cfg: ArchConfig, cell, policy):
    """Decode-shape caches of this rank (``model.cache_struct``)."""
    sh = shape_cell(cell)
    B, S = sh.global_batch, sh.seq_len
    enc_len = S // cfg.enc_len_ratio if cfg.is_encdec else 0
    return M.init_caches(cfg, B, S, META, enc_len, policy)


def decode_token_specs(cfg: ArchConfig, cell):
    """(the whole batch's tokens, ``cache_len`` on the host)."""
    sh = shape_cell(cell)
    return (_empty((sh.global_batch, 1), torch.int32),
            torch.tensor(sh.seq_len - 1, dtype=torch.int32))


def param_specs(cfg: ArchConfig, policy, *, train: bool = False):
    """This rank's parameters: float32 masters with ``train``, else the
    serving dtypes."""
    params = M.init_params(_SHAPES_ONLY, cfg, master=train)
    return params if policy is None \
        else Sh.shard_params(params, policy, cfg=cfg)


def opt_state_specs(cfg: ArchConfig, policy, params):
    """AdamW's state (:func:`opt_config`) of this rank's 2D slices of
    ``params``."""
    flat = adamw.flatten_params(params)
    if policy is not None and policy.mesh is not None \
            and policy.mesh.size > 1:
        zero = Sh.Zero1(policy, flat, cfg)
        flat = {k: zero.local(k, p) for k, p in flat.items()}
    return adamw.init(flat, opt_config(cfg))


def input_specs(cfg: ArchConfig, cell, policy) -> dict[str, Any]:
    """Everything one rank holds to run the cell's step function."""
    kind = shape_cell(cell).kind
    out: dict[str, Any] = {"kind": kind}
    params = param_specs(cfg, policy, train=kind == "train")
    out["params"] = params
    if kind == "train":
        out["batch"] = train_batch_specs(cfg, cell, policy)
        out["opt_state"] = opt_state_specs(cfg, policy, params)
    elif kind == "prefill":
        out["batch"] = prefill_batch_specs(cfg, cell)
    else:
        out["caches"] = cache_specs(cfg, cell, policy)
        tok, clen = decode_token_specs(cfg, cell)
        out["tokens"], out["cache_len"] = tok, clen
    return out


def tree_bytes(tree) -> int:
    """Bytes of every tensor of a nested dict / tuple."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_bytes(v) for v in tree)
    return 0


def resident(specs: dict) -> dict:
    """Per-rank resident bytes of :func:`input_specs`' stand-ins: the
    parameters, the AdamW state, the caches and the batch (temporaries
    are not estimated)."""
    out = {"params_bytes": tree_bytes(specs["params"]),
           "opt_state_bytes": tree_bytes(specs.get("opt_state")),
           "cache_bytes": tree_bytes(specs.get("caches")),
           "batch_bytes": tree_bytes(specs.get("batch"))
           + tree_bytes(specs.get("tokens"))}
    out["total_bytes"] = sum(out.values())
    out["temporaries"] = "not estimated"
    return out
