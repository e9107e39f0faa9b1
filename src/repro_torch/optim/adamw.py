"""AdamW with global-norm clipping and a cosine schedule (PyTorch port of
``repro/optim/adamw.py``).

Parameters, gradients and moments are dicts of tensors keyed by the
reference's tree paths (``"blocks.0.fc1.w"``), in the order the
reference flattens its tree; :func:`flatten_params` makes such a dict of
a nested tree (the LM's parameters) and :func:`unflatten_params` nests
it again.  The arithmetic is the reference's, in
float32 throughout (the step, the schedule and the bias corrections are
float32 tensors, never Python doubles): gradients clipped by
``min(1, clip / (norm + 1e-9))``, ``delta = m̂ / (√v̂ + eps) + wd · p``
applied as ``p - lr · delta``, no decay on leaves named ``scale``,
``b``, ``conv_b``, ``D`` or ``A_log``.  ``torch.optim.AdamW`` applies
its decoupled decay differently and would not match.  With
``donate=True`` :func:`update` writes the new parameters, moments and
step into the tensors it is given, a leaf at a time, as the reference's
launcher donates its train step's state: the old and the new state are
never held whole side by side.  Without it the given tensors are left as
they were and new ones returned (the same bits).

Over a mesh of ranks (``zero``, a ``models.sharding.Zero1``) the state
is ZeRO-1: each rank's moments and gradients are its 2D slices of the
leaves, :func:`update` steps its 2D slice of each parameter and writes
the result back in the layout the rank holds, and the global norm sums
every element's square once over the whole mesh (a leaf replicated
over an axis counts on one rank of it).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Mapping

import torch

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    moment_dtype: torch.dtype = torch.float32


def flatten_params(tree: Mapping, prefix: str = "") -> dict:
    """A nested dict of tensors as one dict keyed by dotted paths
    (``"layers.attn.wq.w"``), in the reference's flatten order (keys
    sorted at every level)."""
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, Mapping):
            out.update(flatten_params(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def unflatten_params(flat: Mapping) -> dict:
    """The nested dict that :func:`flatten_params` flattened."""
    tree: dict = {}
    for path, v in flat.items():
        *parents, name = path.split(".")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[name] = v
    return tree


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warm-up then cosine decay to ``min_lr_ratio``: a float32
    0-d tensor for the int32 step."""
    step = step.to(F32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_ratio
                            + (1 - cfg.min_lr_ratio) * cos)


def init(params: dict, cfg: AdamWConfig) -> dict:
    def zeros(p):
        return torch.zeros(p.shape, dtype=cfg.moment_dtype, device=p.device)

    device = next(iter(params.values())).device
    return {"m": {k: zeros(p) for k, p in params.items()},
            "v": {k: zeros(p) for k, p in params.items()},
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree: dict, zero=None) -> torch.Tensor:
    """sqrt of the sum over leaves, in order, of each leaf's sum of
    squares (float32); with ``zero`` the leaves this rank counts, summed
    over the mesh."""
    total = 0
    for k, leaf in tree.items():
        if zero is None or zero.counted(k):
            total = total + torch.sum(torch.square(leaf.to(F32)))
    if zero is not None:
        device = next(iter(tree.values())).device
        total = zero.total(torch.as_tensor(total, dtype=F32, device=device))
    return torch.sqrt(total)


def _decay_mask(path: str) -> bool:
    """No weight decay on norms, biases and 1-D parameters: the last
    name of the path (list indices skipped, as the reference reads only
    dict keys) decides."""
    names = [p for p in path.split(".") if not p.isdigit()]
    if not names:
        return True
    return names[-1] not in ("scale", "b", "conv_b", "D", "A_log")


@torch.no_grad()
def update(params: dict, grads: dict, state: dict, cfg: AdamWConfig,
           zero=None, *, donate: bool = False):
    """One step -> (new params, new state, metrics).  With ``donate``
    every tensor of ``params`` and ``state`` receives its new value in
    place (each leaf's float32 arithmetic as the reference's, the result
    copied into the held tensor) and the same tensors are returned;
    without it they are copied first (:func:`copy_state`).  With
    ``zero`` the gradients and moments are the rank's 2D slices and
    ``params`` as the rank holds them."""
    if not donate:
        params, state = copy_state(params, state)
    step = state["step"] + 1
    lr = schedule(cfg, step)
    gnorm = global_norm(grads, zero)
    scale_clip = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)

    b1, b2 = cfg.b1, cfg.b2
    stepf = step.to(F32)
    bc1 = 1 - torch.pow(b1, stepf)
    bc2 = 1 - torch.pow(b2, stepf)

    for k, held in params.items():
        p = held if zero is None else zero.local(k, held)
        g = grads[k].to(F32) * scale_clip
        m = b1 * state["m"][k].to(F32) + (1 - b1) * g
        v = b2 * state["v"][k].to(F32) + (1 - b2) * g * g
        delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        if _decay_mask(k):
            delta = delta + cfg.weight_decay * p.to(F32)
        new = (p.to(F32) - lr * delta).to(p.dtype)
        del g, delta
        state["m"][k].copy_(m)
        state["v"][k].copy_(v)
        del m, v
        if zero is None:
            held.copy_(new)
        else:
            zero.whole(k, new, held)
    state["step"].copy_(step)
    metrics = {"grad_norm": gnorm, "lr": lr}
    return params, state, metrics


def copy_state(params: dict, state: dict) -> tuple[dict, dict]:
    """Copies of ``params`` and of an AdamW ``state`` (new tensors)."""
    return ({k: p.clone() for k, p in params.items()},
            {"m": {k: t.clone() for k, t in state["m"].items()},
             "v": {k: t.clone() for k, t in state["v"].items()},
             "step": state["step"].clone()})
