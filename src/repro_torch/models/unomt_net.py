"""UNOMT drug-response regression network (PyTorch port of
``repro/models/unomt_net.py``; paper §4.2, Figures 6–7).

Dense input layer -> stacked residual "response blocks" (two dense layers
+ dropout + ReLU with a skip) -> dense tail -> one regression output.

Parameters are a dict of tensors keyed by the reference's tree paths
(``input.w``, ``blocks.0.fc1.b``, ..., ``out.b``) in the order the
reference flattens its tree, so the optimizer's decay mask reads the
same leaf names.  The products are plain ``x @ w`` in float32, as the
reference leaves them to XLA.  Dropout masks come from a
``torch.Generator``; ``apply`` also takes the keep masks themselves, so
that a test can hand it the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import numpy as np
import torch

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class UnomtNetConfig:
    n_features: int = 17
    d_hidden: int = 1024
    n_res_blocks: int = 3
    n_dense_tail: int = 2
    dropout: float = 0.1


def _layers(cfg: UnomtNetConfig) -> list[tuple[str, int, int]]:
    """(name, fan in, fan out) of each dense layer, in the reference's
    flatten order (dict keys sorted, list items in order)."""
    d = cfg.d_hidden
    layers = []
    for i in range(cfg.n_res_blocks):
        layers += [(f"blocks.{i}.fc1", d, d), (f"blocks.{i}.fc2", d, d)]
    layers += [("input", cfg.n_features, d), ("out", d, 1)]
    layers += [(f"tail.{t}", d, d) for t in range(cfg.n_dense_tail)]
    return layers


def init(gen: torch.Generator, cfg: UnomtNetConfig) -> dict:
    """He-normal weights (``N(0, 2 / fan_in)``) from ``gen``, zero biases,
    on ``gen``'s device."""
    p = {}
    for name, i, o in _layers(cfg):
        p[f"{name}.b"] = torch.zeros(o, dtype=F32, device=gen.device)
        p[f"{name}.w"] = torch.randn((i, o), generator=gen, dtype=F32,
                                     device=gen.device) * (2.0 / i) ** 0.5
    return p


def unomt_params_from_jax(tree: Mapping, device) -> dict:
    """The port's parameters from the reference's ``init`` tree (its
    leaves as numpy or anything ``np.asarray`` takes), float32 on
    ``device``."""
    def flat(node, prefix):
        if isinstance(node, Mapping):
            for k in sorted(node):
                yield from flat(node[k], f"{prefix}{k}.")
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                yield from flat(v, f"{prefix}{i}.")
        else:
            yield prefix[:-1], node

    return {k: torch.from_numpy(np.array(v, np.float32)).to(device)
            for k, v in flat(tree, "")}


def _lin(p: dict, name: str, x: torch.Tensor) -> torch.Tensor:
    return x @ p[f"{name}.w"] + p[f"{name}.b"]


def apply(p: dict, cfg: UnomtNetConfig, x: torch.Tensor, *,
          train: bool = False, generator: torch.Generator | None = None,
          keep_masks: Sequence[torch.Tensor] | None = None) -> torch.Tensor:
    """(n,) predictions.  With ``train`` and ``cfg.dropout > 0`` each
    block's residual branch is dropped where its keep mask is false and
    scaled by ``1 / (1 - dropout)`` elsewhere; mask ``i`` (shape (n,
    d_hidden)) is ``keep_masks[i]`` when given, else a Bernoulli draw
    from ``generator``.  With neither, no dropout (as the reference
    without a key)."""
    drop = train and cfg.dropout > 0 and (keep_masks is not None
                                          or generator is not None)
    h = torch.relu(_lin(p, "input", x))
    for i in range(cfg.n_res_blocks):
        r = torch.relu(_lin(p, f"blocks.{i}.fc1", h))
        r = _lin(p, f"blocks.{i}.fc2", r)
        if drop:
            keep = keep_masks[i] if keep_masks is not None else \
                torch.rand(r.shape, generator=generator,
                           device=r.device) < 1 - cfg.dropout
            r = torch.where(keep, r / (1 - cfg.dropout), 0.0)
        h = torch.relu(h + r)                 # response block + skip
    for t in range(cfg.n_dense_tail):
        h = torch.relu(_lin(p, f"tail.{t}", h))
    return _lin(p, "out", h)[:, 0]


def mse_loss(p: dict, cfg: UnomtNetConfig, batch: Mapping, *,
             train: bool = False, generator: torch.Generator | None = None,
             keep_masks: Sequence[torch.Tensor] | None = None):
    """(loss, {"mse": loss}); with ``batch["mask"]`` the masked mean
    ``Σ err·m / max(Σ m, 1)``."""
    pred = apply(p, cfg, batch["x"], train=train, generator=generator,
                 keep_masks=keep_masks)
    err = (pred - batch["y"]) ** 2
    mask = batch.get("mask")
    if mask is not None:
        m = mask.to(F32)
        loss = torch.sum(err * m) / torch.clamp(torch.sum(m), min=1.0)
    else:
        loss = torch.mean(err)
    return loss, {"mse": loss}
