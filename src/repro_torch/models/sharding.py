"""Sharding policy (PyTorch port of ``repro/models/sharding.py``):
parameter layouts by tree path, and each rank's slice of the parameters.

One rule table covers all architectures: specs are derived from leaf
names (``wq``, ``e_gate``, ``in_proj``, ...) and left-padded with
``None`` for the stacked-layer leading axes.  A spec is a plain tuple
with one entry per dimension: ``None`` (whole), an axis name, or a tuple
of axis names.

Flavors:
* ``tp``      — 1D tensor parallelism over ``model``; parameters
  replicated over data (Megatron);
* ``fsdp_tp`` — 2D: the non-model matrix dim also sharded over ``data``
  (what the reference's serving launcher uses; at ``data=1`` it is the
  same layout as ``tp``).

The reference also carries GSPMD layout constraints (``sc``,
``shard_heads``, ``shard_gqa_grouped``) that change no numbers.  The
port has no compiler to place tensors: each rank holds the slice
:func:`shard_params` gives it and the layers compute on those slices
(``models/layers.py``), with the collectives written out.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch


@dataclasses.dataclass(frozen=True)
class Policy:
    """``mesh`` is a :class:`repro_torch.launch.mesh.Mesh` (or None: one
    device, no sharding)."""
    mesh: Any = None
    flavor: str = "tp"                  # tp | fsdp_tp
    model_axis: str = "model"
    batch_axes: tuple[str, ...] = ("data",)

    # ---------------------------------------------------------------- mesh
    def size(self, axis: str) -> int:
        """Ranks along ``axis`` (1 without a mesh)."""
        return 1 if self.mesh is None else self.mesh.shape[axis]

    @property
    def world_m(self) -> int:
        return self.size(self.model_axis)

    @property
    def model_rank(self) -> int:
        return 0 if self.mesh is None else self.mesh.coord[self.model_axis]

    @property
    def model_group(self):
        """The process group of the model axis (None without a mesh)."""
        return None if self.mesh is None \
            else self.mesh.groups[self.model_axis]

    @property
    def sharded(self) -> bool:
        """Whether the model axis spans more than one rank."""
        return self.world_m > 1

    # ------------------------------------------------------- parameter rules
    def _dd(self, use2d: bool):
        return "data" if use2d else None

    def base_spec(self, names: tuple[str, ...], ndim_hint: int,
                  use2d: bool) -> tuple:
        m = self.model_axis
        dd = self._dd(use2d)
        name = names[-1]
        parent = names[-2] if len(names) > 1 else ""
        if name == "embed":
            return (m, dd)
        if name == "scale":
            return ()
        if parent == "lm_head" and name == "w":
            return (dd, m)
        if name == "b":
            if parent in ("wq", "wk", "wv", "in_proj", "dt_proj"):
                return (m,)
            return (None,)
        if parent in ("wq", "wk", "wv", "w_gate", "w_up", "w_in",
                      "in_proj") and name == "w":
            return (dd, m)
        if parent in ("wo", "w_down", "w_out", "out_proj") and name == "w":
            return (m, dd)
        if parent == "x_proj" and name == "w":
            return (m, None)
        if parent == "dt_proj" and name == "w":
            return (None, m)
        if name == "router":
            return (None, None)
        if name in ("e_gate", "e_up"):
            return (m, dd, None)
        if name == "e_down":
            return (m, None, dd)
        if name == "conv_w":
            return (None, m)
        if name in ("conv_b", "D"):
            return (m,)
        if name == "A_log":
            return (m, None)
        return tuple([None] * ndim_hint)

    def param_specs(self, params_shape: Any, *, for_opt: bool = False,
                    use2d: bool | None = None):
        """A tree of spec tuples matching a nested dict whose leaves have
        a ``shape``."""
        if use2d is None:
            use2d = (self.flavor == "fsdp_tp") or for_opt

        def walk(node, names):
            if isinstance(node, dict):
                return {k: walk(v, names + (k,)) for k, v in node.items()}
            ndim = len(node.shape)
            base = self.base_spec(names, ndim, use2d)
            pad = ndim - len(base)
            if pad < 0:          # scalar leaves (e.g. step counters)
                return ()
            return tuple([None] * pad + list(base))

        return walk(params_shape, ())


def make_policy(mesh, flavor: str = "tp") -> Policy:
    """The reference's axis discovery: batch axes are ``pod`` and
    ``data`` where present, the model axis ``model`` or the last."""
    if mesh is None:
        return Policy(mesh=None, flavor=flavor)
    names = tuple(mesh.axis_names)
    batch_axes = tuple(a for a in ("pod", "data") if a in names)
    model_axis = "model" if "model" in names else names[-1]
    if not batch_axes:
        batch_axes = tuple(a for a in names if a != model_axis)[:1]
    return Policy(mesh=mesh, flavor=flavor, model_axis=model_axis,
                  batch_axes=batch_axes)


# --------------------------------------------------------------------------
# each rank's slice
# --------------------------------------------------------------------------


def _axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def block(n: int, parts: int, index: int) -> slice:
    """Block ``index`` of ``parts`` of a dim of ``n``: ``ceil(n / parts)``
    each, the last ones shorter or empty (the layout GSPMD gives an
    uneven dim)."""
    per = math.ceil(n / parts)
    return slice(min(index * per, n), min((index + 1) * per, n))


def shard_slices(shape, spec, sizes: dict, coord: dict) -> tuple:
    """The slice of each dim that the rank at ``coord`` holds: a dim
    whose spec names axes is cut into the product of their sizes, in the
    order named (the first axis major)."""
    out = []
    for n, entry in zip(shape, spec):
        parts, index = 1, 0
        for a in _axes(entry):
            parts *= sizes[a]
            index = index * sizes[a] + coord[a]
        out.append(block(n, parts, index) if parts > 1 else slice(None))
    return tuple(out)


def kv_head_block(n_heads: int, n_kv_heads: int, world: int, rank: int):
    """(first KV head, KV heads) a model rank computes: its q heads are
    the contiguous block ``rank`` of ``n_heads / world``, and it holds
    the KV heads those read.  With ``n_kv_heads % world == 0`` that is its
    own block of KV heads; else (the reference's ``shard_gqa_grouped``
    case) the one KV head its whole q block reads, when the block lies in
    one group.  Raises otherwise, and where ``n_heads % world``."""
    if n_heads % world:
        raise ValueError(f"{n_heads} attention heads do not split over a "
                         f"model axis of {world}")
    if n_kv_heads % world == 0:
        per = n_kv_heads // world
        return rank * per, per
    q_loc, group = n_heads // world, n_heads // n_kv_heads
    if group % q_loc:
        raise ValueError(f"{n_heads} q heads over {n_kv_heads} KV heads: "
                         f"a block of {q_loc} q heads spans several KV "
                         f"heads unevenly at a model axis of {world}")
    return rank * q_loc // group, 1


def shard_params(params, policy: Policy, coord: dict | None = None,
                 cfg=None):
    """This rank's slice of every leaf along the axes its spec names
    (contiguous copies, so the whole tree can be freed).  ``coord`` maps
    each mesh axis to this rank's index (default: the mesh's own).  With
    ``cfg``, attention's ``wk``/``wv`` columns (and biases) follow
    :func:`kv_head_block` where the KV heads do not split over the model
    axis."""
    if policy.mesh is None:
        return params
    coord = dict(policy.mesh.coord if coord is None else coord)
    sizes = dict(policy.mesh.shape)
    specs = policy.param_specs(params)
    m = policy.model_axis
    grouped = cfg is not None and cfg.n_heads and \
        cfg.n_kv_heads % sizes[m] != 0

    def walk(node, spec, names):
        if isinstance(node, dict):
            return {k: walk(v, spec[k], names + (k,))
                    for k, v in node.items()}
        if grouped and len(names) > 1 and names[-2] in ("wk", "wv"):
            h0, nh = kv_head_block(cfg.n_heads, cfg.n_kv_heads, sizes[m],
                                   coord[m])
            cols = slice(h0 * cfg.d_head, (h0 + nh) * cfg.d_head)
            idx = shard_slices(node.shape[:-1], spec[:-1], sizes,
                               coord) + (cols,)
        else:
            idx = shard_slices(node.shape, spec, sizes, coord)
        return node[idx].contiguous().clone() \
            if isinstance(node, torch.Tensor) else node[idx].copy()

    return walk(params, specs, ())


def local_kv_heads(cfg, policy: Policy | None) -> int:
    """The KV heads one model rank holds in its caches."""
    if policy is None or not policy.sharded:
        return cfg.n_kv_heads
    return kv_head_block(cfg.n_heads, cfg.n_kv_heads, policy.world_m,
                         policy.model_rank)[1]
