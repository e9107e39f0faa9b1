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

A Mamba block's ``in_proj`` is the one leaf whose model cut is not one
contiguous block: its columns are ``[x | z]``, two parts of ``E``
channels, and a model rank holds the x and the z columns of its own
block of channels (:class:`PerPart`), so that its conv, scan, gate and
caches are its own.  The spec entry that says so is the rule every
slicer and gatherer follows (:func:`shard_slices`, :func:`shard_params`,
:class:`StateLayout`).

The batch axes (``pod`` and ``data``): each batch rank holds its block
of a batch's rows, by its index over both, pod major
(:func:`batch_block`, the layout of ``P(("pod", "data"), None)``; every
batch rank holds the whole batch where its rows do not split, as the
reference's ``_batch_axes_for``): training's batch
(:func:`shard_batch`) and serving's slots alike.  The 2D weight dim is
cut over ``data`` alone (the reference's ``_dd``) and is whole over
``pod``.  Under ``fsdp_tp`` a layer gathers its 2D leaves over the
data group before use, and the forward its top-level leaves
(:func:`gather_data`).  In training the AdamW moments and the averaged
gradients (the mean over pod x data) are held in the 2D layout of
``param_specs(for_opt=True)`` (ZeRO-1, :class:`Zero1`); a checkpoint
holds whole leaves, which :class:`StateLayout` gathers and slices.
Where the KV heads do not split over the model axis, the model ranks
whose q heads read one KV head each hold its columns
(:class:`KVHeads`), and in training they sum its gradient.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch

from ..core.context import all_gather, all_reduce, gather_params, \
    reduce_scatter

DATA = "data"


class PerPart(str):
    """A spec entry: the axis ``axis``, cutting its dim viewed as
    ``(parts, n / parts)`` along the second factor, so that each rank
    holds its block of every part, the parts side by side.  It is the
    axis name (it compares equal to it, so a spec equals the
    reference's, whose compiler lays the columns out itself); only the
    port's slicers and gatherers read ``parts``."""

    def __new__(cls, axis: str, parts: int):
        obj = super().__new__(cls, axis)
        obj.parts = parts
        return obj

    def __getnewargs__(self):
        return str(self), self.parts

    def __repr__(self):
        return f"PerPart({str(self)!r}, {self.parts})"


def _parts(entry) -> int:
    """How many parts a spec entry cuts its dim in (1: one block)."""
    return entry.parts if isinstance(entry, PerPart) else 1


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

    @property
    def world_d(self) -> int:
        """Ranks along the batch axes (the product of their sizes)."""
        return math.prod(self.size(a) for a in self.batch_axes)

    @property
    def batch_rank(self) -> int:
        """This rank's index over the batch axes together, the first
        (``pod``) major: the block of a batch's rows it holds."""
        index = 0
        for a in self.batch_axes:
            index = index * self.size(a) + (0 if self.mesh is None
                                            else self.mesh.coord[a])
        return index

    @property
    def batch_group(self):
        """The process group of the batch axes together, ranks in
        :attr:`batch_rank` order (None for one rank)."""
        return None if self.mesh is None \
            else self.mesh.group_of(self.batch_axes)

    @property
    def world_fsdp(self) -> int:
        """Ranks along ``data``, the axis that cuts the 2D weight dim and
        the ZeRO-1 moments (the reference's ``_dd``); other batch axes
        (``pod``) hold them whole."""
        return 1 if self.mesh is None else self.mesh.shape.get(DATA, 1)

    @property
    def fsdp_rank(self) -> int:
        return self.mesh.coord[DATA] if self.world_fsdp > 1 else 0

    @property
    def fsdp_group(self):
        """The process group of ``data`` (None for one rank)."""
        return self.mesh.groups[DATA] if self.world_fsdp > 1 else None

    @property
    def pod_group(self):
        """The process group of the batch axes but ``data`` (``pod``),
        over which weights and moments are replicated (None for one
        rank)."""
        return None if self.mesh is None else self.mesh.group_of(
            tuple(a for a in self.batch_axes if a != DATA))

    @property
    def fsdp(self) -> bool:
        """Whether the layers hold 2D leaves and gather them over data."""
        return self.flavor == "fsdp_tp" and self.world_fsdp > 1

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
        if parent == "in_proj" and name in ("w", "b"):
            # [x | z]: each model rank holds both of its channels' columns
            cols = PerPart(m, 2)
            return (dd, cols) if name == "w" else (cols,)
        if name == "b":
            if parent in ("wq", "wk", "wv", "dt_proj"):
                return (m,)
            return (None,)
        if parent in ("wq", "wk", "wv", "w_gate", "w_up", "w_in") \
                and name == "w":
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

    def leaf_spec(self, path: str, ndim: int, use2d: bool) -> tuple:
        """The spec of the leaf at dotted ``path`` (``flatten_params``'
        keys) with ``ndim`` dims, as :meth:`param_specs` gives it."""
        base = self.base_spec(tuple(path.split(".")), ndim, use2d)
        pad = ndim - len(base)
        return () if pad < 0 else tuple([None] * pad + list(base))


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


def _part_blocks(n: int, k: int, parts: int, index: int) -> np.ndarray:
    """The indices of block ``index`` of ``parts`` of each of the ``k``
    equal parts of a dim of ``n``, part after part (a :class:`PerPart`
    cut)."""
    if n % k:
        raise ValueError(f"a dim of {n} is not {k} equal parts")
    per = n // k
    b = block(per, parts, index)
    return np.concatenate([np.arange(j * per + b.start, j * per + b.stop)
                           for j in range(k)])


class KVHeads(str):
    """A spec entry: the model axis cutting attention's k / v columns
    (``wk``, ``wv``, their biases and moments) by :func:`kv_head_block`
    where the KV heads do not split over it: each model rank holds the
    KV heads its block of q heads reads, so the ranks of a group share
    one.  It is the axis name (it compares equal to it, as the
    reference's spec does, whose compiler replicates those columns);
    only the port's slicers and gatherers read the heads."""

    def __new__(cls, axis: str, n_heads: int, n_kv_heads: int,
                d_head: int):
        obj = super().__new__(cls, axis)
        obj.heads = (n_heads, n_kv_heads, d_head)
        return obj

    def __getnewargs__(self):
        return (str(self),) + self.heads

    def __repr__(self):
        return f"KVHeads({str(self)!r}, *{self.heads})"

    def cols(self, world: int, rank: int) -> slice:
        """The columns model rank ``rank`` of ``world`` holds."""
        n_heads, n_kv, d_head = self.heads
        h0, nh = kv_head_block(n_heads, n_kv, world, rank)
        return slice(h0 * d_head, (h0 + nh) * d_head)

    def first_holders(self, world: int) -> list[int]:
        """For each KV head, the first model rank that holds it."""
        n_heads, n_kv, _ = self.heads
        out = {}
        for r in range(world):
            h0, nh = kv_head_block(n_heads, n_kv, world, r)
            for h in range(h0, h0 + nh):
                out.setdefault(h, r)
        return [out[h] for h in range(n_kv)]


def with_kv_heads(spec: tuple, path: str, cfg, world_m: int) -> tuple:
    """``spec`` of the leaf at dotted ``path`` with its model entry as
    :class:`KVHeads` where it is an attention's ``wk`` / ``wv`` (weight
    or bias) and the config's KV heads do not split over a model axis of
    ``world_m``; else ``spec`` itself."""
    names = path.split(".")
    if cfg is None or not cfg.n_heads or cfg.n_kv_heads % world_m == 0 \
            or len(names) < 2 or names[-2] not in ("wk", "wv") \
            or not spec or spec[-1] is None:
        return spec
    return tuple(spec[:-1]) + (KVHeads(spec[-1], cfg.n_heads,
                                       cfg.n_kv_heads, cfg.d_head),)


def shard_slices(shape, spec, sizes: dict, coord: dict) -> tuple:
    """The index of each dim that the rank at ``coord`` holds: a dim
    whose spec names axes is cut into the product of their sizes, in the
    order named (the first axis major), as one block (a slice), for a
    :class:`PerPart` entry a block of each part (an index array), for a
    :class:`KVHeads` entry the columns of the rank's KV heads."""
    out = []
    for n, entry in zip(shape, spec):
        parts, index = 1, 0
        for a in _axes(entry):
            parts *= sizes[a]
            index = index * sizes[a] + coord[a]
        if parts == 1:
            out.append(slice(None))
        elif isinstance(entry, KVHeads):
            out.append(entry.cols(parts, index))
        elif _parts(entry) > 1:
            out.append(_part_blocks(n, _parts(entry), parts, index))
        else:
            out.append(block(n, parts, index))
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
    axis (:func:`with_kv_heads`).  Under ``fsdp_tp`` a dim cut over a data
    axis of several ranks must split evenly (the layers gather equal
    blocks)."""
    if policy.mesh is None:
        return params
    coord = dict(policy.mesh.coord if coord is None else coord)
    sizes = dict(policy.mesh.shape)
    specs = policy.param_specs(params)

    def walk(node, spec, names):
        if isinstance(node, dict):
            return {k: walk(v, spec[k], names + (k,))
                    for k, v in node.items()}
        spec = with_kv_heads(spec, ".".join(names), cfg, policy.world_m)
        idx = shard_slices(node.shape, spec, sizes, coord)
        dim = data_dim(spec)
        if policy.fsdp and dim is not None \
                and node.shape[dim] % sizes[DATA]:
            raise ValueError(f"{'.'.join(names)}: dim {dim} of "
                             f"{tuple(node.shape)} does not split over a "
                             f"data axis of {sizes[DATA]}")
        return node[idx].contiguous().clone() \
            if isinstance(node, torch.Tensor) else node[idx].copy()

    return walk(params, specs, ())


def data_dim(spec) -> int | None:
    """The dim of ``spec`` cut over the data axis (None if none)."""
    return next((i for i, e in enumerate(spec) if DATA in _axes(e)), None)


# --------------------------------------------------------------------------
# the batch axes
# --------------------------------------------------------------------------


def _batch_axes_for(policy: Policy, B: int) -> tuple[str, ...]:
    """The reference's rule: the batch axes that a batch of ``B`` rows is
    cut over (none where ``B`` does not split over them, and then every
    batch rank holds the whole batch)."""
    return policy.batch_axes if B % policy.world_d == 0 else ()


def batch_block(policy: Policy | None, B: int) -> slice:
    """The rows of a batch of ``B`` that this rank holds: batch rank b
    (:attr:`Policy.batch_rank`, over pod and data, pod major) ``[b B / D,
    (b + 1) B / D)``, the block layout of ``P(batch_axes, None)``; all
    ``B`` where they do not split over the batch axes (or there is one
    batch rank)."""
    if policy is None or policy.world_d == 1 \
            or not _batch_axes_for(policy, B):
        return slice(0, B)
    return block(B, policy.world_d, policy.batch_rank)


def shard_batch(batch: dict, policy: Policy | None) -> dict:
    """This rank's rows (:func:`batch_block`) of every array of
    ``batch`` (leading dim ``B``)."""
    if policy is None or policy.world_d == 1:
        return batch
    rows = batch_block(policy, next(iter(batch.values())).shape[0])
    return {k: v[rows] for k, v in batch.items()}


def gather_data(tree: dict, policy: Policy | None) -> dict:
    """Under ``fsdp_tp`` at a data axis of more than one rank, ``tree``
    (a part of the parameters, names as in the whole tree) with every 2D
    leaf gathered over the data group along its data dim
    (``core.context.gather_params``: in training the backward
    reduce-scatters the gradient; serving's leaves take none); else
    ``tree`` itself.  A ``pod`` axis gathers nothing: the leaves are
    whole over it."""
    if policy is None or not policy.fsdp:
        return tree
    specs = policy.param_specs(tree, use2d=True)
    group = policy.fsdp_group

    def walk(node, spec):
        if isinstance(node, dict):
            return {k: walk(v, spec[k]) for k, v in node.items()}
        dim = data_dim(spec)
        return node if dim is None else gather_params(node, group, dim)

    return walk(tree, specs)


def _gather_blocks(x: torch.Tensor, group, dim: int,
                   n: int | None = None, parts: int = 1) -> torch.Tensor:
    """The ranks' blocks of ``dim`` (of any sizes: the last ones of an
    uneven split are shorter) concatenated in rank order; ``n``, the
    whole size of a one-block cut, if known, spares an exchange of the
    block sizes.  With ``parts`` (a :class:`PerPart` cut) each rank's
    block holds its block of every part, and the whole is put together
    part after part.  A CUDA tensor of a gloo group is gathered into one
    pinned host buffer and copied back once."""
    if n is not None:
        world = torch.distributed.get_world_size(group)
        sizes = [len(range(n)[block(n, world, r)]) for r in range(world)]
    else:
        sizes = [int(s) for s in all_gather(
            torch.tensor([x.shape[dim]], device=x.device), group)]
    per = max(sizes)
    send = x.movedim(dim, 0)
    if send.shape[0] < per:
        send = torch.cat([send, send.new_zeros(
            (per - send.shape[0],) + send.shape[1:])])
    send = send.contiguous()
    world = len(sizes)
    if x.is_cuda and torch.distributed.get_backend(group) == "gloo":
        host = torch.empty(send.shape, dtype=send.dtype, pin_memory=True)
        host.copy_(send)
        out = torch.empty((world * per,) + send.shape[1:], dtype=send.dtype,
                          pin_memory=True)
        torch.distributed.all_gather(list(out.split(per)), host,
                                     group=group)
    else:
        out = torch.cat(all_gather(send, group))
    if any(n < per for n in sizes) or parts > 1:
        held = [out[r * per:r * per + n] for r, n in enumerate(sizes)]
        out = torch.cat([b for j in range(parts) for b in (
            h.narrow(0, j * (len(h) // parts), len(h) // parts)
            for h in held)])
    return out.to(x.device, non_blocking=True).movedim(0, dim).contiguous()


def _gather_kv_heads(x: torch.Tensor, entry: KVHeads, group,
                     dim: int) -> torch.Tensor:
    """The whole k / v columns of ``dim`` from the model ranks' KV heads
    (:class:`KVHeads`): each rank's block gathered in rank order, then
    each KV head's columns from the first rank that holds it."""
    world = torch.distributed.get_world_size(group)
    per = x.shape[dim]
    d_head = entry.heads[2]
    out = _gather_blocks(x, group, dim, n=world * per)
    cols = []
    for h, r in enumerate(entry.first_holders(world)):
        j = h - entry.cols(world, r).start // d_head
        cols.append(torch.arange(r * per + j * d_head,
                                 r * per + (j + 1) * d_head))
    return out.index_select(dim, torch.cat(cols).to(out.device))


def _sum_kv_heads(g: torch.Tensor, entry: KVHeads, policy: Policy,
                  dim: int) -> torch.Tensor:
    """The gradient of this rank's KV head columns summed over the model
    ranks that hold the same heads: each rank's gradient placed at its
    columns of a zeroed whole, all-reduced over the model group (the
    same bits on every rank and every run), its columns taken back.  The
    reference's GSPMD replicates those columns over ``model`` and sums
    their gradient so."""
    n_kv, d_head = entry.heads[1], entry.heads[2]
    cols = entry.cols(policy.world_m, policy.model_rank)
    whole = g.new_zeros(g.shape[:dim] + (n_kv * d_head,) + g.shape[dim + 1:])
    whole.narrow(dim, cols.start, cols.stop - cols.start).copy_(g)
    whole = all_reduce(whole, policy.model_group)
    return whole.narrow(dim, cols.start, cols.stop - cols.start)


class Zero1:
    """One rank's ZeRO-1 layout for AdamW over the flat parameters
    ``flat`` (``flatten_params`` keys) as the rank holds them: the
    moments and the averaged gradients in the 2D layout of
    ``param_specs(for_opt=True)``, cut over ``data`` and whole over
    ``pod``.  Under ``tp`` a rank holds its model slice of each parameter
    whole over data, and its 2D slice is a view of it; under ``fsdp_tp``
    it holds the 2D slice.  ``cfg``, where the train step passes it,
    marks attention's k / v columns shared by model ranks
    (:func:`with_kv_heads`).  Used by ``optim.adamw.update``."""

    def __init__(self, policy: Policy, flat: dict, cfg=None):
        self.policy = policy
        self.spec = {k: with_kv_heads(policy.leaf_spec(k, p.dim(), True),
                                      k, cfg, policy.world_m)
                     for k, p in flat.items()}
        self.ddim = {k: data_dim(s) for k, s in self.spec.items()}
        self.D, self.d = policy.world_fsdp, policy.fsdp_rank
        self.group = policy.fsdp_group
        sizes, coord = policy.mesh.shape, policy.mesh.coord

        def counted(s):
            # a leaf replicated over an axis is counted on one rank of it,
            # a KV head shared by model ranks on the first that holds it
            kv = next((e for e in s if isinstance(e, KVHeads)), None)
            return all(coord[a] == 0 for a in policy.mesh.axis_names
                       if sizes[a] > 1 and not any(a in _axes(e)
                                                   for e in s)) \
                and (kv is None or policy.model_rank in
                     kv.first_holders(policy.world_m))
        self._counted = {k: counted(s) for k, s in self.spec.items()}

    def local(self, k: str, p: torch.Tensor) -> torch.Tensor:
        """This rank's 2D slice of parameter ``k`` as held (a view)."""
        dim = self.ddim[k]
        if self.policy.fsdp or dim is None or self.D == 1:
            return p
        sl = block(p.shape[dim], self.D, self.d)
        return p.narrow(dim, sl.start, sl.stop - sl.start)

    def grad(self, k: str, g: torch.Tensor) -> torch.Tensor:
        """The gradient of ``k`` from this rank's rows -> the mean over
        the batch ranks (pod x data), in the 2D layout: a KV head's
        gradient first summed over the model ranks that share it
        (``layers.attn_apply``'s input gradient needs nothing: its
        ``copy_to_group`` sums it over the model group), then summed over
        ``data`` (under ``fsdp_tp`` a 2D leaf's is already, by its
        gather's backward; under ``tp`` reduce-scattered) and over
        ``pod``, or over both at once for a leaf without a data dim."""
        kv = next((i for i, e in enumerate(self.spec[k])
                   if isinstance(e, KVHeads)), None)
        if kv is not None:
            g = _sum_kv_heads(g, self.spec[k][kv], self.policy, kv)
        policy = self.policy
        if policy.world_d == 1:
            return g
        dim = self.ddim[k]
        if dim is None or self.D == 1:
            g = all_reduce(g, policy.batch_group)
        else:
            if not policy.fsdp:
                g = reduce_scatter(g, self.group, dim)
            if policy.pod_group is not None:
                g = all_reduce(g, policy.pod_group)
        return g / policy.world_d

    def whole(self, k: str, new: torch.Tensor,
              held: torch.Tensor) -> torch.Tensor:
        """Write the updated 2D slice ``new`` of ``k`` into ``held``, the
        parameter as the rank holds it (under ``tp`` gathered over data
        first); returns ``held``."""
        dim = self.ddim[k]
        if not (self.policy.fsdp or dim is None or self.D == 1):
            new = _gather_blocks(new, self.group, dim, held.shape[dim])
        return held.copy_(new)

    def counted(self, k: str) -> bool:
        """Whether this rank adds leaf ``k`` to the global norm."""
        return self._counted[k]

    def total(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the whole mesh."""
        for a in self.policy.mesh.axis_names:
            if self.policy.size(a) > 1:
                x = all_reduce(x, self.policy.mesh.groups[a])
        return x


class _Spec:
    """A spec as a tree leaf (a tree walk recurses into tuples)."""

    def __init__(self, spec):
        self.spec = spec


def _specs_tree(specs, cfg, world_m, path=()):
    if isinstance(specs, dict):
        return {k: _specs_tree(v, cfg, world_m, path + (k,))
                for k, v in specs.items()}
    return _Spec(with_kv_heads(specs, ".".join(path), cfg, world_m))


class StateLayout:
    """How one rank holds the leaves of a training state ``(params,
    opt_state)``: each leaf's spec over ``policy``'s mesh, in the order
    of ``checkpoint.tree_leaves``.  A checkpoint holds whole leaves
    (:meth:`whole`, written by the rank at the mesh's origin) and every
    rank restores its slice of them (:meth:`local`), so a checkpoint of
    one world restores at another, and in the reference."""

    def __init__(self, policy: Policy, specs: list):
        self.policy, self.specs = policy, specs
        self.sizes, self.coord = policy.mesh.shape, policy.mesh.coord

    @property
    def writer(self) -> bool:
        return all(c == 0 for c in self.coord.values())

    def whole(self, leaves: list):
        """Every leaf gathered whole as a numpy array, on the writer (the
        other ranks get None); every rank must call it.  A :class:`KVHeads`
        dim takes one copy of each KV head."""
        out = []
        on_host = torch.distributed.get_backend() == "gloo"
        for leaf, spec in zip(leaves, self.specs):
            x = leaf.detach()
            if on_host:                 # gloo gathers host tensors as they are
                x = x.cpu()
            for dim, entry in enumerate(spec):
                axes = [a for a in _axes(entry) if self.sizes[a] > 1]
                if len(axes) > 1:
                    raise NotImplementedError(f"a dim cut over {axes}")
                if not axes:
                    continue
                group = self.policy.mesh.groups[axes[0]]
                if isinstance(entry, KVHeads):
                    x = _gather_kv_heads(x, entry, group, dim)
                else:
                    x = _gather_blocks(x, group, dim, parts=_parts(entry))
            out.append(x.cpu().numpy() if self.writer else None)
        return out if self.writer else None

    def local(self, arr, i: int):
        """This rank's slice of leaf ``i`` from its whole array."""
        return arr[shard_slices(arr.shape, self.specs[i], self.sizes,
                                self.coord)]

    def barrier(self) -> None:
        torch.distributed.barrier()


def train_state_layout(policy: Policy, params: dict, opt: dict, cfg=None):
    """The :class:`StateLayout` of ``(params, opt_state)`` as the train
    step holds them: parameters in the flavor's layout, the moments
    ``m`` and ``v`` (flat dicts) in the 2D one, the step replicated;
    with ``cfg``, attention's k / v columns as :func:`shard_params` cuts
    them where model ranks share KV heads.  None without a mesh of more
    than one rank."""
    from ..checkpoint import tree_leaves
    if policy is None or policy.mesh is None or policy.mesh.size == 1:
        return None
    moments = {k: _Spec(with_kv_heads(policy.leaf_spec(k, v.dim(), True), k,
                                      cfg, policy.world_m))
               for k, v in opt["m"].items()}
    tree = (_specs_tree(policy.param_specs(params), cfg, policy.world_m),
            {"m": moments, "v": moments, "step": _Spec(())})
    return StateLayout(policy, [s.spec for s in tree_leaves(tree)])


def local_kv_heads(cfg, policy: Policy | None) -> int:
    """The KV heads one model rank holds in its caches."""
    if policy is None or not policy.sharded:
        return cfg.n_kv_heads
    return kv_head_block(cfg.n_heads, cfg.n_kv_heads, policy.world_m,
                         policy.model_rank)[1]
