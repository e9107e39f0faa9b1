"""Checkpoint store (PyTorch port of ``repro/checkpoint/store.py``):
atomic, async, keep-k.

Layout: ``<dir>/step_<N>/arrays.npz + meta.msgpack``, written to
``.tmp_step_<N>`` and renamed, so a crashed writer never corrupts the
latest checkpoint; a leftover temp dir is never listed.  A state is any
tree of dicts, tuples and lists with tensors (or numpy arrays) at the
leaves.  Leaves are numbered ``a0 … an`` in the order ``jax.tree_util``
flattens the same tree (dict keys sorted, tuples and lists in order, a
``None`` no leaf), so a checkpoint the JAX package writes from the same
tree restores here and the port's restores there.  ``restore`` puts each
array on its template leaf's device and dtype.

Over a mesh of ranks (``layout``, a ``models.sharding.StateLayout``) a
checkpoint still holds whole leaves, as the reference's ``np.asarray``
of a global array: ``save`` gathers each leaf's slices to the rank at
the mesh's origin, which writes, and every rank then meets at a
barrier; ``restore`` reads whole leaves and gives each rank its slice.
So a checkpoint of one world restores at another, and in the reference.
"""
from __future__ import annotations

import os
import re
import shutil
import threading
from typing import Any, Callable, Mapping

import msgpack
import numpy as np
import torch

_STEP_RE = re.compile(r"step_(\d+)$")
_ENTRY_RE = re.compile(r"(\.tmp_)?step_(\d+)$")


def tree_map(fn: Callable, tree: Any) -> Any:
    """``tree`` with ``fn`` applied to every leaf.  ``fn`` is called in
    flatten order (a dict's keys sorted); the result keeps the tree's
    types and each dict's own key order."""
    if isinstance(tree, Mapping):
        out = {k: tree_map(fn, tree[k]) for k in sorted(tree)}
        return {k: out[k] for k in tree}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v) for v in tree)
    if tree is None:
        return None
    return fn(tree)


def tree_leaves(tree: Any) -> list:
    """The leaves of ``tree`` in flatten order."""
    leaves = []
    tree_map(leaves.append, tree)
    return leaves


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save(ckpt_dir: str, step: int, state: Any, *, keep_last: int = 3,
         layout=None):
    """Synchronous checkpoint write (atomic); with ``layout`` every rank
    calls it and one writes."""
    if layout is not None:
        leaves = layout.whole(tree_leaves(state))
        final = None
        if leaves is not None:
            final = _write(ckpt_dir, step, leaves, _treedef(state),
                           keep_last)
        layout.barrier()
        return final
    return _write(ckpt_dir, step, tree_leaves(state), _treedef(state),
                  keep_last)


def _treedef(state: Any) -> str:
    return repr(tree_map(lambda _: "*", state))


def _write(ckpt_dir: str, step: int, leaves: list, treedef: str,
           keep_last: int):
    tmp = os.path.join(ckpt_dir, f".tmp_step_{step}")
    final = os.path.join(ckpt_dir, f"step_{step}")
    os.makedirs(tmp, exist_ok=True)
    arrays = {f"a{i}": _to_numpy(l) for i, l in enumerate(leaves)}
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    meta = {
        "step": step,
        "treedef": treedef,
        "n_leaves": len(leaves),
        "dtypes": [str(a.dtype) for a in arrays.values()],
        "shapes": [list(a.shape) for a in arrays.values()],
    }
    with open(os.path.join(tmp, "meta.msgpack"), "wb") as f:
        f.write(msgpack.packb(meta))
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _gc(ckpt_dir, keep_last)
    return final


def _gc(ckpt_dir: str, keep_last: int):
    steps = all_steps(ckpt_dir)
    for s in steps[:-keep_last] if keep_last else []:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s}"),
                      ignore_errors=True)


def all_steps(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        m = _STEP_RE.match(name)
        if m and os.path.exists(os.path.join(ckpt_dir, name,
                                             "meta.msgpack")):
            out.append(int(m.group(1)))
    return sorted(out)


def clear(ckpt_dir: str) -> None:
    """Remove the store's entries from ``ckpt_dir`` (``step_<N>`` and
    ``.tmp_step_<N>``, for a fresh run); everything else there stays."""
    if not os.path.isdir(ckpt_dir):
        return
    for name in os.listdir(ckpt_dir):
        path = os.path.join(ckpt_dir, name)
        if _ENTRY_RE.match(name) and os.path.isdir(path):
            shutil.rmtree(path)


def latest_step(ckpt_dir: str):
    steps = all_steps(ckpt_dir)
    return steps[-1] if steps else None


def restore(ckpt_dir: str, template: Any, step: int | None = None, *,
            layout=None):
    """Restore into the template's tree, each array on its template
    leaf's device and dtype (a numpy leaf gives a numpy array); with
    ``layout`` each leaf is this rank's slice of the whole array.
    Returns (step, state)."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step}")
    with np.load(os.path.join(path, "arrays.npz")) as data:
        n = len(tree_leaves(template))
        if n != len(data.files):
            raise ValueError(f"leaf count mismatch: {n} vs "
                             f"{len(data.files)}")
        index = iter(range(n))

        def load(tpl):
            i = next(index)
            arr = data[f"a{i}"]
            if layout is not None:
                arr = np.array(layout.local(arr, i))    # contiguous
            if isinstance(tpl, torch.Tensor):
                return torch.from_numpy(arr).to(device=tpl.device,
                                                dtype=tpl.dtype)
            return arr.astype(np.asarray(tpl).dtype)

        return step, tree_map(load, template)


def _host_copy(leaf) -> np.ndarray:
    """A copy on the host that no later update of ``leaf`` reaches
    (``.cpu()`` of a CPU tensor is the tensor itself)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.array(leaf)


class AsyncCheckpointer:
    """Checkpointing off the training thread.

    ``save`` copies the state to the host synchronously (cheap beside a
    train step); serialisation and IO run on a worker thread; ``wait()``
    joins it and raises what the write raised.  With ``layout`` every
    rank calls both: ``save`` gathers the whole leaves to the writing
    rank, whose thread alone writes, and ``wait`` ends at a barrier, so
    no rank passes a checkpoint still being written."""

    def __init__(self, ckpt_dir: str, keep_last: int = 3, layout=None):
        self.ckpt_dir = ckpt_dir
        self.keep_last = keep_last
        self.layout = layout
        self._thread: threading.Thread | None = None
        self._error: Exception | None = None
        self.last_saved: int | None = None

    def save(self, step: int, state: Any):
        if self.layout is None:
            leaves = [_host_copy(x) for x in tree_leaves(state)]
        else:
            leaves = self.layout.whole(tree_leaves(state))
        self.wait()
        if leaves is None:             # another rank writes
            return
        treedef = _treedef(state)

        def work():
            try:
                _write(self.ckpt_dir, step, leaves, treedef, self.keep_last)
                self.last_saved = step
            except Exception as e:      # raised again by wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.layout is not None:
            self.layout.barrier()
        if self._error is not None:
            err, self._error = self._error, None
            raise err
