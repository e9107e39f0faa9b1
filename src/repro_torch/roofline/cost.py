"""Per-op cost of one eager step (the counterpart of the JAX package's
``roofline/hlo_cost.py``) and the kernels' bound.

There is no HLO in the port: :class:`CostCounter` counts the step that
actually runs, op by op, as a ``TorchDispatchMode`` (on ``meta`` tensors
in the dry-run, so nothing is computed or allocated).  Accounting
conventions (the reference's, at op granularity):

* FLOPs: ``torch.utils.flop_counter``'s registry, so a matmul is
  ``2·M·N·K`` (convolutions and attention ops as it counts them); other
  ops count none;
* bytes: each op's tensor inputs plus its outputs; views, empty
  factories and scalar reads are free; slicing and gather ops
  (``_SLICING``) are billed at their output window (read + write), and
  in-place window updates (``_UPDATING``) at their update (read + write);
  ``copy_`` reads its source and writes its destination;
* collectives: what ``core/context.py`` tells its observers: the result
  bytes on this rank, times the ring factor of the group's size
  (``collectives._ring_factor``), kept apart where the group spans
  several nodes (``analysis.NODE_GPUS`` ranks each, row-major);
* a hand-written kernel's call on ``meta`` tensors
  (``kernels/build.on_meta``: ``flash_attention``, ``mamba_scan``,
  ``hash_partition``) at the work :func:`kernel_work` counts for it (what
  its bound counts), not at its plain version's op trace: the plain
  flash attention at a 32 k prefill would bill an S x S score tensor the
  kernel never writes.  Flash attention's products count as FLOPs; the
  other kernels' operations (float32 updates and exponentials, key
  compares) are not tensor-core FLOPs, and count as the seconds their
  own rates give them (``kernel_op_s``);
* a loop of identical iterations on ``meta`` tensors may run one of
  them for all through :meth:`CostCounter.repeated` (the hook
  ``kernels/build.meta_loops``), whose ops, forward and backward, count
  once for every iteration (the reference multiplies a ``while`` body by
  its trip count): the training scan's middle chunks.
"""
from __future__ import annotations

from collections import defaultdict

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from ..core import context
from ..kernels import build
from .analysis import EXP_PER_S, F32_FLOPS, HBM_BW, NODE_GPUS, PEAK_FLOPS
from .collectives import CollectiveStats, _ring_factor

aten = torch.ops.aten

# ops that move no bytes of their own
_FREE = {aten.empty, aten.empty_like, aten.empty_strided, aten.new_empty,
         aten.new_empty_strided, aten._local_scalar_dense, aten.lift_fresh,
         aten.sym_size, aten.sym_stride, aten.sym_numel,
         aten.sym_storage_offset, aten.is_same_size}
# ops that touch only their output-sized window of an operand
_SLICING = {aten.index_select, aten.gather, aten.index, aten.embedding}
# in-place window updates: (op, the index of the update argument)
_UPDATING = {aten.index_put_: 2, aten.index_copy_: 3, aten.scatter_: 3,
             aten.scatter_add_: 3, aten.index_add_: 3}


def _nbytes(t) -> int:
    return t.numel() * t.element_size() \
        if isinstance(t, torch.Tensor) else 0


def _work(name: str, args) -> tuple[float, float, float]:
    """(bytes moved, operations, the operations' seconds) of one call of
    a hand-written kernel on ``args``, the arguments its wrapper takes:
    each input read once, each output written once; the key compares and
    value updates at the float32 rate (the products of flash attention at
    the bf16 tensor-core rate), counted for this call's data."""
    if name == "radix_sort" and len(args) == 5:
        _, words, _, bits, _ = args
        n = words.numel()
        # words and perm in, both out in the new order (the cases keep the
        # words), and the pass's (2^bits,) histogram out; the per-block
        # histograms are the kernels' scratch, not the function's
        nbytes = 16 * n + 4 * (1 << bits)
        ops = n
    elif name == "radix_sort":
        words, _, bits, _ = args
        n = words.numel()
        # words in; ranks and the pass's (2^bits,) histogram out
        nbytes = 4 * n + 4 * n + 4 * (1 << bits)
        ops = n
    elif name == "hash_groupby":
        kb, occ, vals = args
        B, K, C = kb.shape
        V = vals.shape[1]
        # the occupancy and the keys and values of the occupied slots in
        # (an empty slot's results do not depend on its keys or values),
        # every slot's results out; each occupied slot is compared with
        # the occupied slots of its bucket
        filled = (occ > 0).sum(1).double()
        nbytes = 4 * (B * C + int(filled.sum()) * (K + V)) \
            + 4 * B * C * (2 + 3 * V)
        pairs = int((filled ** 2).sum())
        ops = pairs * (K + 2 + 3 * V)
    elif name == "flash_attention":
        # q, k, v in and the output out, once each (bf16); 4 D operations
        # (the two products) for each live (query, key) pair: query i
        # sees min(Skv, i + Skv - Sq + 1) keys, Skv - Sq + i + 1 here
        q, k, v, causal = args
        B, Hq, Sq, D = q.shape
        Skv = k.shape[2]
        nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())
        live = Sq * (Skv - Sq + 1) + Sq * (Sq - 1) // 2 if causal \
            else Sq * Skv
        ops = 4 * D * B * Hq * live
        return nbytes, ops, ops / PEAK_FLOPS
    elif name == "mamba_scan":
        # x and y once each, delta, A, B, C and D read once, hT written
        # once when asked; B S E N exponentials at the special-function
        # rate and 5 float32 operations each (the decay, the two products
        # of the update, the product with C and its sum)
        x, delta, A, Bm, Cm, D, with_state = args
        Bsz, S, E = x.shape
        N = A.shape[1]
        nbytes = 2 * x.numel() * x.element_size() + 4 * (
            delta.numel() + A.numel() + Bm.numel() + Cm.numel() + D.numel()
            + (Bsz * E * N if with_state else 0))
        cells = Bsz * S * E * N
        ops = 5 * cells
        return nbytes, ops, max(cells / EXP_PER_S, ops / F32_FLOPS)
    elif name == "hash_partition":
        pid, P = args
        n = pid.numel()
        nbytes, ops = 4 * n + 4 * P + 4 * n, n
    elif name == "fused_bucketing":
        bits, valid, P = args
        n, K = valid.numel(), len(bits)
        nbytes = 4 * K * n + n + 4 * n + 4 * (P + 1) + 4 * n
        ops = 12 * K * n
    elif name == "hash_semi":
        pb, po, bb, bo = args
        B, K, Lc = pb.shape
        # both occupancy slabs and the key planes of the occupied slots in,
        # one member flag per probe slot out; each occupied slot's key
        # compared once (a hash table meets about one key a probe)
        occupied = int((po > 0).sum()) + int((bo > 0).sum())
        nbytes = 4 * (po.numel() + bo.numel() + B * Lc + K * occupied)
        ops = K * occupied
    else:
        pb, po, bb, bo = args
        B, K, Lc = pb.shape
        C = bb.shape[2]
        nbytes = 4 * (pb.numel() + po.numel() + bb.numel() + bo.numel()
                      + B * Lc + B * Lc * C)
        ops = B * Lc * C * K
    return nbytes, ops, ops / F32_FLOPS


def kernel_work(name: str, args) -> tuple[float, float, float, str]:
    """(bytes moved, operations, least seconds, what bounds it) of one
    call of a hand-written kernel on ``args`` (:func:`_work`): the larger
    of its bytes at the memory rate and its operations at theirs."""
    nbytes, ops, t_ops = _work(name, args)
    t_bytes = nbytes / HBM_BW
    return (nbytes, ops, t_bytes, "bytes") if t_bytes >= t_ops \
        else (nbytes, ops, t_ops, "operations")


def bound(name: str, args) -> tuple[float, str]:
    """(least milliseconds, what bounds it) of one kernel call
    (:func:`kernel_work`)."""
    _, _, seconds, by = kernel_work(name, args)
    return seconds * 1e3, by


class _Mark(torch.autograd.Function):
    """Identity on a repeated region's tensors whose backward sets the
    counter's multiplier: after the region (``shared`` None) its backward
    runs before the region's nodes and pushes it; before the region it
    runs after them, pops it and bills the sums of the gradients of the
    inputs every iteration reads (``shared``: a flag for each)."""

    @staticmethod
    def forward(ctx, counter, k, shared, *xs):
        ctx.counter, ctx.k, ctx.shared = counter, k, shared
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        if ctx.shared is None:
            ctx.counter.push(ctx.k)
        else:
            ctx.counter.pop()
            for g, shared in zip(gs, ctx.shared):
                if shared and g is not None:    # k - 1 additions
                    ctx.counter.bill(ctx.k - 1, 3 * _nbytes(g))
        return (None, None, None) + gs


class CostCounter(TorchDispatchMode):
    """Counts the FLOPs, bytes, collectives and kernel calls of the code
    run inside it (see the module's conventions).  ``flops``, ``bytes``,
    ``flops_f32`` (the FLOPs of ops with a float32 operand), ``kernels``
    (name -> calls, bytes, ops), ``kernel_op_s`` (the seconds of the
    operations of the kernels other than flash attention),
    :meth:`collective_stats` and ``ndr_link_bytes`` (the link bytes of
    groups across nodes)."""

    def __init__(self):
        super().__init__()
        self.flops = self.flops_f32 = self.bytes = 0
        self.kernel_op_s = 0.0
        self.ops = 0
        self.counts: dict = defaultdict(int)
        self.result_bytes: dict = defaultdict(float)
        self.link_bytes: dict = defaultdict(float)
        self.ndr_link_bytes = 0.0
        self.kernels: dict = {}
        self._spans: dict = {}
        self._scales = [1]

    def push(self, k: int) -> None:
        """Count what follows ``k`` times more (:meth:`repeated`)."""
        self._scales.append(self._scales[-1] * k)

    def pop(self) -> None:
        self._scales.pop()

    def bill(self, ops: int, nbytes: int) -> None:
        """``ops`` ops of ``nbytes`` each, as they ran (no FLOPs)."""
        self.ops += self._scales[-1] * ops
        self.bytes += self._scales[-1] * ops * nbytes

    def repeated(self, n: int, fn, *args, carry: tuple = ()):
        """``fn(*args)`` as the first of ``n`` identical iterations of a
        loop, run once: its ops count ``n`` times, and so do those of its
        backward, with the ``n - 1`` additions that sum the gradient of
        each input every iteration reads (all but the indices ``carry``,
        which one iteration hands the next).  For ``meta`` tensors (every
        iteration's ops are the same, and no value is computed); the
        caller takes the outputs' shapes for the other iterations'."""
        idx = [i for i, a in enumerate(args)
               if isinstance(a, torch.Tensor) and a.requires_grad]
        grads = torch.is_grad_enabled() and idx
        if grads:
            marked = _Mark.apply(self, n, [i not in carry for i in idx],
                                 *(args[i] for i in idx))
            args = list(args)
            for i, a in zip(idx, marked):
                args[i] = a
        self.push(n)
        try:
            out = fn(*args)
        finally:
            self.pop()
        if not grads:
            return out
        outs = out if isinstance(out, tuple) else (out,)
        marked = iter(_Mark.apply(self, n, None, *(
            o for o in outs
            if isinstance(o, torch.Tensor) and o.requires_grad)))
        outs = tuple(next(marked) if isinstance(o, torch.Tensor)
                     and o.requires_grad else o for o in outs)
        return outs if isinstance(out, tuple) else outs[0]

    # ------------------------------------------------------------ hooks
    def __enter__(self):
        context.observers.append(self._collective)
        build.meta_observers.append(self._kernel)
        build.meta_loops.append(self.repeated)
        try:
            return super().__enter__()
        except BaseException:
            self._unhook()
            raise

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._unhook()

    def _unhook(self):
        if self._collective in context.observers:
            context.observers.remove(self._collective)
        if self._kernel in build.meta_observers:
            build.meta_observers.remove(self._kernel)
        if self.repeated in build.meta_loops:
            build.meta_loops.remove(self.repeated)

    def _across_nodes(self, group) -> bool:
        key = id(group)
        if key not in self._spans:
            ranks = dist.get_process_group_ranks(group) \
                if group is not None else range(dist.get_world_size())
            self._spans[key] = len({r // NODE_GPUS
                                    for r in ranks}) > 1
        return self._spans[key]

    def _collective(self, op: str, nbytes: int, group) -> None:
        g, k = dist.get_world_size(group), self._scales[-1]
        nbytes *= k
        link = nbytes * _ring_factor(op, g)
        self.counts[op] += k
        self.result_bytes[op] += nbytes
        self.link_bytes[op] += link
        if link and self._across_nodes(group):
            self.ndr_link_bytes += link

    def _kernel(self, name: str, args) -> None:
        nbytes, ops, ops_s = _work(name, args)
        n = self._scales[-1]
        nbytes, ops = n * nbytes, n * ops
        k = self.kernels.setdefault(name, {"calls": 0, "bytes": 0,
                                           "ops": 0})
        k["calls"] += n
        k["bytes"] += nbytes
        k["ops"] += ops
        self.bytes += nbytes
        if name == "flash_attention":
            self.flops += ops
        else:
            self.kernel_op_s += n * ops_s

    def collective_stats(self) -> CollectiveStats:
        return CollectiveStats(dict(self.counts), dict(self.result_bytes),
                               dict(self.link_bytes))

    # ------------------------------------------------------------- ops
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self._tally(func, args, kwargs, out)
        return out

    def _tally(self, func, args, kwargs, out) -> None:
        packet = func._overloadpacket
        if func.namespace != "aten" or func.is_view or packet in _FREE:
            return
        k = self._scales[-1]
        self.ops += k
        ins = [t for t in tree_flatten((args, kwargs))[0]
               if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_flatten(out)[0]
                if isinstance(t, torch.Tensor)]
        count = flop_registry.get(packet)
        if count is not None:
            flops = k * count(*args, **kwargs, out_val=out)
            self.flops += flops
            if any(t.dtype == torch.float32 for t in ins):
                self.flops_f32 += flops
        if packet in _SLICING:
            nbytes = 2 * sum(_nbytes(t) for t in outs)
        elif packet in _UPDATING:
            i = _UPDATING[packet]
            upd = args[i] if len(args) > i else None
            nbytes = 2 * (_nbytes(upd) if isinstance(upd, torch.Tensor)
                          else sum(_nbytes(t) for t in outs))
        elif packet is aten.copy_:
            nbytes = 2 * _nbytes(args[1])
        else:
            nbytes = sum(_nbytes(t) for t in ins) \
                + sum(_nbytes(t) for t in outs)
        self.bytes += k * nbytes
