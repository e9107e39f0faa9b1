"""Bucketed hash semi-join (membership) plan (``hash_semi``).

:func:`hash_semi_plan` is what ``isin`` / ``semi_mask`` / ``intersect`` /
``difference`` run under ``impl="hash"``: it buckets both sides by the
key hash with the shared ``kernels.bucketing`` slabs (build side = the
right table's key set, probe side = the left rows), runs the bucketed
membership probe and returns one boolean per original left row —
membership without a join: no match ranks, no pair space, no sort.

The probe replaces the TPU kernel ``bucket_member_buckets`` of
``src/repro/kernels/hash_semi/kernel.py``.  The CUDA kernel
(``csrc/hash_semi.cu``) enters each bucket's distinct occupied build keys
into an open-addressing hash table (in shared memory, or, for a slab too
wide for that, built once per bucket into a workspace this wrapper
allocates) and looks each occupied probe slot up in it on its own
thread, 4 slots a thread in 16-byte loads and stores; it writes one
int32 per probe slot.  The function must read both occupancy slabs and
the occupied slots' keys and write the flags: the bytes bound it.

Static-shape contract: a bucket holds at most ``bucket_capacity`` build
rows and ``probe_capacity`` probe rows; overflowing rows are dropped and
counted (``build_dropped`` / ``probe_dropped``).  A probe-dropped left
row's membership is unknown: it reports ``member=False`` /
``probed=False`` and is counted, never guessed.
"""
import ctypes
import functools
from typing import NamedTuple

import torch

from ...core.kernel_backend import table_kernel_impl
from .. import build
from ..bucketing import group_to_slabs
from ..hash_join import default_hash_join_sizes
from .ref import bucket_member_ref

REPLACES = "src/repro/kernels/hash_semi/kernel.py:49"
SOURCE = "src/repro_torch/kernels/csrc/hash_semi.cu"

# kernel launches in this process; chip_smoke.py resets and reads it
launches = 0

# build slab = the right key set, probe slab = the left rows: the sizing
# problem is the hash join's, so its heuristics are shared
default_hash_semi_sizes = default_hash_join_sizes


@functools.cache
def _entry():
    """(library, ``hash_semi_workspace_bytes``, ``hash_semi_member``) with
    argument types set."""
    lib = build.library("hash_semi")
    size = lib.hash_semi_workspace_bytes
    size.argtypes = [ctypes.c_int] * 2
    size.restype = ctypes.c_longlong
    fn = lib.hash_semi_member
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p] * 3
    fn.restype = ctypes.c_int
    return lib, size, fn


def _bucket_member_cuda(pbits, pocc, bbits, bocc):
    global launches
    for name, t in (("pbits", pbits), ("pocc", pocc), ("bbits", bbits),
                    ("bocc", bocc)):
        build.check_input(name, t)
    B, K, Lc = pbits.shape
    C = bbits.shape[2]
    if pocc.shape != (B, Lc) or bbits.shape != (B, K, C) \
            or bocc.shape != (B, C):
        raise ValueError("inconsistent probe/build slab shapes: "
                         f"{tuple(pbits.shape)} {tuple(pocc.shape)} "
                         f"{tuple(bbits.shape)} {tuple(bocc.shape)}")
    dev = pbits.device
    if B == 0 or Lc == 0 or C == 0:      # no build slot: nothing is a member
        return torch.zeros((B, Lc), dtype=torch.int32, device=dev)
    if K == 0:
        raise ValueError("the membership kernel needs at least one key "
                         "plane")
    lib, size, fn = _entry()
    # the kernel writes every slot; the tables of a slab too wide for
    # shared memory go to a workspace in device memory
    member = torch.empty((B, Lc), dtype=torch.int32, device=dev)
    nbytes = size(B, C)
    workspace = torch.empty(nbytes // 8, dtype=torch.int64, device=dev) \
        if nbytes else None
    status = fn(pbits.data_ptr(), pocc.data_ptr(), bbits.data_ptr(),
                bocc.data_ptr(), B, K, Lc, C,
                workspace.data_ptr() if nbytes else None, member.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, status, "hash_semi")
    launches += 1
    return member


def bucket_member(pbits, pocc, bbits, bocc):
    """member (B, Lc) int32 — see ``ref.py``.  The CUDA kernel runs for
    CUDA tensors, the plain version for CPU tensors."""
    if table_kernel_impl(pbits.device) == "ref":
        return bucket_member_ref(pbits, pocc, bbits, bocc)
    return _bucket_member_cuda(pbits, pocc, bbits, bocc)


class HashSemiPlan(NamedTuple):
    """Membership results mapped back to original left-row ids."""

    member: torch.Tensor         # (Lcap,) bool: key present in build side
    probed: torch.Tensor         # (Lcap,) bool: left row made it into a slab
    build_dropped: torch.Tensor  # () int32 right rows lost to slab overflow
    probe_dropped: torch.Tensor  # () int32 left rows lost to slab overflow


def hash_semi_plan(left_bits: tuple, left_valid: torch.Tensor,
                   right_bits: tuple, right_valid: torch.Tensor, *,
                   num_buckets: int, bucket_capacity: int,
                   probe_capacity: int,
                   left_bid: torch.Tensor | None = None,
                   right_bid: torch.Tensor | None = None) -> HashSemiPlan:
    """Bucketed build (right key set) + membership probe (left) over
    parallel key bit-planes.  ``left_bid`` / ``right_bid`` carry
    precomputed bucket ids (the sizing pass's hash, via ``BucketPlan``)
    so the plan does not re-hash."""
    B, C, Lc = num_buckets, bucket_capacity, probe_capacity
    lbits, rbits = tuple(left_bits), tuple(right_bits)
    lcap = left_valid.shape[0]

    bslab, bocc, _, _, build_dropped = group_to_slabs(
        rbits, right_valid, B, C, bid=right_bid)
    pslab, pocc, prow, _, probe_dropped = group_to_slabs(
        lbits, left_valid, B, Lc, bid=left_bid)
    num_keys = len(lbits)
    pb = pslab.reshape(num_keys, B, Lc).transpose(0, 1).contiguous()
    bb = bslab.reshape(num_keys, B, C).transpose(0, 1).contiguous()
    member_g = bucket_member(pb, pocc.reshape(B, Lc), bb,
                             bocc.reshape(B, C))

    # member + probed back to original left-row order in ONE stacked
    # scatter (trash slot lcap for empty slots)
    idx = torch.where(pocc > 0, prow.to(torch.int64), lcap)
    packed = (torch.zeros((2, lcap + 1), dtype=torch.int32,
                          device=left_valid.device)
              .index_copy_(1, idx, torch.stack(
                  [(member_g.reshape(-1) > 0).to(torch.int32),
                   (pocc > 0).to(torch.int32)]))
              [:, :lcap])
    return HashSemiPlan(member=packed[0] > 0, probed=packed[1] > 0,
                        build_dropped=build_dropped,
                        probe_dropped=probe_dropped)
