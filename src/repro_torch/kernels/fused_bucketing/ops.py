"""Fused hash + histogram + stable ranks (``fused_bucketing``).

Replaces the TPU kernel ``fused_bucket_ranks_tiles`` of
``src/repro/kernels/fused_bucketing/kernel.py``: the grouping pass behind
``bucketing.group_to_slabs``.  On CUDA tensors a call is one call into
``csrc/fused_bucketing.cu``, the counting pass of ``csrc/tile_scan.cuh``
(two or three kernels and nothing between them): an upsweep that hashes
each row's key planes in registers, writes its bucket id and counts it
per block, the per-bucket scan of those counts, and a downsweep that
reads the ids back and writes every row's complete rank.  The planes
are passed by address, not stacked (up to ``max_planes``).  It is bound by memory: 4 B
per key plane and 1 B of validity read, 8 B (bid and rank) written per
row.  ``launches`` counts calls into the library, one per call that has
rows.
"""
import ctypes
import functools

import torch

from ...core.kernel_backend import table_kernel_impl
from .. import build
from .ref import fused_bucket_ranks_ref

REPLACES = "src/repro/kernels/fused_bucketing/kernel.py:52"
SOURCE = "src/repro_torch/kernels/csrc/fused_bucketing.cu"

# calls into the library in this process; chip_smoke.py resets and reads it
launches = 0


@functools.cache
def _entry():
    """(library, the most planes passed by address, rows a tile of
    scratch covers, ``fused_bucketing_ranks`` with argument types set)."""
    lib = build.library("fused_bucketing")
    fn = lib.fused_bucketing_ranks
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int,
                                           ctypes.c_int] \
        + [ctypes.c_void_p] * 5
    fn.restype = ctypes.c_int
    return (lib, lib.fused_bucketing_max_planes(),
            lib.fused_bucketing_tile_rows(), fn)


def _fused_bucket_ranks_cuda(bits: tuple, valid: torch.Tensor,
                             num_buckets: int):
    global launches
    valid = valid.contiguous()
    build.check_input("valid", valid, torch.bool)
    n, dev, P = valid.shape[0], valid.device, num_buckets
    for b in bits:
        build.check_input("bits", b)
        if b.shape != valid.shape or b.device != dev:
            raise ValueError(f"a key plane of {tuple(b.shape)} on "
                             f"{b.device} does not match valid "
                             f"{tuple(valid.shape)} on {dev}")
    if n == 0:
        return (torch.empty(0, dtype=torch.int32, device=dev),
                torch.zeros(P + 1, dtype=torch.int32, device=dev),
                torch.empty(0, dtype=torch.int32, device=dev))
    lib, max_planes, tile, fn = _entry()
    K = len(bits)
    if K <= max_planes:
        planes, stacked = (ctypes.c_void_p * K)(
            *(b.data_ptr() for b in bits)), None
    else:
        planes, stacked = None, torch.stack(bits)
    scratch = torch.empty(-(-n // tile) * (P + 1), dtype=torch.int32,
                          device=dev)
    bid = torch.empty(n, dtype=torch.int32, device=dev)
    hist = torch.empty(P + 1, dtype=torch.int32, device=dev)
    ranks = torch.empty(n, dtype=torch.int32, device=dev)
    status = fn(planes, None if stacked is None else stacked.data_ptr(),
                valid.data_ptr(), n, K, P, scratch.data_ptr(),
                bid.data_ptr(), hist.data_ptr(), ranks.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, status, "fused_bucketing")
    launches += 1
    return bid, hist, ranks


def fused_bucket_ranks(bits: tuple, valid: torch.Tensor, num_buckets: int):
    """(bid (n,), hist (P+1,), ranks (n,)) — see ``ref.py`` for the
    contract.  The CUDA kernels run for CUDA tensors, the plain version for
    CPU tensors."""
    if table_kernel_impl(valid.device) == "ref":
        return fused_bucket_ranks_ref(tuple(bits), valid, num_buckets)
    return _fused_bucket_ranks_cuda(tuple(bits), valid, num_buckets)
