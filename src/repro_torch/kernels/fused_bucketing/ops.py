"""Fused hash + histogram + stable ranks (``fused_bucketing``).

Replaces the TPU kernel ``fused_bucket_ranks_tiles`` of
``src/repro/kernels/fused_bucketing/kernel.py``: the grouping pass behind
``bucketing.group_to_slabs``.  The CUDA kernel
(``csrc/fused_bucketing.cu``) hashes each row's key planes in registers
and ranks the bucket ids there, so the ids are written once and never read
back; the cross-tile scan is composed here, as in the reference.  It is
bound by memory: 4 B per key plane and 1 B of validity read, 8 B (bid and
rank) written per row.
"""
import ctypes

import torch

from ...core.kernel_backend import table_kernel_impl
from .. import build
from ..hash_partition.ops import add_tile_offsets
from .ref import fused_bucket_ranks_ref

REPLACES = "src/repro/kernels/fused_bucketing/kernel.py:52"
SOURCE = "src/repro_torch/kernels/csrc/fused_bucketing.cu"

# kernel launches in this process; chip_smoke.py resets and reads it
launches = 0


def _fused_bucket_ranks_cuda(bits: tuple, valid: torch.Tensor,
                             num_buckets: int):
    global launches
    planes = torch.stack(bits)
    build.check_input("bits", planes)
    if valid.device != planes.device or valid.dtype != torch.bool:
        raise ValueError("valid must be a bool tensor on the bits' device")
    valid = valid.contiguous()
    n, dev = valid.shape[0], valid.device
    if planes.shape[1] != n:
        raise ValueError(f"bits have {planes.shape[1]} rows, valid {n}")
    if n == 0:
        return (torch.zeros(0, dtype=torch.int32, device=dev),
                torch.zeros(num_buckets + 1, dtype=torch.int32, device=dev),
                torch.zeros(0, dtype=torch.int32, device=dev))
    lib = build.library("fused_bucketing")
    tile = lib.fused_bucketing_tile_rows()
    bid = torch.empty(n, dtype=torch.int32, device=dev)
    hist_t = torch.empty((-(-n // tile), num_buckets + 1), dtype=torch.int32,
                         device=dev)
    rank_t = torch.empty(n, dtype=torch.int32, device=dev)
    fn = lib.fused_bucketing_tiles
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    status = fn(planes.data_ptr(), valid.data_ptr(), n, planes.shape[0],
                num_buckets, bid.data_ptr(), hist_t.data_ptr(),
                rank_t.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, status, "fused_bucketing")
    launches += 1
    hist, ranks = add_tile_offsets(hist_t, rank_t, bid, num_buckets + 1, tile)
    return bid, hist, ranks


def fused_bucket_ranks(bits: tuple, valid: torch.Tensor, num_buckets: int):
    """(bid (n,), hist (P+1,), ranks (n,)) — see ``ref.py`` for the
    contract.  The CUDA kernel runs for CUDA tensors, the plain version for
    CPU tensors."""
    if table_kernel_impl(valid.device) == "ref":
        return fused_bucket_ranks_ref(tuple(bits), valid, num_buckets)
    return _fused_bucket_ranks_cuda(tuple(bits), valid, num_buckets)
