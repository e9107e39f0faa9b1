"""Radix histogram + stable within-partition ranks (``hash_partition``).

Replaces the TPU kernel ``radix_histogram_ranks_tiles`` of
``src/repro/kernels/hash_partition/kernel.py``.  The CUDA kernel
(``csrc/hash_partition.cu``) ranks tiles of 1024 rows with warp matching
into per-tile histograms and within-tile ranks; the cross-tile exclusive
scan is composed here, as in the reference.  It is bound by memory: 8 B
per row (the id read, the rank written); its design reads each id once
and keeps the per-tile counts in shared memory.

``partition_plan`` is the op the table shuffle needs: a stable destination
slot per row plus the histogram.
"""
import ctypes

import torch

from ...core.kernel_backend import table_kernel_impl
from .. import build
from .ref import radix_histogram_ranks_ref

REPLACES = "src/repro/kernels/hash_partition/kernel.py:39"
SOURCE = "src/repro_torch/kernels/csrc/hash_partition.cu"

# kernel launches in this process; chip_smoke.py resets and reads it
launches = 0


def add_tile_offsets(hist_t: torch.Tensor, rank_t: torch.Tensor,
                     ids: torch.Tensor, num_partitions: int, tile: int):
    """Per-tile histograms ``(n_tiles, P)`` and within-tile ranks ``(n,)``
    -> (hist ``(P,)``, ranks ``(n,)``): a row's rank gains the counts of
    its id in earlier tiles.  Rows with an id outside ``[0, P)`` keep
    rank 0."""
    P = num_partitions
    # scan each partition's counts along the contiguous axis: (P, n_tiles)
    per_part = hist_t.t().contiguous()
    offsets = (torch.cumsum(per_part, 1, dtype=torch.int32)
               - per_part).view(-1)
    tile_of = torch.arange(ids.shape[0], device=ids.device) // tile
    inside = (ids >= 0) & (ids < P)
    part = ids.clamp(0, max(P - 1, 0)).to(torch.int64)
    off = offsets[part * hist_t.shape[0] + tile_of]
    ranks = rank_t + torch.where(inside, off, 0)
    return hist_t.sum(0, dtype=torch.int32), ranks


def _radix_histogram_ranks_cuda(pid: torch.Tensor, num_partitions: int):
    global launches
    build.check_input("pid", pid)
    n, P = pid.shape[0], num_partitions
    if n == 0:
        return (torch.zeros(P, dtype=torch.int32, device=pid.device),
                torch.zeros(0, dtype=torch.int32, device=pid.device))
    lib = build.library("hash_partition")
    tile = lib.hash_partition_tile_rows()
    hist_t = torch.empty((-(-n // tile), P), dtype=torch.int32,
                         device=pid.device)
    rank_t = torch.empty(n, dtype=torch.int32, device=pid.device)
    fn = lib.hash_partition_tiles
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    status = fn(pid.data_ptr(), n, P, hist_t.data_ptr(), rank_t.data_ptr(),
                torch.cuda.current_stream(pid.device).cuda_stream)
    build.check(lib, status, "hash_partition")
    launches += 1
    return add_tile_offsets(hist_t, rank_t, pid, P, tile)


def radix_histogram_ranks(pid: torch.Tensor, num_partitions: int):
    """hist (P,), ranks (n,) — stable within-partition ranks.  The CUDA
    kernel runs for a CUDA tensor, the plain version for a CPU tensor."""
    if table_kernel_impl(pid.device) == "ref":
        return radix_histogram_ranks_ref(pid, num_partitions)
    return _radix_histogram_ranks_cuda(pid, num_partitions)


def partition_plan(pid: torch.Tensor, num_partitions: int):
    """(hist, dest): ``dest[i] = exclusive_offset[pid[i]] + rank[i]``.

    Scattering row i to slot ``dest[i]`` groups rows by partition, stable
    within each partition."""
    hist, ranks = radix_histogram_ranks(pid, num_partitions)
    offsets = torch.cumsum(hist, 0, dtype=torch.int32) - hist
    return hist, offsets[pid.clamp(0, num_partitions - 1)] + ranks
