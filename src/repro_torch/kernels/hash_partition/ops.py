"""Partition histogram + stable within-partition ranks (``hash_partition``).

Replaces the TPU kernel ``radix_histogram_ranks_tiles`` of
``src/repro/kernels/hash_partition/kernel.py``.  On a CUDA tensor a call
is one call into ``csrc/hash_partition.cu``, the counting pass of
``csrc/tile_scan.cuh``: per-block histograms, their exclusive scan per
partition (folded into the next kernel up to 8 partitions), and a
downsweep that ranks each tile of 2048 rows with warp matching and
writes every row's complete rank; two or three kernels and nothing
between them.  It is bound by memory: 8 B per row (the id read, the rank
written); the pass reads the ids twice and keeps the per-tile counts in
shared memory.  ``launches`` counts calls into the library, one per call
that has rows.

``partition_plan`` is the op the table shuffle needs: a stable destination
slot per row plus the histogram.
"""
import ctypes
import functools

import torch

from ...core.kernel_backend import table_kernel_impl
from .. import build
from .ref import radix_histogram_ranks_ref

REPLACES = "src/repro/kernels/hash_partition/kernel.py:39"
SOURCE = "src/repro_torch/kernels/csrc/hash_partition.cu"

# calls into the library in this process; chip_smoke.py resets and reads it
launches = 0


@functools.cache
def _entry():
    """(library, rows a tile of scratch covers, ``hash_partition_ranks``
    with argument types set)."""
    lib = build.library("hash_partition")
    fn = lib.hash_partition_ranks
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int] \
        + [ctypes.c_void_p] * 4
    fn.restype = ctypes.c_int
    return lib, lib.hash_partition_tile_rows(), fn


def _radix_histogram_ranks_cuda(pid: torch.Tensor, num_partitions: int):
    global launches
    build.check_input("pid", pid)
    n, P, dev = pid.shape[0], num_partitions, pid.device
    if n == 0:
        return (torch.zeros(P, dtype=torch.int32, device=dev),
                torch.empty(0, dtype=torch.int32, device=dev))
    lib, tile, fn = _entry()
    scratch = torch.empty(-(-n // tile) * P, dtype=torch.int32, device=dev)
    hist = torch.empty(P, dtype=torch.int32, device=dev)
    ranks = torch.empty(n, dtype=torch.int32, device=dev)
    status = fn(pid.data_ptr(), n, P, scratch.data_ptr(), hist.data_ptr(),
                ranks.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, status, "hash_partition")
    launches += 1
    return hist, ranks


def radix_histogram_ranks(pid: torch.Tensor, num_partitions: int):
    """hist (P,), ranks (n,) — stable within-partition ranks.  The CUDA
    kernels run for a CUDA tensor, the plain version for a CPU tensor; a
    meta tensor gets the outputs' shapes (``build.on_meta``)."""
    if pid.is_meta:
        return build.on_meta(
            "hash_partition", (pid, num_partitions),
            (torch.empty(num_partitions, dtype=torch.int32, device=pid.device),
             torch.empty(pid.shape, dtype=torch.int32, device=pid.device)))
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
