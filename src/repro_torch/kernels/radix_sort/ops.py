"""Multi-pass LSD radix rank/permutation engine (``radix_sort``).

Port of ``repro/kernels/radix_sort/ops.py``: a stable rank of every row
under multi-key lexicographic order, computed as a chain of counting-sort
digit passes, with no sort call anywhere.

Key columns become int32 *sort words* whose unsigned order is the
ascending order of a stable sort (:func:`sortable_word`): int32 gets the
sign-bit bias; float32 has ``-0.0``, ``+0.0`` and the subnormals equal
(as the reference compares them) and every NaN equal and greatest.  Each
word takes ``ceil(32 / radix_bits)`` stable passes, least significant
digit first, then a 1-bit validity pass moves padding rows to the end.

The digit pass replaces the TPU kernel ``digit_histogram_ranks_tiles`` of
``src/repro/kernels/radix_sort/kernel.py``.  The CUDA kernel
(``csrc/radix_sort.cu``) extracts each row's digit as it loads the word
and ranks it with warp matching (``csrc/tile_rank.cuh``) into per-tile
histograms and within-tile ranks; the cross-tile offsets come from
``hash_partition.ops.add_tile_offsets``.  It is bound by memory: 4 B read
and 4 B written per row, plus ``4 * 2**radix_bits`` B of histogram per
tile.  The kernel runs for every pass on a CUDA tensor with at least one
row, however short (the last tile is masked inside the kernel).

Public ops:

* :func:`radix_permutation` — the stable gather index (``out[i] =
  rows[perm[i]]``);
* :func:`radix_rank` — its inverse (each row's output position);
* :func:`stable_partition_perm` — one 1-bit pass, equal to
  ``argsort(~keep, stable=True)``: the compaction of ``compact()``;
* :func:`grouped_ranks` — (hist, stable within-partition ranks) for any
  partition count: past ``bucketing.MAX_RADIX_BUCKETS``.
"""
import ctypes

import torch

from ...core.kernel_backend import table_kernel_impl
from ...core.table import flush_subnormals
from .. import autotune, build
from ..hash_partition.ops import add_tile_offsets
from .ref import digit_histogram_ranks_ref, extract_digits

REPLACES = "src/repro/kernels/radix_sort/kernel.py:46"
SOURCE = "src/repro_torch/kernels/csrc/radix_sort.cu"

# kernel launches in this process; chip_smoke.py resets and reads it
launches = 0

_I32 = torch.int32
_SIGN = -2 ** 31


def sortable_word(col: torch.Tensor) -> torch.Tensor:
    """Key column -> int32 word whose *unsigned* order is the stable sort
    order: ``-0.0``, ``+0.0`` and the subnormals equal, every NaN equal
    and greatest."""
    if col.dtype.is_floating_point:
        f = flush_subnormals(col.to(torch.float32))
        f = torch.where(torch.isnan(f), torch.full_like(f, float("nan")), f)
        bits = f.view(_I32)
        # sign-magnitude -> biased two's complement: negative floats flip
        # every bit, the others only the sign bit
        return torch.where(bits < 0, ~bits, bits ^ _SIGN)
    return col.to(_I32) ^ _SIGN


def _digit_pass_cuda(words: torch.Tensor, shift: int, radix_bits: int,
                     tile: int, digits: torch.Tensor | None):
    global launches
    build.check_input("words", words)
    n, D = words.shape[0], 1 << radix_bits
    if n == 0:
        return (torch.zeros(D, dtype=_I32, device=words.device),
                torch.zeros(0, dtype=_I32, device=words.device))
    lib = build.library("radix_sort")
    hist_t = torch.empty((-(-n // tile), D), dtype=_I32, device=words.device)
    rank_t = torch.empty(n, dtype=_I32, device=words.device)
    fn = lib.radix_sort_digit_tiles
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    status = fn(words.data_ptr(), n, shift, radix_bits, tile,
                hist_t.data_ptr(), rank_t.data_ptr(),
                torch.cuda.current_stream(words.device).cuda_stream)
    build.check(lib, status, "radix_sort")
    launches += 1
    if digits is None:
        digits = extract_digits(words, shift, radix_bits)
    return add_tile_offsets(hist_t, rank_t, digits, D, tile)


def digit_histogram_ranks(words: torch.Tensor, shift: int, radix_bits: int,
                          tile: int, digits: torch.Tensor | None = None):
    """(hist (2**radix_bits,), stable within-digit ranks (n,)) of one pass.
    The CUDA kernel runs for a CUDA tensor (``tile`` rows per block), the
    plain version for a CPU tensor.  ``digits``, when the caller already
    has them, spares the cross-tile offsets a second extraction."""
    if table_kernel_impl(words.device) == "ref":
        return digit_histogram_ranks_ref(words, shift, radix_bits)
    return _digit_pass_cuda(words, shift, radix_bits, tile, digits)


def _scatter_pass(perm: torch.Tensor, words: torch.Tensor, shift: int,
                  radix_bits: int, tile: int) -> torch.Tensor:
    """One stable counting-sort pass: ``words`` are the sort words in the
    current order (gathered through ``perm``); returns the refined perm.
    ``dest`` is a permutation, so the scatter has no collisions."""
    d = extract_digits(words, shift, radix_bits)
    hist, ranks = digit_histogram_ranks(words, shift, radix_bits, tile, d)
    offsets = torch.cumsum(hist, 0, dtype=_I32) - hist
    dest = (offsets[d.to(torch.int64)] + ranks).to(torch.int64)
    return torch.empty_like(perm).index_copy_(0, dest, perm)


def _iota(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=_I32, device=device)


def _radix_permutation(cols: tuple, invalid: torch.Tensor, *,
                       radix_bits: int, tile: int) -> torch.Tensor:
    n = invalid.shape[0]
    perm = _iota(n, invalid.device)
    for col in reversed(cols):                 # least-significant key first
        w = sortable_word(col)
        for shift in range(0, 32, radix_bits):
            perm = _scatter_pass(perm, w[perm], shift, radix_bits, tile)
    # most significant: validity (padding rows move to the end, stably)
    flag = invalid[perm].to(_I32)
    return _scatter_pass(perm, flag, 0, 1, tile)


def _params(t: torch.Tensor, radix_bits, tile):
    return autotune.radix_params(table_kernel_impl(t.device), t.shape[0],
                                 radix_bits, tile)


def radix_permutation(cols: tuple, invalid: torch.Tensor, *,
                      radix_bits: int | None = None,
                      tile: int | None = None) -> torch.Tensor:
    """Stable gather index sorting by ``cols`` lexicographically
    ascending, rows with ``invalid`` set last: the permutation of a stable
    sort over ``(invalid, *cols)``.  ``radix_bits``/``tile`` default to
    the autotuner's choice (``REPRO_RADIX_BITS``/``REPRO_TILE``)."""
    radix_bits, tile = _params(invalid, radix_bits, tile)
    return _radix_permutation(tuple(cols), invalid, radix_bits=radix_bits,
                              tile=tile)


def _inverse(perm: torch.Tensor) -> torch.Tensor:
    return torch.empty_like(perm).index_copy_(
        0, perm.to(torch.int64), _iota(perm.shape[0], perm.device))


def radix_rank(cols: tuple, invalid: torch.Tensor, *,
               radix_bits: int | None = None,
               tile: int | None = None) -> torch.Tensor:
    """Each row's stable output position under the same order (the
    inverse of :func:`radix_permutation`): valid rows with globally
    distinct keys get exactly their key-sorted slot in ``[0, n_valid)``."""
    return _inverse(radix_permutation(cols, invalid, radix_bits=radix_bits,
                                      tile=tile))


def stable_partition_perm(keep: torch.Tensor, *,
                          tile: int | None = None) -> torch.Tensor:
    """Gather index moving ``keep`` rows to the front, stably, in one
    1-bit pass: equal to ``argsort(~keep, stable=True)``."""
    _, tile = _params(keep, 1, tile)
    perm = _iota(keep.shape[0], keep.device)
    return _scatter_pass(perm, (~keep).to(_I32), 0, 1, tile)


def grouped_ranks(pid: torch.Tensor, num_partitions: int, *,
                  radix_bits: int | None = None, tile: int | None = None):
    """(hist (P,), stable within-partition ranks (n,)) for any ``P``, ids
    in ``[0, P)``: the global stable rank under ascending ``pid``
    (``ceil(log2 P / radix_bits)`` digit passes) minus the partition's
    exclusive offset — the semantics of
    ``hash_partition.radix_histogram_ranks`` with per-pass histograms of
    ``2**radix_bits`` instead of ``P``."""
    radix_bits, tile = _params(pid, radix_bits, tile)
    n = pid.shape[0]
    pid64 = pid.to(torch.int64)
    hist = torch.bincount(pid64, minlength=num_partitions).to(_I32)
    nbits = max(1, (num_partitions - 1).bit_length())
    perm = _iota(n, pid.device)
    for shift in range(0, nbits, radix_bits):
        perm = _scatter_pass(perm, pid[perm], shift, radix_bits, tile)
    offsets = torch.cumsum(hist, 0, dtype=_I32) - hist
    return hist, _inverse(perm) - offsets[pid64]
