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
``src/repro/kernels/radix_sort/kernel.py``.  On a CUDA tensor a pass is
one call into ``csrc/radix_sort.cu``, which launches three kernels and
nothing else: an upsweep of per-block digit histograms and their
exclusive scan per digit (the counting pass of ``csrc/tile_scan.cuh``),
and a downsweep that ranks each tile's digits with warp ballots
(``csrc/tile_rank.cuh``) and scatters the words with ``perm`` through a
digit-ordered tile in shared memory.  Since the words move with
``perm``, a key column is gathered once (``w[perm]``), not before every
pass.  A pass is bound by memory: words and perm read and written, 16 B a
row, plus the histograms.  ``launches`` counts passes, one per call into
the library whatever number of kernels that call launches; a pass on zero
rows launches nothing.

Public ops:

* :func:`radix_permutation` — the stable gather index (``out[i] =
  rows[perm[i]]``);
* :func:`radix_rank` — its inverse (each row's output position);
* :func:`stable_partition_perm` — one 1-bit pass, equal to
  ``argsort(~keep, stable=True)``: the compaction of ``compact()``;
* :func:`grouped_ranks` — (hist, stable within-partition ranks) for any
  partition count: past ``bucketing.MAX_RADIX_BUCKETS``;
* :func:`scatter_pass` and :func:`digit_histogram_ranks` — one pass, as
  the scatter or as (hist, within-digit ranks).
"""
import ctypes
import functools

import torch

from ...core.kernel_backend import table_kernel_impl
from ...core.table import flush_subnormals
from .. import autotune, build
from .ref import digit_histogram_ranks_ref, scatter_pass_ref

REPLACES = "src/repro/kernels/radix_sort/kernel.py:46"
SOURCE = "src/repro_torch/kernels/csrc/radix_sort.cu"

# digit passes run on the card in this process (one per call into the
# library, whatever kernels it launches); chip_smoke.py resets and reads it
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


@functools.cache
def _entry():
    """(library, its ``radix_sort_blocks`` and ``radix_sort_pass`` with
    argument types set)."""
    lib = build.library("radix_sort")
    blocks, fn = lib.radix_sort_blocks, lib.radix_sort_pass
    blocks.argtypes = [ctypes.c_longlong] + [ctypes.c_int] * 3
    blocks.restype = ctypes.c_longlong
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int] \
        + [ctypes.c_void_p] * 6
    fn.restype = ctypes.c_int
    return lib, blocks, fn


def _check(words: torch.Tensor, perm: torch.Tensor | None) -> None:
    """Raise unless words (and perm) are contiguous int32 CUDA vectors of
    one length."""
    build.check_input("words", words)
    if words.dim() != 1:
        raise ValueError(f"words must be 1-D, got {tuple(words.shape)}")
    if perm is not None:
        build.check_input("perm", perm)
        if perm.shape != words.shape or perm.device != words.device:
            raise ValueError(f"perm {tuple(perm.shape)} on {perm.device} "
                             f"does not match words {tuple(words.shape)} "
                             f"on {words.device}")


def _pass_cuda(words: torch.Tensor, perm: torch.Tensor | None, shift: int,
               radix_bits: int, tile: int, *, perm_out=None, words_out=None,
               rank_out=None) -> torch.Tensor:
    """One pass of ``csrc/radix_sort.cu`` over ``words`` (checked, n > 0):
    the scatter into ``perm_out`` (and ``words_out``), or the ranks into
    ``rank_out``.  Returns the pass's digit histogram."""
    global launches
    n, dev = words.shape[0], words.device
    lib, blocks, fn = _entry()
    hist = torch.empty((blocks(n, tile, radix_bits, rank_out is None),
                        1 << radix_bits), dtype=_I32, device=dev)
    total = torch.empty(1 << radix_bits, dtype=_I32, device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    status = fn(words.data_ptr(), ptr(perm), n, shift, radix_bits, tile,
                hist.data_ptr(), total.data_ptr(), ptr(words_out),
                ptr(perm_out), ptr(rank_out),
                torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, status, "radix_sort")
    launches += 1
    return total


def digit_histogram_ranks(words: torch.Tensor, shift: int, radix_bits: int,
                          tile: int):
    """(hist (2**radix_bits,), stable within-digit ranks (n,)) of one pass.
    The CUDA kernels run for a CUDA tensor (``tile`` rows per ranked
    tile), the plain version for a CPU tensor."""
    if table_kernel_impl(words.device) == "ref":
        return digit_histogram_ranks_ref(words, shift, radix_bits)
    _check(words, None)
    if words.shape[0] == 0:
        return (torch.zeros(1 << radix_bits, dtype=_I32, device=words.device),
                torch.zeros(0, dtype=_I32, device=words.device))
    ranks = torch.empty_like(words)
    hist = _pass_cuda(words, None, shift, radix_bits, tile, rank_out=ranks)
    return hist, ranks


def scatter_pass(perm: torch.Tensor | None, words: torch.Tensor, shift: int,
                 radix_bits: int, tile: int, *, keep_words: bool = True):
    """One stable counting-sort pass: ``words`` are the sort words in the
    current order, ``perm`` the current gather index (None: the identity).
    Returns (the refined perm, the words in the new order, or None when
    ``keep_words`` is false and the caller needs no more passes on them)."""
    if table_kernel_impl(words.device) == "ref":
        perm_out, words_out = scatter_pass_ref(perm, words, shift,
                                               radix_bits)
        return perm_out, words_out if keep_words else None
    _check(words, perm)
    perm_out = torch.empty_like(words)
    words_out = torch.empty_like(words) if keep_words else None
    if words.shape[0]:
        _pass_cuda(words, perm, shift, radix_bits, tile, perm_out=perm_out,
                   words_out=words_out)
    return perm_out, words_out


def _iota(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=_I32, device=device)


def _radix_permutation(cols: tuple, invalid: torch.Tensor, *,
                       radix_bits: int, tile: int) -> torch.Tensor:
    perm = None
    for col in reversed(cols):                 # least-significant key first
        w = sortable_word(col)
        words = w if perm is None else w[perm]
        for shift in range(0, 32, radix_bits):
            perm, words = scatter_pass(perm, words, shift, radix_bits, tile,
                                       keep_words=shift + radix_bits < 32)
    # most significant: validity (padding rows move to the end, stably)
    flag = invalid if perm is None else invalid[perm]
    return scatter_pass(perm, flag.to(_I32), 0, 1, tile,
                        keep_words=False)[0]


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
    return scatter_pass(None, (~keep).to(_I32), 0, 1, tile,
                        keep_words=False)[0]


def grouped_ranks(pid: torch.Tensor, num_partitions: int, *,
                  radix_bits: int | None = None, tile: int | None = None):
    """(hist (P,), stable within-partition ranks (n,)) for any ``P``, ids
    in ``[0, P)``: the global stable rank under ascending ``pid``
    (``ceil(log2 P / radix_bits)`` digit passes) minus the partition's
    exclusive offset — the semantics of
    ``hash_partition.radix_histogram_ranks`` with per-pass histograms of
    ``2**radix_bits`` instead of ``P``."""
    radix_bits, tile = _params(pid, radix_bits, tile)
    nbits = max(1, (num_partitions - 1).bit_length())
    perm, words = None, pid
    for shift in range(0, nbits, radix_bits):
        perm, words = scatter_pass(perm, words, shift, radix_bits, tile)
    # the ids are now in ascending order: each partition's first place
    first = torch.searchsorted(words, torch.arange(
        num_partitions + 1, dtype=_I32, device=pid.device)).to(_I32)
    return first[1:] - first[:-1], \
        _inverse(perm) - first[:-1][pid.to(torch.int64)]
