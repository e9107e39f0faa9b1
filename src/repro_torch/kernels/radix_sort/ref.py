"""Plain PyTorch version of one LSD radix digit pass.

For the ``radix_bits``-wide digit at bit offset ``shift`` of every int32
sort word (see ``ops.sortable_word``):

* ``hist``  — ``(2**radix_bits,)`` int32 row counts per digit value;
* ``ranks`` — ``(n,)`` int32 stable rank of each row *within* its digit
  (the i-th row carrying digit d gets rank i, in row order);
* :func:`scatter_pass_ref` — the stable counting-sort scatter those two
  give, of ``perm`` and of the words themselves.

``>>`` on int32 is an arithmetic shift, as in JAX; the mask discards the
sign-extension bits, so the digit is exact at every offset.  The one-hot
of the reference is built a few digit values at a time, so memory stays
bounded at any row count; the results are the reference's.
"""
import torch

# elements of one (digit values, rows) one-hot chunk
_CHUNK_ELEMS = 1 << 27


def extract_digits(words: torch.Tensor, shift: int,
                   radix_bits: int) -> torch.Tensor:
    """int32 sort words -> int32 digit in [0, 2**radix_bits)."""
    return (words >> shift) & ((1 << radix_bits) - 1)


def digit_histogram_ranks_ref(words: torch.Tensor, shift: int,
                              radix_bits: int):
    num_digits = 1 << radix_bits
    d = extract_digits(words, shift, radix_bits)
    n = d.shape[0]
    hist = torch.empty(num_digits, dtype=torch.int32, device=d.device)
    ranks = torch.zeros(n, dtype=torch.int32, device=d.device)
    step = max(1, _CHUNK_ELEMS // max(n, 1))
    for d0 in range(0, num_digits, step):
        cols = torch.arange(d0, min(d0 + step, num_digits), dtype=d.dtype,
                            device=d.device)
        # (digits, n): the running count runs along the contiguous axis
        onehot = (cols[:, None] == d[None, :]).to(torch.int32)
        hist[d0:d0 + cols.shape[0]] = onehot.sum(1, dtype=torch.int32)
        excl = torch.cumsum(onehot, 1, dtype=torch.int32) - onehot
        ranks += (excl * onehot).sum(0, dtype=torch.int32)
    return hist, ranks


def scatter_pass_ref(perm: torch.Tensor | None, words: torch.Tensor,
                     shift: int, radix_bits: int):
    """One stable counting-sort pass: row i goes to ``offsets[d] +
    ranks[i]`` -> (perm_out, words_out), ``perm_out[dest[i]] = perm[i]``
    (``perm`` None: ``i``) and ``words_out[dest[i]] = words[i]``."""
    d = extract_digits(words, shift, radix_bits)
    hist, ranks = digit_histogram_ranks_ref(words, shift, radix_bits)
    offsets = torch.cumsum(hist, 0, dtype=torch.int32) - hist
    dest = (offsets[d.to(torch.int64)] + ranks).to(torch.int64)
    if perm is None:
        perm = torch.arange(words.shape[0], dtype=torch.int32,
                            device=words.device)
    return (torch.empty_like(perm).index_copy_(0, dest, perm),
            torch.empty_like(words).index_copy_(0, dest, words))
