"""Plain PyTorch version of the bucketed hash-accumulate groupby kernel.

Rows arrive bucket-grouped (``ops.py`` groups them with the shared
``kernels.bucketing`` slabs): for each of ``B`` buckets a slab of ``C``
slots, each slot holding the row's ``K`` int32 key bit-planes, an
occupancy flag and ``V`` float32 values.  Equal keys share a bucket, so
each bucket aggregates its own keys.  For every slot ``i``:

* ``rep``    — ``(B, C)`` int32 1 iff slot ``i`` is occupied and no
  earlier slot of its bucket holds its key (the key's first occurrence);
* ``counts`` — ``(B, C)`` int32 number of slots with slot ``i``'s key;
* ``sums`` / ``mins`` / ``maxs`` — ``(B, V, C)`` float32 aggregates of
  each value column over those slots (NaN propagates; an empty slot has
  0, +inf and -inf).

Two slots share a group iff both are occupied and every key plane is
equal.  The reference's ``(B, C, C)`` equality matrix is built a few
buckets at a time, so memory stays bounded; the results do not change.
"""
import torch

# elements of one (buckets, C, C) equality chunk
_CHUNK_ELEMS = 1 << 26


def _accumulate(kbits, occ, vals):
    eq = (occ[:, :, None] > 0) & (occ[:, None, :] > 0)        # (b, C, C)
    for k in range(kbits.shape[1]):
        eq = eq & (kbits[:, k, :, None] == kbits[:, k, None, :])
    m = eq.to(torch.int32)
    counts = m.sum(2, dtype=torch.int32)
    cap = occ.shape[1]
    i = torch.arange(cap, device=occ.device)
    earlier = (i[None, :] < i[:, None]).to(torch.int32)       # j < i
    rep = (occ > 0) & ((m * earlier[None]).sum(2) == 0)
    x = vals[:, :, None, :]                                    # (b, V, 1, C)
    e = eq[:, None, :, :]                                      # (b, 1, C, C)
    sums = torch.where(e, x, 0.0).sum(3)
    mins = torch.where(e, x, float("inf")).amin(3)
    maxs = torch.where(e, x, float("-inf")).amax(3)
    return rep.to(torch.int32), counts, sums, mins, maxs


def bucket_accumulate_ref(kbits: torch.Tensor, occ: torch.Tensor,
                          vals: torch.Tensor):
    """kbits (B, K, C) int32, occ (B, C) int32 0/1, vals (B, V, C) f32 ->
    (rep (B, C) int32, counts (B, C) int32, sums/mins/maxs (B, V, C))."""
    B, _, C = kbits.shape
    V = vals.shape[1]
    step = max(1, _CHUNK_ELEMS // max(C * C * max(V, 1), 1))
    if B <= step:
        return _accumulate(kbits, occ, vals)
    parts = [_accumulate(kbits[b:b + step], occ[b:b + step],
                         vals[b:b + step]) for b in range(0, B, step)]
    return tuple(torch.cat(p) for p in zip(*parts))
