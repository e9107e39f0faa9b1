"""Local (single-partition) HPTMT table operators.

PyTorch port of ``repro/core/local_ops.py`` over
:class:`repro_torch.core.table.Table`: Select, Project, OrderBy, Unique,
GroupBy + Aggregate, Join, Cartesian Product, the set operators
(membership, Intersect, Difference, Union), null handling and column
scaling.  Every op is mask-aware (rows ``>= nvalid`` are padding) and
keeps static capacities: overflowing output rows are dropped and
counted.

Pluggable backends, each emitting bit-identical output across its
choices (float ``sum``/``mean`` up to addition order):

* OrderBy (``sort_values``), ``impl`` / ``REPRO_SORT_IMPL``: ``"xla"``, a
  chain of stable ``torch.sort`` calls (the name is the reference's), or
  ``"radix"``, the multi-pass LSD engine on the ``radix_sort`` kernel;
  ``compact``/``select`` always take the engine's 1-bit pass;
* GroupBy (``groupby_aggregate``) and Unique (``drop_duplicates``),
  ``impl`` / ``REPRO_GROUPBY_IMPL``: ``"sort"`` (sort + segment
  reductions) or ``"hash"`` (the ``hash_groupby`` accumulate, canonical
  key order from the radix rank) — both emit one row per distinct key,
  sorted by key, counts int32;
* Join, ``impl`` / ``REPRO_JOIN_IMPL``: ``"sortmerge"`` (a stable sort of
  the right side plus a binary search per left row) or ``"hash"``
  (bucketed build + probe on the ``hash_join`` kernel); left-row-major
  output, a left row's matches in right-row order, every key pair
  compared in the promoted common dtype;
* Membership (``semi_mask``, ``isin``, ``intersect``, ``difference``),
  ``impl`` / ``REPRO_SEMI_IMPL``: ``"sortmerge"`` (binary search over the
  sorted right key set) or ``"hash"`` (bucketed build + probe on the
  ``hash_semi`` kernel); the same mask either way, keys compared in the
  promoted common dtype.

Float keys compare as the reference compares them: ``-0.0`` equals
``+0.0`` and subnormals equal zero.  The primitives every backend
compares through flush them (``table.flush_subnormals``): the sort words,
``_tuple_less``, ``_group_boundaries`` and the hash bit-planes
(``bucketing.key_bits``, ``partition.hash_columns``).

Planning.  The hash backends size their slabs from the actual keys when
they may (``may_plan=True``, the default for a direct call) and the table
is larger than ``bucketing.EXACT_SLAB_CAP``; the ``dist_*`` operators pass
``may_plan=False`` and keep the sizes they are given, as the reference's
traced distributed operators do.
"""
from __future__ import annotations

from typing import Mapping, Sequence

import torch

from ..kernels import bucketing
from ..kernels.hash_groupby import (default_hash_groupby_sizes,
                                    hash_groupby_plan)
from ..kernels.hash_join import default_hash_join_sizes, hash_join_plan
from ..kernels.hash_semi import default_hash_semi_sizes, hash_semi_plan
from ..kernels.radix_sort import (radix_permutation, radix_rank,
                                  stable_partition_perm)
from .kernel_backend import groupby_impl as _default_groupby_impl
from .kernel_backend import join_impl as _default_join_impl
from .kernel_backend import semi_impl as _default_semi_impl
from .kernel_backend import sort_impl as _default_sort_impl
from .table import Table, flush_subnormals, isnull_values, null_like

_I32 = torch.int32
# (2**31 - 1) as an int32 bit pattern: flips every bit but the sign
_LOW31 = 0x7FFFFFFF


def _sentinel_max(col: torch.Tensor) -> torch.Tensor:
    if col.dtype.is_floating_point:
        return torch.tensor(float("inf"), dtype=col.dtype, device=col.device)
    return torch.tensor(torch.iinfo(col.dtype).max, dtype=col.dtype,
                        device=col.device)


def compact(table: Table, keep: torch.Tensor) -> Table:
    """Move rows where ``keep`` holds to the front (stable); drop the rest.
    One 1-bit radix pass, equal to ``argsort(~keep, stable=True)``."""
    keep = keep & table.valid_mask
    perm = stable_partition_perm(keep)
    return table.gather_rows(perm, keep.sum(dtype=_I32))


# --------------------------------------------------------------------------
# Select / Project / head / take / concat
# --------------------------------------------------------------------------


def select(table: Table, mask: torch.Tensor) -> Table:
    """Paper's Select: keep rows where ``mask`` (bool (capacity,)) holds."""
    return compact(table, mask)


def project(table: Table, names: Sequence[str]) -> Table:
    """Paper's Project: keep a subset of columns."""
    return Table(columns={n: table.columns[n] for n in names},
                 nvalid=table.nvalid)


def head(table: Table, n) -> Table:
    return table.with_nvalid(torch.clamp(table.nvalid, max=int(n)))


def take(table: Table, idx: torch.Tensor, count) -> Table:
    return table.gather_rows(idx, count)


def concat(a: Table, b: Table) -> Table:
    """Union-all of two same-schema tables (capacity = sum of capacities)."""
    if set(a.names) != set(b.names):
        raise ValueError(f"schema mismatch: {a.names} vs {b.names}")
    cap_a, cap_b = a.capacity, b.capacity
    i = torch.arange(cap_a + cap_b, dtype=_I32, device=a.device)
    from_a = i < a.nvalid
    ia = i.clamp(0, max(cap_a - 1, 0))
    ib = (i - a.nvalid).clamp(0, max(cap_b - 1, 0))
    cols = {}
    for n in a.names:
        ca, cb = a.columns[n], b.columns[n].to(a.columns[n].dtype)
        cols[n] = torch.where(from_a, ca[ia], cb[ib])
    return Table(columns=cols, nvalid=a.nvalid + b.nvalid)


def append_rows(acc: Table, t: Table):
    """Append ``t``'s valid rows after ``acc``'s, keeping acc's static
    capacity (unlike :func:`concat`, which grows it): the fixed-capacity
    accumulator behind a chunk loop (``FeatureStore`` ingest).  Rows past
    ``acc.capacity`` are dropped and counted.  Returns ``(appended,
    dropped)``."""
    if set(acc.names) != set(t.names):
        raise ValueError(f"schema mismatch: {acc.names} vs {t.names}")
    cap = acc.capacity
    i = torch.arange(t.capacity, dtype=_I32, device=acc.device)
    slot = acc.nvalid + i
    ok = (i < t.nvalid) & (slot < cap)
    flat = torch.where(ok, slot, cap).to(torch.int64)   # cap: trash slot
    cols = {}
    for n in acc.names:
        a = acc.columns[n]
        buf = torch.cat([a, a.new_zeros(1)])
        buf[flat] = t.columns[n].to(a.dtype)
        cols[n] = buf[:cap]
    total = acc.nvalid + t.nvalid
    out = Table(columns=cols, nvalid=torch.clamp(total, max=cap))
    return out, torch.clamp(total - cap, min=0)


# --------------------------------------------------------------------------
# OrderBy (sort_values)
# --------------------------------------------------------------------------


def _sort_key(col: torch.Tensor, ascending: bool) -> torch.Tensor:
    if ascending:
        return col
    if col.dtype.is_floating_point:
        return -col
    return ~col  # two's complement: exact order reversal, no overflow


def _sortable_word(key: torch.Tensor) -> torch.Tensor:
    """int32 words whose (signed) integer order is the stable-sort order
    of ``key``, for ``argsort``.  Floats take the total order of a float
    sort with ``-0.0``, ``+0.0`` and the subnormals equal and every NaN
    equal and last: zeros and NaNs are made canonical, and a negative
    float's bits are flipped below the sign.  (The radix engine's
    ``radix_sort.sortable_word`` is the unsigned-order twin.)"""
    if not key.dtype.is_floating_point:
        return key.to(_I32)
    f = flush_subnormals(key.to(torch.float32))
    f = torch.where(torch.isnan(f), torch.full_like(f, float("nan")), f)
    bits = f.view(_I32)
    return torch.where(bits < 0, bits ^ _LOW31, bits)


def sort_values(table: Table, by: Sequence[str],
                ascending: bool | Sequence[bool] = True, *,
                impl: str | None = None) -> Table:
    """Paper's OrderBy: stable multi-key sort; padding rows stay at the end.

    ``impl`` (default ``REPRO_SORT_IMPL``): ``"xla"`` is the port of one
    stable multi-operand sort over (validity, keys, iota) — PyTorch sorts
    one operand at a time, so it is a chain of stable sorts, least
    significant key first; ``"radix"`` is the multi-pass LSD radix
    permutation (``kernels/radix_sort``).  Both give the same
    permutation."""
    by = list(by)
    if isinstance(ascending, bool):
        ascending = [ascending] * len(by)
    impl = impl or _default_sort_impl()
    keys = [_sort_key(table.columns[k], a) for k, a in zip(by, ascending)]
    if impl == "xla":
        invalid = (~table.valid_mask).to(_I32)
        perm = torch.arange(table.capacity, device=table.device)
        for key in reversed([invalid, *keys]):
            word = _sortable_word(key)[perm]
            perm = perm[torch.argsort(word, stable=True)]
    elif impl == "radix":
        perm = radix_permutation(tuple(keys), ~table.valid_mask)
    else:
        raise ValueError(f"unknown sort impl {impl!r} "
                         "(expected 'xla' or 'radix')")
    return table.gather_rows(perm, table.nvalid)


# --------------------------------------------------------------------------
# Lexicographic vectorized binary search (exact, multi-key, static shape)
# --------------------------------------------------------------------------


def _tuple_less(a: tuple, b: tuple) -> torch.Tensor:
    """a < b lexicographically (element-wise over vectors), float
    subnormals compared as zero."""
    res = torch.zeros(a[0].shape, dtype=torch.bool, device=a[0].device)
    eq = torch.ones(a[0].shape, dtype=torch.bool, device=a[0].device)
    for x, y in zip(a, b):
        x, y = flush_subnormals(x), flush_subnormals(y)
        res = res | (eq & (x < y))
        eq = eq & (x == y)
    return res


def lex_searchsorted(sorted_keys: tuple, query_keys: tuple,
                     side: str = "left") -> torch.Tensor:
    """``searchsorted`` over a tuple of parallel sorted key columns.

    ``sorted_keys[i]`` share shape ``(n,)`` and are lexicographically
    sorted; ``query_keys[i]`` share shape ``(m,)``.  Returns int32 ``(m,)``
    insertion points.  Exact (comparison-based), O(m log n); float
    subnormals compare as zero (:func:`_tuple_less`)."""
    n = sorted_keys[0].shape[0]
    m = query_keys[0].shape[0]
    dev = query_keys[0].device
    lo = torch.zeros((m,), dtype=_I32, device=dev)
    hi = torch.full((m,), n, dtype=_I32, device=dev)
    if n == 0:
        return lo
    for _ in range(int(n - 1).bit_length() + 1):
        mid = (lo + hi) // 2
        midc = mid.clamp(0, n - 1)
        at_mid = tuple(k[midc] for k in sorted_keys)
        if side == "left":
            go_right = _tuple_less(at_mid, query_keys)        # k[mid] < q
        else:
            go_right = ~_tuple_less(query_keys, at_mid)       # k[mid] <= q
        go_right = go_right & (mid < hi)
        lo = torch.where(go_right, mid + 1, lo)
        hi = torch.where(go_right, hi, mid)
    return lo


def _sorted_keys_with_sentinel(table: Table, by: Sequence[str]):
    """Sort table by ``by``; overwrite padding keys with +max sentinels so
    the full-capacity key arrays are globally sorted."""
    ts = sort_values(table, by)
    valid = ts.valid_mask
    keys = tuple(torch.where(valid, ts.columns[k],
                             _sentinel_max(ts.columns[k])) for k in by)
    return ts, keys


# --------------------------------------------------------------------------
# Unique / drop_duplicates
# --------------------------------------------------------------------------


def drop_duplicates(table: Table, subset: Sequence[str] | None = None, *,
                    impl: str | None = None, return_overflow: bool = False,
                    num_buckets: int | None = None,
                    bucket_capacity: int | None = None,
                    may_plan: bool = True):
    """Keep the first occurrence of each distinct key (paper: Unique).

    ``impl`` (default ``REPRO_GROUPBY_IMPL``): ``"sort"`` (stable sort +
    boundary compaction) or ``"hash"`` (key-only hash groupby).  Both emit
    one row per distinct key, sorted by the ``subset`` columns, other
    columns from the key's first occurrence.  The hash backend takes
    static ``num_buckets`` / ``bucket_capacity`` (planned from the keys
    when ``may_plan``, see the module docstring); rows overflowing a slab
    are dropped and counted (``return_overflow=True`` returns the
    count)."""
    subset = list(subset) if subset is not None else list(table.names)
    impl = impl or _default_groupby_impl()
    if impl == "sort":
        out = _sort_drop_duplicates(table, subset)
        over = torch.zeros((), dtype=_I32, device=table.device)
    elif impl == "hash":
        out, over = _hash_drop_duplicates(table, subset, num_buckets,
                                          bucket_capacity, may_plan)
    else:
        raise ValueError(f"unknown groupby impl {impl!r} "
                         "(expected 'sort' or 'hash')")
    if return_overflow:
        return out, over
    return out


def _group_boundaries(ts: Table, by: list) -> torch.Tensor:
    """Valid rows of the sorted table ``ts`` whose key differs from the
    previous row's (and row 0); float subnormals equal zero."""
    neq_prev = torch.zeros(ts.capacity, dtype=torch.bool, device=ts.device)
    for k in by:
        col = flush_subnormals(ts.columns[k])
        neq_prev = neq_prev | (col != torch.roll(col, 1))
    first = torch.arange(ts.capacity, device=ts.device) == 0
    return (first | neq_prev) & ts.valid_mask


def _sort_drop_duplicates(table: Table, subset: list) -> Table:
    ts = sort_values(table, subset)
    return compact(ts, _group_boundaries(ts, subset))


def _hash_drop_duplicates(table: Table, subset: list, num_buckets,
                          bucket_capacity, may_plan):
    """Key-only hash groupby: the plan's group representatives are the
    first occurrences; ranking them by key gives the sort backend's
    output."""
    plan = _run_hash_groupby_plan(table, subset, (), num_buckets,
                                  bucket_capacity, may_plan)
    _, grow, final, ngroups, cap = _canonical_group_layout(table, subset,
                                                           plan)
    out_cols = {n: _place_groups(table.columns[n][grow], final, cap)
                for n in table.names}
    return Table(columns=out_cols, nvalid=ngroups), plan.dropped


# --------------------------------------------------------------------------
# GroupBy + Aggregate
# --------------------------------------------------------------------------

_AGGS = ("sum", "count", "mean", "min", "max")


def groupby_aggregate(table: Table, by: Sequence[str],
                      aggs: Mapping[str, Sequence[str] | str], *,
                      impl: str | None = None,
                      return_overflow: bool = False,
                      num_buckets: int | None = None,
                      bucket_capacity: int | None = None,
                      may_plan: bool = True):
    """Paper's GroupBy followed by Aggregate.

    ``aggs`` maps value-column name -> aggregation(s) in
    {sum,count,mean,min,max}; output columns are ``{col}_{agg}``, one row
    per distinct key sorted by the ``by`` columns, capacity preserved,
    counts int32, value aggregates float32.  ``impl`` (default
    ``REPRO_GROUPBY_IMPL``): ``"sort"`` or ``"hash"``, bit-identical
    (float sum/mean whenever addition is exact).  The hash backend takes
    static ``num_buckets`` / ``bucket_capacity`` (planned when
    ``may_plan``); rows overflowing a slab are dropped and counted
    (``return_overflow=True`` returns the count)."""
    by = list(by)
    aggs = {c: [ops] if isinstance(ops, str) else list(ops)
            for c, ops in aggs.items()}
    for ops in aggs.values():
        for op in ops:
            if op not in _AGGS:
                raise ValueError(f"unknown aggregation {op!r}")
    impl = impl or _default_groupby_impl()
    if impl == "sort":
        out = _sort_groupby(table, by, aggs)
        over = torch.zeros((), dtype=_I32, device=table.device)
    elif impl == "hash":
        out, over = _hash_groupby(table, by, aggs, num_buckets,
                                  bucket_capacity, may_plan)
    else:
        raise ValueError(f"unknown groupby impl {impl!r} "
                         "(expected 'sort' or 'hash')")
    if return_overflow:
        return out, over
    return out


def _sort_groupby(table: Table, by: list,
                  aggs: Mapping[str, list]) -> Table:
    """Sort backend: lexicographic sort, group boundaries, segment
    reductions indexed by group id."""
    ts = sort_values(table, by)
    valid = ts.valid_mask
    cap = ts.capacity
    dev = ts.device
    boundary = _group_boundaries(ts, by)
    ngroups = boundary.sum(dtype=_I32)
    seg = torch.cumsum(boundary.to(_I32), 0, dtype=_I32) - 1   # 0-based
    # padding rows -> trash segment (cap-1 is free whenever padding exists)
    seg = torch.where(valid, seg, cap - 1).to(torch.int64)

    out_cols: dict[str, torch.Tensor] = {k: ts.columns[k] for k in by}
    counts = torch.zeros(cap, dtype=_I32, device=dev).index_add_(
        0, seg, valid.to(_I32))
    countf = counts.clamp(min=1).to(torch.float32)

    def seg_reduce(x, fill, reduce):
        return torch.full((cap,), fill, dtype=torch.float32, device=dev) \
            .scatter_reduce_(0, seg, torch.where(valid, x, fill), reduce)

    for col_name, ops in aggs.items():
        fcol = ts.columns[col_name].to(torch.float32)
        for op in ops:
            if op in ("sum", "mean"):
                v = seg_reduce(fcol, 0.0, "sum")
                if op == "mean":
                    v = v / countf
            elif op == "count":
                v = counts
            elif op == "min":
                v = seg_reduce(fcol, float("inf"), "amin")
            else:
                v = seg_reduce(fcol, float("-inf"), "amax")
            out_cols[f"{col_name}_{op}"] = v

    # segment g's result sits at index g; compacting the boundary rows
    # aligns the keys with index g
    key_tbl = compact(Table(columns={k: out_cols[k] for k in by},
                            nvalid=ts.nvalid), boundary)
    cols = dict(key_tbl.columns)
    for name, v in out_cols.items():
        if name not in by:
            cols[name] = v
    return Table(columns=cols, nvalid=ngroups)


def _run_hash_groupby_plan(table: Table, by: list, value_cols: tuple,
                           num_buckets, bucket_capacity, may_plan):
    bp = bucketing.BucketPlan([table.columns[k] for k in by])
    planned = _planned_sizes(bp, table.nvalid, table.capacity, num_buckets,
                             bucket_capacity, may_plan)
    if planned is not None:
        B, C = planned
        bid = bp.bucket_ids_for(B)     # the sizing pass's hash, reused
    else:
        B, C = default_hash_groupby_sizes(table.capacity, num_buckets)
        C = bucket_capacity or C
        bid = None
    return hash_groupby_plan(
        bp.bits, table.valid_mask,
        tuple(table.columns[c] for c in value_cols),
        num_buckets=B, bucket_capacity=C, bid=bid)


def _canonical_group_layout(table: Table, by: list, plan):
    """Map the plan's group representatives to canonical (key-sorted)
    output rows without a sort: compact the representatives bucket-major
    (scatter by running count), then rank each group's key — gathered
    from its first-occurrence row — with the multi-pass radix rank.  Group
    keys are distinct, so each valid group's rank is its slot in
    ``[0, ngroups)``.

    Returns (scat, grow, final, ngroups, cap): the slab -> compact scatter
    (for the plan's per-slot aggregates), per compacted group its
    representative row and its canonical slot (``cap`` = trash), the
    group count and the output capacity."""
    cap = table.capacity
    rep = plan.rep.reshape(-1) > 0
    ridx = torch.cumsum(rep.to(_I32), 0, dtype=_I32) - 1
    ngroups = rep.sum(dtype=_I32)
    slot = torch.where(rep, ridx, cap).to(torch.int64)

    def scat(x):
        return torch.zeros(cap + 1, dtype=x.dtype, device=x.device) \
            .index_copy_(0, slot, x)[:cap]

    grow = scat(plan.row.reshape(-1))
    gvalid = scat(rep)
    gkeys = tuple(table.columns[k][grow] for k in by)
    rank = radix_rank(gkeys, ~gvalid)
    final = torch.where(gvalid, rank, cap)
    return scat, grow, final, ngroups, cap


def _place_groups(x: torch.Tensor, final: torch.Tensor,
                  cap: int) -> torch.Tensor:
    """Scatter compacted group entries into their canonical slots."""
    return torch.zeros(cap + 1, dtype=x.dtype, device=x.device) \
        .index_copy_(0, final.to(torch.int64), x)[:cap]


def _hash_groupby(table: Table, by: list, aggs: Mapping[str, list],
                  num_buckets, bucket_capacity, may_plan):
    """Hash backend: the bucketed accumulate (``kernels/hash_groupby``)
    aggregates every key inside its bucket in one pass; canonical key
    order comes from the radix rank."""
    plan = _run_hash_groupby_plan(table, by, tuple(aggs), num_buckets,
                                  bucket_capacity, may_plan)
    scat, grow, final, ngroups, cap = _canonical_group_layout(table, by,
                                                              plan)

    def place(x):
        return _place_groups(scat(x.reshape(-1)), final, cap)

    out_cols = {k: _place_groups(table.columns[k][grow], final, cap)
                for k in by}
    counts = place(plan.counts)
    countf = counts.clamp(min=1).to(torch.float32)
    for i, (col_name, ops) in enumerate(aggs.items()):
        s = place(plan.sums[:, i, :])
        for op in ops:
            if op == "sum":
                v = s
            elif op == "count":
                v = counts
            elif op == "mean":
                v = s / countf
            elif op == "min":
                v = place(plan.mins[:, i, :])
            else:
                v = place(plan.maxs[:, i, :])
            out_cols[f"{col_name}_{op}"] = v
    return Table(columns=out_cols, nvalid=ngroups), plan.dropped


# merge rule per partial-aggregate column suffix: how two partials of the
# same group combine into the partial of their union
_PARTIAL_MERGE = {"sum": "sum", "count": "sum", "min": "min", "max": "max"}


def partial_agg_columns(aggs: Mapping[str, Sequence[str] | str]):
    """Expand requested aggregations to the *partial* set that chunked
    (morsel) execution accumulates: ``mean`` needs ``sum`` + ``count``,
    everything else is its own partial.  Returns ``{col: [partial ops]}``
    in canonical (sum, count, min, max) order."""
    out: dict[str, list] = {}
    for col, ops in aggs.items():
        ops = [ops] if isinstance(ops, str) else list(ops)
        need = set()
        for op in ops:
            if op not in _AGGS:
                raise ValueError(f"unknown aggregation {op!r}")
            need.update(("sum", "count") if op == "mean" else (op,))
        out[col] = [op for op in ("sum", "count", "min", "max")
                    if op in need]
    return out


def merge_partial_aggregates(acc: Table, part: Table, by: Sequence[str], *,
                             impl: str | None = None,
                             return_overflow: bool = False,
                             num_buckets: int | None = None,
                             bucket_capacity: int | None = None):
    """Merge two canonical partial-aggregate tables into one with
    ``acc``'s capacity: the associative combine step of morsel-driven
    groupby (``core/morsel.py``).

    Both inputs carry the ``by`` key columns plus partial columns named
    ``{col}_{op}`` with ``op`` in sum/count/min/max (the shape
    :func:`groupby_aggregate` emits, see :func:`partial_agg_columns`).
    Equal keys combine through the matching reduction (sum of sums, sum
    of counts, min of mins, max of maxs) by re-running the aggregation
    backend (``impl`` 'sort' | 'hash', the latter on the ``hash_groupby``
    slabs, sized by ``num_buckets`` / ``bucket_capacity`` or the
    heuristics, never planned from the keys, as the reference's traced
    merge) over the concatenation, so the output is again canonical (one
    row per key, key-sorted) and any chunking of the rows folds to the
    same table.

    Counts are re-summed as float32 and cast back to int32, as the
    reference does (exact below 2^24 rows a group).  Groups past
    ``acc.capacity`` and hash-slab overflow are dropped and counted:
    ``return_overflow=True`` returns ``(merged, dropped)``."""
    by = list(by)
    t = concat(acc, part)
    merge_op: dict[str, str] = {}
    for name in acc.names:
        if name in by:
            continue
        _, _, suffix = name.rpartition("_")
        if suffix not in _PARTIAL_MERGE:
            raise ValueError(
                f"column {name!r} is not a partial-aggregate column "
                "(expected a _sum/_count/_min/_max suffix)")
        merge_op[name] = _PARTIAL_MERGE[suffix]
    g, over = groupby_aggregate(t, by, {n: [op] for n, op in
                                        merge_op.items()},
                                impl=impl, return_overflow=True,
                                num_buckets=num_buckets,
                                bucket_capacity=bucket_capacity,
                                may_plan=False)
    cap = acc.capacity
    cols = {k: g.columns[k][:cap] for k in by}
    for name, op in merge_op.items():
        v = g.columns[f"{name}_{op}"][:cap]
        if name.endswith("_count"):
            v = v.to(_I32)
        cols[name] = v
    out = Table(columns=cols, nvalid=torch.clamp(g.nvalid, max=cap))
    dropped = over + torch.clamp(g.nvalid - cap, min=0)
    if return_overflow:
        return out, dropped
    return out


def aggregate(table: Table, col: str, op: str) -> torch.Tensor:
    """Whole-column masked reduction -> 0-d tensor (paper's Aggregate):
    ``count`` is int32, every other aggregation float32."""
    valid = table.valid_mask
    x = table.columns[col].to(torch.float32)
    n = table.nvalid.to(torch.float32).clamp(min=1.0)
    if op == "sum":
        return torch.where(valid, x, 0.0).sum()
    if op == "count":
        return table.nvalid.to(_I32)
    if op == "mean":
        return torch.where(valid, x, 0.0).sum() / n
    if op == "min":
        return torch.where(valid, x, float("inf")).amin()
    if op == "max":
        return torch.where(valid, x, float("-inf")).amax()
    if op == "std":
        m = torch.where(valid, x, 0.0).sum() / n
        v = torch.where(valid, (x - m) ** 2, 0.0).sum() / n
        return torch.sqrt(v)
    raise ValueError(f"unknown aggregation {op!r}")


# --------------------------------------------------------------------------
# Join (pluggable backend: sort-merge / bucketed hash)
# --------------------------------------------------------------------------


def join(left: Table, right: Table, *,
         left_on: Sequence[str], right_on: Sequence[str] | None = None,
         how: str = "inner", out_capacity: int | None = None,
         suffix: str = "_r", return_overflow: bool = False,
         impl: str | None = None, num_buckets: int | None = None,
         bucket_capacity: int | None = None,
         probe_capacity: int | None = None, may_plan: bool = True):
    """Paper's Join: inner/left join with static output capacity.

    ``impl`` picks the backend (``"sortmerge"`` or ``"hash"``); both emit
    identical output.  ``out_capacity`` defaults to ``left.capacity``;
    overflowing output rows are dropped and counted
    (``return_overflow=True`` returns the count).  The hash backend adds
    ``num_buckets`` / ``bucket_capacity`` / ``probe_capacity`` static
    sizing; rows overflowing a slab are dropped and counted into the same
    metric.  ``may_plan`` lets the hash backend size its slabs from the
    actual keys (see the module docstring)."""
    if how not in ("inner", "left"):
        raise ValueError("how must be 'inner' or 'left'")
    impl = impl or _default_join_impl()
    left_on = list(left_on)
    right_on = list(right_on) if right_on is not None else left_on
    out_cap = out_capacity or left.capacity
    if impl == "sortmerge":
        return _sortmerge_join(left, right, left_on, right_on, how, out_cap,
                               suffix, return_overflow)
    if impl == "hash":
        return _hash_join(left, right, left_on, right_on, how, out_cap,
                          suffix, return_overflow, num_buckets,
                          bucket_capacity, probe_capacity, may_plan)
    raise ValueError(f"unknown join impl {impl!r} "
                     "(expected 'sortmerge' or 'hash')")


def _emit_layout(match_counts: torch.Tensor, lvalid: torch.Tensor,
                 how: str):
    """(inclusive cumsum, exclusive offsets, total) of per-left-row emit
    counts — the left-row-major layout shared by both join backends (left
    join emits 1 slot for each ``lvalid`` row with no matches)."""
    if how == "left":
        emit = torch.where(lvalid & (match_counts == 0), 1, match_counts)
    else:
        emit = match_counts
    cum = torch.cumsum(emit, 0, dtype=_I32)
    offs = cum - emit
    total = cum[-1] if emit.shape[0] > 0 else \
        torch.zeros((), dtype=_I32, device=emit.device)
    return cum, offs, total


def _promoted_semi_keys(left: Table, right: Table, left_on: list,
                        right_on: list):
    """Both sides' key columns cast to their promoted common dtype, so a
    mixed-dtype probe cannot collide distinct keys (int32 x float32 ->
    float32)."""
    q, v = [], []
    for lk, rk in zip(left_on, right_on):
        lc, rc = left.columns[lk], right.columns[rk]
        dt = torch.promote_types(lc.dtype, rc.dtype)
        q.append(lc.to(dt))
        v.append(rc.to(dt))
    return tuple(q), tuple(v)


def _assemble(left: Table, right: Table, left_on, right_on, how, suffix,
              lrow, rrow, matched):
    """Output columns: left rows ``lrow``, right rows ``rrow`` (nulls where
    a left join row has no match); the right keys are dropped when both
    sides use the same key names."""
    cols: dict[str, torch.Tensor] = {}
    for n in left.names:
        cols[n] = left.columns[n][lrow]
    drop_keys = set(right_on) if left_on == right_on else set()
    for n in right.names:
        if n in drop_keys:
            continue
        name = n + suffix if n in cols else n
        v = right.columns[n][rrow]
        if how == "left":
            v = torch.where(matched, v, null_like(v))
        cols[name] = v
    return cols


def _sortmerge_join(left: Table, right: Table, left_on, right_on, how,
                    out_cap, suffix, return_overflow):
    """Sort-merge backend: the right table is sorted by its keys; each left
    row binary-searches its match range ``[lo, hi)``; output slot ``j`` is
    mapped back to its (left row, match offset) pair with a second search
    — vectorized, no dynamic shapes."""
    rs, rkeys = _sorted_keys_with_sentinel(right, right_on)
    # compare in the promoted common dtype (casting the sorted keys is
    # order-preserving)
    dts = tuple(torch.promote_types(left.columns[k].dtype,
                                    rs.columns[rk].dtype)
                for k, rk in zip(left_on, right_on))
    qkeys = tuple(left.columns[k].to(dt) for k, dt in zip(left_on, dts))
    rkeys = tuple(rk.to(dt) for rk, dt in zip(rkeys, dts))
    lo = lex_searchsorted(rkeys, qkeys, side="left")
    hi = lex_searchsorted(rkeys, qkeys, side="right")
    lo = torch.minimum(lo, right.nvalid)
    hi = torch.minimum(hi, right.nvalid)
    lvalid = left.valid_mask
    match_counts = torch.where(lvalid, hi - lo, 0)
    cum, offs, total = _emit_layout(match_counts, lvalid, how)

    j = torch.arange(out_cap, dtype=_I32, device=left.device)
    if left.capacity:
        lrow = torch.searchsorted(cum, j, right=True, out_int32=True)
        lrow = lrow.clamp(0, left.capacity - 1)
    else:
        lrow = torch.zeros_like(j)
    within = j - offs[lrow]
    matched = within < match_counts[lrow]
    rrow = (lo[lrow] + within).clamp(0, max(right.capacity - 1, 0))

    cols = _assemble(left, rs, left_on, right_on, how, suffix, lrow, rrow,
                     matched)
    out = Table(columns=cols, nvalid=torch.clamp(total, max=out_cap))
    if return_overflow:
        return out, (total - out_cap).clamp(min=0)
    return out


def _planned_sizes(bplan: bucketing.BucketPlan, nvalid, capacity: int,
                   num_buckets, explicit_capacity, may_plan: bool):
    """Slab sizing from the actual keys via the two-pass bucket planner
    (hash join and hash groupby).

    Applies only when the caller may plan, gave no explicit capacity and
    the tables exceed ``bucketing.EXACT_SLAB_CAP``; returns
    ``(num_buckets, bucket_capacity)`` or ``None``.  The capacity is
    rounded up to a power of two, as in the reference."""
    if not may_plan or explicit_capacity is not None \
            or capacity <= bucketing.EXACT_SLAB_CAP:
        return None
    B, C = bucketing.plan_bucket_sizes(num_buckets=num_buckets, plan=bplan,
                                       nvalid=int(nvalid))
    return B, 1 << max(3, (C - 1).bit_length())


def _hash_join(left: Table, right: Table, left_on, right_on, how,
               out_cap, suffix, return_overflow, num_buckets,
               bucket_capacity, probe_capacity, may_plan):
    """Hash backend: bucketed build+probe (kernels/hash_join) instead of
    two sorts.  The plan yields per-left-row match counts plus per (probe
    slot, chain slot) match ranks; each matched pair goes to output slot
    offset-of-its-left-row + rank, which reproduces the sort-merge order
    because chain order is original right-row order."""
    B, C, Lc = default_hash_join_sizes(left.capacity, right.capacity,
                                       num_buckets)
    qkeys, rkeys = _promoted_semi_keys(left, right, list(left_on),
                                       list(right_on))
    lbp = bucketing.BucketPlan(qkeys)
    rbp = bucketing.BucketPlan(rkeys)
    big = max(left.capacity, right.capacity)
    built = _planned_sizes(rbp, right.nvalid, big, B, bucket_capacity,
                           may_plan)
    if built is not None:
        C = built[1]
    probed = _planned_sizes(lbp, left.nvalid, big, B, probe_capacity,
                            may_plan)
    if probed is not None:
        Lc = probed[1]
    C = bucket_capacity or C
    Lc = probe_capacity or Lc
    npairs = B * Lc * C
    if npairs >= 2 ** 31:
        raise ValueError(
            f"hash join pair space B*Lc*C = {B}*{Lc}*{C} = {npairs} "
            "reaches 2**31: the reference numbers pairs in int32, so this "
            "size is outside the join's contract (use the sortmerge "
            "backend, or more buckets)")
    plan = hash_join_plan(
        lbp.bits, left.valid_mask, rbp.bits, right.valid_mask,
        num_buckets=B, bucket_capacity=C, probe_capacity=Lc,
        left_bid=lbp.bucket_ids_for(B) if probed is not None else None,
        right_bid=rbp.bucket_ids_for(B) if built is not None else None)

    # a probe-dropped left row's match status is unknown: it is excluded
    # from emission entirely (counted in probe_dropped)
    lvalid = left.valid_mask & plan.probed
    mc = plan.match_counts
    cum, offs, total = _emit_layout(mc, lvalid, how)

    # scatter only the matched pairs: pair = (b*Lc + l)*C + c goes to
    # output slot offs[left row] + rank; no two live pairs share a slot,
    # and every pair past out_cap lands on the trash slot out_cap
    rank = plan.rank.reshape(-1)
    pair = torch.nonzero(rank >= 0).reshape(-1)
    probe_row = plan.probe_row.reshape(-1)
    slot = offs[probe_row[pair // C]].to(torch.int64) + rank[pair]
    slot = torch.where(slot < out_cap, slot, out_cap)
    buf = (torch.full((out_cap + 1,), -1, dtype=torch.int64,
                      device=left.device)
           .index_copy_(0, slot, pair)[:out_cap])
    matched = buf >= 0
    pp = buf.clamp(min=0)
    # probe slot index b*Lc+l = pair // C; build slot index b*C + c =
    # (pair // (Lc*C))*C + pair % C
    out_lrow = torch.where(matched, probe_row[pp // C], 0)
    out_rrow = torch.where(
        matched, plan.build_row.reshape(-1)[(pp // (Lc * C)) * C + pp % C],
        0)
    if how == "left":
        un = lvalid & (mc == 0)
        flat_u = torch.where(un & (offs < out_cap), offs.to(torch.int64),
                             out_cap)
        ubuf = (torch.zeros((out_cap + 1,), dtype=_I32, device=left.device)
                .index_copy_(0, flat_u, torch.arange(
                    left.capacity, dtype=_I32, device=left.device))
                [:out_cap])
        out_lrow = torch.where(matched, out_lrow, ubuf)

    cols = _assemble(left, right, left_on, right_on, how, suffix, out_lrow,
                     out_rrow, matched)
    out = Table(columns=cols, nvalid=torch.clamp(total, max=out_cap))
    if return_overflow:
        overflow = ((total - out_cap).clamp(min=0)
                    + plan.build_dropped + plan.probe_dropped)
        return out, overflow
    return out


def cartesian_product(left: Table, right: Table, out_capacity: int,
                      suffix: str = "_r", return_overflow: bool = False):
    """Paper's Cartesian Product with a static output capacity; rows past
    ``out_capacity`` are dropped and counted (``return_overflow=True``
    returns the count)."""
    dev = left.device
    n2 = right.nvalid.clamp(min=1)
    j = torch.arange(out_capacity, dtype=_I32, device=dev)
    lrow = (j // n2).clamp(0, max(left.capacity - 1, 0))
    rrow = (j % n2).clamp(0, max(right.capacity - 1, 0))
    total = left.nvalid * right.nvalid
    cols = {n: left.columns[n][lrow] for n in left.names}
    for n in right.names:
        name = n + suffix if n in cols else n
        cols[name] = right.columns[n][rrow]
    out = Table(columns=cols, nvalid=torch.clamp(total, max=out_capacity))
    if return_overflow:
        return out, (total - out_capacity).clamp(min=0)
    return out


# --------------------------------------------------------------------------
# Membership + set operators (sort-merge or bucketed hash membership; no
# join is materialised either way)
# --------------------------------------------------------------------------


def _sortmerge_semi(qkeys: tuple, lvalid: torch.Tensor, vkeys: tuple,
                    rnvalid: torch.Tensor) -> torch.Tensor:
    """Sort the right key set, binary-search each left key's match range:
    member iff the range is non-empty."""
    vt = Table(columns={f"k{i}": c for i, c in enumerate(vkeys)},
               nvalid=rnvalid)
    _, skeys = _sorted_keys_with_sentinel(vt, list(vt.names))
    lo = torch.minimum(lex_searchsorted(skeys, qkeys, side="left"), rnvalid)
    hi = torch.minimum(lex_searchsorted(skeys, qkeys, side="right"),
                       rnvalid)
    return (hi > lo) & lvalid


def _hash_semi(qkeys: tuple, left: Table, vkeys: tuple, right: Table,
               num_buckets, bucket_capacity, probe_capacity, may_plan):
    """Build the right key set into bucket slabs and probe each left key
    (``kernels/hash_semi``): one boolean per row.  Each side's bit-planes
    are extracted once (``BucketPlan``) and shared by the two-pass sizing
    and the plan.  Probe-dropped rows report False and are counted."""
    B, C, Lc = default_hash_semi_sizes(left.capacity, right.capacity,
                                       num_buckets)
    lbp = bucketing.BucketPlan(qkeys)
    rbp = bucketing.BucketPlan(vkeys)
    big = max(left.capacity, right.capacity)
    built = _planned_sizes(rbp, right.nvalid, big, B, bucket_capacity,
                           may_plan)
    if built is not None:
        C = built[1]
    probed = _planned_sizes(lbp, left.nvalid, big, B, probe_capacity,
                            may_plan)
    if probed is not None:
        Lc = probed[1]
    C = bucket_capacity or C
    Lc = probe_capacity or Lc
    plan = hash_semi_plan(
        lbp.bits, left.valid_mask, rbp.bits, right.valid_mask,
        num_buckets=B, bucket_capacity=C, probe_capacity=Lc,
        left_bid=lbp.bucket_ids_for(B) if probed is not None else None,
        right_bid=rbp.bucket_ids_for(B) if built is not None else None)
    mask = plan.member & left.valid_mask
    return mask, plan.build_dropped + plan.probe_dropped


def semi_mask(left: Table, right: Table, left_on: Sequence[str],
              right_on: Sequence[str] | None = None, *,
              impl: str | None = None, return_overflow: bool = False,
              num_buckets: int | None = None,
              bucket_capacity: int | None = None,
              probe_capacity: int | None = None, may_plan: bool = True):
    """Semi-join membership mask: per left row, does its key appear among
    the right table's valid keys?

    ``impl`` (default ``REPRO_SEMI_IMPL``): ``"sortmerge"`` or ``"hash"``,
    the same mask either way.  The hash backend takes static
    ``num_buckets`` / ``bucket_capacity`` / ``probe_capacity`` (planned
    from the keys when ``may_plan``, see the module docstring); rows
    overflowing a slab report non-member and are counted
    (``return_overflow=True`` returns the count)."""
    left_on = list(left_on)
    right_on = list(right_on) if right_on is not None else left_on
    impl = impl or _default_semi_impl()
    qkeys, vkeys = _promoted_semi_keys(left, right, left_on, right_on)
    if impl == "sortmerge":
        mask = _sortmerge_semi(qkeys, left.valid_mask, vkeys, right.nvalid)
        over = torch.zeros((), dtype=_I32, device=left.device)
    elif impl == "hash":
        mask, over = _hash_semi(qkeys, left, vkeys, right, num_buckets,
                                bucket_capacity, probe_capacity, may_plan)
    else:
        raise ValueError(f"unknown semi impl {impl!r} "
                         "(expected 'sortmerge' or 'hash')")
    if return_overflow:
        return mask, over
    return mask


def _semi_mask(left: Table, right: Table, on: Sequence[str], **kwargs):
    """Same-named-columns :func:`semi_mask` (the set operators' shape)."""
    return semi_mask(left, right, on, on, **kwargs)


def isin(table: Table, col: str, values: Table, values_col: str, *,
         impl: str | None = None, return_overflow: bool = False,
         num_buckets: int | None = None, bucket_capacity: int | None = None,
         probe_capacity: int | None = None, may_plan: bool = True):
    """Bool mask: ``table[col]`` present among the valid
    ``values[values_col]`` — a single-key :func:`semi_mask`, the paper's
    membership filter (UNOMT Fig. 11)."""
    return semi_mask(table, values, [col], [values_col], impl=impl,
                     return_overflow=return_overflow,
                     num_buckets=num_buckets,
                     bucket_capacity=bucket_capacity,
                     probe_capacity=probe_capacity, may_plan=may_plan)


def intersect(a: Table, b: Table, on: Sequence[str] | None = None, *,
              impl: str | None = None, dedup_impl: str | None = None,
              return_overflow: bool = False,
              num_buckets: int | None = None,
              bucket_capacity: int | None = None,
              probe_capacity: int | None = None, may_plan: bool = True):
    """Paper's Intersect: distinct rows of ``a`` present in ``b``, one
    row per distinct key sorted by the ``on`` columns.  ``impl`` selects
    the semi-join backend, ``dedup_impl`` the dedup backend (see
    :func:`drop_duplicates`); ``return_overflow=True`` returns the summed
    semi + dedup overflow."""
    on = list(on) if on is not None else list(a.names)
    mask, s_over = _semi_mask(a, b, on, impl=impl, return_overflow=True,
                              num_buckets=num_buckets,
                              bucket_capacity=bucket_capacity,
                              probe_capacity=probe_capacity,
                              may_plan=may_plan)
    out, d_over = drop_duplicates(compact(a, mask), on, impl=dedup_impl,
                                  return_overflow=True, may_plan=may_plan)
    if return_overflow:
        return out, s_over + d_over
    return out


def difference(a: Table, b: Table, on: Sequence[str] | None = None, *,
               impl: str | None = None, return_overflow: bool = False,
               num_buckets: int | None = None,
               bucket_capacity: int | None = None,
               probe_capacity: int | None = None, may_plan: bool = True):
    """Paper's Difference: rows of ``a`` with no match in ``b`` (all
    occurrences, original row order).  A probe-dropped row's membership
    is unknown, so it is excluded and counted, never guessed."""
    on = list(on) if on is not None else list(a.names)
    mask, over = _semi_mask(a, b, on, impl=impl, return_overflow=True,
                            num_buckets=num_buckets,
                            bucket_capacity=bucket_capacity,
                            probe_capacity=probe_capacity,
                            may_plan=may_plan)
    out = compact(a, a.valid_mask & ~mask)
    if return_overflow:
        return out, over
    return out


def union(a: Table, b: Table, on: Sequence[str] | None = None, *,
          impl: str | None = None, return_overflow: bool = False,
          num_buckets: int | None = None,
          bucket_capacity: int | None = None, may_plan: bool = True):
    """Paper's Union: concat + dedup on the ``on`` key columns (all
    columns when omitted), keeping each key's first occurrence — ``a``'s
    rows win ties against ``b``'s.  ``impl`` selects the dedup backend
    ('sort' | 'hash'); overflow is counted."""
    on = list(on) if on is not None else list(a.names)
    return drop_duplicates(concat(a, b), on, impl=impl,
                           return_overflow=return_overflow,
                           num_buckets=num_buckets,
                           bucket_capacity=bucket_capacity,
                           may_plan=may_plan)


# --------------------------------------------------------------------------
# Null handling (UNOMT: isnull / dropna / fillna)
# --------------------------------------------------------------------------


def isnull(table: Table, col: str) -> torch.Tensor:
    return isnull_values(table.columns[col]) & table.valid_mask


def dropna(table: Table, subset: Sequence[str] | None = None) -> Table:
    subset = list(subset) if subset is not None else list(table.names)
    bad = torch.zeros(table.capacity, dtype=torch.bool, device=table.device)
    for k in subset:
        bad = bad | isnull_values(table.columns[k])
    return compact(table, ~bad)


def fillna(table: Table, values: Mapping[str, float]) -> Table:
    cols = dict(table.columns)
    for k, v in values.items():
        col = cols[k]
        cols[k] = torch.where(isnull_values(col),
                              torch.tensor(v, dtype=col.dtype,
                                           device=col.device), col)
    return Table(columns=cols, nvalid=table.nvalid)


# --------------------------------------------------------------------------
# Column scaling (the UNOMT pipeline's scikit-learn StandardScaler)
# --------------------------------------------------------------------------


def column_moments(table: Table, cols: Sequence[str],
                   impl: str | None = None,
                   center: Mapping[str, torch.Tensor] | None = None):
    """Per-column moments over the valid rows: ``({col: sum(x)},
    {col: sum((x - center)**2)}, count)`` as float32 0-d tensors.

    ``center`` maps column -> scalar (0 when omitted).  Called twice,
    first for the sums and then centered on the means, it gives the
    two-pass variance, which does not cancel when ``|mean| >> std``.
    ``impl=None`` reduces inline; ``"sort"`` / ``"hash"`` route the same
    sums through :func:`groupby_aggregate` on a constant key."""
    center = dict(center) if center is not None else {}
    if impl is None:
        valid = table.valid_mask
        s1, sd2 = {}, {}
        for k in cols:
            x = table.columns[k].to(torch.float32)
            d = x - center.get(k, 0.0)
            s1[k] = torch.where(valid, x, 0.0).sum()
            sd2[k] = torch.where(valid, d * d, 0.0).sum()
        return s1, sd2, table.nvalid.to(torch.float32)
    cap = table.capacity
    aug = {"__k": torch.zeros(cap, dtype=_I32, device=table.device)}
    aggs: dict[str, list] = {}
    for k in cols:
        x = table.columns[k].to(torch.float32)
        d = x - center.get(k, 0.0)
        aug[k] = x
        aug[f"__sq_{k}"] = d * d
        aggs[k] = ["sum"]
        aggs[f"__sq_{k}"] = ["sum"]
    # a constant key is one group in one bucket: the slab must hold every
    # row, so it is sized to the full capacity
    g = groupby_aggregate(Table(columns=aug, nvalid=table.nvalid), ["__k"],
                          aggs, impl=impl, num_buckets=8,
                          bucket_capacity=cap)
    nz = table.nvalid > 0
    s1 = {k: torch.where(nz, g.columns[f"{k}_sum"][0], 0.0) for k in cols}
    sd2 = {k: torch.where(nz, g.columns[f"__sq_{k}_sum"][0], 0.0)
           for k in cols}
    return s1, sd2, table.nvalid.to(torch.float32)


def _scale_columns(table: Table, cols: Sequence[str], means: Mapping,
                  variances: Mapping) -> Table:
    """``(x - mean) / sqrt(var + 1e-12)`` for each of ``cols``."""
    out = dict(table.columns)
    for k in cols:
        x = out[k].to(torch.float32)
        out[k] = (x - means[k]) / torch.sqrt(variances[k] + 1e-12)
    return Table(columns=out, nvalid=table.nvalid)


def standard_scale(table: Table, cols: Sequence[str],
                   impl: str | None = None) -> Table:
    """(x - mean) / std per column over the valid rows (scikit-learn's
    StandardScaler), two-pass: the means first, then the variance of the
    deviations about them.  ``impl`` selects how the moments are summed
    (see :func:`column_moments`); the choices agree up to float32
    addition order."""
    s1, _, n = column_moments(table, cols, impl=impl)
    n = n.clamp(min=1.0)
    means = {k: s1[k] / n for k in cols}
    _, sd2, _ = column_moments(table, cols, impl=impl, center=means)
    return _scale_columns(table, cols, means, {k: sd2[k] / n for k in cols})
