"""Out-of-core, morsel-driven execution (PyTorch port of
``repro/core/morsel.py``).

Host memory (or a memory-mapped file: ``np.memmap`` columns work
unchanged, since chunks are slices) holds the full relation; the device
only ever holds one fixed-capacity **morsel** per side plus the
operator's resident state.  The unit of scalability is the operator
contract (communication ∘ local operator with counted overflow), not the
materialised table.

:class:`ChunkedTable` is the host-side source: numpy columns cut into
fixed-``chunk_rows`` morsels, each streamed through
:func:`~repro_torch.core.dist_ops.distribute_table` (floats narrow to
float32, out-of-int32-range integers raise).  PyTorch runs eagerly, so a
chunk step is a plain call; the reference's donated accumulators are
simply rebound.

``chunked_dist_join``
    ``build='resident'``: the build side is hash-shuffled once and kept
    on the device (folded with :func:`local_ops.append_rows` when it
    arrives in chunks); each probe morsel is shuffled on the key, joined
    against the resident build block and collected to the host (or
    handed to ``sink``).  ``build='restream'``: each probe morsel is
    shuffled once and joined against every re-shuffled build morsel —
    inner joins only, since an inner join distributes over a partition
    of the build side and a left join does not.

``chunked_dist_groupby``
    Per morsel: shuffle on the keys and a local *partial* aggregation
    (``mean`` decomposes into sum + count,
    :func:`local_ops.partial_agg_columns`), folded into a resident
    accumulator by :func:`local_ops.merge_partial_aggregates`; a final
    pass maps partials to the requested aggregates with the monolithic
    formula (``mean = sum / max(count, 1)`` in float32), so results are
    bit-identical whenever float addition is exact.

``chunked_dist_sort``
    Per morsel: a full :func:`~repro_torch.core.dist_ops.dist_sort` into
    a sorted host run; the runs fold through a stable vectorised k-way
    merge (adjacent pairwise merges, earlier runs win ties).  The merge
    compares the words the monolithic sort compares
    (``local_ops._sortable_word``): NaN keys last whichever the
    direction, ``-0.0`` equal to ``+0.0``, subnormals equal to zero.  So
    the result equals the monolithic ``dist_sort``, ties in row order.
    (The reference's merge compares raw floats, which a NaN key breaks.)

Every stage keeps the engine's "dropped, never silently lost" rule: the
per-chunk shuffle, local-operator, append and merge counters (summed
over ranks on the device) are summed across chunks on the host; each
operator returns ``(result, total_dropped)``.
"""
from __future__ import annotations

import math
from typing import Callable, Mapping, Sequence

import numpy as np
import torch

from . import dist_ops as D
from . import local_ops as L
from .context import HptmtContext
from .table import Table, flush_subnormals_np, narrow_column

__all__ = [
    "ChunkedTable",
    "chunked_dist_join",
    "chunked_dist_groupby",
    "chunked_dist_sort",
    "merge_sorted_runs",
]


class ChunkedTable:
    """Host-side chunked table: numpy columns streamed as fixed-size
    morsels.

    ``data`` maps column name -> 1-D numpy array (all equal length; a
    ``np.memmap`` works — chunks are slices, nothing is copied until a
    chunk is distributed).  ``chunk_rows`` is the morsel size: every
    chunk has exactly ``chunk_rows`` rows except the last (and a
    zero-row table yields exactly one empty chunk).
    """

    def __init__(self, data: Mapping[str, np.ndarray], chunk_rows: int):
        if chunk_rows <= 0:
            raise ValueError(f"chunk_rows must be positive, got "
                             f"{chunk_rows}")
        self.columns = {k: np.asarray(v) for k, v in data.items()}
        if not self.columns:
            raise ValueError("ChunkedTable needs at least one column")
        lengths = {k: len(v) for k, v in self.columns.items()}
        if len(set(lengths.values())) != 1:
            raise ValueError(f"columns must have equal length: {lengths}")
        self.nrows = next(iter(lengths.values()))
        self.chunk_rows = int(chunk_rows)

    @property
    def names(self) -> tuple[str, ...]:
        return tuple(self.columns.keys())

    @property
    def num_chunks(self) -> int:
        return max(1, math.ceil(self.nrows / self.chunk_rows))

    def chunk(self, i: int) -> dict[str, np.ndarray]:
        lo = i * self.chunk_rows
        hi = min(lo + self.chunk_rows, self.nrows)
        return {k: v[lo:hi] for k, v in self.columns.items()}

    def chunks(self):
        for i in range(self.num_chunks):
            yield self.chunk(i)

    def capacity_per_shard(self, world: int) -> int:
        """The fixed per-shard capacity one morsel needs — the same for
        every chunk (the last, smaller chunk reuses it)."""
        return max(1, math.ceil(self.chunk_rows / world))

    def distribute(self, ctx: HptmtContext,
                   capacity_per_shard: int | None = None):
        """Stream the chunks through ``distribute_table``: yields this
        rank's block of each morsel, all with the same static capacity."""
        cap = capacity_per_shard or self.capacity_per_shard(ctx.world_size)
        for chunk in self.chunks():
            yield D.distribute_table(ctx, chunk, capacity_per_shard=cap)


def _as_chunked(data, default_chunk_rows: int | None = None):
    if isinstance(data, ChunkedTable):
        return data
    n = len(next(iter(data.values())))
    return ChunkedTable(data, default_chunk_rows or max(n, 1))


def _dropped(d) -> int:
    """Host value of a drop counter already summed over ranks."""
    return int(d)


def _emit(parts: list, sink, out: dict):
    if sink is not None:
        sink(out)
    else:
        parts.append(out)


def _concat_parts(parts: list[dict] | None):
    if parts is None:
        return None
    cols: dict[str, list] = {}
    for p in parts:
        for k, v in p.items():
            cols.setdefault(k, []).append(v)
    return {k: np.concatenate(v) for k, v in cols.items()}


# --------------------------------------------------------------------------
# Chunked distributed join
# --------------------------------------------------------------------------


def chunked_dist_join(ctx: HptmtContext, left, right, *,
                      left_on: Sequence[str],
                      right_on: Sequence[str] | None = None,
                      how: str = "inner",
                      build: str = "resident",
                      out_capacity_per_shard: int | None = None,
                      build_capacity_per_shard: int | None = None,
                      overcommit: float = 2.0,
                      local_impl: str | None = None,
                      local_join_sizes: Mapping[str, int] | None = None,
                      sink: Callable[[dict], None] | None = None):
    """Morsel-driven distributed join: stream the probe (left) side in
    chunks against a build (right) side, past-device-memory sized.

    ``left`` / ``right`` are :class:`ChunkedTable` or plain column
    mappings.  ``build='resident'`` (default): the right side is
    shuffled once into a device-resident build block of capacity
    ``build_capacity_per_shard`` (default: rows-per-shard x
    ``overcommit``) — ``how='inner'|'left'``.  ``build='restream'``: the
    right side is re-streamed per probe morsel (block-nested loop; inner
    joins only).

    ``out_capacity_per_shard`` bounds one morsel's join output per shard
    (default: the shuffled probe-morsel capacity).  ``local_impl`` and
    ``local_join_sizes`` go to the local join, which keeps the sizes it
    is given.  Returns ``(columns, dropped)``: the host-side numpy result
    (chunk-major, rank-major within a chunk; the content equals the
    monolithic ``dist_join``'s) and the overflow total across every
    chunk's shuffle, local join and build append.  With ``sink`` each
    output morsel is handed to it instead and ``columns`` is None.
    """
    if how not in ("inner", "left"):
        raise ValueError("how must be 'inner' or 'left'")
    if build not in ("resident", "restream"):
        raise ValueError("build must be 'resident' or 'restream'")
    if build == "restream" and how != "inner":
        raise ValueError("build='restream' supports inner joins only: a "
                         "left join does not distribute over build "
                         "partition (unmatched rows would duplicate "
                         "per build morsel)")
    left_on = list(left_on)
    right_on = list(right_on) if right_on is not None else list(left_on)
    left = _as_chunked(left)
    right = _as_chunked(right)
    world = ctx.world_size
    pcap = left.capacity_per_shard(world)
    _, ploc = D.default_shuffle_sizes(ctx, pcap, overcommit)
    out_cap = out_capacity_per_shard or ploc
    sizes = dict(local_join_sizes or {})
    dropped = 0
    parts: list[dict] | None = None if sink is not None else []

    def local_join(c, probe, build_side, how):
        out, jd = L.join(probe, build_side, left_on=left_on,
                         right_on=right_on, how=how, out_capacity=out_cap,
                         impl=local_impl, return_overflow=True,
                         may_plan=False, **sizes)
        return out, c.psum(jd)

    if build == "resident":
        bcap = build_capacity_per_shard or max(
            1, math.ceil(right.nrows / world * overcommit))
        acc = D.distribute_table(
            ctx, {k: narrow_column(k, v[:0]) for k, v in
                  right.columns.items()},
            capacity_per_shard=bcap)

        def build_step(c, a, chunk):
            sh, d = D.shuffle(c, chunk, right_on, overcommit=overcommit)
            a2, ad = L.append_rows(a, sh)
            return a2, d + c.psum(ad)

        build_pipe = D.DistributedPipeline(ctx, build_step)
        for g in right.distribute(ctx):
            acc, d = build_pipe(acc, g)
            dropped += _dropped(d)

        def probe_step(c, b, chunk):
            sh, d = D.shuffle(c, chunk, left_on, overcommit=overcommit)
            out, jd = local_join(c, sh, b, how)
            return out, d + jd

        probe_pipe = D.DistributedPipeline(ctx, probe_step)
        for g in left.distribute(ctx):
            out, d = probe_pipe(acc, g)
            dropped += _dropped(d)
            _emit(parts, sink, D.collect_table(ctx, out))
        return _concat_parts(parts), dropped

    # restream: block-nested loop — shuffle each probe morsel once, join
    # it against every (re-shuffled) build morsel; inner joins are
    # additive over build partition, so the emitted morsels compose.
    shuffle_probe = D.DistributedPipeline(
        ctx, lambda c, t: D.shuffle(c, t, left_on, overcommit=overcommit))
    shuffle_build = D.DistributedPipeline(
        ctx, lambda c, t: D.shuffle(c, t, right_on, overcommit=overcommit))
    join_pipe = D.DistributedPipeline(
        ctx, lambda c, p, b: local_join(c, p, b, "inner"))
    for pg in left.distribute(ctx):
        psh, d = shuffle_probe(pg)
        dropped += _dropped(d)
        for bg in right.distribute(ctx):
            bsh, d = shuffle_build(bg)
            dropped += _dropped(d)
            out, d = join_pipe(psh, bsh)
            dropped += _dropped(d)
            _emit(parts, sink, D.collect_table(ctx, out))
    return _concat_parts(parts), dropped


# --------------------------------------------------------------------------
# Chunked distributed groupby (partial aggregates + associative merge)
# --------------------------------------------------------------------------


def chunked_dist_groupby(ctx: HptmtContext, table, by: Sequence[str],
                         aggs: Mapping[str, Sequence[str] | str], *,
                         group_capacity_per_shard: int | None = None,
                         overcommit: float = 2.0,
                         local_impl: str | None = None,
                         groupby_sizes: Mapping[str, int] | None = None):
    """Morsel-driven distributed GroupBy+Aggregate.

    Streams ``table`` (a :class:`ChunkedTable` or column mapping) chunk
    by chunk: shuffle on the keys, local partial aggregation, and an
    associative :func:`local_ops.merge_partial_aggregates` fold into a
    device-resident accumulator of ``group_capacity_per_shard`` groups
    per rank (default: the shuffled-morsel capacity; overflowing groups
    are dropped and counted).  ``groupby_sizes`` (the hash backend's
    ``num_buckets`` / ``bucket_capacity``) serve both the partial
    aggregation and the merge.  A key is pinned to one rank by the
    partition hash, so the final accumulator equals the monolithic
    ``dist_groupby`` result per rank.

    Returns ``(columns, dropped)``: the host-collected canonical result
    (one row per key, key-sorted within its rank) and the chunk-summed
    overflow total.
    """
    by = list(by)
    aggs_norm = {c: [ops] if isinstance(ops, str) else list(ops)
                 for c, ops in aggs.items()}
    partials = L.partial_agg_columns(aggs_norm)
    table = _as_chunked(table)
    world = ctx.world_size
    cap = table.capacity_per_shard(world)
    _, oc = D.default_shuffle_sizes(ctx, cap, overcommit)
    gcap = group_capacity_per_shard or oc
    sizes = dict(groupby_sizes or {})

    acc0 = {k: narrow_column(k, table.columns[k][:0]) for k in by}
    for col, ops in partials.items():
        for op in ops:
            dt = np.int32 if op == "count" else np.float32
            acc0[f"{col}_{op}"] = np.zeros(0, dt)
    acc = D.distribute_table(ctx, acc0, capacity_per_shard=gcap)

    def step(c, a, chunk):
        sh, d1 = D.shuffle(c, chunk, by, overcommit=overcommit)
        part, d2 = L.groupby_aggregate(sh, by, partials, impl=local_impl,
                                       return_overflow=True, may_plan=False,
                                       **sizes)
        merged, d3 = L.merge_partial_aggregates(a, part, by,
                                                impl=local_impl,
                                                return_overflow=True,
                                                **sizes)
        return merged, d1 + c.psum(d2 + d3)

    pipe = D.DistributedPipeline(ctx, step)
    dropped = 0
    for g in table.distribute(ctx):
        acc, d = pipe(acc, g)
        dropped += _dropped(d)

    cols = {k: acc.columns[k] for k in by}
    for col, ops in aggs_norm.items():
        for op in ops:
            if op == "mean":
                cnt = acc.columns[f"{col}_count"]
                v = acc.columns[f"{col}_sum"] / \
                    cnt.clamp(min=1).to(torch.float32)
            else:
                v = acc.columns[f"{col}_{op}"]
            cols[f"{col}_{op}"] = v
    return D.collect_table(ctx, Table(columns=cols, nvalid=acc.nvalid)), \
        dropped


# --------------------------------------------------------------------------
# Chunked distributed sort (sorted runs + stable host k-way merge)
# --------------------------------------------------------------------------


def _np_sort_key(col: np.ndarray, ascending: bool) -> np.ndarray:
    """Host mirror of ``local_ops._sort_key`` (order-reversal transform)."""
    if ascending:
        return col
    if np.issubdtype(col.dtype, np.floating):
        return -col
    return ~col


def _np_sortable_word(key: np.ndarray) -> np.ndarray:
    """Host mirror of ``local_ops._sortable_word``: integers whose order
    is the monolithic sort's order of ``key``.  A float key compares as
    the engine's float32 (``-0.0``, ``+0.0`` and the subnormals equal,
    every NaN equal and last); an integer key as itself."""
    if not np.issubdtype(key.dtype, np.floating):
        return key.astype(np.int64)
    f = flush_subnormals_np(key.astype(np.float32))
    f = np.where(np.isnan(f), np.float32(np.nan), f)
    bits = f.view(np.int32)
    return np.where(bits < 0, bits ^ np.int32(0x7FFFFFFF), bits)


def _np_tuple_less(a: tuple, b: tuple) -> np.ndarray:
    res = np.zeros(a[0].shape, bool)
    eq = np.ones(a[0].shape, bool)
    for x, y in zip(a, b):
        res = res | (eq & (x < y))
        eq = eq & (x == y)
    return res


def _np_lex_searchsorted(sorted_keys: tuple, query_keys: tuple,
                         side: str) -> np.ndarray:
    """Host mirror of ``local_ops.lex_searchsorted`` over parallel
    lexicographically sorted integer word columns (``np.searchsorted``
    for one column, a vectorised binary search for several)."""
    if len(sorted_keys) == 1:
        return np.searchsorted(sorted_keys[0], query_keys[0],
                               side=side).astype(np.int64)
    n = len(sorted_keys[0])
    m = len(query_keys[0])
    lo = np.zeros(m, np.int64)
    hi = np.full(m, n, np.int64)
    iters = max(1, int(n - 1).bit_length() + 1) if n > 0 else 0
    for _ in range(iters):
        mid = (lo + hi) // 2
        midc = np.clip(mid, 0, max(n - 1, 0))
        at_mid = tuple(k[midc] for k in sorted_keys)
        if side == "left":
            go_right = _np_tuple_less(at_mid, query_keys)
        else:
            go_right = ~_np_tuple_less(query_keys, at_mid)
        go_right = go_right & (mid < hi)
        lo = np.where(go_right, mid + 1, lo)
        hi = np.where(go_right, hi, mid)
    return lo


def _merge_two_runs(a: dict, b: dict, by: list, ascending: bool) -> dict:
    ak = tuple(_np_sortable_word(_np_sort_key(a[k], ascending)) for k in by)
    bk = tuple(_np_sortable_word(_np_sort_key(b[k], ascending)) for k in by)
    n, m = len(ak[0]), len(bk[0])
    # stable positions: a row i lands at i + |b rows strictly less|,
    # b row j at j + |a rows less-or-equal| — a (the earlier run) wins ties
    pos_a = np.arange(n) + _np_lex_searchsorted(bk, ak, "left")
    pos_b = np.arange(m) + _np_lex_searchsorted(ak, bk, "right")
    # the words are totally ordered, so the positions are a permutation:
    # n + m writes that reach every slot write each exactly once
    hit = np.zeros(n + m, bool)
    hit[pos_a] = True
    hit[pos_b] = True
    assert hit.all(), "run merge positions are not a permutation"
    out = {}
    for k in a:
        col = np.empty(n + m, a[k].dtype)
        col[pos_a] = a[k]
        col[pos_b] = b[k]
        out[k] = col
    return out


def merge_sorted_runs(runs: list[dict], by: Sequence[str],
                      ascending: bool = True) -> dict:
    """Stable k-way merge of sorted runs (host-side, vectorised).

    Adjacent pairwise merges keep run order, so ties resolve to the
    earlier run — the monolithic sort's row order when runs are
    consecutive chunks.  Keys compare as the monolithic sort compares
    them (:func:`_np_sortable_word`)."""
    by = list(by)
    if not runs:
        return {}
    runs = list(runs)
    while len(runs) > 1:
        nxt = []
        for i in range(0, len(runs) - 1, 2):
            nxt.append(_merge_two_runs(runs[i], runs[i + 1], by, ascending))
        if len(runs) % 2:
            nxt.append(runs[-1])
        runs = nxt
    return runs[0]


def chunked_dist_sort(ctx: HptmtContext, table, by: Sequence[str],
                      ascending: bool = True, *,
                      n_samples: int = 32, overcommit: float = 2.0,
                      local_impl: str | None = None):
    """Morsel-driven distributed OrderBy: each chunk runs the full
    sample sort (``dist_sort``) into a globally sorted host run; runs
    fold through the stable k-way merge.  Equal to the monolithic
    ``dist_sort``, equal keys tied in row order, float keys ordered as
    it orders them.  Returns ``(columns, dropped)``.
    """
    by = list(by)
    table = _as_chunked(table)
    pipe = D.DistributedPipeline(
        ctx, lambda c, t: D.dist_sort(c, t, by, ascending=ascending,
                                      n_samples=n_samples,
                                      overcommit=overcommit,
                                      local_impl=local_impl))
    runs, dropped = [], 0
    for g in table.distribute(ctx):
        out, d = pipe(g)
        dropped += _dropped(d)
        runs.append(D.collect_table(ctx, out))
    return merge_sorted_runs(runs, by, ascending), dropped
