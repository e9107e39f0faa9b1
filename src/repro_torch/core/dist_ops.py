"""Distributed HPTMT table operators (paper Table 5).

PyTorch port of ``repro/core/dist_ops.py``: every distributed operator is
*communication ∘ local operator*.

* :func:`shuffle_by_pid` — hash partition (``hash_partition`` kernel), one
  stacked send scatter, one ``all_to_all``, a cumsum receive compaction;
  :func:`shuffle` hashes the key columns first;
* :func:`dist_join` — shuffle both sides on the key, then the local join
  (``sortmerge`` or ``hash``); or, with ``strategy="broadcast"``, gather
  the right side everywhere (:func:`all_gather_table`) and join locally;
* :func:`dist_groupby` / :func:`dist_unique` — shuffle on the key, then
  the local groupby / drop_duplicates (``sort`` or ``hash``);
* :func:`dist_isin` / :func:`dist_intersect` / :func:`dist_difference` —
  shuffle both sides on the key, then the local membership
  (``sortmerge`` or ``hash``);
* :func:`dist_standard_scale` — column scaling with global moments;
* :func:`dist_sort` — sample sort: local sort, splitters from gathered
  samples, range partition, shuffle, local sort (``xla`` or ``radix``);
* :func:`dist_repartition` — exact load rebalance;
* :func:`plan_dist_join_sizes` — every static capacity of the join, sized
  exactly from the keys on the host.

The local hash backends never re-plan their sizes here: they keep the
sizes the caller gives (``may_plan=False``), as the reference's traced
operators do.

A rank is one process with one device; tables here are that rank's block
(``distribute_table``) and come back together through
:func:`collect_table`.  At world size 1 the shuffle still runs every step
— kernel, send scatter, the (identity) exchange and the compaction.

Static-shape contract: a shuffle routes at most ``slots_per_dest`` rows
from one sender to one receiver and keeps at most ``out_capacity`` rows
per receiver; overflowing rows are dropped and counted.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Mapping, Sequence

import numpy as np
import torch

from . import local_ops as L
from .context import HptmtContext
from .kernel_backend import sort_impl as _default_sort_impl
from .partition import hash_columns_np, partition_ids
from .table import Table, narrow_column
from ..kernels import bucketing as _bucketing
from ..kernels.hash_partition import radix_histogram_ranks
from ..kernels.radix_sort import stable_partition_perm

# --------------------------------------------------------------------------
# host <-> rank adapters
# --------------------------------------------------------------------------


def distribute_table(ctx: HptmtContext, data: Mapping[str, np.ndarray],
                     capacity_per_shard: int | None = None) -> Table:
    """This rank's block of the rows of numpy columns, on ``ctx.device``.

    Rows are block-distributed over the ranks (the paper's row
    decomposition).  Columns follow the engine dtype contract: floats
    narrow to float32, integers outside int32 raise.
    ``capacity_per_shard=None`` means rows-per-shard; an explicit
    non-positive capacity is an error."""
    world = ctx.world_size
    arrays = {k: np.asarray(v) for k, v in data.items()}
    n = len(next(iter(arrays.values())))
    per = math.ceil(n / world) if n else 1
    if capacity_per_shard is None:
        cap = per
    else:
        if capacity_per_shard <= 0:
            raise ValueError(
                f"capacity_per_shard must be positive, got "
                f"{capacity_per_shard} (pass None for rows-per-shard)")
        cap = capacity_per_shard
    if cap < per:
        raise ValueError(f"capacity_per_shard {cap} < rows/shard {per}")
    lo, hi = min(ctx.rank * per, n), min((ctx.rank + 1) * per, n)
    cols = {}
    for k, v in arrays.items():
        v = narrow_column(k, v)
        buf = np.zeros(cap, v.dtype)
        buf[: hi - lo] = v[lo:hi]
        cols[k] = torch.from_numpy(buf).to(ctx.device)
    return Table(columns=cols, nvalid=torch.tensor(
        hi - lo, dtype=torch.int32, device=ctx.device))


def collect_table(ctx: HptmtContext, table: Table) -> dict[str, np.ndarray]:
    """Every rank's valid rows, in rank order, as numpy columns (a
    collective: every rank calls it and gets the whole table)."""
    nvalid = [int(n) for n in ctx.all_gather(table.nvalid.reshape(1))]
    out = {}
    for k, v in table.columns.items():
        parts = ctx.all_gather(v)
        out[k] = np.concatenate([p[:n].cpu().numpy()
                                 for p, n in zip(parts, nvalid)])
    return out


# --------------------------------------------------------------------------
# The shuffle — HPTMT's Table communication operator (paper Table 4)
# --------------------------------------------------------------------------


def shuffle_by_pid(ctx: HptmtContext, table: Table, pid: torch.Tensor,
                   slots_per_dest: int, out_capacity: int):
    """Route each valid row to rank ``pid[row]`` through one all-to-all.

    Returns ``(table, dropped)`` where ``dropped`` counts rows lost to the
    static ``slots_per_dest`` / ``out_capacity`` bounds, summed over all
    ranks (0 when sized right)."""
    world = ctx.world_size
    valid = table.valid_mask
    names = table.names
    dev = table.device
    # trash partition `world` for padding rows
    pid = torch.where(valid, pid, world)
    hist, ranks = radix_histogram_ranks(pid, world + 1)
    ok = valid & (ranks < slots_per_dest) & (pid < world)
    nslots = world * slots_per_dest
    flat = torch.where(ok, pid.to(torch.int64) * slots_per_dest + ranks,
                       nslots)

    # send side: every column (viewed as an int32 plane) plus the occupancy
    # plane land in the (ncols+1, nslots) send slabs through ONE stacked
    # scatter; slot nslots is the trash column
    planes = [_bucketing.pack_i32(table.columns[n]) for n in names] \
        + [ok.to(torch.int32)]
    send = (torch.zeros((len(planes), nslots + 1), dtype=torch.int32,
                        device=dev)
            .index_copy_(1, flat, torch.stack(planes))[:, :nslots])
    # ONE all-to-all moves all columns: block d goes to rank d
    send = send.reshape(len(planes), world, slots_per_dest).transpose(0, 1)
    recv = ctx.all_to_all(send.contiguous()).transpose(0, 1) \
        .reshape(len(planes), nslots)
    recv_valid = recv[-1] > 0
    n_recv = recv_valid.sum(dtype=torch.int32)
    # receive side: each valid row's slot is its rank among valid rows in
    # slot order (cumsum); one stacked scatter writes all columns
    pos = torch.cumsum(recv_valid.to(torch.int32), 0, dtype=torch.int32) - 1
    okr = recv_valid & (pos < out_capacity)
    dest = torch.where(okr, pos.to(torch.int64), out_capacity)
    out = (torch.zeros((len(names), out_capacity + 1), dtype=torch.int32,
                       device=dev)
           .index_copy_(1, dest, recv[:-1])[:, :out_capacity])
    cols = {n: _bucketing.unpack_i32(out[i], table.columns[n].dtype)
            for i, n in enumerate(names)}
    compacted = Table(columns=cols,
                      nvalid=torch.clamp(n_recv, max=out_capacity))
    sent_dropped = (hist[:world] - slots_per_dest).clamp(min=0).sum(
        dtype=torch.int32)
    recv_dropped = (n_recv - out_capacity).clamp(min=0)
    dropped = ctx.psum(sent_dropped) + ctx.psum(recv_dropped)
    return compacted, dropped


def default_shuffle_sizes(ctx: HptmtContext, capacity: int,
                          overcommit: float = 2.0):
    world = ctx.world_size
    slots = max(1, math.ceil(capacity * overcommit / world))
    out_cap = max(capacity, math.ceil(capacity * overcommit))
    return slots, out_cap


def _pad8(load: float, headroom: float) -> int:
    """Observed load -> static capacity: headroom cushion, 8-aligned."""
    return max(8, -(-int(math.ceil(load * headroom)) // 8) * 8)


def plan_dist_join_sizes(left_keys: Sequence[np.ndarray],
                         right_keys: Sequence[np.ndarray], *, world: int,
                         how: str = "inner", headroom: float = 1.25,
                         local_impl: str | None = None,
                         num_buckets: int | None = None) -> dict:
    """Host-side capacity plan for a shuffle-strategy :func:`dist_join`.

    Sizes the shuffle slabs, the join output and — under the hash local
    backend — the per-bucket build/probe slab depths from the actual key
    distributions.  Equal keys co-locate, so per-destination and
    per-bucket loads are exact whatever the sender split.  Every bound is
    the observed maximum times ``headroom``, rounded up to a multiple of
    8.  The numpy hash chains equal the device's bit for bit.

    Returns ``{"shuffle_sizes": {"left": (slots_per_dest, out_capacity),
    "right": ...}, "out_capacity": ..., "local_join_sizes": ...}`` —
    keyword-compatible with :func:`dist_join`."""
    lcols = [narrow_column(f"k{i}", np.asarray(c))
             for i, c in enumerate(left_keys)]
    rcols = [narrow_column(f"k{i}", np.asarray(c))
             for i, c in enumerate(right_keys)]
    nl = len(lcols[0])
    # partition ids with each side's own dtype (what the shuffle hashes) ...
    pid = np.concatenate([
        (hash_columns_np(lcols) % np.uint32(world)).astype(np.int64),
        (hash_columns_np(rcols) % np.uint32(world)).astype(np.int64)])
    # ... but key identity in the promoted common dtype (what the local
    # join compares)
    planes = []
    for lc, rc in zip(lcols, rcols):
        dt = np.promote_types(lc.dtype, rc.dtype)
        dt = np.float32 if np.issubdtype(dt, np.floating) else np.int32
        planes.append(_bucketing.key_bits_np(
            np.concatenate([lc.astype(dt), rc.astype(dt)])))
    bits = np.stack(planes, axis=1)                       # (nl+nr, K)
    if bits.shape[1] == 1:
        # the same groups as the row-wise unique below, many times faster
        uniq, first, inv = np.unique(bits[:, 0], return_index=True,
                                     return_inverse=True)
        uniq = uniq[:, None]
    else:
        uniq, first, inv = np.unique(bits, axis=0, return_index=True,
                                     return_inverse=True)
    inv = inv.reshape(-1)
    n_uniq = uniq.shape[0]
    cl = np.bincount(inv[:nl], minlength=n_uniq).astype(np.float64)
    cr = np.bincount(inv[nl:], minlength=n_uniq).astype(np.float64)
    upid = pid[first]

    def _side(counts):
        recv = np.bincount(upid, weights=counts, minlength=world)
        cap = _pad8(recv.max() if n_uniq else 0, headroom)
        return cap, cap        # slots_per_dest bound == receive capacity

    lsizes, rsizes = _side(cl), _side(cr)
    matches = cl * cr
    if how == "left":
        matches = matches + np.where(cr == 0, cl, 0)
    per_dest = np.bincount(upid, weights=matches, minlength=world)
    out_cap = _pad8(per_dest.max() if n_uniq else 0, headroom)

    local_sizes = None
    if local_impl == "hash":
        B = num_buckets or _bucketing.default_bucket_count(
            max(lsizes[1], rsizes[1]))
        ubid = _bucketing.bucket_ids_np(
            [uniq[:, k] for k in range(uniq.shape[1])], B).astype(np.int64)
        db = upid * B + ubid
        local_sizes = dict(
            num_buckets=B,
            bucket_capacity=_pad8(
                np.bincount(db, weights=cr, minlength=world * B).max()
                if n_uniq else 0, headroom),
            probe_capacity=_pad8(
                np.bincount(db, weights=cl, minlength=world * B).max()
                if n_uniq else 0, headroom))
    return {"shuffle_sizes": {"left": lsizes, "right": rsizes},
            "out_capacity": out_cap, "local_join_sizes": local_sizes}


def shuffle(ctx: HptmtContext, table: Table, key_cols: Sequence[str], *,
            overcommit: float = 2.0, slots_per_dest: int | None = None,
            out_capacity: int | None = None):
    """Hash shuffle: co-locate equal keys on the same rank."""
    s, oc = default_shuffle_sizes(ctx, table.capacity, overcommit)
    pid = partition_ids(table, list(key_cols), ctx.world_size)
    return shuffle_by_pid(ctx, table, pid, slots_per_dest or s,
                          out_capacity or oc)


# --------------------------------------------------------------------------
# Distributed join = shuffle + local join (paper Fig. 4)
# --------------------------------------------------------------------------


def dist_join(ctx: HptmtContext, left: Table, right: Table, *,
              left_on: Sequence[str], right_on: Sequence[str] | None = None,
              how: str = "inner", out_capacity: int | None = None,
              overcommit: float = 2.0, strategy: str = "shuffle",
              local_impl: str | None = None,
              local_join_sizes: Mapping[str, int] | None = None,
              shuffle_sizes: Mapping[str, tuple[int, int]] | None = None):
    """Distributed join (paper Fig. 4 operator).

    ``strategy="shuffle"``: hash-shuffle both sides on the key, then join
    locally.  ``strategy="broadcast"``: gather the (small) right side on
    every rank and join locally, with no shuffle of the left side.

    ``local_impl`` selects the local backend ('sortmerge' | 'hash');
    ``local_join_sizes`` forwards the hash backend's static sizing;
    ``shuffle_sizes`` gives explicit per-side ``(slots_per_dest,
    out_capacity)`` bounds instead of the ``overcommit`` heuristic —
    :func:`plan_dist_join_sizes` computes all of them.  Returns ``(table,
    dropped)`` with the rows lost anywhere, summed over ranks."""
    right_on = list(right_on) if right_on is not None else list(left_on)
    jkw = dict(local_join_sizes or {})
    if strategy == "broadcast":
        g = all_gather_table(ctx, right)
        out, jdrop = L.join(left, g, left_on=list(left_on),
                            right_on=right_on, how=how,
                            out_capacity=out_capacity or left.capacity,
                            impl=local_impl, return_overflow=True,
                            may_plan=False, **jkw)
        return out, ctx.psum(jdrop)
    if strategy != "shuffle":
        raise ValueError(f"unknown join strategy {strategy!r}")
    # hash both sides with the same key columns -> same pid function
    lp = partition_ids(left, list(left_on), ctx.world_size)
    rp_tbl = right.rename(dict(zip(right_on, left_on))) \
        if right_on != list(left_on) else right
    rp = partition_ids(rp_tbl, list(left_on), ctx.world_size)
    if shuffle_sizes is not None:
        ls, loc = shuffle_sizes["left"]
        rs, roc = shuffle_sizes["right"]
    else:
        ls, loc = default_shuffle_sizes(ctx, left.capacity, overcommit)
        rs, roc = default_shuffle_sizes(ctx, right.capacity, overcommit)
    lsh, ldrop = shuffle_by_pid(ctx, left, lp, ls, loc)
    rsh, rdrop = shuffle_by_pid(ctx, right, rp, rs, roc)
    # the local join never re-plans here: its sizes are the caller's
    out, jdrop = L.join(lsh, rsh, left_on=list(left_on), right_on=right_on,
                        how=how, out_capacity=out_capacity or loc,
                        impl=local_impl, return_overflow=True,
                        may_plan=False, **jkw)
    return out, ldrop + rdrop + ctx.psum(jdrop)


def dist_groupby(ctx: HptmtContext, table: Table, by: Sequence[str],
                 aggs: Mapping[str, Sequence[str] | str],
                 overcommit: float = 2.0, local_impl: str | None = None,
                 groupby_sizes: Mapping[str, int] | None = None):
    """Distributed GroupBy + Aggregate: shuffle on the keys, then the
    local groupby (``local_impl`` 'sort' | 'hash'; ``groupby_sizes``
    gives the hash backend's ``num_buckets`` / ``bucket_capacity``).
    Means come from the shuffled raw rows, so they are exact.  Returns
    ``(table, dropped)``, drops summed over ranks."""
    sh, dropped = shuffle(ctx, table, by, overcommit=overcommit)
    out, gdrop = L.groupby_aggregate(sh, list(by), aggs, impl=local_impl,
                                     return_overflow=True, may_plan=False,
                                     **dict(groupby_sizes or {}))
    return out, dropped + ctx.psum(gdrop)


def dist_unique(ctx: HptmtContext, table: Table, subset: Sequence[str],
                overcommit: float = 2.0, local_impl: str | None = None,
                groupby_sizes: Mapping[str, int] | None = None):
    """Paper §4.3's distributed unique: no duplicate record survives
    across ranks.  Shuffle on the key, then the local drop_duplicates
    (under 'hash' a key-only hash groupby sized by ``groupby_sizes``)."""
    sh, dropped = shuffle(ctx, table, subset, overcommit=overcommit)
    out, gdrop = L.drop_duplicates(sh, list(subset), impl=local_impl,
                                   return_overflow=True, may_plan=False,
                                   **dict(groupby_sizes or {}))
    return out, dropped + ctx.psum(gdrop)


def dist_difference(ctx: HptmtContext, a: Table, b: Table,
                    on: Sequence[str], overcommit: float = 2.0,
                    local_impl: str | None = None,
                    semi_sizes: Mapping[str, int] | None = None):
    """Distributed Difference: shuffle both sides on the key, then the
    local difference.  Equal keys co-locate (the partition hash is over
    key values), so a rank's membership is global membership.
    ``local_impl`` picks the semi-join backend ('sortmerge' | 'hash');
    ``semi_sizes`` gives the hash backend's ``num_buckets`` /
    ``bucket_capacity`` / ``probe_capacity``.  Slab overflow joins the
    shuffle drops in the returned counter, summed over ranks."""
    ash, d1 = shuffle(ctx, a, on, overcommit=overcommit)
    bsh, d2 = shuffle(ctx, b, on, overcommit=overcommit)
    out, over = L.difference(ash, bsh, on=list(on), impl=local_impl,
                             return_overflow=True, may_plan=False,
                             **dict(semi_sizes or {}))
    return out, d1 + d2 + ctx.psum(over)


def dist_intersect(ctx: HptmtContext, a: Table, b: Table,
                   on: Sequence[str], overcommit: float = 2.0,
                   local_impl: str | None = None,
                   dedup_impl: str | None = None,
                   semi_sizes: Mapping[str, int] | None = None):
    """Distributed Intersect: shuffle both sides on the key, then the
    local intersect (``local_impl`` the semi-join backend, ``dedup_impl``
    the dedup backend).  Returns ``(table, dropped)`` as
    :func:`dist_difference`."""
    ash, d1 = shuffle(ctx, a, on, overcommit=overcommit)
    bsh, d2 = shuffle(ctx, b, on, overcommit=overcommit)
    out, over = L.intersect(ash, bsh, on=list(on), impl=local_impl,
                            dedup_impl=dedup_impl, return_overflow=True,
                            may_plan=False, **dict(semi_sizes or {}))
    return out, d1 + d2 + ctx.psum(over)


def dist_isin(ctx: HptmtContext, table: Table, col: str, values: Table,
              values_col: str, overcommit: float = 2.0,
              local_impl: str | None = None,
              semi_sizes: Mapping[str, int] | None = None):
    """Distributed membership filter: the rows of ``table`` whose ``col``
    is among ``values[values_col]`` anywhere in the world.  Both sides
    are shuffled on their key column (the hash is over values, not
    names), then the local :func:`isin` mask selects.  Returns
    ``(filtered_table, dropped)`` as :func:`dist_difference`."""
    tsh, d1 = shuffle(ctx, table, [col], overcommit=overcommit)
    vsh, d2 = shuffle(ctx, values, [values_col], overcommit=overcommit)
    mask, over = L.isin(tsh, col, vsh, values_col, impl=local_impl,
                        return_overflow=True, may_plan=False,
                        **dict(semi_sizes or {}))
    return L.select(tsh, mask), d1 + d2 + ctx.psum(over)


# --------------------------------------------------------------------------
# Distributed sort (sample sort) — paper Table 5 "Sorting tables"
# --------------------------------------------------------------------------


def dist_sort(ctx: HptmtContext, table: Table, by: Sequence[str],
              ascending: bool = True, n_samples: int = 32,
              overcommit: float = 2.0, local_impl: str | None = None):
    """Sample sort: local sort, splitter all_gather, range partition,
    all_to_all, local sort.  Globally sorted = rank order + local order.

    ``local_impl`` ('xla' | 'radix', default ``REPRO_SORT_IMPL``) sorts
    before and after the shuffle; under 'radix' the gathered splitter
    candidates are ranked by the radix engine too.  Both give the same
    splitters, routing and local order.  Returns ``(table, dropped)``."""
    by = list(by)
    impl = local_impl or _default_sort_impl()
    world = ctx.world_size
    ts = L.sort_values(table, by, ascending=ascending, impl=impl)
    cap = ts.capacity
    dev = ts.device
    s = min(n_samples, cap)
    # evenly sample valid rows (the clamp handles nvalid < s)
    pos = (torch.arange(s, device=dev) * ts.nvalid.clamp(min=1)) // s
    pos = pos.clamp(0, cap - 1)
    valid_s = torch.arange(s, device=dev) < ts.nvalid.clamp(max=s)
    sample_keys = []
    for k in by:
        col = L._sort_key(ts.columns[k], ascending)[pos]
        sample_keys.append(torch.where(valid_s, col, L._sentinel_max(col)))
    # the gathered candidates, sorted by the same backend
    samples = Table(columns={k: torch.cat(ctx.all_gather(c))
                             for k, c in zip(by, sample_keys)},
                    nvalid=torch.tensor(world * s, dtype=torch.int32,
                                        device=dev))
    sorted_samples = L.sort_values(samples, by, impl=impl)
    sorted_keys = tuple(sorted_samples.columns[k] for k in by)
    # world-1 splitters at quantile positions
    spl_pos = (torch.arange(1, world, device=dev) * (world * s)) // world
    splitters = tuple(c[spl_pos] for c in sorted_keys)
    row_keys = tuple(
        torch.where(ts.valid_mask, L._sort_key(ts.columns[k], ascending),
                    L._sentinel_max(ts.columns[k]))
        for k in by)
    pid = _rank_against_splitters(splitters, row_keys)
    slots, out_cap = default_shuffle_sizes(ctx, cap, overcommit)
    sh, dropped = shuffle_by_pid(ctx, ts, pid, slots, out_cap)
    return L.sort_values(sh, by, ascending=ascending, impl=impl), dropped


def _rank_against_splitters(splitters: tuple,
                            row_keys: tuple) -> torch.Tensor:
    """pid = number of splitters <= key (vectorized lex compare)."""
    cap = row_keys[0].shape[0]
    pid = torch.zeros(cap, dtype=torch.int32, device=row_keys[0].device)
    for i in range(splitters[0].shape[0]):
        spl = tuple(s[i].expand(cap) for s in splitters)
        pid = pid + (~L._tuple_less(row_keys, spl)).to(torch.int32)
    return pid


# --------------------------------------------------------------------------
# Repartition / rebalance — skew (straggler) mitigation
# --------------------------------------------------------------------------


def dist_repartition(ctx: HptmtContext, table: Table):
    """Exact load rebalance: the row of global rank r goes to rank
    r // ceil(N / world), with one all_to_all.  A sender gives one
    destination at most min(capacity, target) rows and a destination
    receives at most target <= capacity, so the capacities never drop."""
    world = ctx.world_size
    dev = table.device
    counts = torch.cat(ctx.all_gather(table.nvalid.reshape(1)))
    prefix = counts[:ctx.rank].sum()
    total = counts.sum()
    target = ((total + world - 1) // world).clamp(min=1)
    r = prefix + torch.arange(table.capacity, dtype=torch.int32, device=dev)
    pid = (r // target).clamp(max=world - 1).to(torch.int32)
    return shuffle_by_pid(ctx, table, pid, slots_per_dest=table.capacity,
                          out_capacity=table.capacity)


# --------------------------------------------------------------------------
# Column scaling with global moments (scikit-learn's StandardScaler)
# --------------------------------------------------------------------------


def dist_standard_scale(ctx: HptmtContext, table: Table,
                        cols: Sequence[str],
                        local_impl: str | None = None) -> Table:
    """(x - mean) / std per column with the mean and std over every
    rank's valid rows, so the result does not depend on the world size.
    Two-pass as the local op: global means from summed sums, then the
    summed variance of deviations about them.  ``local_impl`` selects how
    each rank sums its moments (``L.column_moments``: inline, 'sort' or
    'hash')."""
    s1, _, n = L.column_moments(table, cols, impl=local_impl)
    n = ctx.psum(n).clamp(min=1.0)
    means = {k: ctx.psum(s1[k]) / n for k in cols}
    _, sd2, _ = L.column_moments(table, cols, impl=local_impl,
                                 center=means)
    return L._scale_columns(table, cols, means,
                            {k: ctx.psum(sd2[k]) / n for k in cols})


# --------------------------------------------------------------------------
# Broadcast of tables (paper Table 4: Broadcast for tables)
# --------------------------------------------------------------------------


def all_gather_table(ctx: HptmtContext, table: Table) -> Table:
    """Replicate a (small) table on every rank: capacity * world rows,
    the valid rows compacted to the front by the 1-bit radix pass."""
    cols = {k: torch.cat(ctx.all_gather(v))
            for k, v in table.columns.items()}
    gvalid = torch.cat(ctx.all_gather(table.valid_mask.to(torch.int32))) > 0
    perm = stable_partition_perm(gvalid)
    return Table(columns={k: v[perm] for k, v in cols.items()},
                 nvalid=gvalid.sum(dtype=torch.int32))


@dataclasses.dataclass
class DistributedPipeline:
    """Run a table pipeline ``fn(ctx, *tables)`` on this rank — the
    counterpart of the reference's single-program runner.  PyTorch runs
    eagerly, so there is nothing to trace or cache: each call runs ``fn``
    on the rank's tables."""

    ctx: HptmtContext
    fn: Callable

    def __call__(self, *tables: Table):
        return self.fn(self.ctx, *tables)
