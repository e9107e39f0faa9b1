"""The port's three kernels and the hashing around them against the JAX
package, exactly.

On the CPU each wrapper runs its plain PyTorch version; these tests hold
it to the JAX ``ref`` and to the JAX Pallas kernel run in interpret mode
with a small explicit ``tile`` (n above it and not a multiple of it, so
the tiled path really runs).  The cross-tile composition the CUDA wrappers
use (``add_tile_offsets``) is fed the JAX kernel's own per-tile outputs.
The CUDA kernels are held to these plain versions on the card by
``tests/test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import partition as JP
from repro.kernels import bucketing as JB
from repro.kernels.fused_bucketing import fused_bucket_ranks as j_fused
from repro.kernels.fused_bucketing.kernel import fused_bucket_ranks_tiles
from repro.kernels.hash_join import default_hash_join_sizes as j_hj_sizes
from repro.kernels.hash_join import hash_join_plan as j_hj_plan
from repro.kernels.hash_join.kernel import bucket_probe_buckets
from repro.kernels.hash_join.ref import bucket_probe_ref as jh_ref
from repro.kernels.hash_partition import partition_plan as j_plan
from repro.kernels.hash_partition import radix_histogram_ranks as j_rank
from repro.kernels.hash_partition.kernel import radix_histogram_ranks_tiles
from repro_torch.core import partition as TP
from repro_torch.kernels import bucketing as TB
from repro_torch.kernels.fused_bucketing import fused_bucket_ranks
from repro_torch.kernels.fused_bucketing.ref import (bucket_ids,
                                                     fused_bucket_ranks_ref)
from repro_torch.kernels.hash_join import (default_hash_join_sizes,
                                           hash_join_plan)
from repro_torch.kernels.hash_join.ops import bucket_probe
from repro_torch.kernels.hash_partition import (partition_plan,
                                                radix_histogram_ranks)
from repro_torch.kernels.hash_partition.ref import (
    add_tile_offsets, radix_histogram_ranks_ref)

TILE = 128
N = 300          # > TILE and not a multiple of it


def t(a):
    return torch.from_numpy(np.array(a))


def same(j, x):
    """JAX array == torch tensor, exactly, dtype included."""
    j, x = np.asarray(j), x.numpy()
    assert j.dtype == x.dtype, (j.dtype, x.dtype)
    np.testing.assert_array_equal(j, x)


def key_planes(rng, n, k, kind):
    """K int32 bit-planes: negative ints, or float bits with -0.0/NaN."""
    if kind == "int":
        return [rng.integers(-40, 40, n).astype(np.int32) for _ in range(k)]
    out = []
    for _ in range(k):
        f = rng.choice(np.array([0.0, -0.0, np.nan, 1.5, -2.25, np.inf],
                                np.float32), n)
        out.append(f.view(np.int32))
    return out


# --------------------------------------------------------------------------
# hash_partition
# --------------------------------------------------------------------------


@pytest.mark.parametrize("P", [2, 9, 513])
def test_radix_histogram_ranks_matches_jax(P, rng):
    pid = rng.integers(0, P, N).astype(np.int32)
    th, tr = radix_histogram_ranks(t(pid), P)
    for impl in ("ref", "pallas_interpret"):
        jh, jr = j_rank(jnp.asarray(pid), P, impl=impl, tile=TILE)
        same(jh, th)
        same(jr, tr)
    jh, jd = j_plan(jnp.asarray(pid), P, impl="ref")
    th, td = partition_plan(t(pid), P)
    same(jh, th)
    same(jd, td)


@pytest.mark.parametrize("P", [2, 9, 513])
def test_tile_offsets_compose_the_jax_kernel_tiles(P, rng):
    """Per-tile outputs of the TPU kernel (ragged tail as ids outside
    [0, P), which it neither counts nor ranks) + the port's cross-tile
    scan == the whole-array ranking."""
    pid = rng.integers(0, P, N).astype(np.int32)
    n_tiles = -(-N // TILE)
    padded = np.full(n_tiles * TILE, P, np.int32)
    padded[:N] = pid
    hist_t, rank_t = radix_histogram_ranks_tiles(
        jnp.asarray(padded.reshape(n_tiles, TILE)), P, interpret=True)
    hist, ranks = add_tile_offsets(
        t(np.asarray(hist_t)), t(np.asarray(rank_t).reshape(-1)[:N]),
        t(pid), P, TILE)
    wh, wr = radix_histogram_ranks_ref(t(pid), P)
    assert torch.equal(hist, wh) and torch.equal(ranks, wr)


def blocked_ranks(pid, P, tile, per):
    """The counting pass of the CUDA launches in plain torch: per-block
    histograms over ``per`` tiles of ``tile`` rows, their exclusive scan
    over blocks for each id, then each row's rank in its tile plus the
    rows of its id in earlier blocks and in earlier tiles of its block.
    An id outside [0, P) is not counted and gets rank 0."""
    n, rows = pid.shape[0], tile * per
    starts = range(0, n, rows)
    block_hist = torch.stack([radix_histogram_ranks_ref(pid[b:b + rows], P)[0]
                              for b in starts])
    offsets = torch.cumsum(block_hist, 0, dtype=torch.int32) - block_hist
    inside = (pid >= 0) & (pid < P)
    part = pid.clamp(0, P - 1).to(torch.int64)
    ranks = torch.zeros(n, dtype=torch.int32)
    for base, b in zip(offsets, starts):
        base = base.clone()
        for lo in range(b, min(b + rows, n), tile):
            hi = min(lo + tile, n)
            h, r = radix_histogram_ranks_ref(pid[lo:hi], P)
            ranks[lo:hi] = torch.where(inside[lo:hi], r + base[part[lo:hi]],
                                       0)
            base += h
    return block_hist.sum(0, dtype=torch.int32), ranks


@pytest.mark.parametrize("P", [2, 9, 513])
@pytest.mark.parametrize("tile,per", [(128, 1), (128, 3), (64, 4)])
def test_blocked_counting_pass_matches_jax(P, tile, per, rng):
    """The decomposition the CUDA launches compute (upsweep, scan over
    blocks, in-tile ranks plus offsets), with a ragged last block and
    tile, == the plain version and the JAX kernel; with ids outside
    [0, P) (which the JAX kernel does not take: it ranks them
    -2**31) == the plain version and the JAX ``ref``."""
    n = 1000
    pid = rng.integers(0, P, n).astype(np.int32)
    hist, ranks = blocked_ranks(t(pid), P, tile, per)
    wh, wr = radix_histogram_ranks_ref(t(pid), P)
    assert torch.equal(hist, wh) and torch.equal(ranks, wr)
    jh, jr = j_rank(jnp.asarray(pid), P, impl="pallas_interpret", tile=TILE)
    same(jh, hist)
    same(jr, ranks)
    pid[::7] = -1
    pid[3::11] = P
    hist, ranks = blocked_ranks(t(pid), P, tile, per)
    wh, wr = radix_histogram_ranks_ref(t(pid), P)
    assert torch.equal(hist, wh) and torch.equal(ranks, wr)
    jh, jr = j_rank(jnp.asarray(pid), P, impl="ref")
    same(jh, hist)
    same(jr, ranks)


def test_out_of_range_ids_are_uncounted_rank_zero():
    pid = t(np.array([0, 5, 1, -1, 0, 2], np.int32))
    hist, ranks = radix_histogram_ranks(pid, 3)
    assert hist.tolist() == [2, 1, 1]
    assert ranks.tolist() == [0, 0, 0, 0, 1, 0]
    jh, jr = j_rank(jnp.asarray(pid.numpy()), 3, impl="ref")
    same(jh, hist)
    same(jr, ranks)


# --------------------------------------------------------------------------
# hashing: torch, numpy copies, JAX
# --------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["int", "float", "mixed"])
def test_hash_columns_and_bucket_ids_match_jax(kind, rng):
    n = 257
    if kind == "mixed":
        cols = [rng.integers(-2**31, 2**31 - 1, n).astype(np.int32),
                key_planes(rng, n, 1, "float")[0].view(np.float32)]
    elif kind == "float":
        cols = [p.view(np.float32) for p in key_planes(rng, n, 2, "float")]
    else:
        cols = key_planes(rng, n, 2, "int")
    jh = np.asarray(JP.hash_columns([jnp.asarray(c) for c in cols]))
    th = TP.hash_columns([t(c) for c in cols]).numpy()
    np.testing.assert_array_equal(jh.astype(np.int64), th)
    np.testing.assert_array_equal(jh, TP.hash_columns_np(cols))
    planes = [np.asarray(JB.key_bits(jnp.asarray(c))) for c in cols]
    for c, p in zip(cols, planes):
        np.testing.assert_array_equal(p, TB.key_bits_np(c))
        same(p, TB.key_bits(t(c)))
    for B in (1, 8, 512, 1000):
        jb = np.asarray(JB.bucket_ids(tuple(jnp.asarray(p) for p in planes),
                                      B))
        same(jb, bucket_ids(tuple(t(p) for p in planes), B))
        np.testing.assert_array_equal(jb, TB.bucket_ids_np(planes, B))


def test_mix32_full_range_in_int64(rng):
    """The int64 murmur chain equals uint32 arithmetic over the full
    32-bit range (products split in halves never leave int64)."""
    u = rng.integers(0, 2**32, 100_000, dtype=np.uint64).astype(np.uint32)
    u[:4] = [0, 1, 2**31, 2**32 - 1]
    want = TB.bucket_ids_np([u.view(np.int32)], 2**31 - 1)
    got = bucket_ids((t(u.view(np.int32)),), 2**31 - 1)
    np.testing.assert_array_equal(want, got.numpy())


# --------------------------------------------------------------------------
# fused_bucketing
# --------------------------------------------------------------------------


@pytest.mark.parametrize("P", [2, 9, 512])
@pytest.mark.parametrize("K,kind", [(1, "int"), (2, "int"), (1, "float"),
                                    (2, "float")])
def test_fused_bucket_ranks_matches_jax(P, K, kind, rng):
    planes = key_planes(rng, N, K, kind)
    valid = rng.random(N) < 0.8
    tb, th, tr = fused_bucket_ranks(tuple(t(p) for p in planes), t(valid), P)
    jbits = tuple(jnp.asarray(p) for p in planes)
    for impl in ("ref", "pallas_interpret"):
        jb, jh, jr = j_fused(jbits, jnp.asarray(valid), P, impl=impl,
                             tile=TILE)
        same(jb, tb)
        same(jh, th)
        same(jr, tr)


def test_fused_tiles_compose_with_tile_offsets(rng):
    P = 9
    planes = key_planes(rng, N, 2, "int")
    valid = rng.random(N) < 0.8
    n_tiles = -(-N // TILE)
    pad = n_tiles * TILE - N
    bt = np.stack([np.pad(p, (0, pad)) for p in planes]) \
        .reshape(2, n_tiles, TILE).transpose(1, 0, 2)
    vt = np.pad(valid.astype(np.int32), (0, pad)).reshape(n_tiles, TILE)
    bid_t, hist_t, rank_t = fused_bucket_ranks_tiles(
        jnp.asarray(bt), jnp.asarray(vt), P, interpret=True)
    hist_t = np.asarray(hist_t).copy()
    hist_t[-1, P] -= pad            # the port's kernel never counts the tail
    bid = t(np.asarray(bid_t).reshape(-1)[:N])
    hist, ranks = add_tile_offsets(t(hist_t),
                                   t(np.asarray(rank_t).reshape(-1)[:N]),
                                   bid, P + 1, TILE)
    wb, wh, wr = fused_bucket_ranks_ref(tuple(t(p) for p in planes),
                                        t(valid), P)
    assert torch.equal(bid, wb) and torch.equal(hist, wh)
    assert torch.equal(ranks, wr)


# --------------------------------------------------------------------------
# hash_join probe, slab grouping and plan
# --------------------------------------------------------------------------


def probe_inputs(rng, B, K, Lc, C):
    return (rng.integers(-3, 3, (B, K, Lc)).astype(np.int32),
            (rng.random((B, Lc)) < 0.8).astype(np.int32),
            rng.integers(-3, 3, (B, K, C)).astype(np.int32),
            (rng.random((B, C)) < 0.8).astype(np.int32))


@pytest.mark.parametrize("K", [1, 2])
@pytest.mark.parametrize("B,Lc,C", [(3, 16, 24), (5, 40, 8)])
def test_bucket_probe_matches_jax(B, K, Lc, C, rng):
    args = probe_inputs(rng, B, K, Lc, C)
    tc, tr = bucket_probe(*(t(a) for a in args))
    jargs = tuple(jnp.asarray(a) for a in args)
    for jc, jr in (jh_ref(*jargs), bucket_probe_buckets(*jargs,
                                                        interpret=True)):
        same(jc, tc)
        same(jr, tr)


@pytest.mark.parametrize("with_bid", [False, True])
@pytest.mark.parametrize("K", [1, 2])
def test_group_to_slabs_matches_jax(with_bid, K, rng):
    n, B, cap = 200, 8, 20
    planes = key_planes(rng, n, K, "int")
    valid = np.arange(n) < 170
    payload = rng.normal(size=n).astype(np.float32)
    payload[::9] = np.nan
    jbits = tuple(jnp.asarray(p) for p in planes)
    jbid = JB.bucket_ids(jbits, B) if with_bid else None
    tbid = bucket_ids(tuple(t(p) for p in planes), B) if with_bid else None
    j = JB.group_to_slabs(jbits, jnp.asarray(valid), B, cap, "ref",
                          payload=(jnp.asarray(payload),), bid=jbid)
    x = TB.group_to_slabs(tuple(t(p) for p in planes), t(valid), B, cap,
                          payload=(t(payload),), bid=tbid)
    for a, b in zip(j[:3], x[:3]):
        same(a, b)
    np.testing.assert_array_equal(np.asarray(j[3][0]).view(np.int32),
                                  x[3][0].numpy().view(np.int32))
    same(j[4], x[4])
    assert int(x[4]) > 0            # the slabs overflow at this size


@pytest.mark.parametrize("K", [1, 2])
def test_hash_join_plan_matches_jax(K, rng):
    nl, nr = 150, 120
    lp, rp = key_planes(rng, nl, K, "int"), key_planes(rng, nr, K, "int")
    lv, rv = np.arange(nl) < 140, np.arange(nr) < 117
    kw = dict(num_buckets=8, bucket_capacity=24, probe_capacity=32)
    j = j_hj_plan(tuple(jnp.asarray(p) for p in lp), jnp.asarray(lv),
                  tuple(jnp.asarray(p) for p in rp), jnp.asarray(rv),
                  impl="ref", **kw)
    x = hash_join_plan(tuple(t(p) for p in lp), t(lv),
                       tuple(t(p) for p in rp), t(rv), **kw)
    for a, b in zip(j, x):
        same(a, b)


def test_sizing_helpers_match_jax(rng):
    for lc, rc in [(5, 7), (512, 100), (513, 2000), (10**6, 10**6)]:
        for B in (None, 64):
            assert default_hash_join_sizes(lc, rc, B) == j_hj_sizes(lc, rc, B)
    for cap in (0, 1, 17, 600, 10**7):
        assert TB.default_bucket_count(cap) == JB.default_bucket_count(cap)
    keys = rng.integers(0, 30, 700).astype(np.int32)
    keys[:100] = 7                                  # one hot key
    assert TB.plan_bucket_sizes([keys]) == JB.plan_bucket_sizes([keys])
    bp = TB.BucketPlan([t(keys)])
    jbp = JB.BucketPlan([jnp.asarray(keys)], None)
    assert TB.plan_bucket_sizes(plan=bp, nvalid=650, num_buckets=16) == \
        JB.plan_bucket_sizes(plan=jbp, nvalid=650, num_buckets=16)


@pytest.mark.parametrize("B", [513, 1000, 70000])
def test_more_than_512_buckets_name_the_radix_slice(B, rng):
    """Past 512 buckets the slabs are ranked by the multi-pass radix rank
    (``radix_sort.grouped_ranks``) and match the JAX package, with bucket
    ids hashed here or passed in."""
    n, cap = 400, 8
    planes = key_planes(rng, n, 2, "int")
    valid = np.arange(n) < 390
    payload = rng.normal(size=n).astype(np.float32)
    jbits = tuple(jnp.asarray(p) for p in planes)
    tbits = tuple(t(p) for p in planes)
    for with_bid in (False, True):
        j = JB.group_to_slabs(
            jbits, jnp.asarray(valid), B, cap, "ref",
            payload=(jnp.asarray(payload),),
            bid=JB.bucket_ids(jbits, B) if with_bid else None)
        x = TB.group_to_slabs(tbits, t(valid), B, cap, payload=(t(payload),),
                              bid=bucket_ids(tbits, B) if with_bid else None)
        for a, b in zip(j[:3], x[:3]):
            same(a, b)
        np.testing.assert_array_equal(np.asarray(j[3][0]).view(np.int32),
                                      x[3][0].numpy().view(np.int32))
        same(j[4], x[4])
    bid = t(rng.integers(0, B, n).astype(np.int32))
    jh, jr = JB.bucket_ranks(jnp.asarray(bid.numpy()), B, "ref")
    th, tr = TB.bucket_ranks(bid, B)
    same(jh, th)
    same(jr, tr)


def test_pack_unpack_round_trip(rng):
    f = rng.normal(size=16).astype(np.float32)
    f[:3] = [-0.0, np.nan, -np.inf]
    for col in (t(f), t(rng.integers(-5, 5, 16).astype(np.int32)),
                torch.tensor([True, False])):
        plane = TB.pack_i32(col)
        back = TB.unpack_i32(plane, col.dtype)
        assert plane.dtype == torch.int32 and back.dtype == col.dtype
        assert torch.equal(TB.pack_i32(back), plane)
