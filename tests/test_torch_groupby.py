"""The port's hash-groupby accumulate, GroupBy + Aggregate, Unique and
Aggregate against the JAX package.

Tolerance: exact (float32 by their bits), except where addition order
can differ — float sums and means of non-integer data must lie within
1e-6 of the group's sum of magnitudes — and the sign of a zero min or max
(``-0.0 == +0.0``, as ``jnp.min`` and ``torch.amin`` may return either).
On integer-valued data the sums and means are exact.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import local_ops as JL
from repro.core.table import Table as JT
from repro.kernels import bucketing as JB
from repro.kernels.hash_groupby import \
    default_hash_groupby_sizes as j_sizes
from repro.kernels.hash_groupby import hash_groupby_plan as j_plan
from repro.kernels.hash_groupby.kernel import bucket_accumulate_buckets
from repro.kernels.hash_groupby.ref import bucket_accumulate_ref as j_ref
from repro_torch.core import local_ops as TL
from repro_torch.core.table import Table as TT
from repro_torch.kernels import bucketing as TB
from repro_torch.kernels.hash_groupby import (default_hash_groupby_sizes,
                                              hash_groupby_plan)
from repro_torch.kernels.hash_groupby import ref as TGref
from repro_torch.kernels.hash_groupby.ops import bucket_accumulate

AGGS = {"v": ["sum", "count", "mean", "min", "max"],
        "w": ["max", "sum"]}


@pytest.fixture(autouse=True)
def _defaults(monkeypatch):
    for var in ("REPRO_GROUPBY_IMPL", "REPRO_SORT_IMPL", "REPRO_KERNEL_IMPL"):
        monkeypatch.delenv(var, raising=False)


def t(a):
    return torch.from_numpy(np.array(a))


def values_equal(a, b):
    """float arrays equal as values: NaN == NaN, -0.0 == +0.0."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert np.all((a == b) | (np.isnan(a) & np.isnan(b)))


def sums_close(a, b, scale):
    a, b, scale = np.asarray(a), np.asarray(b), np.asarray(scale)
    assert a.dtype == b.dtype == np.float32
    ok = (np.abs(a - b) <= 1e-6 * scale) | (np.isnan(a) & np.isnan(b))
    assert ok.all()


def slab_inputs(rng, B, K, V, C, integer=False):
    kb = rng.integers(-3, 3, (B, K, C)).astype(np.int32)
    occ = (rng.random((B, C)) < 0.8).astype(np.int32)
    if integer:
        vals = rng.integers(-100, 100, (B, V, C)).astype(np.float32)
    else:
        vals = rng.normal(size=(B, V, C)).astype(np.float32)
    vals[rng.random(vals.shape) < 0.1] = -0.0
    vals[rng.random(vals.shape) < 0.03] = np.nan
    return kb, occ, vals


# --------------------------------------------------------------------------
# the accumulate
# --------------------------------------------------------------------------


@pytest.mark.parametrize("integer", [False, True])
@pytest.mark.parametrize("B,K,V,C", [(3, 1, 1, 16), (4, 2, 5, 24)])
def test_bucket_accumulate_matches_jax(B, K, V, C, integer, rng):
    args = slab_inputs(rng, B, K, V, C, integer)
    got = [x.numpy() for x in bucket_accumulate(*(t(a) for a in args))]
    scale = TGref.bucket_accumulate_ref(t(args[0]), t(args[1]),
                                        t(np.abs(args[2])))[2].numpy()
    jargs = tuple(jnp.asarray(a) for a in args)
    for want in (j_ref(*jargs), bucket_accumulate_buckets(*jargs,
                                                          interpret=True)):
        want = [np.asarray(w) for w in want]
        for g, w in zip(got[:2], want[:2]):
            assert g.dtype == w.dtype == np.int32
            np.testing.assert_array_equal(g, w)
        if integer:
            np.testing.assert_array_equal(got[2].view(np.int32),
                                          want[2].view(np.int32))
        sums_close(got[2], want[2], scale)
        values_equal(got[3], want[3])
        values_equal(got[4], want[4])


@pytest.mark.parametrize("K,V", [(1, 1), (2, 3)])
def test_bucket_accumulate_edge_buckets_match_jax(K, V, rng):
    """Buckets with holes in the occupancy (not a prefix), every slot one
    key, no slot occupied, and every key distinct: the plain version
    equals the reference's Pallas kernel (interpret mode) and its ref."""
    C = 40
    kb = rng.integers(-3, 3, (4, K, C)).astype(np.int32)
    kb[1] = 7
    kb[3] = np.arange(C)[None, :] * (np.arange(K)[:, None] + 1)
    occ = (rng.random((4, C)) < 0.35).astype(np.int32)
    occ[1], occ[2], occ[3] = 1, 0, 1
    vals = rng.integers(-100, 100, (4, V, C)).astype(np.float32)
    vals[rng.random(vals.shape) < 0.1] = -0.0
    vals[rng.random(vals.shape) < 0.03] = np.nan
    got = [x.numpy() for x in bucket_accumulate(t(kb), t(occ), t(vals))]
    assert got[1][1, 0] == C and not got[1][2].any()
    jargs = (jnp.asarray(kb), jnp.asarray(occ), jnp.asarray(vals))
    for want in (j_ref(*jargs), bucket_accumulate_buckets(*jargs,
                                                          interpret=True)):
        want = [np.asarray(w) for w in want]
        for g, w in zip(got[:2], want[:2]):
            np.testing.assert_array_equal(g, w)
        values_equal(got[2], want[2])        # integer-valued: exact
        values_equal(got[3], want[3])
        values_equal(got[4], want[4])


def test_bucket_accumulate_chunks_buckets(monkeypatch, rng):
    """The plain version's chunking over buckets changes nothing."""
    args = tuple(t(a) for a in slab_inputs(rng, 7, 2, 2, 12))
    whole = TGref.bucket_accumulate_ref(*args)
    monkeypatch.setattr(TGref, "_CHUNK_ELEMS", 2 * 12 * 12 * 2)
    chunked = TGref.bucket_accumulate_ref(*args)
    for a, b in zip(whole, chunked):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


# --------------------------------------------------------------------------
# the plan
# --------------------------------------------------------------------------


@pytest.mark.parametrize("with_bid", [False, True])
@pytest.mark.parametrize("B,K", [(8, 1), (8, 2), (600, 1)])
def test_hash_groupby_plan_matches_jax(B, K, with_bid, rng):
    """600 buckets take the multi-pass radix ranking (past 512)."""
    n, C = 240, 24
    planes = [rng.integers(-20, 20, n).astype(np.int32) for _ in range(K)]
    valid = np.arange(n) < 230
    vals = (rng.integers(-50, 50, n).astype(np.float32),
            rng.normal(size=n).astype(np.float32))
    jbits = tuple(jnp.asarray(p) for p in planes)
    tbits = tuple(t(p) for p in planes)
    kw = dict(num_buckets=B, bucket_capacity=C)
    j = j_plan(jbits, jnp.asarray(valid), tuple(jnp.asarray(v) for v in vals),
               bid=JB.bucket_ids(jbits, B) if with_bid else None, **kw)
    x = hash_groupby_plan(tbits, t(valid), tuple(t(v) for v in vals),
                          bid=TB.bucket_ids(tbits, B) if with_bid else None,
                          **kw)
    for name in ("rep", "row", "counts", "dropped"):
        a, b = np.asarray(getattr(j, name)), getattr(x, name).numpy()
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    np.testing.assert_array_equal(np.asarray(j.sums)[:, 0].view(np.int32),
                                  x.sums[:, 0].numpy().view(np.int32))
    scale = hash_groupby_plan(tbits, t(valid), tuple(t(np.abs(v))
                                                     for v in vals), **kw)
    sums_close(x.sums.numpy(), j.sums, scale.sums.numpy())
    values_equal(j.mins, x.mins.numpy())
    values_equal(j.maxs, x.maxs.numpy())


def test_default_sizes_match_jax():
    for cap in (0, 1, 100, 512, 513, 10**6):
        for B in (None, 64, 65536):
            assert default_hash_groupby_sizes(cap, B) == j_sizes(cap, B)


# --------------------------------------------------------------------------
# GroupBy + Aggregate, Unique
# --------------------------------------------------------------------------


def table_data(dist, rng, n=64):
    if dist == "empty":
        n = 0
    if dist == "multi":
        keys = {"a": rng.integers(0, 4, n).astype(np.int32),
                "b": rng.integers(-2, 2, n).astype(np.int32)}
    elif dist == "float":
        keys = {"a": rng.choice(np.array([0.0, -0.0, 1.5, -2.25, np.inf,
                                          3.0], np.float32), n)}
    elif dist == "alldup":
        keys = {"a": np.full(n, 7, np.int32)}
    else:
        keys = {"a": rng.integers(-10, 10, n).astype(np.int32)}
    v = rng.integers(-100, 100, n).astype(np.float32)
    v[rng.random(n) < 0.05] = np.nan
    return {**keys, "v": v, "w": rng.normal(size=n).astype(np.float32)}


def both(data, capacity):
    return (JT.from_dict(data, capacity=capacity),
            TT.from_dict(data, capacity=capacity, device="cpu"))


def abs_sums(tt, by):
    """Per group (in output order) the sum of ``|w|``: the scale of the
    ``w_sum`` tolerance."""
    cols = dict(tt.columns, w=tt.columns["w"].abs())
    g = TL.groupby_aggregate(TT(columns=cols, nvalid=tt.nvalid), by,
                             {"w": "sum"}, impl="sort")
    return g.to_numpy()["w_sum"]


def assert_groupby_same(jout, tout, msg, scale):
    """Keys, counts and the integer-valued ``v`` aggregates bit for bit;
    ``w_sum`` (normal floats) within 1e-6 of ``scale``, the group's sum
    of magnitudes; zeros' signs free in min and max."""
    assert int(np.asarray(jout.nvalid).reshape(-1)[0]) == int(tout.nvalid)
    j, x = jout.to_numpy(), tout.to_numpy()
    assert list(j) == list(x), msg
    for k in j:
        a, b = np.asarray(j[k]), x[k]
        assert a.dtype == b.dtype, (msg, k)
        if k == "w_sum":
            sums_close(b, a, scale)
        elif k.endswith(("_min", "_max")):
            values_equal(a, b)
        elif a.dtype == np.float32:
            np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32),
                                          err_msg=f"{msg} {k}")
        else:
            np.testing.assert_array_equal(a, b, err_msg=f"{msg} {k}")


DISTS = ["int", "multi", "float", "alldup", "empty"]
CAP = 70     # one capacity for every case: the JAX programs are reused


@pytest.mark.parametrize("impl", ["sort", "hash"])
@pytest.mark.parametrize("dist", DISTS)
def test_groupby_aggregate_matches_jax(dist, impl, rng):
    data = table_data(dist, rng)
    by = [k for k in data if k not in ("v", "w")]
    jt, tt = both(data, CAP)
    jout, jover = JL.groupby_aggregate(jt, by, AGGS, impl=impl,
                                       return_overflow=True)
    tout, tover = TL.groupby_aggregate(tt, by, AGGS, impl=impl,
                                       return_overflow=True)
    assert int(jover) == int(tover) == 0 and tover.dtype == torch.int32
    scale = abs_sums(tt, by)
    assert_groupby_same(jout, tout, f"{dist}/{impl}", scale)
    if impl == "hash":      # the two backends agree with each other too
        assert_groupby_same(jout, TL.groupby_aggregate(tt, by, AGGS,
                                                       impl="sort"), dist,
                            scale)


@pytest.mark.parametrize("impl", ["sort", "hash"])
@pytest.mark.parametrize("dist", DISTS)
def test_drop_duplicates_matches_jax(dist, impl, rng):
    data = table_data(dist, rng)
    subset = [k for k in data if k not in ("v", "w")]
    jt, tt = both(data, CAP)
    jout, jover = JL.drop_duplicates(jt, subset, impl=impl,
                                     return_overflow=True)
    tout, tover = TL.drop_duplicates(tt, subset, impl=impl,
                                     return_overflow=True)
    assert int(jover) == int(tover) == 0
    j, x = jout.to_numpy(), tout.to_numpy()
    assert int(np.asarray(jout.nvalid)) == int(tout.nvalid)
    assert list(j) == list(x)
    for k in j:       # payload rows are copies: every bit must match
        np.testing.assert_array_equal(np.asarray(j[k]).view(np.int32),
                                      x[k].view(np.int32), err_msg=k)


@pytest.mark.parametrize("op", ["groupby", "unique"])
def test_planned_eager_hash_matches_jax(op, rng):
    """Above EXACT_SLAB_CAP a direct call plans its slabs from the keys
    (bucket ids hashed once and reused), as the reference's eager call
    does; ``may_plan=False`` keeps the heuristic sizes."""
    n = 700
    data = {"a": rng.integers(0, 90, n).astype(np.int32),
            "v": rng.integers(-9, 9, n).astype(np.float32),
            "w": rng.normal(size=n).astype(np.float32)}
    data["a"][:200] = 5                                 # one hot key
    jt, tt = both(data, n)
    if op == "groupby":
        jout, jover = JL.groupby_aggregate(jt, ["a"], AGGS, impl="hash",
                                           return_overflow=True)
        tout, tover = TL.groupby_aggregate(tt, ["a"], AGGS, impl="hash",
                                           return_overflow=True)
        assert_groupby_same(jout, tout, "planned", abs_sums(tt, ["a"]))
    else:
        jout, jover = JL.drop_duplicates(jt, ["a"], impl="hash",
                                         return_overflow=True)
        tout, tover = TL.drop_duplicates(tt, ["a"], impl="hash",
                                         return_overflow=True)
        assert int(jout.nvalid) == int(tout.nvalid)
    assert int(jover) == int(tover) == 0
    # the uniform heuristic overflows on the hot key
    _, over = TL.groupby_aggregate(tt, ["a"], AGGS, impl="hash",
                                   return_overflow=True, may_plan=False)
    assert int(over) > 0


@pytest.mark.parametrize("cap_delta", [0, -1])
@pytest.mark.parametrize("op", ["groupby", "unique"])
def test_overflow_trips_exactly_at_capacity(op, cap_delta):
    """All-equal keys in one bucket: 24 rows fit a 24-slot slab, a
    23-slot slab drops one row — identically in both packages."""
    n = 24
    data = {"a": np.full(n, 3, np.int32),
            "v": np.arange(n, dtype=np.float32),
            "w": np.zeros(n, np.float32)}
    jt, tt = both(data, n)
    kw = dict(impl="hash", return_overflow=True, num_buckets=4,
              bucket_capacity=n + cap_delta)
    if op == "groupby":
        jout, jover = JL.groupby_aggregate(jt, ["a"], AGGS, **kw)
        tout, tover = TL.groupby_aggregate(tt, ["a"], AGGS, **kw)
        assert_groupby_same(jout, tout, f"cap {n + cap_delta}",
                            abs_sums(tt, ["a"]))
    else:
        jout, jover = JL.drop_duplicates(jt, ["a"], **kw)
        tout, tover = TL.drop_duplicates(tt, ["a"], **kw)
    assert int(jover) == int(tover) == -cap_delta


def test_groupby_rejects_unknown_names(rng):
    tt = TT.from_dict(table_data("int", rng), device="cpu")
    with pytest.raises(ValueError, match="unknown aggregation"):
        TL.groupby_aggregate(tt, ["a"], {"v": "median"})
    with pytest.raises(ValueError, match="unknown groupby impl"):
        TL.groupby_aggregate(tt, ["a"], {"v": "sum"}, impl="nope")
    with pytest.raises(ValueError, match="unknown groupby impl"):
        TL.drop_duplicates(tt, ["a"], impl="nope")


@pytest.mark.parametrize("op", ["sum", "count", "mean", "min", "max",
                                "std"])
def test_aggregate_matches_jax(op, rng):
    data = {"x": rng.integers(-50, 50, 40).astype(np.float32),
            "i": rng.integers(-5, 5, 40).astype(np.int32)}
    jt, tt = both(data, 48)
    jt, tt = jt.with_nvalid(37), tt.with_nvalid(37)
    for col in ("x", "i"):
        a = np.asarray(JL.aggregate(jt, col, op))
        b = TL.aggregate(tt, col, op).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape == ()
        np.testing.assert_allclose(b, a, rtol=1e-6)
    with pytest.raises(ValueError):
        TL.aggregate(tt, "x", "median")
