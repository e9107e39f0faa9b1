"""The port's hash-semi membership kernel and plan, the Table 5 set
operators (membership, Intersect, Difference, Union, Cartesian Product),
null handling and column scaling against the JAX package.

The same seeded numpy tables go through both packages.  Tolerance: every
mask, row, order, dtype and drop counter is exact (floats by their bits),
but for the columns that ``column_moments`` / ``standard_scale`` compute:
their float32 sums add in another order in each package, so they are held
to ``|port - jax| <= 2e-5 * (1 + |jax|)``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import local_ops as JL
from repro.core.table import Table as JT
from repro.kernels.hash_join import default_hash_join_sizes as j_join_sizes
from repro.kernels.hash_semi import default_hash_semi_sizes as j_sizes
from repro.kernels.hash_semi import hash_semi_plan as j_plan
from repro.kernels.hash_semi.kernel import bucket_member_buckets
from repro.kernels.hash_semi.ref import bucket_member_ref as j_ref
from repro_torch.core import kernel_backend
from repro_torch.core import local_ops as TL
from repro_torch.core.table import Table as TT
from repro_torch.kernels import bucketing as TB
from repro_torch.kernels.hash_semi import (default_hash_semi_sizes,
                                           hash_semi_plan)
from repro_torch.kernels.hash_semi.ops import bucket_member
from repro_torch.kernels.hash_semi.ref import bucket_member_ref

ROWS = 48
DISTS = ["uniform", "skewed", "allequal", "alldistinct", "empty"]
IMPLS = ["sortmerge", "hash"]
DEDUP = {"sortmerge": "sort", "hash": "hash"}


@pytest.fixture(autouse=True)
def _defaults(monkeypatch):
    for var in ("REPRO_SEMI_IMPL", "REPRO_GROUPBY_IMPL", "REPRO_SORT_IMPL",
                "REPRO_KERNEL_IMPL", "REPRO_JOIN_IMPL"):
        monkeypatch.delenv(var, raising=False)


def t(a):
    return torch.from_numpy(np.array(a))


def make_pair(dist: str, rng):
    """The key distributions of tests/test_setop_backends.py."""
    if dist == "uniform":
        ka = rng.integers(0, 12, ROWS)
        kb = rng.integers(6, 18, ROWS // 2)
    elif dist == "skewed":
        ka = np.where(rng.random(ROWS) < 0.6, 3, rng.integers(0, 40, ROWS))
        kb = np.where(rng.random(ROWS // 2) < 0.5, 3,
                      rng.integers(20, 60, ROWS // 2))
    elif dist == "allequal":
        ka = np.full(ROWS, 7)
        kb = np.full(ROWS // 2, 7)
    elif dist == "alldistinct":
        ka = rng.permutation(ROWS)
        kb = rng.permutation(ROWS)[:ROWS // 2] + ROWS // 2
    else:
        ka = np.zeros(0, np.int64)
        kb = rng.integers(0, 12, ROWS // 2)
    a = {"k": ka.astype(np.int32),
         "v": rng.integers(-100, 100, len(ka)).astype(np.float32)}
    b = {"k": kb.astype(np.int32),
         "v": rng.integers(-100, 100, len(kb)).astype(np.float32)}
    return a, b


# the capacities of the small probe and build tables: one shape for most
# cases, so the JAX side compiles each operation once
CAP_A, CAP_B = ROWS + 8, ROWS // 2 + 8


def both(data: dict, capacity: int | None = None, pad: int = 5):
    n = len(next(iter(data.values())))
    cap = capacity if capacity is not None else max(n, 1) + pad
    return (JT.from_dict(data, capacity=cap),
            TT.from_dict(data, capacity=cap, device="cpu"))


def assert_same(jout, tout, msg=""):
    """Valid rows equal bit for bit, dtypes and column order included."""
    j, x = jout.to_numpy(), tout.to_numpy()
    assert int(np.asarray(jout.nvalid)) == int(tout.nvalid), msg
    assert list(j) == list(x), msg
    for k in j:
        a, b = np.asarray(j[k]), x[k]
        assert a.dtype == b.dtype, (msg, k, a.dtype, b.dtype)
        if a.dtype == np.float32:
            a, b = a.view(np.int32), b.view(np.int32)
        np.testing.assert_array_equal(a, b, err_msg=f"{msg} col={k}")


def assert_mask(jmask, tmask, msg=""):
    np.testing.assert_array_equal(np.asarray(jmask), tmask.numpy(),
                                  err_msg=msg)


# --------------------------------------------------------------------------
# the membership kernel and its plan
# --------------------------------------------------------------------------


def slabs(rng, B, K, Lc, C):
    return (rng.integers(-3, 3, (B, K, Lc)).astype(np.int32),
            (rng.random((B, Lc)) < 0.8).astype(np.int32),
            rng.integers(-3, 3, (B, K, C)).astype(np.int32),
            (rng.random((B, C)) < 0.8).astype(np.int32))


@pytest.mark.parametrize("K", [1, 3])
@pytest.mark.parametrize("B,Lc,C", [(3, 16, 8), (5, 24, 40), (2, 8, 0)])
def test_bucket_member_matches_jax(B, K, Lc, C, rng):
    args = slabs(rng, B, K, Lc, C)
    got = bucket_member(*(t(a) for a in args))
    assert got.dtype == torch.int32
    assert torch.equal(got, bucket_member_ref(*(t(a) for a in args)))
    want = np.asarray(j_ref(*(jnp.asarray(a) for a in args)))
    np.testing.assert_array_equal(got.numpy(), want)
    if C:
        tiles = bucket_member_buckets(*(jnp.asarray(a) for a in args),
                                      interpret=True)
        np.testing.assert_array_equal(got.numpy(), np.asarray(tiles))


def test_default_sizes_match_jax():
    for lcap, rcap in ((40, 30), (600, 5000), (70000, 1280),
                       (10_000_000, 65536)):
        for nb in (None, 16):
            assert default_hash_semi_sizes(lcap, rcap, nb) == \
                j_sizes(lcap, rcap, nb) == j_join_sizes(lcap, rcap, nb)


@pytest.mark.parametrize("with_bid", [False, True])
@pytest.mark.parametrize("K", [1, 2])
@pytest.mark.parametrize("caps", [(8, 64, 64), (8, 5, 3), (4, 12, 9)],
                         ids=["roomy", "both_trip", "tight"])
def test_hash_semi_plan_matches_jax(caps, K, with_bid, rng):
    """member, probed and both drop counters, including capacities that
    drop build and probe rows."""
    B, C, Lc = caps
    n_l, n_r = 60, 40
    lk = [rng.integers(0, 9, n_l).astype(np.int32) for _ in range(K)]
    rk = [rng.integers(3, 12, n_r).astype(np.int32) for _ in range(K)]
    lvalid = np.arange(n_l) < 52
    rvalid = np.arange(n_r) < 37
    kw = dict(num_buckets=B, bucket_capacity=C, probe_capacity=Lc)
    jbid = {}
    tbid = {}
    if with_bid:
        lbp, rbp = TB.BucketPlan([t(c) for c in lk]), \
            TB.BucketPlan([t(c) for c in rk])
        tbid = dict(left_bid=lbp.bucket_ids_for(B),
                    right_bid=rbp.bucket_ids_for(B))
        jbid = {k: jnp.asarray(v.numpy()) for k, v in tbid.items()}
    got = hash_semi_plan(tuple(t(c) for c in lk), t(lvalid),
                         tuple(t(c) for c in rk), t(rvalid), **kw, **tbid)
    want = j_plan(tuple(jnp.asarray(c) for c in lk), jnp.asarray(lvalid),
                  tuple(jnp.asarray(c) for c in rk), jnp.asarray(rvalid),
                  **kw, impl="ref", **jbid)
    for name in ("member", "probed", "build_dropped", "probe_dropped"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)


def test_plan_counters_trip_exactly_at_capacity():
    """All-equal keys: slabs one row short of the group drop exactly one
    row on each side; slabs the group's size drop none."""
    n = 24
    bits = (torch.full((n,), 5, dtype=torch.int32),)
    valid = torch.ones(n, dtype=torch.bool)
    for cap, drop in ((n - 1, 1), (n, 0)):
        plan = hash_semi_plan(bits, valid, bits, valid, num_buckets=4,
                              bucket_capacity=cap, probe_capacity=cap)
        assert int(plan.build_dropped) == drop
        assert int(plan.probe_dropped) == drop
        assert int(plan.member.sum()) == n - drop


# --------------------------------------------------------------------------
# the set operators, both backends, against the JAX package
# --------------------------------------------------------------------------


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("dist", DISTS)
@pytest.mark.parametrize("op", ["isin", "intersect", "difference", "union"])
def test_setop_matches_jax(op, dist, impl, rng):
    a, b = make_pair(dist, rng)
    (ja, ta), (jb, tb) = both(a, CAP_A), both(b, CAP_B)
    if op == "isin":
        jm, jo = JL.isin(ja, "k", jb, "k", impl=impl, return_overflow=True)
        tm, to = TL.isin(ta, "k", tb, "k", impl=impl, return_overflow=True)
        assert_mask(jm, tm, f"isin {dist}")
        assert not tm[len(a["k"]):].any()
    elif op == "union":
        jm, jo = JL.union(ja, jb, on=["k"], impl=DEDUP[impl],
                          return_overflow=True)
        tm, to = TL.union(ta, tb, on=["k"], impl=DEDUP[impl],
                          return_overflow=True)
        assert_same(jm, tm, f"union {dist}")
    else:
        kw = dict(on=["k"], impl=impl, return_overflow=True)
        if op == "intersect":
            kw["dedup_impl"] = DEDUP[impl]
        jm, jo = getattr(JL, op)(ja, jb, **kw)
        tm, to = getattr(TL, op)(ta, tb, **kw)
        assert_same(jm, tm, f"{op} {dist}")
    assert int(jo) == int(to) == 0


@pytest.mark.parametrize("impl", IMPLS)
def test_backends_agree_with_each_other(impl, rng):
    a, b = make_pair("skewed", rng)
    (_, ta), (_, tb) = both(a, CAP_A), both(b, CAP_B)
    other = "hash" if impl == "sortmerge" else "sortmerge"
    assert torch.equal(TL.isin(ta, "k", tb, "k", impl=impl),
                       TL.isin(ta, "k", tb, "k", impl=other))


def test_planned_eager_hash_semi_matches_jax(rng):
    """Above the exact-slab range a direct call plans its slabs from the
    keys (two-pass), as the reference's eager call does."""
    n = 1500
    a = {"k": np.where(rng.random(n) < 0.3, 4, rng.integers(0, 900, n))
         .astype(np.int32), "v": rng.normal(size=n).astype(np.float32)}
    b = {"k": rng.integers(400, 1400, 700).astype(np.int32),
         "v": rng.normal(size=700).astype(np.float32)}
    (ja, ta), (jb, tb) = both(a), both(b)
    for op in ("isin", "difference"):
        if op == "isin":
            jm, jo = JL.isin(ja, "k", jb, "k", impl="hash",
                             return_overflow=True)
            tm, to = TL.isin(ta, "k", tb, "k", impl="hash",
                             return_overflow=True)
            assert_mask(jm, tm)
        else:
            jm, jo = JL.difference(ja, jb, ["k"], impl="hash",
                                   return_overflow=True)
            tm, to = TL.difference(ta, tb, ["k"], impl="hash",
                                   return_overflow=True)
            assert_same(jm, tm)
        assert int(jo) == int(to) == 0


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("direction", ["float_probe", "int_probe"])
def test_promoted_dtype_no_false_positive(direction, impl):
    """A float32 3.7 probe must not match an int32 3 (and 3.0 must)."""
    if direction == "float_probe":
        q = {"x": np.array([3.7, 3.0, -1.5, 2.0], np.float32)}
        v = {"y": np.array([3, 2, 9], np.int32)}
        want = [False, True, False, True]
    else:
        q = {"x": np.array([3, 4], np.int32)}
        v = {"y": np.array([3.0, 3.5], np.float32)}
        want = [True, False]
    (jq, tq), (jv, tv) = both(q, CAP_A), both(v, CAP_B)
    tm = TL.isin(tq, "x", tv, "y", impl=impl)
    np.testing.assert_array_equal(tm.numpy()[:len(want)], want)
    assert_mask(JL.isin(jq, "x", jv, "y", impl=impl), tm)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("op", ["semi_mask", "intersect", "difference"])
def test_multi_and_mixed_dtype_keys_match_jax(op, impl, rng):
    n = 40
    a = {"ik": rng.integers(0, 4, n).astype(np.int32),
         "fk": (rng.integers(-3, 4, n) * 0.5).astype(np.float32),
         "v": rng.integers(-50, 50, n).astype(np.float32)}
    b = {"ik": rng.integers(0, 4, n // 2).astype(np.int32),
         "fk": (rng.integers(-3, 4, n // 2) * 0.5).astype(np.float32),
         "v": rng.integers(-50, 50, n // 2).astype(np.float32)}
    (ja, ta), (jb, tb) = both(a, CAP_A), both(b, CAP_B)
    on = ["ik", "fk"]
    if op == "semi_mask":
        assert_mask(JL.semi_mask(ja, jb, on, impl=impl),
                    TL.semi_mask(ta, tb, on, impl=impl))
    else:
        assert_same(getattr(JL, op)(ja, jb, on=on, impl=impl),
                    getattr(TL, op)(ta, tb, on=on, impl=impl), op)


@pytest.mark.parametrize("impl", ["sort", "hash"])
def test_union_key_subset_and_tie_order(impl):
    """One row per key, the payload of the key's first occurrence: ``a``'s
    rows win ties; without ``on`` whole rows are deduplicated."""
    a = {"k": np.array([1, 2], np.int32), "v": np.array([10., 20.],
                                                        np.float32)}
    b = {"k": np.array([2, 3], np.int32), "v": np.array([99., 30.],
                                                        np.float32)}
    (ja, ta), (jb, tb) = both(a, CAP_A), both(b, CAP_B)
    u = TL.union(ta, tb, on=["k"], impl=impl)
    np.testing.assert_array_equal(u.to_numpy()["v"], [10., 20., 30.])
    assert_same(JL.union(ja, jb, on=["k"], impl=impl), u)
    full = TL.union(ta, tb, impl=impl)
    assert int(full.nvalid) == 4
    assert_same(JL.union(ja, jb, impl=impl), full)


@pytest.mark.parametrize("case", ["probe", "build", "union"])
def test_overflow_counters_match_jax(case):
    """Slabs smaller than the all-equal group: both packages drop and
    count the same rows; a probe-dropped row reports non-member."""
    n = 24
    big = {"k": np.full(n, 1, np.int32)}
    small = {"k": np.full(4, 1, np.int32)}
    (jbig, tbig), (jsm, tsm) = both(big, n), both(small, 4)
    if case == "probe":
        kw = dict(impl="hash", num_buckets=4, probe_capacity=8,
                  return_overflow=True)
        (jm, jo), (tm, to) = (JL.isin(jbig, "k", jsm, "k", **kw),
                              TL.isin(tbig, "k", tsm, "k", **kw))
        assert int(to) == n - 8 and int(tm.sum()) == 8
        assert_mask(jm, tm)
    elif case == "build":
        kw = dict(impl="hash", num_buckets=4, bucket_capacity=8,
                  return_overflow=True)
        (jm, jo), (tm, to) = (JL.isin(jsm, "k", jbig, "k", **kw),
                              TL.isin(tsm, "k", tbig, "k", **kw))
        assert int(to) == n - 8 and int(tm.sum()) == 4
        assert_mask(jm, tm)
    else:
        a = {"k": np.full(16, 1, np.int32),
             "v": np.arange(16, dtype=np.float32)}
        (ja, ta) = both(a, 16)
        kw = dict(on=["k"], impl="hash", return_overflow=True,
                  num_buckets=4, bucket_capacity=8)
        (jm, jo), (tm, to) = (JL.union(ja, ja, **kw),
                              TL.union(ta, ta, **kw))
        assert int(tm.nvalid) == 1 and int(to) == 32 - 8
        assert_same(jm, tm)
    assert int(jo) == int(to)


@pytest.mark.parametrize("out_cap", [8, 12, 16])
def test_cartesian_product_matches_jax(out_cap, rng):
    a = {"k": np.arange(4, dtype=np.int32),
         "v": rng.normal(size=4).astype(np.float32)}
    b = {"k": np.arange(3, dtype=np.int32) * 10,
         "w": rng.normal(size=3).astype(np.float32)}
    (ja, ta), (jb, tb) = both(a, 4), both(b, 4)
    jo, jd = JL.cartesian_product(ja, jb, out_cap, return_overflow=True)
    to, td = TL.cartesian_product(ta, tb, out_cap, return_overflow=True)
    assert_same(jo, to)
    assert int(td) == int(jd) == max(12 - out_cap, 0)
    assert isinstance(TL.cartesian_product(ta, tb, out_cap), TT)


SPECIAL = np.array([np.nan, -0.0, 0.0, np.inf, -np.inf, 1e-40, -1e-40,
                    1.5, -2.0, 3.0e38], np.float32)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("op", ["isin", "intersect", "difference"])
def test_special_float_keys_match_jax(op, impl, rng):
    """NaN, ±0.0, ±inf and subnormal keys: each backend as the
    reference's (subnormals and -0.0 are members of a set holding 0.0)."""
    a = {"k": rng.choice(SPECIAL, 40),
         "v": rng.integers(-9, 9, 40).astype(np.float32)}
    b = {"k": rng.choice(SPECIAL[1:], 12),
         "v": rng.integers(-9, 9, 12).astype(np.float32)}
    b["k"][:2] = [0.0, np.inf]
    (ja, ta), (jb, tb) = both(a, CAP_A), both(b, CAP_B)
    if op == "isin":
        tm = TL.isin(ta, "k", tb, "k", impl=impl)
        assert_mask(JL.isin(ja, "k", jb, "k", impl=impl), tm)
        k = a["k"]
        sub = np.isin(k, np.float32([1e-40, -1e-40, -0.0]))
        assert tm[:40].numpy()[sub].all()
    else:
        assert_same(getattr(JL, op)(ja, jb, on=["k"], impl=impl),
                    getattr(TL, op)(ta, tb, on=["k"], impl=impl), op)


def test_env_selects_the_semi_backend(monkeypatch, rng):
    a, b = make_pair("uniform", rng)
    (_, ta), (_, tb) = both(a, CAP_A), both(b, CAP_B)
    monkeypatch.setenv("REPRO_SEMI_IMPL", "hash")
    assert kernel_backend.semi_impl() == "hash"
    mh = TL.isin(ta, "k", tb, "k")
    monkeypatch.setenv("REPRO_SEMI_IMPL", "sortmerge")
    assert torch.equal(TL.isin(ta, "k", tb, "k"), mh)
    monkeypatch.delenv("REPRO_SEMI_IMPL")
    assert kernel_backend.semi_impl() == "sortmerge"
    with pytest.raises(ValueError):
        TL.isin(ta, "k", tb, "k", impl="nope")
    with pytest.raises(ValueError):
        TL.difference(ta, tb, on=["k"], impl="nope")


# --------------------------------------------------------------------------
# null handling, table helpers and column scaling
# --------------------------------------------------------------------------


def null_table(rng, n=30):
    f = rng.normal(size=n).astype(np.float32)
    f[::4] = np.nan
    i = rng.integers(-5, 5, n).astype(np.int32)
    i[1::5] = np.iinfo(np.int32).min
    return {"f": f, "i": i, "g": rng.normal(size=n).astype(np.float32)}


@pytest.mark.parametrize("op", ["isnull_f", "isnull_i", "dropna_f",
                                "dropna_all", "fillna"])
def test_null_ops_match_jax(op, rng):
    jt, tt = both(null_table(rng), pad=6)
    if op.startswith("isnull"):
        col = op[-1]
        assert_mask(JL.isnull(jt, col), TL.isnull(tt, col))
    elif op == "dropna_f":
        assert_same(JL.dropna(jt, ["f"]), TL.dropna(tt, ["f"]))
    elif op == "dropna_all":
        assert_same(JL.dropna(jt), TL.dropna(tt))
    else:
        vals = {"f": -1.25, "i": 7}
        assert_same(JL.fillna(jt, vals), TL.fillna(tt, vals))


def test_table_helpers_match_jax(rng):
    data = null_table(rng, 12)
    jt, tt = both(data, pad=4)
    np.testing.assert_array_equal(
        np.asarray(jt.to_tensor(["g", "i"])).view(np.int32),
        tt.to_tensor(["g", "i"]).numpy().view(np.int32))
    assert tt.to_tensor().shape == (16, 3)
    assert_same(jt.pad_to(20), tt.pad_to(20))
    assert tt.pad_to(20).capacity == 20 and tt.pad_to(16) is tt
    with pytest.raises(ValueError):
        tt.pad_to(3)
    assert_same(jt.add_prefix("p_"), tt.add_prefix("p_"))
    assert_same(jt.astype({"i": jnp.float32}),
                tt.astype({"i": torch.float32}))
    assert_same(jt.map_column("i", lambda c: c * 2, out="i2"),
                tt.map_column("i", lambda c: c * 2, out="i2"))
    assert tt.replace_columns({"g": tt.columns["g"]}).names == ("g",)


def close(jcol, tcol, msg=""):
    a = np.asarray(jcol).astype(np.float64)
    b = np.asarray(tcol).astype(np.float64)
    assert a.shape == b.shape, msg
    assert np.all(np.abs(b - a) <= 2e-5 * (1 + np.abs(a))), msg


@pytest.mark.parametrize("impl", [None, "sort", "hash"])
def test_column_moments_match_jax(impl, rng):
    n = 200
    data = {"x": (1000 + rng.normal(size=n)).astype(np.float32),
            "y": rng.normal(size=n).astype(np.float32)}
    jt, tt = both(data, pad=24)
    center = {"x": 1000.0, "y": 0.25}
    js1, jsd, jn = JL.column_moments(jt, ["x", "y"], impl=impl,
                                     center={k: jnp.float32(v)
                                             for k, v in center.items()})
    ts1, tsd, tn = TL.column_moments(tt, ["x", "y"], impl=impl,
                                     center={k: torch.tensor(v)
                                             for k, v in center.items()})
    assert float(jn) == float(tn) == n
    for k in ("x", "y"):
        close(js1[k], ts1[k], k)
        close(jsd[k], tsd[k], k)


@pytest.mark.parametrize("impl", [None, "sort", "hash"])
def test_standard_scale_matches_jax(impl, rng):
    """The scaled columns within the stated tolerance; the others bit for
    bit; an all-equal column (std 0) scales to 0, not NaN."""
    n = 300
    data = {"x": (1e4 + rng.normal(size=n)).astype(np.float32),
            "c": np.full(n, 3.5, np.float32),
            "k": rng.integers(0, 9, n).astype(np.int32)}
    jt, tt = both(data, pad=20)
    jo = JL.standard_scale(jt, ["x", "c"], impl=impl)
    to = TL.standard_scale(tt, ["x", "c"], impl=impl)
    j, x = jo.to_numpy(), to.to_numpy()
    assert list(j) == list(x)
    close(j["x"], x["x"], "x")
    close(j["c"], x["c"], "c")
    assert np.all(x["c"] == 0.0)
    np.testing.assert_array_equal(j["k"], x["k"])
    # float32 values near 1e4 carry about 1e-3 of rounding each
    assert abs(float(x["x"].mean())) < 1e-2
    assert abs(float(x["x"].std()) - 1.0) < 1e-2
