"""Subnormal float keys in the port against the JAX package.

XLA compares a subnormal float32 as zero (on the CPU and the TPU), so the
reference puts ``1e-40``, ``-1e-40``, ``0.0`` and ``-0.0`` in one group,
one join match set, one sort run and one partition, and emits the group's
first occurrence with its own bits.  The port flushes subnormals wherever
it derives a comparison key, a sort word or hash bits
(``table.flush_subnormals``).  Everything here is exact: rows, order,
dtypes, floats by their bits.
"""
import numpy as np
import pytest
import torch

from repro.core import dist_ops as JD
from repro.core import local_ops as JL
from repro.core import partition as JP
from repro.core.table import Table as JT
from repro.kernels import bucketing as JB
from repro_torch.core import dist_ops as TD
from repro_torch.core import local_ops as TL
from repro_torch.core import partition as TP
from repro_torch.core.table import Table as TT
from repro_torch.core.table import flush_subnormals, flush_subnormals_np
from repro_torch.kernels import bucketing as TB

EXAMPLE = np.array([1e-40, 0, -1e-40, 1, 1e-40, 0], np.float32)
TINY = np.float32([1e-40, -1e-40, 1e-45, -1e-45, 1.1e-38, -0.0, 0.0])


@pytest.fixture(autouse=True)
def _defaults(monkeypatch):
    for var in ("REPRO_SEMI_IMPL", "REPRO_GROUPBY_IMPL", "REPRO_SORT_IMPL",
                "REPRO_KERNEL_IMPL", "REPRO_JOIN_IMPL"):
        monkeypatch.delenv(var, raising=False)


def both(data, capacity=None):
    return (JT.from_dict(data, capacity=capacity),
            TT.from_dict(data, capacity=capacity, device="cpu"))


def assert_same(jout, tout, msg=""):
    j, x = jout.to_numpy(), tout.to_numpy()
    assert int(np.asarray(jout.nvalid)) == int(tout.nvalid), msg
    assert list(j) == list(x), msg
    for k in j:
        a, b = np.asarray(j[k]), x[k]
        assert a.dtype == b.dtype, (msg, k)
        if a.dtype == np.float32:
            a, b = a.view(np.int32), b.view(np.int32)
        np.testing.assert_array_equal(a, b, err_msg=f"{msg} col={k}")


def keys_with_subnormals(rng, n):
    pool = np.concatenate([TINY, np.float32([1.0, -2.5, 3.0e-38, np.inf,
                                             np.nan])])
    return rng.choice(pool, n)


def test_flush_keeps_normals_and_nan():
    x = np.float32([1e-40, -1e-40, -0.0, 1.2e-38, -1.2e-38, np.nan, np.inf,
                    -3.0])
    got = flush_subnormals(torch.from_numpy(x)).numpy()
    want = np.float32([0, 0, 0, 1.2e-38, -1.2e-38, np.nan, np.inf, -3.0])
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    np.testing.assert_array_equal(flush_subnormals_np(x).view(np.int32),
                                  want.view(np.int32))
    i = torch.arange(5, dtype=torch.int32)
    assert flush_subnormals(i) is i


@pytest.mark.parametrize("impl", ["sort", "hash"])
def test_groupby_example(impl):
    data = {"k": EXAMPLE, "v": np.arange(6, dtype=np.float32)}
    jt, tt = both(data)
    got = TL.groupby_aggregate(tt, ["k"], {"v": ["sum"]}, impl=impl)
    out = got.to_numpy()
    assert int(got.nvalid) == 2
    np.testing.assert_array_equal(out["k"].view(np.int32),
                                  np.float32([1e-40, 1]).view(np.int32))
    np.testing.assert_array_equal(out["v_sum"], [12, 3])
    assert_same(JL.groupby_aggregate(jt, ["k"], {"v": ["sum"]}, impl=impl),
                got)


@pytest.mark.parametrize("impl", ["sortmerge", "hash"])
def test_join_example(impl):
    left = {"k": EXAMPLE, "v": np.arange(6, dtype=np.float32)}
    right = {"k": np.float32([0.0]), "w": np.float32([7.0])}
    (jl, tl), (jr, tr) = both(left), both(right)
    got = TL.join(tl, tr, left_on=["k"], impl=impl, out_capacity=8)
    assert int(got.nvalid) == 5
    assert_same(JL.join(jl, jr, left_on=["k"], impl=impl, out_capacity=8),
                got)


@pytest.mark.parametrize("ascending", [True, False])
@pytest.mark.parametrize("impl", ["xla", "radix"])
def test_sort_values_matches_jax(impl, ascending, rng):
    data = {"k": keys_with_subnormals(rng, 60),
            "i": rng.integers(0, 3, 60).astype(np.int32),
            "row": np.arange(60, dtype=np.int32)}
    jt, tt = both(data, 64)
    assert_same(JL.sort_values(jt, ["k", "i"], ascending, impl=impl),
                TL.sort_values(tt, ["k", "i"], ascending, impl=impl))


@pytest.mark.parametrize("impl", ["sort", "hash"])
@pytest.mark.parametrize("op", ["groupby", "unique"])
def test_groupby_and_dedup_match_jax(op, impl, rng):
    data = {"k": keys_with_subnormals(rng, 80),
            "j": rng.integers(0, 2, 80).astype(np.int32),
            "v": rng.integers(-9, 9, 80).astype(np.float32)}
    jt, tt = both(data, 90)
    if op == "groupby":
        aggs = {"v": ["sum", "count", "min"]}
        assert_same(JL.groupby_aggregate(jt, ["k", "j"], aggs, impl=impl),
                    TL.groupby_aggregate(tt, ["k", "j"], aggs, impl=impl))
    else:
        assert_same(JL.drop_duplicates(jt, ["k"], impl=impl),
                    TL.drop_duplicates(tt, ["k"], impl=impl))


@pytest.mark.parametrize("impl", ["sortmerge", "hash"])
@pytest.mark.parametrize("how", ["inner", "left"])
def test_join_matches_jax(how, impl, rng):
    left = {"k": keys_with_subnormals(rng, 40),
            "v": rng.normal(size=40).astype(np.float32)}
    right = {"k": keys_with_subnormals(rng, 30),
             "w": rng.normal(size=30).astype(np.float32)}
    (jl, tl), (jr, tr) = both(left, 44), both(right, 32)
    kw = dict(left_on=["k"], how=how, impl=impl, out_capacity=1300)
    assert_same(JL.join(jl, jr, **kw), TL.join(tl, tr, **kw), how)


@pytest.mark.parametrize("impl", ["sortmerge", "hash"])
def test_isin_matches_jax(impl, rng):
    a = {"k": keys_with_subnormals(rng, 50)}
    b = {"k": np.float32([0.0, 1.0, np.inf])}
    (ja, ta), (jb, tb) = both(a, 52), both(b, 4)
    got = TL.isin(ta, "k", tb, "k", impl=impl)
    np.testing.assert_array_equal(
        np.asarray(JL.isin(ja, "k", jb, "k", impl=impl)), got.numpy())
    assert got[:50].numpy()[np.isin(a["k"], TINY)].all()


def test_hash_bits_match_jax_and_flush():
    """Partition hashes and bucket planes: subnormals hash as +0.0, the
    numpy copies equal the tensor code and the reference."""
    cols = [np.concatenate([TINY, np.float32([1.0, np.nan, -7.5])])]
    tt = TT.from_dict({"k": cols[0]}, device="cpu")
    h = TP.hash_columns([tt.columns["k"]]).numpy()
    assert len(set(h[:len(TINY)].tolist())) == 1
    np.testing.assert_array_equal(h.astype(np.uint32),
                                  TP.hash_columns_np(cols))
    np.testing.assert_array_equal(
        TP.hash_columns_np(cols),
        np.asarray(JP.hash_columns([JT.from_dict({"k": cols[0]})
                                    .columns["k"]])).astype(np.uint32))
    np.testing.assert_array_equal(
        TB.key_bits(torch.from_numpy(cols[0])).numpy(),
        TB.key_bits_np(cols[0]))
    np.testing.assert_array_equal(
        TB.key_bits_np(cols[0]),
        np.asarray(JB.key_bits(JT.from_dict({"k": cols[0]}).columns["k"])))


def test_plan_dist_join_sizes_matches_jax(rng):
    lk = keys_with_subnormals(rng, 200)
    rk = keys_with_subnormals(rng, 150)
    for impl in ("sortmerge", "hash"):
        kw = dict(world=2, local_impl=impl)
        assert TD.plan_dist_join_sizes([lk], [rk], **kw) == \
            JD.plan_dist_join_sizes([lk], [rk], **kw)
