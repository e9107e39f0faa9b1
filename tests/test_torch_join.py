"""The port's sort, local join (both backends), join planner and
distributed join at world 1 against the JAX package, bit for bit.

The same seeded numpy tables go through both packages; outputs compare
column by column (floats by their bits), with ``nvalid`` and the drop
counters.  JAX results are cached in module-scoped fixtures.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from repro.core import dist_ops as JD
from repro.core import local_ops as JL
from repro.core.context import make_context as jax_context
from repro.core.table import Table as JTable
from repro_torch.core import dist_ops as TD
from repro_torch.core import local_ops as TL
from repro_torch.core.context import make_context
from repro_torch.core.table import Table as TTable

ROWS = 48
DISTS = ["unique", "dup10", "alldup", "empty_left", "empty_right",
         "empty_both"]
OUT_CAP = ROWS * ROWS + ROWS


@pytest.fixture(autouse=True)
def _default_backends(monkeypatch):
    for var in ("REPRO_JOIN_IMPL", "REPRO_SORT_IMPL", "REPRO_KERNEL_IMPL",
                "REPRO_GROUPBY_IMPL"):
        monkeypatch.delenv(var, raising=False)


def make_sides(dist: str, seed: int):
    """The key distributions of tests/test_join_backends.py."""
    rng = np.random.default_rng(seed)
    if dist == "unique":
        lk = rng.permutation(np.arange(ROWS, dtype=np.int32))
        rk = rng.permutation(np.arange(ROWS, dtype=np.int32))
    elif dist == "dup10":
        nk = max(ROWS // 10, 1)
        lk = rng.integers(0, nk, ROWS).astype(np.int32)
        rk = rng.integers(0, nk, ROWS).astype(np.int32)
    elif dist == "alldup":
        lk = np.full(ROWS, 3, np.int32)
        rk = np.full(ROWS, 3, np.int32)
    elif dist == "empty_left":
        lk = np.zeros(0, np.int32)
        rk = rng.integers(0, 8, ROWS).astype(np.int32)
    elif dist == "empty_right":
        lk = rng.integers(0, 8, ROWS).astype(np.int32)
        rk = np.zeros(0, np.int32)
    else:
        lk = rk = np.zeros(0, np.int32)
    left = {"k": lk, "lv": rng.normal(size=len(lk)).astype(np.float32)}
    right = {"k": rk, "rv": rng.normal(size=len(rk)).astype(np.float32)}
    return left, right


def both(data: dict, capacity: int):
    return (JTable.from_dict(data, capacity=capacity),
            TTable.from_dict(data, capacity=capacity, device="cpu"))


def assert_same(jout, tout, msg=""):
    """Valid rows equal bit for bit, dtypes and column order included."""
    j = jout.to_numpy()
    x = tout.to_numpy()
    assert int(np.asarray(jout.nvalid).reshape(-1)[0]) == int(tout.nvalid)
    assert list(j) == list(x), msg
    for k in j:
        a, b = np.asarray(j[k]), x[k]
        assert a.dtype == b.dtype, (msg, k, a.dtype, b.dtype)
        if a.dtype == np.float32:
            a, b = a.view(np.int32), b.view(np.int32)
        np.testing.assert_array_equal(a, b, err_msg=f"{msg} col={k}")


def run_local(lib, lt, rt, impl, **kw):
    sizes = dict(num_buckets=8, bucket_capacity=max(ROWS, 8),
                 probe_capacity=max(ROWS, 8)) if impl == "hash" else {}
    return lib.join(lt, rt, impl=impl, return_overflow=True,
                    **sizes, **kw)


@pytest.fixture(scope="module")
def jax_local():
    """JAX join output per (dist, how, impl), computed once."""
    out = {}
    for dist in DISTS:
        left, right = make_sides(dist, 7)
        lt = JTable.from_dict(left, capacity=max(len(left["k"]), 1) + 5)
        rt = JTable.from_dict(right, capacity=max(len(right["k"]), 1) + 3)
        for how in ("inner", "left"):
            for impl in ("sortmerge", "hash"):
                out[dist, how, impl] = run_local(
                    JL, lt, rt, impl, left_on=["k"], how=how,
                    out_capacity=OUT_CAP)
    return out


@pytest.mark.parametrize("impl", ["sortmerge", "hash"])
@pytest.mark.parametrize("how", ["inner", "left"])
@pytest.mark.parametrize("dist", DISTS)
def test_local_join_matches_jax(jax_local, dist, how, impl):
    left, right = make_sides(dist, 7)
    lt = TTable.from_dict(left, capacity=max(len(left["k"]), 1) + 5,
                          device="cpu")
    rt = TTable.from_dict(right, capacity=max(len(right["k"]), 1) + 3,
                          device="cpu")
    tout, tover = run_local(TL, lt, rt, impl, left_on=["k"], how=how,
                            out_capacity=OUT_CAP)
    jout, jover = jax_local[dist, how, impl]
    assert int(tover) == int(jover) == 0
    assert tover.dtype == torch.int32
    assert_same(jout, tout, f"{dist}/{how}/{impl}")


@pytest.mark.parametrize("impl", ["sortmerge", "hash"])
@pytest.mark.parametrize("how", ["inner", "left"])
@pytest.mark.parametrize("case", ["multikey", "renamed", "mixed_dtype"])
def test_key_shapes_match_jax(case, how, impl, rng):
    n, m = 30, 25
    if case == "multikey":
        left = {"a": rng.integers(0, 4, n).astype(np.int32),
                "b": rng.integers(0, 3, n).astype(np.int32),
                "lv": rng.normal(size=n).astype(np.float32)}
        right = {"a": rng.integers(0, 4, m).astype(np.int32),
                 "b": rng.integers(0, 3, m).astype(np.int32),
                 "rv": rng.normal(size=m).astype(np.float32)}
        on = dict(left_on=["a", "b"])
    elif case == "renamed":
        left = {"k": rng.integers(0, 6, n).astype(np.int32),
                "v": rng.normal(size=n).astype(np.float32)}
        right = {"key": rng.integers(0, 6, m).astype(np.int32),
                 "v": rng.normal(size=m).astype(np.float32)}
        on = dict(left_on=["k"], right_on=["key"])
    else:
        # int32 probe keys against float32 build keys: 3 must not equal 3.5
        left = {"k": rng.integers(0, 6, n).astype(np.int32),
                "lv": rng.normal(size=n).astype(np.float32)}
        right = {"k": (rng.integers(0, 12, m) / 2).astype(np.float32),
                 "rv": rng.normal(size=m).astype(np.float32)}
        right["k"][:3] = [-0.0, 0.0, np.nan]
        on = dict(left_on=["k"])
    jl, tl = both(left, n + 4)
    jr, tr = both(right, m + 2)
    kw = dict(how=how, out_capacity=512, **on)
    jout, jover = run_local(JL, jl, jr, impl, **kw)
    tout, tover = run_local(TL, tl, tr, impl, **kw)
    assert int(jover) == int(tover) == 0
    assert_same(jout, tout, f"{case}/{how}/{impl}")


@pytest.mark.parametrize("case,impl", [
    ("build", "hash"), ("probe", "hash"), ("probe_left", "hash"),
    ("out", "hash"), ("out", "sortmerge")])
def test_overflow_counters_match_jax(case, impl):
    """alldup keys with capacities below the duplicate count: the counters
    trip at capacity, identically in both packages."""
    n = 24
    left = {"k": np.full(n, 1, np.int32), "lv": np.arange(n, dtype=np.float32)}
    right = {"k": np.full(n, 1, np.int32),
             "rv": np.arange(n, dtype=np.float32)}
    jl, tl = both(left, n)
    jr, tr = both(right, n)
    kw = {"build": dict(num_buckets=4, bucket_capacity=8, probe_capacity=n,
                        out_capacity=n * n),
          "probe": dict(num_buckets=4, bucket_capacity=n, probe_capacity=8,
                        out_capacity=n * n),
          "probe_left": dict(num_buckets=4, bucket_capacity=n,
                             probe_capacity=8, out_capacity=n * n,
                             how="left"),
          "out": dict(out_capacity=100)}[case]
    if impl == "hash" and case == "out":
        kw.update(num_buckets=4, bucket_capacity=n, probe_capacity=n)
    jout, jover = JL.join(jl, jr, left_on=["k"], return_overflow=True,
                          impl=impl, **kw)
    tout, tover = TL.join(tl, tr, left_on=["k"], return_overflow=True,
                          impl=impl, **kw)
    assert int(tover) == int(jover) > 0
    assert_same(jout, tout, f"{case}/{impl}")


def test_planned_eager_hash_join_matches_jax(rng):
    """Above EXACT_SLAB_CAP a direct join plans its slabs from the keys,
    as the reference's eager join does."""
    n = 600
    left = {"k": rng.integers(0, 60, n).astype(np.int32),
            "lv": rng.normal(size=n).astype(np.float32)}
    right = {"k": rng.integers(0, 60, n).astype(np.int32),
             "rv": rng.normal(size=n).astype(np.float32)}
    jl, tl = both(left, n)
    jr, tr = both(right, n)
    kw = dict(left_on=["k"], out_capacity=8000, return_overflow=True,
              impl="hash")
    jout, jover = JL.join(jl, jr, **kw)
    tout, tover = TL.join(tl, tr, **kw)
    assert int(jover) == int(tover) == 0
    assert_same(jout, tout, "planned")


def test_pair_space_limit_raises(rng):
    data = {"k": np.arange(8, dtype=np.int32)}
    tl = TTable.from_dict(data, device="cpu")
    with pytest.raises(ValueError, match="2\\*\\*31"):
        TL.join(tl, tl, left_on=["k"], impl="hash", num_buckets=512,
                bucket_capacity=2128, probe_capacity=2128)


@pytest.mark.parametrize("ascending", [True, False])
def test_sort_values_float_order_matches_jax(ascending, rng):
    vals = np.array([np.nan, -0.0, 0.0, -np.inf, np.inf, 1.0, -1.0, -0.0,
                     np.nan, 2.5, 1.0, -np.inf], np.float32)
    n = 60
    data = {"f": rng.choice(vals, n),
            "i": rng.integers(-3, 3, n).astype(np.int32),
            "row": np.arange(n, dtype=np.int32)}
    jt, tt = both(data, n + 6)
    jt, tt = jt.with_nvalid(n - 4), tt.with_nvalid(n - 4)
    for by in (["f"], ["i", "f"], ["f", "i"]):
        js = JL.sort_values(jt, by, ascending=ascending, impl="xla")
        ts = TL.sort_values(tt, by, ascending=ascending)
        assert_same(js, ts, f"sort {by}")
        np.testing.assert_array_equal(np.asarray(js.columns["row"]),
                                      ts.columns["row"].numpy())


def test_sort_backends_outside_this_slice_raise():
    """Unknown backends raise; the radix sort backend is ported and
    gives the xla backend's rows."""
    tt = TTable.from_dict({"k": np.array([3, -1, 2, -1])}, device="cpu")
    assert TL.sort_values(tt, ["k"], impl="radix").columns["k"].tolist() \
        == TL.sort_values(tt, ["k"], impl="xla").columns["k"].tolist() \
        == [-1, -1, 2, 3]
    with pytest.raises(ValueError, match="unknown sort impl"):
        TL.sort_values(tt, ["k"], impl="nope")
    with pytest.raises(ValueError):
        TL.join(tt, tt, left_on=["k"], impl="nope")


@pytest.mark.parametrize("side", ["left", "right"])
def test_lex_searchsorted_matches_jax(side, rng):
    a = np.sort(rng.integers(0, 5, 40)).astype(np.int32)
    b = rng.integers(0, 4, 40).astype(np.int32)
    order = np.lexsort((b, a))
    sk = (a[order], b[order])
    q = (rng.integers(-1, 6, 33).astype(np.int32),
         rng.integers(-1, 5, 33).astype(np.int32))
    j = JL.lex_searchsorted(tuple(jnp.asarray(x) for x in sk),
                            tuple(jnp.asarray(x) for x in q), side=side)
    x = TL.lex_searchsorted(tuple(torch.from_numpy(x) for x in sk),
                            tuple(torch.from_numpy(x) for x in q), side=side)
    np.testing.assert_array_equal(np.asarray(j), x.numpy())
    assert x.dtype == torch.int32


@pytest.mark.parametrize("world", [1, 3])
@pytest.mark.parametrize("how", ["inner", "left"])
@pytest.mark.parametrize("local_impl", [None, "hash"])
@pytest.mark.parametrize("keys", ["int", "float", "two"])
def test_plan_dist_join_sizes_matches_jax(keys, local_impl, how, world, rng):
    n = 500
    if keys == "int":
        lk = [rng.integers(-50, 50, n)]
        rk = [rng.integers(-50, 50, n + 13)]
    elif keys == "float":
        lk = [rng.choice(np.array([0.0, -0.0, 1.5, np.nan, 2.0]), n)]
        rk = [rng.integers(0, 3, n + 13).astype(np.int32)]
    else:
        lk = [rng.integers(0, 9, n), rng.integers(0, 4, n)]
        rk = [rng.integers(0, 9, n + 13), rng.integers(0, 4, n + 13)]
    kw = dict(world=world, how=how, local_impl=local_impl)
    assert TD.plan_dist_join_sizes(lk, rk, **kw) == \
        JD.plan_dist_join_sizes(lk, rk, **kw)


def fig4_sides(rows, seed=0):
    rng = np.random.default_rng(seed)
    nk = max(rows // 10, 1)
    left = {"k": rng.integers(0, nk, rows).astype(np.int32),
            "lv": rng.normal(size=rows).astype(np.float32)}
    right = {"key": rng.integers(0, nk, rows).astype(np.int32),
             "rv": rng.normal(size=rows).astype(np.float32)}
    return left, right


DIST_CASES = {
    "planned": dict(planned=True),
    "overcommit": dict(planned=False, out_capacity=20000),
    "tight": dict(planned=False, shuffle_sizes={"left": (900, 900),
                                                "right": (1000, 950)},
                  out_capacity=5000),
}


@pytest.fixture(scope="module")
def jax_dist():
    """JAX DistributedPipeline outputs at world 1, computed once."""
    ctx = jax_context(Mesh(np.array(jax.devices()[:1]), ("data",)))
    left, right = fig4_sides(1000)
    out = {}
    for case, spec in DIST_CASES.items():
        for impl in ("sortmerge", "hash"):
            kw = dist_kwargs(JD, left, right, impl, spec)
            pipe = JD.DistributedPipeline(
                ctx, lambda c, a, b, kw=kw: JD.dist_join(c, a, b, **kw))
            res, dropped = pipe(JD.distribute_table(ctx, left),
                                JD.distribute_table(ctx, right))
            out[case, impl] = (JD.collect_table(ctx, res),
                               int(np.asarray(dropped).max()))
    return out


def dist_kwargs(lib, left, right, impl, spec):
    kw = dict(left_on=["k"], right_on=["key"], local_impl=impl)
    if spec["planned"]:
        plan = lib.plan_dist_join_sizes([left["k"]], [right["key"]], world=1,
                                        local_impl=impl)
        kw.update(out_capacity=plan["out_capacity"],
                  shuffle_sizes=plan["shuffle_sizes"],
                  local_join_sizes=plan["local_join_sizes"])
    else:
        kw.update(shuffle_sizes=spec.get("shuffle_sizes"),
                  out_capacity=spec.get("out_capacity"))
        if impl == "hash":
            kw["local_join_sizes"] = dict(num_buckets=64,
                                          bucket_capacity=64,
                                          probe_capacity=64)
    return kw


@pytest.mark.parametrize("impl", ["sortmerge", "hash"])
@pytest.mark.parametrize("case", list(DIST_CASES))
def test_dist_join_world1_matches_jax(jax_dist, case, impl):
    left, right = fig4_sides(1000)
    ctx = make_context("cpu")
    kw = dist_kwargs(TD, left, right, impl, DIST_CASES[case])
    pipe = TD.DistributedPipeline(
        ctx, lambda c, a, b: TD.dist_join(c, a, b, **kw))
    res, dropped = pipe(TD.distribute_table(ctx, left),
                        TD.distribute_table(ctx, right))
    got = TD.collect_table(ctx, res)
    want, wdrop = jax_dist[case, impl]
    assert int(dropped) == wdrop
    assert (wdrop > 0) == (case == "tight")
    assert list(got) == list(want)
    for k in want:
        a, b = np.asarray(want[k]), got[k]
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32),
                                      err_msg=f"{case}/{impl}/{k}")


def test_dist_join_hash_matches_sortmerge_bits(jax_dist):
    a, b = jax_dist["planned", "sortmerge"][0], jax_dist["planned", "hash"][0]
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]).view(np.int32),
                                      np.asarray(b[k]).view(np.int32))


@pytest.mark.parametrize("impl", ["sortmerge", "hash"])
def test_broadcast_strategy_names_the_radix_slice(impl):
    """The broadcast join (all_gather_table on the 1-bit radix pass, then
    the local join) matches the JAX package at world 1."""
    rng = np.random.default_rng(5)
    left = {"k": rng.integers(0, 40, 300).astype(np.int32),
            "lv": rng.normal(size=300).astype(np.float32)}
    right = {"k": rng.permutation(np.arange(50, dtype=np.int32))[:45],
             "rv": rng.normal(size=45).astype(np.float32)}
    kw = dict(left_on=["k"], strategy="broadcast", local_impl=impl,
              local_join_sizes=dict(num_buckets=8, bucket_capacity=48,
                                    probe_capacity=300)
              if impl == "hash" else None)
    jctx = jax_context(Mesh(np.array(jax.devices()[:1]), ("data",)))
    jres, jdrop = JD.DistributedPipeline(
        jctx, lambda c, a, b: JD.dist_join(c, a, b, **kw))(
        JD.distribute_table(jctx, left, 320),
        JD.distribute_table(jctx, right, 48))
    ctx = make_context("cpu")
    tres, tdrop = TD.dist_join(ctx, TD.distribute_table(ctx, left, 320),
                               TD.distribute_table(ctx, right, 48), **kw)
    want, got = JD.collect_table(jctx, jres), TD.collect_table(ctx, tres)
    assert int(np.asarray(jdrop).max()) == int(tdrop) == 0
    assert list(want) == list(got) and len(got["k"]) > 0
    for k in want:
        np.testing.assert_array_equal(np.asarray(want[k]).view(np.int32),
                                      got[k].view(np.int32), err_msg=k)
    with pytest.raises(ValueError, match="unknown join strategy"):
        TD.dist_join(ctx, tres, tres, left_on=["k"], strategy="nope")
