"""The port's out-of-core morsel operators (``repro_torch.core.morsel``)
against the JAX package's at world 1, on the data of
``tests/dist/morsel_conformance.py`` (2000 rows, 150 keys, 300-row
morsels).

Tolerance: none.  Table results are bit-identical (floats compared by
their bits): the joins row for row, in chunk order, the groupby on
integer-valued floats (where float addition is exact), the sorts ties
included.  Float sort
keys with NaN, -0.0 and subnormals: the port's chunked sort equals the
monolithic ``dist_sort`` of both packages; the reference's chunked sort
does not (its run merge compares raw floats).
"""
import jax
import numpy as np
import pytest

from repro.core import dist_ops as JD
from repro.core import local_ops as JL
from repro.core import morsel as JM
from repro.core.context import make_context as jax_context
from repro.core.table import Table as JT
from repro_torch.core import dist_ops as TD
from repro_torch.core import local_ops as TL
from repro_torch.core import morsel as TM
from repro_torch.core.context import make_context as torch_context
from repro_torch.core.table import Table as TT

from oracles import np_sort_values

ROWS, NKEYS, CHUNK = 2000, 150, 300
OUT_CAP = 8192
# hash groupby slabs: 8 buckets of 600 slots hold any bucket of a
# shuffled morsel (600 rows at most) and of the monolithic table here
GSIZES = {"num_buckets": 8, "bucket_capacity": 600}
AGGS = {"lv": ["sum", "mean", "count", "min", "max"]}


@pytest.fixture(scope="module")
def ctxs():
    return jax_context(jax.make_mesh((1,), ("rows",))), torch_context("cpu")


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(1)
    left = {"k": rng.integers(0, NKEYS, ROWS).astype(np.int64),
            "lv": rng.integers(-50, 50, ROWS).astype(np.float64)}
    right = {"k": np.arange(NKEYS, dtype=np.int64),
             "rv": rng.integers(0, 100, NKEYS).astype(np.float64)}
    return left, right


def assert_bits(got: dict, want: dict, msg=""):
    """Same columns, dtypes and values, floats by their bits."""
    assert list(got) == list(want), msg
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype, (msg, k, g.dtype, w.dtype)
        if w.dtype == np.float32:
            g, w = g.view(np.int32), w.view(np.int32)
        np.testing.assert_array_equal(g, w, err_msg=f"{msg} col={k}")


@pytest.mark.parametrize("impl", ["sortmerge", "hash"])
@pytest.mark.parametrize("build,rchunk", [("resident", NKEYS),
                                          ("restream", 64)])
def test_chunked_join_matches_jax(ctxs, data, build, rchunk, impl):
    jctx, tctx = ctxs
    left, right = data
    kw = dict(left_on=["k"], build=build, out_capacity_per_shard=OUT_CAP,
              local_impl=impl)
    want, wd = JM.chunked_dist_join(jctx, JM.ChunkedTable(left, CHUNK),
                                    JM.ChunkedTable(right, rchunk), **kw)
    got, gd = TM.chunked_dist_join(tctx, TM.ChunkedTable(left, CHUNK),
                                   TM.ChunkedTable(right, rchunk), **kw)
    assert wd == gd == 0
    assert len(got["k"]) == ROWS
    assert_bits(got, want, f"join/{build}/{impl}")


@pytest.mark.parametrize("impl", ["sortmerge", "hash"])
def test_chunked_left_join_with_unmatched_rows(ctxs, data, impl):
    jctx, tctx = ctxs
    left, right = data
    rsub = {k: v[::2] for k, v in right.items()}     # odd keys unmatched
    kw = dict(left_on=["k"], how="left", out_capacity_per_shard=OUT_CAP,
              local_impl=impl)
    want, wd = JM.chunked_dist_join(jctx, JM.ChunkedTable(left, CHUNK),
                                    rsub, **kw)
    got, gd = TM.chunked_dist_join(tctx, TM.ChunkedTable(left, CHUNK),
                                   rsub, **kw)
    assert wd == gd == 0
    assert np.isnan(got["rv"]).any()
    assert_bits(got, want, f"join/left/{impl}")


@pytest.mark.parametrize("impl", ["sort", "hash"])
def test_chunked_groupby_matches_jax_and_monolithic(ctxs, data, impl):
    jctx, tctx = ctxs
    left, _ = data
    gs = GSIZES if impl == "hash" else None
    want, wd = JM.chunked_dist_groupby(
        jctx, JM.ChunkedTable(left, CHUNK), ["k"], AGGS,
        group_capacity_per_shard=NKEYS, local_impl=impl, groupby_sizes=gs)
    got, gd = TM.chunked_dist_groupby(
        tctx, TM.ChunkedTable(left, CHUNK), ["k"], AGGS,
        group_capacity_per_shard=NKEYS, local_impl=impl, groupby_sizes=gs)
    assert wd == gd == 0
    assert len(got["k"]) == NKEYS
    assert_bits(got, want, f"groupby/{impl}")
    mono, md = TD.dist_groupby(tctx, TD.distribute_table(tctx, left), ["k"],
                               AGGS, local_impl=impl, groupby_sizes=gs)
    assert int(md) == 0
    assert_bits(got, TD.collect_table(tctx, mono), f"groupby/{impl}/mono")


@pytest.mark.parametrize("ascending", [True, False])
def test_chunked_sort_matches_jax(ctxs, data, ascending):
    jctx, tctx = ctxs
    left, _ = data
    want, wd = JM.chunked_dist_sort(jctx, JM.ChunkedTable(left, CHUNK),
                                    ["k"], ascending=ascending)
    got, gd = TM.chunked_dist_sort(tctx, TM.ChunkedTable(left, CHUNK),
                                   ["k"], ascending=ascending)
    assert wd == gd == 0
    assert_bits(got, want, f"sort asc={ascending}")
    mono, _ = TD.dist_sort(tctx, TD.distribute_table(tctx, left), ["k"],
                           ascending=ascending)
    assert_bits(got, TD.collect_table(tctx, mono), "sort/mono")


# --------------------------------------------------------------------------
# the k-way run merge (mirrors tests/test_morsel.py)
# --------------------------------------------------------------------------


@pytest.mark.parametrize("ascending", [True, False])
def test_merge_sorted_runs_matches_stable_sort(ascending, rng):
    data = {"k": rng.integers(0, 9, 200).astype(np.int32),
            "v": np.arange(200, dtype=np.int32)}
    want = np_sort_values(data, ["k"], ascending=ascending)
    runs = [np_sort_values({c: v[lo:lo + 48] for c, v in data.items()},
                           ["k"], ascending=ascending)
            for lo in range(0, 200, 48)]
    got = TM.merge_sorted_runs(runs, ["k"], ascending=ascending)
    assert_bits(got, want)
    assert_bits(got, JM.merge_sorted_runs(runs, ["k"], ascending=ascending))


def test_merge_sorted_runs_descending_floats_and_multikey(rng):
    data = {"k": rng.integers(0, 5, 120).astype(np.float32),
            "s": rng.integers(0, 3, 120).astype(np.int32),
            "v": np.arange(120, dtype=np.int32)}
    want = np_sort_values(data, ["k", "s"], ascending=False)
    runs = [np_sort_values({c: v[lo:lo + 40] for c, v in data.items()},
                           ["k", "s"], ascending=False)
            for lo in range(0, 120, 40)]
    got = TM.merge_sorted_runs(runs, ["k", "s"], ascending=False)
    assert_bits(got, want)


def test_merge_sorted_runs_degenerate():
    assert TM.merge_sorted_runs([], ["k"]) == {}
    one = {"k": np.arange(4, dtype=np.int32)}
    np.testing.assert_array_equal(
        TM.merge_sorted_runs([one], ["k"])["k"], one["k"])
    empty = {"k": np.zeros(0, np.int32)}
    out = TM.merge_sorted_runs([empty, one, empty], ["k"])
    np.testing.assert_array_equal(out["k"], one["k"])


# --------------------------------------------------------------------------
# partial aggregates and their merge
# --------------------------------------------------------------------------


def test_partial_agg_columns_matches_jax():
    aggs = {"a": ["mean", "max"], "b": "count", "c": ["min", "sum"]}
    assert TL.partial_agg_columns(aggs) == JL.partial_agg_columns(aggs)
    with pytest.raises(ValueError, match="unknown aggregation"):
        TL.partial_agg_columns({"a": ["median"]})


@pytest.mark.parametrize("impl", ["sort", "hash"])
def test_merge_partial_aggregates_matches_jax(impl):
    """Two partial tables whose key union (11 keys, two shared) overflows
    the accumulator's capacity of 8: the first 8 keys survive, 3 groups
    are counted as dropped."""
    rng = np.random.default_rng(5)

    def partial(keys):
        n = len(keys)
        return {"k": keys.astype(np.int32),
                "v_sum": rng.integers(-9, 9, n).astype(np.float32),
                "v_count": rng.integers(1, 5, n).astype(np.int32),
                "v_min": rng.integers(-9, 0, n).astype(np.float32),
                "v_max": rng.integers(0, 9, n).astype(np.float32)}

    acc = partial(np.array([0, 2, 4, 6, 8, 10]))
    part = partial(np.array([1, 2, 3, 5, 8, 9, 11]))
    kw = dict(impl=impl, return_overflow=True,
              **(GSIZES if impl == "hash" else {}))
    want, wd = JL.merge_partial_aggregates(
        JT.from_dict(acc, capacity=8), JT.from_dict(part, capacity=8),
        ["k"], **kw)
    got, gd = TL.merge_partial_aggregates(
        TT.from_dict(acc, capacity=8, device="cpu"),
        TT.from_dict(part, capacity=8, device="cpu"), ["k"], **kw)
    assert int(wd) == int(gd) == 3
    assert int(got.nvalid) == int(want.nvalid) == 8
    assert_bits(got.to_numpy(), want.to_numpy(), f"merge/{impl}")
    with pytest.raises(ValueError, match="partial-aggregate"):
        bad = TT.from_dict({"k": np.arange(3), "v": np.ones(3)},
                           device="cpu")
        TL.merge_partial_aggregates(bad, bad, ["k"])


# --------------------------------------------------------------------------
# argument checks and sources
# --------------------------------------------------------------------------


def test_restream_left_join_rejected(ctxs):
    tctx = ctxs[1]
    d = {"k": np.arange(4, dtype=np.int32)}
    with pytest.raises(ValueError, match="restream"):
        TM.chunked_dist_join(tctx, d, d, left_on=["k"], how="left",
                             build="restream")
    with pytest.raises(ValueError, match="how"):
        TM.chunked_dist_join(tctx, d, d, left_on=["k"], how="outer")
    with pytest.raises(ValueError, match="build"):
        TM.chunked_dist_join(tctx, d, d, left_on=["k"], build="nope")


def test_zero_row_sources_stream_one_empty_morsel(ctxs, data):
    tctx = ctxs[1]
    _, right = data
    empty = {"k": np.zeros(0, np.int64), "lv": np.zeros(0, np.float64)}
    out, d = TM.chunked_dist_join(tctx, empty, right, left_on=["k"])
    assert d == 0 and len(out["k"]) == 0 and set(out) == {"k", "lv", "rv"}
    out, d = TM.chunked_dist_join(tctx, empty, TM.ChunkedTable(right, 64),
                                  left_on=["k"], build="restream")
    assert d == 0 and len(out["k"]) == 0
    out, d = TM.chunked_dist_groupby(tctx, empty, ["k"], {"lv": "mean"})
    assert d == 0 and len(out["k"]) == 0
    out, d = TM.chunked_dist_sort(tctx, empty, ["k"])
    assert d == 0 and len(out["k"]) == 0


def test_memmap_source_equals_in_memory(ctxs, data, tmp_path):
    tctx = ctxs[1]
    left, right = data
    mm = {}
    for name, v in left.items():
        f = np.memmap(tmp_path / f"{name}.bin", dtype=v.dtype, mode="w+",
                      shape=v.shape)
        f[:] = v
        f.flush()
        mm[name] = np.memmap(tmp_path / f"{name}.bin", dtype=v.dtype,
                             mode="r", shape=v.shape)
    seen = []
    out, d = TM.chunked_dist_join(tctx, TM.ChunkedTable(mm, CHUNK), right,
                                  left_on=["k"], sink=seen.append)
    assert out is None and d == 0 and len(seen) == -(-ROWS // CHUNK)
    want, _ = TM.chunked_dist_join(tctx, TM.ChunkedTable(left, CHUNK),
                                   right, left_on=["k"])
    assert_bits(TM._concat_parts(seen), want, "memmap")


# --------------------------------------------------------------------------
# float sort keys: NaN, -0.0 and subnormals
# --------------------------------------------------------------------------


@pytest.mark.parametrize("impl", ["xla", "radix"])
@pytest.mark.parametrize("ascending", [True, False])
def test_chunked_sort_float_keys_equal_monolithic(ctxs, ascending, impl):
    """64 rows of keys from {-0.0, 0.0, NaN, +-1.0, +-1e-40} with a row
    id, in 16-row morsels: the port's chunked sort equals the port's and
    the reference's monolithic ``dist_sort`` (NaN last, -0.0 tied with
    0.0 and the subnormals, ties in row order).  The reference's chunked
    sort does not: its merge compares raw floats, so a NaN duplicates and
    loses rows."""
    jctx, tctx = ctxs
    rng = np.random.default_rng(0)
    pool = np.float32([-0.0, 0.0, np.nan, 1.0, -1.0, 1e-40, -1e-40])
    d = {"k": rng.choice(pool, 64), "i": np.arange(64, dtype=np.int32)}
    got, gd = TM.chunked_dist_sort(tctx, TM.ChunkedTable(d, 16), ["k"],
                                   ascending=ascending, local_impl=impl)
    assert gd == 0
    mono, _ = TD.dist_sort(tctx, TD.distribute_table(tctx, d), ["k"],
                           ascending=ascending, local_impl=impl)
    assert_bits(got, TD.collect_table(tctx, mono), "port mono")
    jpipe = JD.DistributedPipeline(jctx, lambda c, t: JD.dist_sort(
        c, t, ["k"], ascending=ascending))
    jmono, _ = jpipe(JD.distribute_table(jctx, d))
    assert_bits(got, JD.collect_table(jctx, jmono), "jax mono")
    np.testing.assert_array_equal(np.sort(got["i"]), np.arange(64))
    assert np.isnan(got["k"][-int(np.isnan(d["k"]).sum()):]).all()

    # the reference's fault: its chunked sort loses and duplicates rows
    ref, _ = JM.chunked_dist_sort(jctx, JM.ChunkedTable(d, 16), ["k"],
                                  ascending=ascending)
    assert not np.array_equal(np.sort(ref["i"]), np.arange(64))

