"""The PyTorch port's Table, backend selection, context and host adapters
against the JAX package: the same numpy inputs through both, compared
exactly (integers, and float columns by their bits)."""
import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from repro.core import dist_ops as D
from repro.core import table as JT
from repro.core.context import make_context as jax_context
from repro_torch.core import dist_ops as TD
from repro_torch.core import kernel_backend as KB
from repro_torch.core import table as TT
from repro_torch.core.context import make_context

CPU = torch.device("cpu")


def bits(a):
    """Float arrays compared by their bits (NaN payloads and -0.0 too)."""
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def assert_same_columns(jcols: dict, tcols: dict):
    assert list(jcols) == list(tcols)
    for k in jcols:
        j, t = np.asarray(jcols[k]), np.asarray(tcols[k])
        assert j.dtype == t.dtype, (k, j.dtype, t.dtype)
        np.testing.assert_array_equal(bits(j), bits(t), err_msg=k)


def jax_state(t: JT.Table):
    return ({k: np.asarray(v) for k, v in t.columns.items()},
            int(np.asarray(t.nvalid).reshape(-1)[0]))


@pytest.fixture
def data(rng):
    f = rng.normal(size=12).astype(np.float64)
    f[[1, 5]] = [-0.0, np.nan]
    return {"i64": rng.integers(-50, 50, 12).astype(np.int64),
            "f64": f, "b": rng.integers(0, 2, 12).astype(bool),
            "i32": rng.integers(-2**31, 2**31 - 1, 12).astype(np.int32)}


@pytest.mark.parametrize("capacity", [None, 12, 20])
def test_from_dict_state_matches_jax(data, capacity):
    jt = JT.Table.from_dict(data, capacity=capacity)
    tt = TT.Table.from_dict(data, capacity=capacity, device="cpu")
    jcols, jn = jax_state(jt)
    tcols, tn = tt.state()
    assert jn == tn == 12
    assert tt.capacity == jt.capacity and tt.names == jt.names
    assert tt.nvalid.dtype == torch.int32 and tt.device == CPU
    assert_same_columns(jcols, tcols)
    assert_same_columns(jt.to_numpy(), tt.to_numpy())
    np.testing.assert_array_equal(np.asarray(jt.valid_mask),
                                  tt.valid_mask.numpy())


def test_from_state_round_trip(data):
    jt = JT.Table.from_dict(data, capacity=16).with_nvalid(9)
    cols, n = jax_state(jt)
    tt = TT.Table.from_state(cols, n, device="cpu")
    assert int(tt.nvalid) == 9
    assert_same_columns(cols, tt.state()[0])
    assert_same_columns(jt.to_numpy(), tt.to_numpy())


def test_row_ops_match_jax(data, rng):
    jt = JT.Table.from_dict(data, capacity=16)
    tt = TT.Table.from_dict(data, capacity=16, device="cpu")
    idx = rng.integers(0, 16, 10).astype(np.int32)
    jg = jt.gather_rows(jax.numpy.asarray(idx), 7)
    tg = tt.gather_rows(torch.from_numpy(idx), 7)
    assert_same_columns(jax_state(jg)[0], tg.state()[0])
    assert int(tg.nvalid) == 7
    assert_same_columns(jt.with_nvalid(4).to_numpy(),
                        tt.with_nvalid(4).to_numpy())
    jr = jt.rename({"i64": "key", "b": "flag"})
    tr = tt.rename({"i64": "key", "b": "flag"})
    assert tr.names == jr.names
    assert_same_columns(jax_state(jr)[0], tr.state()[0])


def test_narrowing_and_nulls_match_jax():
    wide = {"k": np.array([0, 2**32], np.int64)}
    for build in (lambda: JT.Table.from_dict(wide),
                  lambda: TT.Table.from_dict(wide, device="cpu")):
        with pytest.raises(ValueError, match="int32 range"):
            build()
    with pytest.raises(TypeError):
        TT.narrow_column("s", np.array(["a"]))
    edge = np.array([2**31 - 1, -2**31], np.int64)
    np.testing.assert_array_equal(JT.narrow_column("k", edge),
                                  TT.narrow_column("k", edge))
    assert TT.INT_NULL == JT.INT_NULL
    col_i = torch.zeros(3, dtype=torch.int32)
    col_f = torch.zeros(3, dtype=torch.float32)
    np.testing.assert_array_equal(
        TT.null_like(col_i).numpy(),
        np.asarray(JT.null_like(jax.numpy.zeros(3, jax.numpy.int32))))
    assert torch.isnan(TT.null_like(col_f)).all()


def test_kernel_backend_selection(monkeypatch):
    monkeypatch.delenv("REPRO_KERNEL_IMPL", raising=False)
    monkeypatch.delenv("REPRO_JOIN_IMPL", raising=False)
    monkeypatch.delenv("REPRO_SORT_IMPL", raising=False)
    monkeypatch.delenv("REPRO_GROUPBY_IMPL", raising=False)
    assert KB.table_kernel_impl(CPU) == "ref"
    assert KB.table_kernel_impl(torch.device("cuda")) == "cuda"
    assert KB.join_impl() == "sortmerge" and KB.sort_impl() == "xla"
    assert KB.groupby_impl() == "sort"
    monkeypatch.setenv("REPRO_KERNEL_IMPL", "cuda")
    with pytest.raises(ValueError, match="cannot run on a cpu tensor"):
        KB.table_kernel_impl(CPU)
    monkeypatch.setenv("REPRO_KERNEL_IMPL", "ref")
    assert KB.table_kernel_impl(CPU) == "ref"
    with pytest.raises(ValueError):
        KB.table_kernel_impl(torch.device("cuda"))
    monkeypatch.setenv("REPRO_JOIN_IMPL", "hash")
    assert KB.join_impl() == "hash"
    monkeypatch.setenv("REPRO_SORT_IMPL", "radix")
    assert KB.sort_impl() == "radix"
    monkeypatch.setenv("REPRO_GROUPBY_IMPL", "hash")
    assert KB.groupby_impl() == "hash"


def test_context_defaults_to_the_card(monkeypatch):
    ctx = make_context("cpu")
    assert (ctx.world_size, ctx.rank, ctx.device) == (1, 0, CPU)
    x = torch.arange(6, dtype=torch.int32).reshape(1, 2, 3)
    assert ctx.all_to_all(x) is x and ctx.psum(x) is x
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_context()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TT.Table.from_dict({"k": np.arange(3)})


@pytest.mark.parametrize("rows,cap", [(10, None), (10, 16), (0, None),
                                      (1, 4)])
def test_distribute_collect_match_jax_world1(rows, cap, rng):
    data = {"k": rng.integers(-9, 9, rows).astype(np.int64),
            "v": rng.normal(size=rows)}
    jctx = jax_context(Mesh(np.array(jax.devices()[:1]), ("data",)))
    jt = D.distribute_table(jctx, data, capacity_per_shard=cap)
    tt = TD.distribute_table(make_context("cpu"), data,
                             capacity_per_shard=cap)
    jcols, _ = jax_state(jt)
    assert int(np.asarray(jt.nvalid)[0]) == int(tt.nvalid)
    assert_same_columns(jcols, tt.state()[0])
    assert_same_columns(D.collect_table(jctx, jt),
                        TD.collect_table(make_context("cpu"), tt))


def test_distribute_rejects_bad_capacity():
    ctx = make_context("cpu")
    data = {"k": np.arange(10)}
    with pytest.raises(ValueError, match="must be positive"):
        TD.distribute_table(ctx, data, capacity_per_shard=0)
    with pytest.raises(ValueError, match="rows/shard"):
        TD.distribute_table(ctx, data, capacity_per_shard=5)
    with pytest.raises(ValueError, match="int32 range"):
        TD.distribute_table(ctx, {"k": np.array([2**40])})
