"""The last small modules of the port against the JAX package's, on the
same seeded numpy inputs:

* ``repro_torch.data.dictionary.Dictionary``: the ids of a seeded list
  with repeats, ints, floats and unicode strings, and ``decode``, equal
  the reference's;
* the table's ingest errors name the dictionary module of their package;
* ``core.partition.plan_partitions``: (hist, dest, pid) bit-identical to
  the reference's, int32 each, on int keys, float keys with -0.0 and
  subnormals, two key columns and padding, at P in {1, 3, 16}; ``impl``
  may only confirm the device.
"""
import numpy as np
import pytest

from repro.core import partition as JP
from repro.core.table import Table as JTable
from repro.data.dictionary import Dictionary as JDictionary
from repro_torch.core import partition as TP
from repro_torch.core.table import Table as TTable
from repro_torch.data.dictionary import Dictionary as TDictionary


def mixed_values(seed=0, n=400):
    """Strings, ints and floats with repeats, in a seeded order."""
    rng = np.random.default_rng(seed)
    pool = ["alpha", "béta", "γάμμα", "東京", "🙂", "", " ", "alpha ",
            7, -3, 0, 2 ** 40, 1.5, -0.0, 0.0, float("nan"), 1e-320,
            np.int64(7), np.float32(1.5), "7", "1.5"]
    return [pool[i] for i in rng.integers(0, len(pool), n)]


def test_dictionary_ids_and_decode_match_reference():
    vals = mixed_values()
    jd, td = JDictionary(), TDictionary()
    for chunk in (vals[:150], vals[150:], vals[::-1]):
        want, got = jd.encode(chunk), td.encode(chunk)
        assert got.dtype == np.int32 == want.dtype
        np.testing.assert_array_equal(got, want)
    assert td.items == jd.items and td.vocab == jd.vocab
    ids = np.random.default_rng(1).integers(0, len(td.items), 300)
    assert td.decode(ids) == jd.decode(ids)
    assert td.decode(td.encode(["東京", 7])) == ["東京", "7"]


@pytest.mark.parametrize("col,err", [
    (np.array([0, 2 ** 40], np.int64), ValueError),
    (np.array(["a", "b"]), TypeError)])
def test_table_errors_name_the_dictionary(col, err):
    with pytest.raises(err) as want:
        JTable.from_dict({"k": col})
    with pytest.raises(err) as got:
        TTable.from_dict({"k": col}, device="cpu")
    assert "(repro.data.dictionary)" in str(want.value)
    assert str(got.value) == str(want.value).replace(
        "(repro.data.dictionary)", "(repro_torch.data.dictionary)")


def key_tables(kind, seed):
    """(columns, key names, rows) of a seeded table of ``kind``."""
    rng = np.random.default_rng(seed)
    n = 300
    if kind == "int":
        return {"k": rng.integers(-50, 50, n).astype(np.int32),
                "v": rng.normal(size=n).astype(np.float32)}, ["k"], n
    if kind == "float":
        pool = np.array([0.0, -0.0, 1e-40, -1e-40, 1.5, -2.25, np.inf,
                         3e38, 1.17549435e-38, 7.0], np.float32)
        return {"k": pool[rng.integers(0, len(pool), n)],
                "v": rng.integers(0, 9, n).astype(np.int32)}, ["k"], n
    return {"a": rng.integers(0, 7, n).astype(np.int32),
            "b": rng.choice(np.array([0.0, -0.0, 1e-41, 2.5], np.float32),
                            n)}, ["a", "b"], n


@pytest.mark.parametrize("P", [1, 3, 16])
@pytest.mark.parametrize("kind", ["int", "float", "two"])
def test_plan_partitions_bit_identical(kind, P):
    cols, keys, n = key_tables(kind, seed=P)
    for capacity in (n, n + 37):          # with and without padding
        want = JP.plan_partitions(JTable.from_dict(cols, capacity), keys, P)
        got = TP.plan_partitions(
            TTable.from_dict(cols, capacity, device="cpu"), keys, P)
        for g, w in zip(got, want):
            w = np.asarray(w)
            assert w.dtype == np.int32
            assert g.dtype == TP.torch.int32
            np.testing.assert_array_equal(g.numpy(), w)
    hist = got[0].numpy()
    assert hist.sum() == n and (got[2].numpy()[n:] == P).all()


def test_plan_partitions_impl_confirms_the_device():
    t = TTable.from_dict({"k": np.arange(10, dtype=np.int32)},
                         device="cpu")
    ref = TP.plan_partitions(t, ["k"], 3, impl="ref")
    for a, b in zip(ref, TP.plan_partitions(t, ["k"], 3)):
        assert a.equal(b)
    with pytest.raises(ValueError, match="cannot run on a cpu"):
        TP.plan_partitions(t, ["k"], 3, impl="cuda")
