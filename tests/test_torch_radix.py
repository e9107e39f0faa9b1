"""The port's radix engine (``kernels/radix_sort``, ``kernels/autotune``)
and the row operators on it against the JAX package, exactly.

On the CPU the digit pass runs its plain PyTorch version; it is held to
the JAX ``ref`` and to the JAX Pallas kernel in interpret mode, whose
per-tile outputs the port's cross-tile composition (``add_tile_offsets``)
must turn into the whole-array ranking, and its scatter to the
reference's ``_scatter_pass``.  The CUDA pass is held to the plain
version on the card by ``tests/test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import local_ops as JL
from repro.core.table import Table as JT
from repro.kernels import autotune as JA
from repro.kernels.radix_sort import ops as JR
from repro.kernels.radix_sort.kernel import digit_histogram_ranks_tiles
from repro.kernels.radix_sort.ref import digit_histogram_ranks_ref as j_ref
from repro_torch.core import local_ops as TL
from repro_torch.core.table import Table as TT
from repro_torch.kernels import autotune as TA
from repro_torch.kernels.hash_partition.ref import add_tile_offsets
from repro_torch.kernels.radix_sort import ops as TR
from repro_torch.kernels.radix_sort import ref as TRref

TILE = 128
N = 300          # > TILE and not a multiple of it
INT_MIN, INT_MAX = -2**31, 2**31 - 1
SPECIAL_F = np.array([np.nan, -np.nan, 0.0, -0.0, np.inf, -np.inf, 1.0, -1.0,
                      3.4e38, -3.4e38, 1.2e-38, -1.2e-38, 2.5], np.float32)


@pytest.fixture(autouse=True)
def _defaults(monkeypatch):
    for var in ("REPRO_SORT_IMPL", "REPRO_KERNEL_IMPL", "REPRO_RADIX_BITS",
                "REPRO_TILE", "REPRO_AUTOTUNE"):
        monkeypatch.delenv(var, raising=False)
    TA.clear_cache()
    JA.clear_cache()


def t(a):
    return torch.from_numpy(np.array(a))


def same(j, x):
    """JAX array == torch tensor, exactly, dtype included."""
    j, x = np.asarray(j), x.numpy()
    assert j.dtype == x.dtype, (j.dtype, x.dtype)
    np.testing.assert_array_equal(j, x)


def words(rng, n):
    w = rng.integers(INT_MIN, INT_MAX + 1, n, dtype=np.int64).astype(np.int32)
    w[:2] = [INT_MIN, INT_MAX]
    return w


# --------------------------------------------------------------------------
# the digit pass
# --------------------------------------------------------------------------


@pytest.mark.parametrize("bits,shift", [(1, 0), (1, 31), (4, 0), (4, 28),
                                        (8, 8), (8, 24), (11, 0), (11, 21)])
def test_digit_pass_matches_jax(bits, shift, rng):
    w = words(rng, N)
    jh, jr = j_ref(jnp.asarray(w), shift, bits)
    th, tr = TR.digit_histogram_ranks(t(w), shift, bits, 1024)
    same(jh, th)
    same(jr, tr)
    # the TPU kernel's tiles (pad rows: word 0, digit 0, counted in the
    # last tile, which the CUDA kernel masks instead) + the port's scan
    n_tiles = -(-N // TILE)
    pad = n_tiles * TILE - N
    hist_t, rank_t = digit_histogram_ranks_tiles(
        jnp.asarray(np.pad(w, (0, pad)).reshape(n_tiles, TILE)), shift, bits,
        interpret=True)
    hist_t = np.asarray(hist_t).copy()
    hist_t[-1, 0] -= pad
    hist, ranks = add_tile_offsets(
        t(hist_t), t(np.asarray(rank_t).reshape(-1)[:N]),
        TRref.extract_digits(t(w), shift, bits), 1 << bits, TILE)
    assert torch.equal(hist, th) and torch.equal(ranks, tr)


@pytest.mark.parametrize("bits,shift", [(1, 0), (1, 31), (4, 28), (8, 8),
                                        (11, 21)])
def test_scatter_pass_matches_jax(bits, shift, rng):
    """The plain scatter pass (what the CUDA pass is held to on the card)
    == the reference's ``_scatter_pass``: the refined perm, and the words
    moved with it (the reference's pass scattering the words as its
    perm)."""
    w = words(rng, N)
    w[N // 2:N // 2 + 40] = w[0]              # a run of equal digits
    perm = rng.permutation(N).astype(np.int32)
    jw = jnp.asarray(w)
    tp, tw = TR.scatter_pass(t(perm), t(w), shift, bits, 1024)
    same(JR._scatter_pass(jnp.asarray(perm), jw, shift, bits, "ref", 1024),
         tp)
    same(JR._scatter_pass(jw, jw, shift, bits, "ref", 1024), tw)
    ident, none = TR.scatter_pass(None, t(w), shift, bits, 1024,
                                  keep_words=False)
    assert none is None
    same(JR._scatter_pass(jnp.arange(N, dtype=jnp.int32), jw, shift, bits,
                          "ref", 1024), ident)


def test_digit_pass_chunks_digits(monkeypatch, rng):
    """The plain version's chunking over digit values changes nothing."""
    w = t(words(rng, N))
    whole = TRref.digit_histogram_ranks_ref(w, 5, 8)
    monkeypatch.setattr(TRref, "_CHUNK_ELEMS", 7 * N)
    chunked = TRref.digit_histogram_ranks_ref(w, 5, 8)
    assert all(torch.equal(a, b) for a, b in zip(whole, chunked))


# --------------------------------------------------------------------------
# sort words
# --------------------------------------------------------------------------


def _float_order(f):
    """(rank key) of a float sort: -0.0 == +0.0, every NaN equal and
    greatest."""
    return np.where(np.isnan(f), np.inf, np.where(f == 0, 0.0, f)), \
        np.isnan(f)


def test_sortable_words_order_specials():
    """The radix word's unsigned order and the xla chain's signed order
    both equal the float sort order on NaN, +-0.0, +-inf, INT_MIN and
    INT_MAX, and the radix word matches the JAX package bit for bit."""
    ints = np.array([INT_MIN, INT_MAX, 0, -1, 1, INT_MIN + 1], np.int32)
    for col in (SPECIAL_F, ints):
        same(JR.sortable_word(jnp.asarray(col)), TR.sortable_word(t(col)))
    radix = TR.sortable_word(t(SPECIAL_F)).numpy().view(np.uint32)
    signed = TL._sortable_word(t(SPECIAL_F)).numpy()
    val, nan = _float_order(SPECIAL_F.astype(np.float64))
    for i in range(len(SPECIAL_F)):
        for j in range(len(SPECIAL_F)):
            less = (not nan[i]) and (nan[j] or val[i] < val[j])
            eq = (nan[i] and nan[j]) or (not nan[i] and not nan[j]
                                         and val[i] == val[j])
            assert (radix[i] < radix[j]) == less and \
                (radix[i] == radix[j]) == eq
            assert (signed[i] < signed[j]) == less and \
                (signed[i] == signed[j]) == eq
    r = TR.sortable_word(t(ints)).numpy().view(np.uint32)
    assert np.array_equal(np.argsort(r, kind="stable"),
                          np.argsort(ints, kind="stable"))
    assert np.array_equal(TL._sortable_word(t(ints)).numpy(), ints)


# --------------------------------------------------------------------------
# the engine's public ops
# --------------------------------------------------------------------------


@pytest.mark.parametrize("radix_bits", [4, 8, 11])
def test_radix_permutation_and_rank_match_jax(radix_bits, rng):
    n = 257
    cols = (rng.integers(-3, 3, n).astype(np.int32),
            rng.choice(SPECIAL_F, n), words(rng, n))
    invalid = rng.random(n) < 0.2
    jc = tuple(jnp.asarray(c) for c in cols)
    tc = tuple(t(c) for c in cols)
    for keys in ((1,), (0, 2, 1)):
        jk = tuple(jc[i] for i in keys)
        tk = tuple(tc[i] for i in keys)
        jp = JR.radix_permutation(jk, jnp.asarray(invalid),
                                  radix_bits=radix_bits)
        same(jp, TR.radix_permutation(tk, t(invalid), radix_bits=radix_bits))
        # radix_rank is the inverse of that permutation
        rank = TR.radix_rank(tk, t(invalid), radix_bits=radix_bits)
        assert np.array_equal(rank.numpy()[np.asarray(jp)], np.arange(n))
        assert rank.dtype == torch.int32


@pytest.mark.parametrize("frac", [0.0, 0.3, 1.0])
def test_stable_partition_perm_matches_jax(frac, rng):
    keep = rng.random(N) < frac
    got = TR.stable_partition_perm(t(keep))
    same(JR.stable_partition_perm(jnp.asarray(keep)), got)
    assert np.array_equal(got.numpy(), np.argsort(~keep, kind="stable"))


@pytest.mark.parametrize("P", [513, 1000, 70000])
def test_grouped_ranks_matches_jax(P, rng):
    pid = rng.integers(0, P, N).astype(np.int32)
    pid[:5] = P - 1
    jh, jr = JR.grouped_ranks(jnp.asarray(pid), P)
    th, tr = TR.grouped_ranks(t(pid), P)
    same(jh, th)
    same(jr, tr)


# --------------------------------------------------------------------------
# OrderBy and the row operators
# --------------------------------------------------------------------------


def sort_table(rng, n):
    return {"f": rng.choice(SPECIAL_F, n),
            "i": rng.integers(-3, 3, n).astype(np.int32),
            "row": np.arange(n, dtype=np.int32)}


def both(data, capacity, nvalid=None):
    jt = JT.from_dict(data, capacity=capacity)
    tt = TT.from_dict(data, capacity=capacity, device="cpu")
    if nvalid is not None:
        jt, tt = jt.with_nvalid(nvalid), tt.with_nvalid(nvalid)
    return jt, tt


def assert_same(jout, tout, msg=""):
    """Valid rows equal bit for bit, dtypes and column order included."""
    assert int(np.asarray(jout.nvalid).reshape(-1)[0]) == int(tout.nvalid)
    j, x = jout.to_numpy(), tout.to_numpy()
    assert list(j) == list(x), msg
    for k in j:
        a, b = np.asarray(j[k]), x[k]
        assert a.dtype == b.dtype, (msg, k)
        if a.dtype == np.float32:
            a, b = a.view(np.int32), b.view(np.int32)
        np.testing.assert_array_equal(a, b, err_msg=f"{msg} col={k}")


@pytest.mark.parametrize("ascending", [True, False, (False, True)])
def test_sort_values_radix_xla_and_jax_agree(ascending, rng):
    n = 60
    jt, tt = both(sort_table(rng, n), n + 6, nvalid=n - 4)
    for by in (["f", "i"], ["i", "f"]):
        asc = ascending if isinstance(ascending, bool) else list(ascending)
        want = JL.sort_values(jt, by, ascending=asc, impl="xla")
        assert_same(want, JL.sort_values(jt, by, ascending=asc, impl="radix"))
        for impl in ("radix", "xla"):
            got = TL.sort_values(tt, by, ascending=asc, impl=impl)
            assert_same(want, got, f"{impl} {by}")
            # the padding rows too: sorted after the valid rows
            np.testing.assert_array_equal(np.asarray(want.columns["row"]),
                                          got.columns["row"].numpy())


def test_sort_impl_from_environment(monkeypatch, rng):
    jt, tt = both(sort_table(rng, 40), 40)
    monkeypatch.setenv("REPRO_SORT_IMPL", "radix")
    assert_same(JL.sort_values(jt, ["f"], impl="xla"),
                TL.sort_values(tt, ["f"]))
    monkeypatch.setenv("REPRO_SORT_IMPL", "nope")
    with pytest.raises(ValueError, match="unknown sort impl"):
        TL.sort_values(tt, ["f"])


def test_compact_select_head_take_concat_match_jax(rng):
    n = 50
    data = {"f": rng.choice(SPECIAL_F, n),
            "i": rng.integers(-9, 9, n).astype(np.int32)}
    jt, tt = both(data, n + 7, nvalid=n - 3)
    mask = rng.random(n + 7) < 0.5
    assert_same(JL.compact(jt, jnp.asarray(mask)), TL.compact(tt, t(mask)))
    assert_same(JL.select(jt, jnp.asarray(mask)), TL.select(tt, t(mask)))
    assert_same(JL.project(jt, ["i"]), TL.project(tt, ["i"]))
    for k in (0, 5, n + 20):
        assert_same(JL.head(jt, k), TL.head(tt, k))
    idx = rng.integers(0, n, 30).astype(np.int32)
    assert_same(JL.take(jt, jnp.asarray(idx), 21), TL.take(tt, t(idx), 21))
    other = {"i": rng.integers(0, 3, 9).astype(np.int32),
             "f": rng.normal(size=9).astype(np.float32)}
    jo, to = both(other, 12, nvalid=8)
    assert_same(JL.concat(jt, jo), TL.concat(tt, to))
    assert TL.concat(tt, to).capacity == n + 7 + 12
    with pytest.raises(ValueError, match="schema"):
        TL.concat(tt, TL.project(to, ["i"]))


# --------------------------------------------------------------------------
# autotune
# --------------------------------------------------------------------------


def test_autotune_defaults_and_overrides(monkeypatch):
    assert TA.radix_params("ref", 1000) == JA.radix_params("ref", 1000) \
        == (8, 1024)
    assert TA.radix_params("cuda", 5) == (8, 1024)
    for cap in (0, 1, 2, 3, 1000, 1 << 20):
        assert TA._capacity_bucket(cap) == JA._capacity_bucket(cap)
    monkeypatch.setenv("REPRO_RADIX_BITS", "4")
    monkeypatch.setenv("REPRO_TILE", "2048")
    assert TA.radix_params("cuda", 10) == (4, 2048)
    assert TA.radix_params("ref", 10, radix_bits=11, tile=512) == (11, 512)
    monkeypatch.setenv("REPRO_TILE", "128")
    with pytest.raises(ValueError, match="tile 128"):
        TA.tuned("tile", "ref", 10)
    monkeypatch.setenv("REPRO_TILE", "1024")
    monkeypatch.setenv("REPRO_RADIX_BITS", "12")
    with pytest.raises(ValueError, match="radix_bits 12"):
        TA.tuned("radix_bits", "cuda", 10)
    with pytest.raises(ValueError, match="tile 300"):
        TA.radix_params("ref", 10, radix_bits=8, tile=300)


def test_radix_bits_override_reaches_the_engine(monkeypatch, rng):
    cols = (t(words(rng, N)),)
    invalid = t(rng.random(N) < 0.1)
    default = TR.radix_permutation(cols, invalid)
    monkeypatch.setenv("REPRO_RADIX_BITS", "11")
    assert TA.tuned("radix_bits", "ref", N) == 11
    assert torch.equal(TR.radix_permutation(cols, invalid), default)
    monkeypatch.setenv("REPRO_RADIX_BITS", "0")
    with pytest.raises(ValueError):
        TR.radix_permutation(cols, invalid)


def test_autotune_sweep_is_cached(monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE", "1")
    calls = []
    real = TA._sweep

    def sweep(knob, backend, capacity):
        calls.append((knob, backend, capacity))
        return real(knob, backend, capacity)

    monkeypatch.setattr(TA, "_sweep", sweep)
    bits = TA.tuned("radix_bits", "ref", 1000)
    tile = TA.tuned("tile", "ref", 900)
    assert bits in (4, 8, 11) and tile in TA.TILES
    assert TA.tuned("radix_bits", "ref", 1023) == bits   # same size class
    assert calls == [("radix_bits", "ref", 1024), ("tile", "ref", 1024)]
