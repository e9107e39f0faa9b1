"""The port's UNOMT data-engineering pipeline (paper Figs. 8–11) against
the JAX package, at the sizes of tests/test_system.py.

Tolerance: the generator's tables, the valid rows, their order, ``nvalid``,
the integer columns and every float column the pipeline does not scale
are bit-identical.  The scaled columns (``concentration`` and the RNA
features) come from float32 sums that add in another order in each
package, so they are held to ``|port - jax| <= 2e-5 * (1 + |jax|)``, as
are the feature tensors built from them.
"""
import numpy as np
import pytest
import torch

from repro.core.table import Table as JT
from repro.data import unomt as JU
from repro_torch.core.table import Table as TT
from repro_torch.data import unomt as TU

SIZES = dict(n_response=1024, n_drugs=64, n_cells=32, seed=7)
TABLES = ("response", "descriptors", "fingerprints", "rna")
SCALED = {"concentration", *TU.rna_cols()}


def close(a, b, msg=""):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, msg
    assert np.all(np.abs(b - a) <= 2e-5 * (1 + np.abs(a))), msg


@pytest.fixture(scope="module")
def raw():
    return JU.gen_unomt_tables(**SIZES)


@pytest.fixture(scope="module")
def jax_local(raw):
    out = {}
    for impl in ("sortmerge", "hash"):
        feat = JU.unomt_local_pipeline(
            *[JT.from_dict(raw[k]) for k in TABLES], out_capacity=2048,
            semi_impl=impl)
        X, y, mask = JU.feature_label_arrays(feat)
        out[impl] = (feat.to_numpy(), int(feat.nvalid),
                     tuple(np.asarray(a) for a in (X, y, mask)))
    return out


def port_local(raw, impl):
    feat = TU.unomt_local_pipeline(
        *[TT.from_dict(raw[k], device="cpu") for k in TABLES],
        out_capacity=2048, semi_impl=impl)
    return feat, TU.feature_label_arrays(feat)


@pytest.mark.parametrize("sizes", [SIZES, dict(n_response=300, n_drugs=16,
                                               n_cells=8, n_drug_feat=6,
                                               n_rna_feat=4, seed=3)])
def test_gen_unomt_tables_bit_identical(sizes):
    want = JU.gen_unomt_tables(**sizes)
    got = TU.gen_unomt_tables(**sizes)
    assert list(got) == list(want)
    for name in want:
        assert list(got[name]) == list(want[name])
        for c, w in want[name].items():
            g = got[name][c]
            assert g.dtype == w.dtype, (name, c)
            np.testing.assert_array_equal(g.view(np.int32), w.view(np.int32))
    assert TU.drug_feature_cols(6) == JU.drug_feature_cols(6)
    assert TU.rna_cols(4) == JU.rna_cols(4)


@pytest.mark.parametrize("impl", ["sortmerge", "hash"])
def test_local_pipeline_matches_jax(raw, jax_local, impl):
    want, nvalid, _ = jax_local[impl]
    feat, _ = port_local(raw, impl)
    got = feat.to_numpy()
    assert int(feat.nvalid) == nvalid > 800
    assert list(got) == list(want)
    for c, w in want.items():
        g = got[c]
        assert g.dtype == w.dtype, c
        if c in SCALED:
            close(w, g, c)
        elif g.dtype == np.float32:
            np.testing.assert_array_equal(g.view(np.int32), w.view(np.int32),
                                          err_msg=c)
        else:
            np.testing.assert_array_equal(g, w, err_msg=c)


@pytest.mark.parametrize("impl", ["sortmerge", "hash"])
def test_feature_label_arrays_match_jax(raw, jax_local, impl):
    _, nvalid, (jX, jy, jmask) = jax_local[impl]
    _, (X, y, mask) = port_local(raw, impl)
    assert X.shape == jX.shape == (2048, 17) and X.dtype == torch.float32
    assert y.shape == jy.shape == (2048,)
    np.testing.assert_array_equal(mask.numpy(), jmask)
    close(jX, X.numpy())
    np.testing.assert_array_equal(y.numpy().view(np.int32),
                                  jy.view(np.int32))
    assert torch.isfinite(X[:nvalid]).all()
    assert not X[nvalid:].any()


def test_semi_backends_give_the_same_features(raw):
    a, _ = port_local(raw, "sortmerge")
    b, _ = port_local(raw, "hash")
    assert int(a.nvalid) == int(b.nvalid)
    for c in a.names:
        assert torch.equal(a.columns[c][:int(a.nvalid)].view(torch.int32),
                           b.columns[c][:int(b.nvalid)].view(torch.int32))


def test_dist_pipeline_world1_equals_local(raw):
    """At world 1 the distributed pipeline keeps the local pipeline's
    rows (up to the repartition's order) and drops nothing."""
    from repro_torch.core import dist_ops as TD
    from repro_torch.core.context import make_context
    ctx = make_context("cpu")
    tables = [TD.distribute_table(ctx, raw[k]) for k in TABLES]
    out, dropped = TD.DistributedPipeline(
        ctx, lambda c, *ts: TU.unomt_dist_pipeline(c, *ts, overcommit=1.0,
                                                   semi_impl="hash"))(*tables)
    assert int(dropped) == 0
    local, _ = port_local(raw, "hash")
    got, want = out.to_numpy(), local.to_numpy()
    assert list(got) == list(want)
    order_g = np.lexsort((got["response"], got["cell_id"], got["drug_id"]))
    order_w = np.lexsort((want["response"], want["cell_id"],
                          want["drug_id"]))
    for c in want:
        g, w = got[c][order_g], want[c][order_w]
        if c in SCALED:
            close(w, g, c)
        else:
            np.testing.assert_array_equal(g, w, err_msg=c)
