"""Shared fixtures/oracles for the repro test suite.

NOTE: no XLA_FLAGS tweaking here — in-process tests run on the single real
CPU device (per the assignment: only launch/dryrun.py builds the 512-device
placeholder mesh).  Multi-device distributed behaviour is exercised by
``tests/dist/dist_checks.py`` in a subprocess with
``--xla_force_host_platform_device_count=8``.
"""
from __future__ import annotations

import numpy as np
import pytest


# --------------------------------------------------------------------------
# numpy oracles for the table operators (a tiny "pandas" so the engine is
# checked against an independent implementation)
# --------------------------------------------------------------------------


def np_sort(data: dict, by, ascending=True) -> dict:
    """Stable multi-key sort of dict-of-1D-arrays."""
    keys = [np.asarray(data[k]) for k in reversed(list(by))]
    if not isinstance(ascending, bool):
        raise NotImplementedError
    order = np.lexsort(keys)
    if not ascending:
        order = order[::-1]
        # lexsort descending is not stable-reversed; re-sort stably:
        idx = np.arange(len(order))
        rev = [np.asarray(data[k]) for k in reversed(list(by))]
        rev = [-(r.astype(np.float64)) for r in rev]
        order = np.lexsort(rev + [idx][:0] or rev)
        order = np.lexsort(rev)
    return {k: np.asarray(v)[order] for k, v in data.items()}


def np_join_inner(left: dict, right: dict, on: str,
                  r_suffix: str = "_r") -> dict:
    """Inner join oracle: all (l,r) pairs with equal keys; order is
    left-row-major with right matches in right *sorted* order (matching the
    engine's sort-merge semantics up to within-key permutation)."""
    lk = np.asarray(left[on])
    rk = np.asarray(right[on])
    out_rows_l, out_rows_r = [], []
    for i in range(len(lk)):
        for j in range(len(rk)):
            if lk[i] == rk[j]:
                out_rows_l.append(i)
                out_rows_r.append(j)
    out = {}
    for k, v in left.items():
        out[k] = np.asarray(v)[out_rows_l]
    for k, v in right.items():
        if k == on:
            continue
        name = k + r_suffix if k in left else k
        out[name] = np.asarray(v)[out_rows_r]
    return out


def np_groupby_sum(data: dict, by: str, col: str) -> dict:
    keys = np.asarray(data[by])
    vals = np.asarray(data[col]).astype(np.float64)
    uk = np.unique(keys)
    return {by: uk,
            f"{col}_sum": np.array([vals[keys == k].sum() for k in uk])}


def as_sets(data: dict, cols=None):
    """Row multiset as a sorted list of tuples (order-insensitive compare)."""
    cols = list(cols) if cols is not None else sorted(data.keys())
    n = len(np.asarray(data[cols[0]]))
    rows = []
    for i in range(n):
        rows.append(tuple(round(float(np.asarray(data[c])[i]), 4)
                          for c in cols))
    return sorted(rows)


@pytest.fixture
def rng():
    return np.random.default_rng(42)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; the test skips without one")
