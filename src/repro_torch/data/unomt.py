"""UNOMT application data + data-engineering pipeline (paper §4).

PyTorch port of ``repro/data/unomt.py``.  Synthetic stand-ins for the
NCI60/gCSI drug-response data (the real data is gated): three raw tables
with the relational shape the paper describes — a drug-response table,
two drug-feature sub-tables merged by inner join, and an RNA-sequence
table with duplicates — and the operator pipeline of paper Figures 8–11:

  project (column filter) -> map (clean drug ids) -> dropna -> standard
  scaling -> join of the drug sub-tables -> distributed unique of the RNA
  table -> isin filters -> joins -> repartition -> to_tensor

The generator is numpy only and gives the reference's tables bit for bit
for the same arguments; the pipelines run on the tables' device.
"""
from __future__ import annotations

import numpy as np

from ..core import dist_ops as D
from ..core import local_ops as L
from ..core.context import HptmtContext
from ..core.table import Table


def gen_unomt_tables(*, n_response: int = 4096, n_drugs: int = 256,
                     n_cells: int = 128, n_drug_feat: int = 8,
                     n_rna_feat: int = 8, seed: int = 0):
    """Raw numpy columns for the three source tables: ``{"response",
    "descriptors", "fingerprints", "rna"}``.  The response is a noisy
    function of drug and cell latent features, so a network trained on
    the pipeline's output has signal to learn."""
    rng = np.random.default_rng(seed)
    drug_lat = rng.normal(size=(n_drugs, n_drug_feat)).astype(np.float32)
    cell_lat = rng.normal(size=(n_cells, n_rna_feat)).astype(np.float32)
    w_d = rng.normal(size=(n_drug_feat,)).astype(np.float32)
    w_c = rng.normal(size=(n_rna_feat,)).astype(np.float32)

    did = rng.integers(0, n_drugs, n_response)
    cid = rng.integers(0, n_cells, n_response)
    conc = rng.uniform(-3, 0, n_response).astype(np.float32)
    resp = (drug_lat[did] @ w_d + cell_lat[cid] @ w_c
            + 0.5 * conc + 0.05 * rng.normal(size=n_response)) \
        .astype(np.float32)
    # the raw table has extra columns (filtered by Project), drug ids that
    # need a cleanup map (the "symbols" are an offset) and some null
    # responses (dropna)
    response = {
        "drug_id_raw": (did + 1_000_000).astype(np.int32),
        "cell_id": cid.astype(np.int32),
        "concentration": conc,
        "response": np.where(rng.random(n_response) < 0.02, np.nan,
                             resp).astype(np.float32),
        "study": rng.integers(0, 6, n_response).astype(np.int32),
        "junk_a": rng.normal(size=n_response).astype(np.float32),
        "junk_b": rng.integers(0, 9, n_response).astype(np.int32),
    }
    # drug features arrive as two sub-tables merged on drug id
    descriptors = {"drug_id": np.arange(n_drugs, dtype=np.int32)}
    for j in range(n_drug_feat // 2):
        descriptors[f"desc{j}"] = drug_lat[:, j]
    fingerprints = {"drug_id": np.arange(n_drugs, dtype=np.int32)}
    for j in range(n_drug_feat // 2, n_drug_feat):
        fingerprints[f"fp{j}"] = drug_lat[:, j]
    # rna sequences with duplicate records (the drop-duplicates step)
    dup = rng.integers(0, n_cells, n_cells // 4)
    rna_ids = np.concatenate([np.arange(n_cells), dup]).astype(np.int32)
    rng.shuffle(rna_ids)
    rna = {"cell_id": rna_ids}
    for j in range(n_rna_feat):
        rna[f"rna{j}"] = cell_lat[rna_ids, j]
    return {"response": response, "descriptors": descriptors,
            "fingerprints": fingerprints, "rna": rna}


def drug_feature_cols(n_drug_feat: int = 8):
    return [f"desc{j}" for j in range(n_drug_feat // 2)] + \
        [f"fp{j}" for j in range(n_drug_feat // 2, n_drug_feat)]


def rna_cols(n_rna_feat: int = 8):
    return [f"rna{j}" for j in range(n_rna_feat)]


def _clean_response(resp: Table, ctx: HptmtContext | None = None) -> Table:
    """Fig. 8: column filter -> map (clean drug id) -> dropna -> scale.
    With ``ctx`` the scaling uses global moments, so the result does not
    depend on the world size; without it, this table's own."""
    t = L.project(resp, ["drug_id_raw", "cell_id", "concentration",
                         "response"])
    t = t.map_column("drug_id_raw", lambda c: c - 1_000_000, out="drug_id")
    t = L.project(t, ["drug_id", "cell_id", "concentration", "response"])
    t = L.dropna(t, ["response"])
    if ctx is None:
        return L.standard_scale(t, ["concentration"])
    return D.dist_standard_scale(ctx, t, ["concentration"])


def unomt_local_pipeline(resp: Table, desc: Table, fp: Table, rna: Table,
                         *, n_drug_feat: int = 8, n_rna_feat: int = 8,
                         out_capacity: int | None = None,
                         semi_impl: str | None = None) -> Table:
    """Single-partition Figures 8–11.  ``semi_impl`` selects the Fig. 11
    membership backend ('sortmerge' | 'hash', default
    ``REPRO_SEMI_IMPL``)."""
    t = _clean_response(resp)
    drug = L.join(desc, fp, left_on=["drug_id"],
                  out_capacity=desc.capacity)              # Fig. 9
    rna_u = L.drop_duplicates(rna, ["cell_id"])            # Fig. 10
    rna_u = L.standard_scale(rna_u, rna_cols(n_rna_feat))
    # Fig. 11: keep the response rows whose drug and cell exist
    keep = L.isin(t, "drug_id", drug, "drug_id", impl=semi_impl) & \
        L.isin(t, "cell_id", rna_u, "cell_id", impl=semi_impl)
    t = L.select(t, keep)
    t = L.join(t, drug, left_on=["drug_id"],
               out_capacity=out_capacity or t.capacity)
    return L.join(t, rna_u, left_on=["cell_id"],
                  out_capacity=out_capacity or t.capacity)


def unomt_dist_pipeline(ctx: HptmtContext, resp: Table, desc: Table,
                        fp: Table, rna: Table, *, n_drug_feat: int = 8,
                        n_rna_feat: int = 8, overcommit: float = 4.0,
                        semi_impl: str | None = None):
    """Distributed Figures 8–11: the local cleanup is pleasingly parallel
    (paper §4.3), the joins and the unique are the distributed operators.
    Returns ``(features table, rows dropped)``; run it through
    ``DistributedPipeline``.  The Fig. 11 filters keep the sizes their
    capacities give (no planning from the keys), as the reference's
    traced pipeline does."""
    t = _clean_response(resp, ctx)
    drug, d1 = D.dist_join(ctx, desc, fp, left_on=["drug_id"],
                           overcommit=overcommit)
    rna_u, d2 = D.dist_unique(ctx, rna, ["cell_id"], overcommit=overcommit)
    rna_u = D.dist_standard_scale(ctx, rna_u, rna_cols(n_rna_feat))
    # membership against the global id sets (the small keys, gathered)
    drug_ids = D.all_gather_table(ctx, L.project(drug, ["drug_id"]))
    cell_ids = D.all_gather_table(ctx, L.project(rna_u, ["cell_id"]))
    keep = L.isin(t, "drug_id", drug_ids, "drug_id", impl=semi_impl,
                  may_plan=False) & \
        L.isin(t, "cell_id", cell_ids, "cell_id", impl=semi_impl,
               may_plan=False)
    t = L.select(t, keep)
    t, d3 = D.dist_join(ctx, t, drug, left_on=["drug_id"],
                        overcommit=overcommit)
    t, d4 = D.dist_join(ctx, t, rna_u, left_on=["cell_id"],
                        overcommit=overcommit)
    # rebalance after the skewed joins (straggler mitigation)
    t, d5 = D.dist_repartition(ctx, t)
    return t, d1 + d2 + d3 + d4 + d5


def feature_label_arrays(t: Table, *, n_drug_feat: int = 8,
                         n_rna_feat: int = 8):
    """Stage 3 (paper Listing 3): Table -> (X, y, mask) on the table's
    device: X ``(capacity, 1 + n_drug_feat + n_rna_feat)`` float32, y
    ``(capacity,)``, mask the valid rows."""
    feats = ["concentration"] + drug_feature_cols(n_drug_feat) \
        + rna_cols(n_rna_feat)
    X = t.to_tensor(feats)
    y = t.to_tensor(["response"])[:, 0]
    return X, y, t.valid_mask
