"""Subprocess worker for tests/test_torch_dist.py: the distributed set
operators (``dist_isin``, ``dist_intersect``, ``dist_difference``, both
semi backends), the UNOMT pipeline (``unomt_dist_pipeline``, both
backends) and a groupby over subnormal and zero float keys at world W,
run by the JAX package or by the PyTorch port on the same data and
written to one ``.npz`` for comparison.

Usage:
  XLA_FLAGS=--xla_force_host_platform_device_count=W \\
      python torch_setop_conformance.py jax W OUT.npz
  python torch_setop_conformance.py torch W OUT.npz RANK STORE_FILE

In ``torch`` mode every rank is one process; they meet through a gloo
process group on a ``file://`` store and rank 0 writes the collected
output.
"""
import sys
from datetime import timedelta

import numpy as np

ROWS = 96
UNOMT = dict(n_response=512, n_drugs=32, n_cells=16, seed=5)
TABLES = ("response", "descriptors", "fingerprints", "rna")


def setop_cases(D, world: int):
    """(name, fn(ctx, *tables), datas) with numpy-only inputs."""
    rng = np.random.default_rng(300 + world)
    dists = {
        "uniform": (rng.integers(0, 12, ROWS), rng.integers(6, 18,
                                                           ROWS // 2)),
        "skewed": (np.where(rng.random(ROWS) < 0.6, 3,
                            rng.integers(0, 40, ROWS)),
                   np.where(rng.random(ROWS // 2) < 0.5, 3,
                            rng.integers(20, 60, ROWS // 2))),
        "allequal": (np.full(ROWS, 7), np.full(ROWS // 2, 7)),
    }
    # a shard holds at most ROWS valid rows after the shuffle, so slabs of
    # ROWS slots fit every distribution
    sizes = {"num_buckets": 8, "bucket_capacity": ROWS,
             "probe_capacity": ROWS}
    for name, (ka, kb) in dists.items():
        a = {"k": ka.astype(np.int32),
             "v": rng.integers(-100, 100, ROWS).astype(np.float32)}
        b = {"k": kb.astype(np.int32),
             "v": rng.integers(-100, 100, ROWS // 2).astype(np.float32)}
        for impl in ("sortmerge", "hash"):
            ss = sizes if impl == "hash" else None
            dd = "hash" if impl == "hash" else "sort"
            yield (f"isin/{name}/{impl}", lambda c, x, y, impl=impl, ss=ss:
                   D.dist_isin(c, x, "k", y, "k", overcommit=4.0,
                               local_impl=impl, semi_sizes=ss), (a, b))
            yield (f"intersect/{name}/{impl}",
                   lambda c, x, y, impl=impl, ss=ss, dd=dd:
                   D.dist_intersect(c, x, y, ["k"], overcommit=4.0,
                                    local_impl=impl, dedup_impl=dd,
                                    semi_sizes=ss), (a, b))
            yield (f"difference/{name}/{impl}",
                   lambda c, x, y, impl=impl, ss=ss:
                   D.dist_difference(c, x, y, ["k"], overcommit=4.0,
                                     local_impl=impl, semi_sizes=ss),
                   (a, b))
    tiny = np.float32([1e-40, -1e-40, 0.0, -0.0, 1e-45, 2.5, -1.0])
    sub = {"f": rng.choice(tiny, ROWS),
           "v": rng.integers(-50, 50, ROWS).astype(np.float32)}
    for impl in ("sort", "hash"):
        gs = {"num_buckets": 8, "bucket_capacity": ROWS} \
            if impl == "hash" else None
        yield (f"subnormal_groupby/{impl}", lambda c, x, impl=impl, gs=gs:
               D.dist_groupby(c, x, ["f"], {"v": ["sum", "count"]},
                              overcommit=4.0, local_impl=impl,
                              groupby_sizes=gs), (sub,))


def run(D, U, ctx, world: int) -> dict:
    out = {}

    def record(name, res, dropped):
        for k, v in D.collect_table(ctx, res).items():
            out[f"{name}/{k}"] = v
        out[f"{name}/dropped"] = np.asarray(int(np.max(np.asarray(
            dropped.cpu() if hasattr(dropped, "cpu") else dropped))))

    for name, fn, datas in setop_cases(D, world):
        res, dropped = D.DistributedPipeline(ctx, fn)(
            *[D.distribute_table(ctx, d) for d in datas])
        record(name, res, dropped)
    raw = U.gen_unomt_tables(**UNOMT)
    for impl in ("sortmerge", "hash"):
        res, dropped = D.DistributedPipeline(
            ctx, lambda c, *ts, impl=impl: U.unomt_dist_pipeline(
                c, *ts, semi_impl=impl))(
            *[D.distribute_table(ctx, raw[k]) for k in TABLES])
        record(f"unomt/{impl}", res, dropped)
    return out


def main():
    mode, world, path = sys.argv[1], int(sys.argv[2]), sys.argv[3]
    if mode == "jax":
        import jax
        from jax.sharding import Mesh
        from repro.core import dist_ops as D
        from repro.core.context import make_context
        from repro.data import unomt as U
        ctx = make_context(Mesh(np.array(jax.devices()[:world]), ("data",)))
        np.savez(path, **run(D, U, ctx, world))
        return 0
    import torch.distributed as dist
    from repro_torch.core import dist_ops as D
    from repro_torch.core.context import make_context
    from repro_torch.data import unomt as U
    rank, store = int(sys.argv[4]), sys.argv[5]
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=world, rank=rank,
                            timeout=timedelta(seconds=120))
    try:
        out = run(D, U, make_context("cpu"), world)
        if rank == 0:
            np.savez(path, **out)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
