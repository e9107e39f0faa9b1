"""Subprocess worker for tests/test_torch_dist.py: the chunked (morsel)
join, groupby and sort and one DDP step of the UNOMT net (exact and
compressed allreduce) at world W, run by the JAX package or by the
PyTorch port on the same numpy data and written to one ``.npz``.

Usage:
  XLA_FLAGS=--xla_force_host_platform_device_count=W \\
      python torch_morsel_train_conformance.py jax W OUT.npz
  python torch_morsel_train_conformance.py torch W OUT.npz RANK STORE_FILE

In ``torch`` mode every rank is one process; they meet through a gloo
process group on a ``file://`` store and rank 0 writes the output.
"""
import sys
from datetime import timedelta

import numpy as np

ROWS, NKEYS, CHUNK, OUT_CAP = 2000, 150, 300, 8192
# hash groupby slabs: a bucket holds any shuffled morsel's rows (at most
# 600 a rank)
GSIZES = {"num_buckets": 8, "bucket_capacity": 600}
AGGS = {"lv": ["sum", "mean", "count", "min", "max"]}
NET = dict(n_features=17, d_hidden=32, n_res_blocks=2, n_dense_tail=1,
           dropout=0.0)
BATCH = 64


def table_data(world: int):
    rng = np.random.default_rng(world)
    left = {"k": rng.integers(0, NKEYS, ROWS).astype(np.int64),
            "lv": rng.integers(-50, 50, ROWS).astype(np.float64)}
    right = {"k": np.arange(NKEYS, dtype=np.int64),
             "rv": rng.integers(0, 100, NKEYS).astype(np.float64)}
    return left, right


def net_params():
    """The net's parameter tree in numpy (the reference's layout)."""
    rng = np.random.default_rng(9)
    d, f = NET["d_hidden"], NET["n_features"]

    def lin(i, o):
        return {"w": (rng.normal(size=(i, o)) * (2.0 / i) ** 0.5)
                .astype(np.float32), "b": np.zeros(o, np.float32)}

    return {"input": lin(f, d),
            "blocks": [{"fc1": lin(d, d), "fc2": lin(d, d)}
                       for _ in range(NET["n_res_blocks"])],
            "tail": [lin(d, d) for _ in range(NET["n_dense_tail"])],
            "out": lin(d, 1)}


def batch_data():
    rng = np.random.default_rng(10)
    return {"x": rng.normal(size=(BATCH, 17)).astype(np.float32),
            "y": rng.normal(size=BATCH).astype(np.float32),
            "mask": rng.random(BATCH) < 0.8}


def table_cases(M, ctx, world: int):
    left, right = table_data(world)
    for build, rchunk in (("resident", NKEYS), ("restream", 64)):
        for impl in ("sortmerge", "hash"):
            yield f"join/{build}/{impl}", M.chunked_dist_join(
                ctx, M.ChunkedTable(left, CHUNK),
                M.ChunkedTable(right, rchunk), left_on=["k"], build=build,
                out_capacity_per_shard=OUT_CAP, local_impl=impl)
    for impl in ("sort", "hash"):
        yield f"groupby/{impl}", M.chunked_dist_groupby(
            ctx, M.ChunkedTable(left, CHUNK), ["k"], AGGS,
            group_capacity_per_shard=NKEYS, local_impl=impl,
            groupby_sizes=GSIZES if impl == "hash" else None)
    for asc in (True, False):
        yield f"sort/{asc}", M.chunked_dist_sort(
            ctx, M.ChunkedTable(left, CHUNK), ["k"], ascending=asc)


def record(out: dict, name: str, cols: dict, dropped):
    for k, v in cols.items():
        out[f"{name}/{k}"] = np.asarray(v)
    out[f"{name}/dropped"] = np.asarray(int(dropped))


def run_jax(world: int, path: str):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from repro.core import morsel as M
    from repro.core.context import make_context
    from repro.models import unomt_net as N
    from repro.optim import adamw, compression
    from repro.runtime.ddp import make_ddp_train_step

    ctx = make_context(Mesh(np.array(jax.devices()[:world]), ("data",)))
    out = {}
    for name, (cols, dropped) in table_cases(M, ctx, world):
        record(out, name, cols, dropped)
    cfg = N.UnomtNetConfig(**NET)
    opt = adamw.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    batch = {k: jnp.asarray(v) for k, v in batch_data().items()}
    for compress in (False, True):
        params = jax.tree_util.tree_map(jnp.asarray, net_params())
        step = make_ddp_train_step(lambda p, b: N.mse_loss(p, cfg, b), opt,
                                   ctx, compress=compress)
        params, _, _, m = step(params, adamw.init(params, opt),
                               compression.init_residuals(params), batch)
        for path_, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
            key = jax.tree_util.keystr(path_, simple=True, separator=".")
            out[f"ddp/{compress}/{key}"] = np.asarray(leaf)
        out[f"ddp/{compress}/loss"] = np.asarray(m["loss"])
        out[f"ddp/{compress}/grad_norm"] = np.asarray(m["grad_norm"])
    np.savez(path, **out)


def run_torch(world: int, path: str, rank: int, store: str):
    import torch
    import torch.distributed as dist
    from repro_torch.core import morsel as M
    from repro_torch.core.context import make_context
    from repro_torch.models import unomt_net as N
    from repro_torch.optim import adamw, compression
    from repro_torch.runtime.ddp import make_ddp_train_step

    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=world, rank=rank,
                            timeout=timedelta(seconds=120))
    try:
        ctx = make_context("cpu")
        out = {}
        for name, (cols, dropped) in table_cases(M, ctx, world):
            record(out, name, cols, dropped)
        cfg = N.UnomtNetConfig(**NET)
        opt = adamw.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
        batch = {k: torch.from_numpy(v) for k, v in batch_data().items()}
        for compress in (False, True):
            params = N.unomt_params_from_jax(net_params(), "cpu")
            step = make_ddp_train_step(lambda p, b: N.mse_loss(p, cfg, b),
                                       opt, ctx, compress=compress)
            params, _, _, m = step(params, adamw.init(params, opt),
                                   compression.init_residuals(params),
                                   batch)
            for key, leaf in params.items():
                out[f"ddp/{compress}/{key}"] = leaf.numpy()
            out[f"ddp/{compress}/loss"] = m["loss"].numpy()
            out[f"ddp/{compress}/grad_norm"] = m["grad_norm"].numpy()
        if rank == 0:
            np.savez(path, **out)
    finally:
        dist.destroy_process_group()


def main():
    mode, world, path = sys.argv[1], int(sys.argv[2]), sys.argv[3]
    if mode == "jax":
        run_jax(world, path)
    else:
        run_torch(world, path, int(sys.argv[4]), sys.argv[5])
    return 0


if __name__ == "__main__":
    sys.exit(main())
