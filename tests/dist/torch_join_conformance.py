"""Subprocess worker for tests/test_torch_dist.py: the Fig. 4 distributed
join and the Table 5 operators (groupby, unique, sort, repartition, the
broadcast join) at world W, run by the JAX package or by the PyTorch port
on the same data, written to one ``.npz`` for a bit-for-bit comparison.

Usage:
  XLA_FLAGS=--xla_force_host_platform_device_count=W \\
      python torch_join_conformance.py jax W OUT.npz
  python torch_join_conformance.py torch W OUT.npz RANK STORE_FILE

In ``torch`` mode every rank is one process; they meet through a gloo
process group on a ``file://`` store and rank 0 writes the collected
output.  Each join case runs both local backends (``sortmerge``,
``hash``), the blind-overcommit sizes and the exact plan; each Table 5
case runs both local backends of its operator.  Float values are
integer-valued where they are summed, so sums and means compare bit for
bit.
"""
import sys
from datetime import timedelta

import numpy as np

ROWS = 96


def cases(world: int):
    """(name, left, right, kwargs) with numpy-only inputs."""
    rng = np.random.default_rng(100 + world)
    uniq = np.arange(ROWS, dtype=np.int32)
    rng.shuffle(uniq)
    dists = {
        "unique": (uniq, rng.permutation(uniq)),
        "dup10": (rng.integers(0, ROWS // 10, ROWS).astype(np.int32),
                  rng.integers(0, ROWS // 10, ROWS).astype(np.int32)),
        "alldup": (np.full(ROWS, 7, np.int32), np.full(ROWS, 7, np.int32)),
    }
    for name, (lk, rk) in dists.items():
        left = {"k": lk, "lv": rng.normal(size=ROWS).astype(np.float32)}
        right = {"k": rk, "rv": rng.normal(size=ROWS).astype(np.float32)}
        for how in ("inner", "left"):
            for impl in ("sortmerge", "hash"):
                yield (f"{name}/{how}/{impl}", left, right,
                       dict(left_on=["k"], how=how, local_impl=impl,
                            out_capacity=ROWS * ROWS + ROWS, overcommit=4.0,
                            local_join_sizes=(
                                {"num_buckets": 8, "bucket_capacity": ROWS,
                                 "probe_capacity": ROWS}
                                if impl == "hash" else None)),
                       (ROWS // world) * 4)
    left = {"k": dists["dup10"][0], "lv": rng.normal(size=ROWS)}
    right = {"k": dists["dup10"][1], "rv": rng.normal(size=ROWS)}
    for impl in ("sortmerge", "hash"):
        yield f"planned/{impl}", left, right, dict(impl=impl), None


def table5_cases(D, world: int):
    """(name, fn(ctx, *tables), datas) with numpy-only inputs."""
    L = D.L
    rng = np.random.default_rng(200 + world)
    data = {"k": rng.integers(0, 12, ROWS).astype(np.int32),
            "f": rng.choice(np.array([0.0, -0.0, 1.5, -2.0, 7.25],
                                     np.float32), ROWS),
            "v": rng.integers(-50, 50, ROWS).astype(np.float32)}
    data["v"][::17] = np.nan
    aggs = {"v": ["sum", "count", "mean", "min", "max"]}
    sizes = {"num_buckets": 8, "bucket_capacity": ROWS}
    for impl in ("sort", "hash"):
        gs = sizes if impl == "hash" else None
        yield (f"groupby/{impl}", lambda c, a, gs=gs, impl=impl:
               D.dist_groupby(c, a, ["k", "f"], aggs, overcommit=4.0,
                              local_impl=impl, groupby_sizes=gs), (data,))
        yield (f"unique/{impl}", lambda c, a, gs=gs, impl=impl:
               D.dist_unique(c, a, ["f"], overcommit=4.0, local_impl=impl,
                             groupby_sizes=gs), (data,))
    for impl in ("xla", "radix"):
        yield (f"sort/{impl}", lambda c, a, impl=impl: D.dist_sort(
            c, a, ["f", "k"], ascending=False, local_impl=impl), (data,))
    yield ("repartition", lambda c, a: D.dist_repartition(
        c, L.select(a, a.columns["k"] < 3)), (data,))
    left = {"k": rng.integers(0, 20, ROWS).astype(np.int32),
            "lv": rng.normal(size=ROWS).astype(np.float32)}
    right = {"k": rng.permutation(np.arange(24, dtype=np.int32))[:20],
             "rv": rng.normal(size=20).astype(np.float32)}
    for impl in ("sortmerge", "hash"):
        js = {"num_buckets": 8, "bucket_capacity": 24,
              "probe_capacity": ROWS} if impl == "hash" else None
        yield (f"broadcast/{impl}", lambda c, a, b, impl=impl, js=js:
               D.dist_join(c, a, b, left_on=["k"], strategy="broadcast",
                           local_impl=impl, local_join_sizes=js),
               (left, right))


def run(D, ctx, world: int) -> dict:
    out = {}
    for name, left, right, kw, cap in cases(world):
        if "impl" in kw:                      # the exact host-side plan
            impl = kw["impl"]
            plan = D.plan_dist_join_sizes([left["k"]], [right["k"]],
                                          world=world, local_impl=impl)
            kw = dict(left_on=["k"], local_impl=impl,
                      out_capacity=plan["out_capacity"],
                      shuffle_sizes=plan["shuffle_sizes"],
                      local_join_sizes=plan["local_join_sizes"])
        pipe = D.DistributedPipeline(
            ctx, lambda c, a, b, kw=kw: D.dist_join(c, a, b, **kw))
        res, dropped = pipe(D.distribute_table(ctx, left, cap),
                            D.distribute_table(ctx, right, cap))
        got = D.collect_table(ctx, res)
        for k, v in got.items():
            out[f"{name}/{k}"] = v
        out[f"{name}/dropped"] = np.asarray(int(np.max(np.asarray(
            dropped.cpu() if hasattr(dropped, "cpu") else dropped))))
    for name, fn, datas in table5_cases(D, world):
        res, dropped = D.DistributedPipeline(ctx, fn)(
            *[D.distribute_table(ctx, d) for d in datas])
        for k, v in D.collect_table(ctx, res).items():
            out[f"{name}/{k}"] = v
        out[f"{name}/dropped"] = np.asarray(int(np.max(np.asarray(
            dropped.cpu() if hasattr(dropped, "cpu") else dropped))))
    return out


def main():
    mode, world, path = sys.argv[1], int(sys.argv[2]), sys.argv[3]
    if mode == "jax":
        import jax
        from jax.sharding import Mesh
        from repro.core import dist_ops as D
        from repro.core.context import make_context
        ctx = make_context(Mesh(np.array(jax.devices()[:world]), ("data",)))
        np.savez(path, **run(D, ctx, world))
        return 0
    import torch.distributed as dist
    from repro_torch.core import dist_ops as D
    from repro_torch.core.context import make_context
    rank, store = int(sys.argv[4]), sys.argv[5]
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=world, rank=rank,
                            timeout=timedelta(seconds=120))
    try:
        out = run(D, make_context("cpu"), world)
        if rank == 0:
            np.savez(path, **out)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
