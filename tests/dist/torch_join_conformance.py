"""Subprocess worker for tests/test_torch_dist.py: the Fig. 4 distributed
join at world W, run by the JAX package or by the PyTorch port on the
same data, written to one ``.npz`` for a bit-for-bit comparison.

Usage:
  XLA_FLAGS=--xla_force_host_platform_device_count=W \\
      python torch_join_conformance.py jax W OUT.npz
  python torch_join_conformance.py torch W OUT.npz RANK STORE_FILE

In ``torch`` mode every rank is one process; they meet through a gloo
process group on a ``file://`` store and rank 0 writes the collected
output.  Each case runs both local backends (``sortmerge``, ``hash``), the
blind-overcommit sizes and the exact plan.
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
