"""UNOMT end to end (paper §4): data engineering and deep learning in one
program on one runtime, the paper's headline application.

    PYTHONPATH=src python -m repro_torch.launch.unomt_e2e \\
        [--device cpu] [--rows 20000] [--steps 200] [--compress]

The counterpart of ``examples/unomt_e2e.py``'s stages 2–4 (paper
Fig. 5), without its restart drill:

2. data engineering -> the distributed join / unique / isin / scale
   pipeline (``data.unomt.unomt_dist_pipeline``);
3. table -> tensor  -> ``feature_label_arrays``, on the tables' device:
   the features never pass through the host;
4. training         -> BSP DDP training of the drug-response net
   (``runtime.ddp``), exact or int8-compressed gradient allreduce.

Runs on the CUDA card unless ``--device cpu``; the world is this process
unless ``torch.distributed`` is initialised.  Prints each stage and
asserts that the loss fell.
"""
import argparse

import torch

from ..core import dist_ops as D
from ..core.context import make_context
from ..data.unomt import (feature_label_arrays, gen_unomt_tables,
                          unomt_dist_pipeline)
from ..models import unomt_net
from ..optim import adamw, compression
from ..runtime.ddp import make_ddp_train_step

TABLES = ("response", "descriptors", "fingerprints", "rna")


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="'cpu', or the CUDA card when not given")
    ap.add_argument("--rows", type=int, default=20_000)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--compress", action="store_true",
                    help="int8 error-feedback gradient allreduce")
    args = ap.parse_args(argv)

    ctx = make_context(args.device)
    world = ctx.world_size
    print(f"[stage 1] {world} rank(s) on {ctx.device}")

    # ---- stage 2: distributed data engineering --------------------------
    raw = gen_unomt_tables(n_response=args.rows, n_drugs=512, n_cells=256,
                           seed=0)
    tables = [D.distribute_table(
        ctx, raw[k], capacity_per_shard=max(
            (len(next(iter(raw[k].values()))) // world) * 2, 8))
        for k in TABLES]
    feat, dropped = D.DistributedPipeline(
        ctx, lambda c, *ts: unomt_dist_pipeline(c, *ts, overcommit=3.0))(
        *tables)
    n_rows = int(ctx.psum(feat.nvalid))
    print(f"[stage 2] features: {n_rows} rows (dropped={int(dropped)})")

    # ---- stage 3: table -> tensors, on the device -----------------------
    X, y, mask = feature_label_arrays(feat)
    # the global batch is every rank's block in rank order (the sharded
    # array of the reference); the DDP step takes this rank's block back
    X, y, mask = (torch.cat(ctx.all_gather(a)) for a in (X, y, mask))
    print(f"[stage 3] X {tuple(X.shape)} {X.dtype} on {X.device}")

    # ---- stage 4: BSP DDP training --------------------------------------
    net_cfg = unomt_net.UnomtNetConfig(n_features=X.shape[1], d_hidden=512,
                                       n_res_blocks=3, n_dense_tail=2,
                                       dropout=0.0)
    params = unomt_net.init(torch.Generator(ctx.device).manual_seed(0),
                            net_cfg)
    opt_cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=20,
                                total_steps=args.steps)
    step = make_ddp_train_step(
        lambda p, b: unomt_net.mse_loss(p, net_cfg, b), opt_cfg, ctx,
        compress=args.compress)
    state = (params, adamw.init(params, opt_cfg),
             compression.init_residuals(params))
    batch = {"x": X, "y": y, "mask": mask}
    history = []
    for _ in range(args.steps):
        *state, metrics = step(*state, batch)
        history.append({k: float(v) for k, v in metrics.items()})
    print(f"[stage 4] loss {history[0]['loss']:.4f} -> "
          f"{history[-1]['loss']:.4f} over {len(history)} steps "
          f"({'compressed' if args.compress else 'exact'} allreduce)")
    if not history[-1]["loss"] < history[0]["loss"]:
        raise AssertionError("the loss did not fall")
    print("unomt_e2e OK")
    return history


if __name__ == "__main__":
    main()
