"""UNOMT end to end (paper §4): data engineering and deep learning in one
program on one runtime, the paper's headline application.

    PYTHONPATH=src python -m repro_torch.launch.unomt_e2e \\
        [--device cpu] [--rows 20000] [--steps 200] [--compress] \\
        [--fail-at 120] [--ckpt-dir DIR] [--ckpt-every 50]

The counterpart of ``examples/unomt_e2e.py``'s stages 2–4 (paper
Fig. 5), restart drill included:

2. data engineering -> the distributed join / unique / isin / scale
   pipeline (``data.unomt.unomt_dist_pipeline``);
3. table -> tensor  -> ``feature_label_arrays``, on the tables' device:
   the features never pass through the host;
4. training         -> BSP DDP training of the drug-response net
   (``runtime.ddp``), exact or int8-compressed gradient allreduce, in
   the fault-tolerant loop (``runtime.trainer``): the state
   ``(params, opt, residuals)`` is checkpointed every ``--ckpt-every``
   steps, and ``--fail-at`` injects a failure there, after which training
   restarts from the latest checkpoint and ends bit-identical to the run
   without it.  The net runs without dropout, as the reference's drill
   does (a drill with dropout would also have to checkpoint the
   generator's state).

Runs on the CUDA card unless ``--device cpu``; the world is this process
unless ``torch.distributed`` is initialised (each rank then checkpoints
its replica of the state under ``rank<r>/``).  A run first removes the
checkpoints in ``--ckpt-dir`` (``checkpoint.clear``; nothing else
there); without one it checkpoints into a temporary directory.  Prints
each stage and asserts that the loss fell.
"""
import argparse
import os
import tempfile

import torch

from .. import checkpoint
from ..core import dist_ops as D
from ..core.context import HptmtContext, make_context
from ..data.unomt import (feature_label_arrays, gen_unomt_tables,
                          unomt_dist_pipeline)
from ..models import unomt_net
from ..optim import adamw, compression
from ..runtime.ddp import make_ddp_train_step
from ..runtime.trainer import FailureInjector, Trainer, run_with_restarts

TABLES = ("response", "descriptors", "fingerprints", "rna")


def train_stage(ctx: HptmtContext, X, y, mask, *, steps: int, ckpt_dir: str,
                compress: bool = False, batch_rows: int | None = None,
                ckpt_every: int = 50, fail_at: int | None = None,
                log_every: int = 10):
    """Stage 4 in the fault-tolerant loop: the reference's net (512
    hidden, 3 blocks, tail 2, no dropout; weights from
    ``torch.Generator`` seed 0) trained for ``steps`` DDP steps.  Step
    ``s`` takes the global batch ``s mod (n // batch_rows)`` of
    ``batch_rows`` rows in order (all ``n`` rows when not given), so a
    restart resumes the same data.  Returns (state, history of the last
    attempt) as ``run_with_restarts`` does."""
    net_cfg = unomt_net.UnomtNetConfig(n_features=X.shape[1], d_hidden=512,
                                       n_res_blocks=3, n_dense_tail=2,
                                       dropout=0.0)
    params = unomt_net.init(torch.Generator(ctx.device).manual_seed(0),
                            net_cfg)
    opt_cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=20, total_steps=steps)
    ddp_step = make_ddp_train_step(
        lambda p, b: unomt_net.mse_loss(p, net_cfg, b), opt_cfg, ctx,
        compress=compress)

    def step_fn(state, batch):
        *state, metrics = ddp_step(*state, batch)
        return tuple(state), metrics

    b = batch_rows or X.shape[0]
    n_batches = X.shape[0] // b

    def batches(start):
        s = start
        while True:
            rows = slice((s % n_batches) * b, (s % n_batches + 1) * b)
            yield {"x": X[rows], "y": y[rows], "mask": mask[rows]}
            s += 1

    state0 = (params, adamw.init(params, opt_cfg),
              compression.init_residuals(params))
    trainer = Trainer(step_fn=step_fn, ckpt_dir=ckpt_dir,
                      ckpt_every=ckpt_every,
                      failure=FailureInjector(fail_at))
    return run_with_restarts(batches, trainer, state0, n_steps=steps,
                             log_every=log_every)


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="'cpu', or the CUDA card when not given")
    ap.add_argument("--rows", type=int, default=20_000)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--compress", action="store_true",
                    help="int8 error-feedback gradient allreduce")
    ap.add_argument("--fail-at", type=int, default=None,
                    help="inject a failure at this step (restart drill)")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (a temporary one if not "
                         "given)")
    ap.add_argument("--ckpt-every", type=int, default=50)
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

    # ---- stage 4: BSP DDP training, fault tolerant -------------------
    with tempfile.TemporaryDirectory(prefix="unomt_ckpt_") as tmp:
        ckpt_dir = args.ckpt_dir or tmp
        if world > 1:
            ckpt_dir = os.path.join(ckpt_dir, f"rank{ctx.rank}")
        checkpoint.clear(ckpt_dir)                     # a fresh run
        _, history = train_stage(ctx, X, y, mask, steps=args.steps,
                                 ckpt_dir=ckpt_dir, compress=args.compress,
                                 ckpt_every=args.ckpt_every,
                                 fail_at=args.fail_at)
    print(f"[stage 4] loss {history[0]['loss']:.4f} -> "
          f"{history[-1]['loss']:.4f} over {len(history)} steps "
          f"({'compressed' if args.compress else 'exact'} allreduce)")
    stragglers = [h for h in history if h["straggler"]]
    if stragglers:
        print(f"[monitor] {len(stragglers)} straggler steps flagged")
    if not history[-1]["loss"] < history[0]["loss"]:
        raise AssertionError("the loss did not fall")
    print("unomt_e2e OK")
    return history


if __name__ == "__main__":
    main()
