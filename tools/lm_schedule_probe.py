"""Train the repo's LM on ``lm_batch_at`` batches in order under several
learning-rate schedules and print each run's losses: whether a loss that
does not fall in a short run is the schedule's doing or the model's.

    python3 tools/lm_schedule_probe.py [--arch lm100m] [--reduced]
        [--device cpu] [--lr 3e-4] [--batch 8] [--seq 512]
        [--run WARMUP:TOTAL:STEPS ...]

Each ``--run`` trains from the same float32 masters
(``torch.Generator`` seed 0) for STEPS steps of ``make_train_step`` with
``AdamWConfig(lr, warmup_steps=WARMUP, total_steps=TOTAL)``, remat as
the config says, batch ``s`` being ``lm_batch_at(s)``.  The default runs
are ``100:300:300`` (``launch/train.py``'s defaults, whose first 50
steps have the rates of ``AdamWConfig(lr=3e-4, total_steps=50)``: a
warm-up of 100 steps that 50 never leave), ``10:50:50`` and ``5:50:50``.
One JSON line per run: every step's training loss (each batch is seen
once, so it is also a held-out loss), the means of the first and last
ten, the loss of a held-out batch (``lm_batch_at(10**6)``) before and
after, the seconds, and the card's name and power limit as
``nvidia-smi`` gives them.  Runs on the CUDA card unless ``--device
cpu``.
"""
import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.configs import get_config, get_reduced  # noqa: E402
from repro_torch.core.kernel_backend import resolve_device  # noqa: E402
from repro_torch.data.synthetic import lm_batch_at  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.transformer import StackOpts  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

HELD_OUT = 10**6


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not available"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="lm100m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default=None)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--run", action="append", default=None,
                    help="WARMUP:TOTAL:STEPS (repeatable)")
    args = ap.parse_args(argv)
    runs = [tuple(int(v) for v in r.split(":"))
            for r in args.run or ("100:300:300", "10:50:50", "5:50:50")]
    device = resolve_device(args.device)
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    name = card() if device.type == "cuda" else "cpu"

    def batch(s):
        b = lm_batch_at(s, vocab=cfg.vocab, batch=args.batch, seq=args.seq)
        return {k: torch.from_numpy(v).to(device) for k, v in b.items()}

    loss_fn = M.make_loss_fn(cfg, None, StackOpts(remat="none"))

    def held_out(params):
        with torch.no_grad():
            return float(loss_fn(params, batch(HELD_OUT))[1]["loss"])

    for warmup, total, steps in runs:
        opt_cfg = adamw.AdamWConfig(lr=args.lr, warmup_steps=warmup,
                                    total_steps=total)
        params = M.init_params(torch.Generator(device).manual_seed(0), cfg,
                               master=True)
        opt = adamw.init(adamw.flatten_params(params), opt_cfg)
        step = M.make_train_step(cfg, None, opt_cfg)
        before = held_out(params)
        losses = []
        t0 = time.perf_counter()
        for s in range(steps):
            params, opt, met = step(params, opt, batch(s))
            losses.append(met["loss"])
        losses = [float(v) for v in losses]
        seconds = time.perf_counter() - t0
        print(json.dumps({
            "arch": cfg.name, "card": name, "lr": args.lr,
            "warmup_steps": warmup, "total_steps": total, "steps": steps,
            "batch": args.batch, "seq": args.seq, "seconds": seconds,
            "first10": float(np.mean(losses[:10])),
            "last10": float(np.mean(losses[-10:])),
            "held_out": [before, held_out(params)], "losses": losses}),
            flush=True)
        del params, opt
    return 0


if __name__ == "__main__":
    sys.exit(main())
