"""Training launcher (PyTorch port of ``repro/launch/train.py``): LM
training with the fault-tolerance stack, at world 1.

    PYTHONPATH=src python -m repro_torch.launch.train --arch lm100m \\
        [--steps 300] [--batch 8] [--seq 512] [--reduced] [--device cpu]
        [--ckpt-dir DIR] [--ckpt-every 50]
        [--fail-at 120]                # failure-injection drill
        [--resume]                     # restore the latest checkpoint

Float32 master weights from ``torch.Generator(device).manual_seed(0)``,
step-addressable batches from ``data.synthetic.lm_batch_at``, AdamW, and
the loop of ``runtime.trainer.run_with_restarts``: asynchronous
checkpoints every ``--ckpt-every`` steps and at the end, and a restart
from the latest one after a failure, which ends bit-identical to the run
without it.  A run without ``--resume`` first removes the checkpoints
in ``--ckpt-dir`` (``checkpoint.clear``; nothing else there).
Runs on the CUDA card unless ``--device cpu``.  Sharded training
(``--mesh``, ``--coordinator``: the data axis, batch sharding, FSDP
gathers and the ZeRO-1 optimizer layout) is the next slice, ROADMAP
Queue 1 item 4b; both flags raise.  Serving at the model axis is
``launch/serve.py --mesh``.
"""
import argparse
import os
import tempfile

import torch

from .. import checkpoint
from ..configs import get_config, get_reduced
from ..core.kernel_backend import resolve_device
from ..data.synthetic import lm_batch_at
from ..models import model as M
from ..optim import adamw
from ..runtime.trainer import FailureInjector, Trainer, run_with_restarts


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="lm100m")
    ap.add_argument("--reduced", action="store_true",
                    help="use the arch's reduced() smoke config")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_lm_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--fail-at", type=int, default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default=None,
                    help="'cpu', or the CUDA card when not given")
    ap.add_argument("--mesh", default=None, help="not ported yet")
    ap.add_argument("--coordinator", default=None, help="not ported yet")
    args = ap.parse_args(argv)
    if args.mesh or args.coordinator:
        raise SystemExit("launch.train: --mesh and --coordinator (sharded "
                         "training: the data axis, batch sharding, FSDP "
                         "gathers, ZeRO-1) wait for ROADMAP Queue 1 item 4b; "
                         "serving at the model axis runs with "
                         "launch.serve --mesh")

    device = resolve_device(args.device)
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    print(f"[launch] arch={cfg.name} params={cfg.param_count():,} "
          f"device={device}")

    opt_cfg = adamw.AdamWConfig(lr=args.lr, total_steps=args.steps)
    params = M.init_params(torch.Generator(device).manual_seed(0), cfg,
                           master=True)
    opt_state = adamw.init(adamw.flatten_params(params), opt_cfg)
    train_step = M.make_train_step(cfg, opt_cfg)

    def step_fn(state, batch):
        params, opt, metrics = train_step(*state, batch)
        return (params, opt), metrics

    def batches(start):
        s = start
        while True:
            b = lm_batch_at(s, vocab=cfg.vocab, batch=args.batch,
                            seq=args.seq)
            yield {k: torch.from_numpy(v).to(device) for k, v in b.items()}
            s += 1

    trainer = Trainer(step_fn=step_fn, ckpt_dir=args.ckpt_dir,
                      ckpt_every=args.ckpt_every,
                      failure=FailureInjector(args.fail_at))
    if not args.resume:
        # a fresh run: stale checkpoints would make its steps count wrong
        checkpoint.clear(args.ckpt_dir)
    _, history = run_with_restarts(batches, trainer, (params, opt_state),
                                   n_steps=args.steps,
                                   log_every=args.log_every)
    if history:
        print(f"[done] loss {history[0]['loss']:.4f} -> "
              f"{history[-1]['loss']:.4f} over {len(history)} recorded "
              "steps")
    if trainer.monitor.stragglers:
        print(f"[monitor] stragglers flagged: "
              f"{trainer.monitor.stragglers[:5]}")
    return history


if __name__ == "__main__":
    main()
