"""Training launcher (PyTorch port of ``repro/launch/train.py``): LM
training with the fault-tolerance stack, at world 1 or over a mesh of
rank processes.

    PYTHONPATH=src python -m repro_torch.launch.train --arch lm100m \\
        [--steps 300] [--batch 8] [--seq 512] [--reduced] [--device cpu]
        [--mesh data=2,model=2]        # D x M rank processes
        [--mesh pod=2,data=2,model=1]  # P x D x M rank processes
        [--coordinator host:port]      # this process is one rank
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
Runs on the CUDA card unless ``--device cpu``.

``--mesh data=D,model=M`` trains over D x M rank processes, and
``--mesh pod=P,data=D,model=M`` over P x D x M (the rows of a batch cut
over pod x data, pod major; weights and moments cut over data and whole
over pod, the gradients averaged over pod x data)
(``launch.serve.spawn``; they meet through a ``file://`` store in a
temporary directory): rank r on ``cuda:r`` when there are that many
cards (NCCL), all on the one card when there is one (gloo, the
exchanges staged through host memory), on the CPU under ``--device
cpu`` (gloo).  Each rank draws the world-1 weights, keeps its slices
under ``make_policy(mesh, cfg.train.sharding)``, holds its AdamW moments
in the ZeRO-1 layout and trains on its rows of every batch
(``sharding.shard_batch``); the checkpoints hold whole leaves, so they
restore at any world and in the reference.  ``main`` returns rank 0's
history.  ``--coordinator host:port`` runs this process as one rank of
such a run, started once per rank (by ``torchrun`` or by hand): rank,
world size and card from ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK``,
the mesh from ``--mesh`` (default ``data=WORLD_SIZE,model=1``); it
returns this rank's history.

The batches carry tokens and labels only, as the reference launcher's
do: a config whose model also reads frames (an encoder) or patch
embeddings (a vision prefix) is refused before any rank starts, at
every world.  Those train through ``models.model.make_train_step`` with
their inputs in the batch, at world 1 or over a mesh.
"""
import argparse
import json
import math
import os
import tempfile

import torch

from .. import checkpoint
from ..configs import get_config, get_reduced
from ..core.kernel_backend import resolve_device
from ..data.synthetic import lm_batch_at
from ..models import model as M
from ..models import sharding as Sh
from ..models import transformer as Tf
from ..optim import adamw
from ..runtime.trainer import FailureInjector, Trainer, run_with_restarts
from . import mesh as Me
from .serve import rank_device, spawn


def parse_args(argv=None):
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
    ap.add_argument("--mesh", default=None,
                    help="e.g. data=2,model=2: rank processes over a mesh")
    ap.add_argument("--coordinator", default=None,
                    help="host:port: this process is rank $RANK of "
                         "$WORLD_SIZE")
    return ap.parse_args(argv)


def train(args, cfg, device, policy=None, rank: int = 0) -> list[dict]:
    """The run on this rank (``policy`` None: the whole run in this
    process); rank 0 prints."""
    say = print if rank == 0 else (lambda *a, **k: None)
    say(f"[launch] arch={cfg.name} params={cfg.param_count():,} "
        f"device={device}" + ("" if policy is None else
                              f" mesh={dict(policy.mesh.shape)}"))
    opt_cfg = adamw.AdamWConfig(lr=args.lr, total_steps=args.steps)
    params = M.init_params(torch.Generator(device).manual_seed(0), cfg,
                           master=True)
    zero = None
    if policy is not None:
        params = Sh.shard_params(params, policy, cfg=cfg)
        zero = Sh.Zero1(policy, adamw.flatten_params(params))
        if device.type == "cuda":       # the whole draws, for other ranks
            torch.cuda.empty_cache()
    flat = adamw.flatten_params(params)
    opt_state = adamw.init({k: zero.local(k, p) for k, p in flat.items()}
                           if zero else flat, opt_cfg)
    train_step = M.make_train_step(cfg, policy, opt_cfg, donate=True)

    def step_fn(state, batch):
        params, opt, metrics = train_step(*state, batch)
        return (params, opt), metrics

    def batches(start):
        s = start
        while True:
            b = lm_batch_at(s, vocab=cfg.vocab, batch=args.batch,
                            seq=args.seq)
            yield {k: torch.from_numpy(v).to(device)
                   for k, v in Sh.shard_batch(b, policy).items()}
            s += 1

    layout = Sh.train_state_layout(policy, params, opt_state, cfg)
    trainer = Trainer(step_fn=step_fn, ckpt_dir=args.ckpt_dir,
                      ckpt_every=args.ckpt_every,
                      failure=FailureInjector(args.fail_at), layout=layout)
    if not args.resume:
        # a fresh run: stale checkpoints would make its steps count wrong
        if rank == 0:
            checkpoint.clear(args.ckpt_dir)
        if layout is not None:
            layout.barrier()
    _, history = run_with_restarts(batches, trainer, (params, opt_state),
                                   n_steps=args.steps,
                                   log_every=args.log_every, log_fn=say)
    if history:
        say(f"[done] loss {history[0]['loss']:.4f} -> "
            f"{history[-1]['loss']:.4f} over {len(history)} recorded steps")
    if trainer.monitor.stragglers:
        say(f"[monitor] stragglers flagged: "
            f"{trainer.monitor.stragglers[:5]}")
    return history


def _config(args):
    return get_reduced(args.arch) if args.reduced else get_config(args.arch)


def _check_batches(cfg) -> None:
    """Raise for a config whose model reads inputs besides the tokens,
    which ``lm_batch_at``'s batches do not carry."""
    what = "frames for its encoder" if cfg.is_encdec else \
        "patch embeddings" if cfg.frontend == "vision" else None
    if what:
        raise ValueError(f"{cfg.name}: the launcher's batches carry tokens "
                         f"and labels only, and this model also reads "
                         f"{what}; train it through "
                         "models.model.make_train_step with them in the "
                         "batch")


def _policy(cfg, shape: dict):
    return Sh.make_policy(Me.make_mesh(shape), cfg.train.sharding)


def _train_rank(rank: int, world: int, store: str, args, out: str) -> None:
    """One rank of ``--mesh``: join the group, build the mesh and the
    config's policy, train; rank 0 writes its history to ``out``."""
    device = rank_device(rank, world, args.device)
    if device.type == "cpu":           # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    Me.init_rank(rank, world, store, device)
    try:
        cfg = _config(args)
        history = train(args, cfg, device,
                        _policy(cfg, Me.parse_mesh(args.mesh)), rank)
        if rank == 0:
            with open(out, "w") as f:
                json.dump(history, f)
    finally:
        torch.distributed.destroy_process_group()


def main(argv=None) -> list[dict]:
    args = parse_args(argv)
    cfg = _config(args)
    _check_batches(cfg)
    if args.coordinator:
        rank, world, device = Me.init_from_env(args.coordinator, args.device)
        try:
            shape = Me.parse_mesh(args.mesh) if args.mesh \
                else {"data": world, "model": 1}
            return train(args, cfg, device, _policy(cfg, shape), rank)
        finally:
            torch.distributed.destroy_process_group()
    shape = Me.parse_mesh(args.mesh) if args.mesh else {}
    world = math.prod(shape.values()) if shape else 1
    if world == 1:
        return train(args, cfg, resolve_device(args.device))
    # refuse what the ranks would refuse, before any starts
    Tf.check_supported(cfg, Sh.make_policy(Me.abstract_mesh(shape),
                                           cfg.train.sharding), train=True)
    rank_device(0, world, args.device)
    with tempfile.TemporaryDirectory(prefix="repro_torch_train_") as tmp:
        out = os.path.join(tmp, "history.json")
        spawn(world, _train_rank, (args, out))
        with open(out) as f:
            return json.load(f)


if __name__ == "__main__":
    main()
