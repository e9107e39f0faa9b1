"""Serving launcher: continuous-batching decode fused with feature joins.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch lm100m \
        --reduced [--requests 32] [--slots 4] [--prompt-len 32] [--gen 16] \
        [--queue-capacity 64] [--no-features] [--seed 0] [--device cpu] \
        [--mesh data=D,model=M] [--mesh pod=P,data=D,model=M]

Thin CLI over :class:`repro_torch.serving.ServingEngine` (the port of
``repro.launch.serve``): it draws
random weights from a ``torch.Generator`` seeded with ``--seed``,
generates a stream of requests (random prompts of heterogeneous lengths,
each carrying drug/cell feature keys), submits them through the bounded
admission queue and runs the engine until drained.  Every request's keys
resolve against UNOMT feature tables through the port's distributed join
before its prompt enters a slot.  Prints the metrics snapshot and
asserts the accounting identity: submitted == completed + rejected +
feature_misses.  Runs on the CUDA card unless ``--device cpu``.  Any
uniform decoder-only config serves: a dense one (``lm100m``,
``granite-3-2b``, ...), an MoE one (``granite-moe-3b-a800m``,
``qwen3-moe-235b-a22b``) or a Mamba one (``falcon-mamba-7b``, prefilled
at each prompt's true length).

``--mesh data=D,model=M`` serves over D x M rank processes
(:func:`spawn`), which meet through a ``file://`` store in a temporary
directory: rank r runs on ``cuda:r`` when there are D x M cards (NCCL),
on the one card for all ranks when there is one (gloo, the exchanges
staged through host memory) and on the CPU under ``--device cpu``
(gloo).  Each rank draws the same weights, keeps its slice under
``make_policy(mesh, "fsdp_tp")``, as the reference's launcher (the
model axis: tensor and expert parallelism; the data axis: the 2D slice
of each matrix, gathered over the data ranks a layer at a time in every
forward) and runs the same engine over the same requests.  The slots
split over the data ranks where they divide (each rank decodes its
block; a slot's prefill runs on every data rank, its cache kept by the
slot's owner); MoE layers dispatch by ``moe_shuffle`` in prefill and
``moe_decode`` in decode over the rank's model group, and the feature
stores run over all D x M ranks.  Rank 0 prints the snapshot.
``--mesh pod=P,data=D,model=M`` adds the second batch axis: the slots
split over pod x data (pod major), the weights are cut over data and
whole over pod (the reference's ``_dd``), so a pod gathers nothing.
Dense, MoE, Mamba and hybrid (Jamba's period stacks) configs serve this
way.  Refused, before any rank starts: what
``models.transformer.check_supported`` refuses (heads, channels or a
vocabulary that do not split over the model axis).  A mesh of one rank
serves in this process, as without ``--mesh``.
"""
import argparse
import math
import multiprocessing
import os
import tempfile
import time

import numpy as np
import torch

from ..configs import get_config, get_reduced
from ..core.context import make_context
from ..core.kernel_backend import resolve_device
from ..data.unomt import gen_unomt_tables
from ..models import model as M
from ..models import sharding as Sh
from ..models import transformer as Tf
from ..serving import FeatureStore, Request, ServingEngine
from . import mesh as Me

N_DRUGS, N_CELLS = 256, 128
CHUNK_ROWS = 64                # ingest morsel of the feature stores


def feature_stores(ctx, seed: int, probe_capacity: int) -> dict:
    """The drug and cell feature stores over ``gen_unomt_tables`` (256
    drugs, 128 cells): drug descriptors and fingerprints side by side,
    and the first RNA record of each cell (the table has duplicates)."""
    raw = gen_unomt_tables(n_drugs=N_DRUGS, n_cells=N_CELLS, seed=seed)
    drug = dict(raw["descriptors"])
    drug.update({k: v for k, v in raw["fingerprints"].items()
                 if k != "drug_id"})
    _, first = np.unique(raw["rna"]["cell_id"], return_index=True)
    rna = {k: v[first] for k, v in raw["rna"].items()}
    return {
        "drug_id": FeatureStore(ctx, "drug_id", drug,
                                probe_capacity=probe_capacity,
                                chunk_rows=CHUNK_ROWS),
        "cell_id": FeatureStore(ctx, "cell_id", rna,
                                probe_capacity=probe_capacity,
                                chunk_rows=CHUNK_ROWS),
    }, {"drug_id": drug, "cell_id": rna}


def make_requests(cfg, n: int, prompt_len: int, gen: int, seed: int):
    """``n`` requests: prompts of 1..prompt_len tokens, gen_len 1..gen,
    keys over the stores' drugs and cells, from ``default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        reqs.append(Request(
            req_id=i,
            prompt=rng.integers(0, cfg.vocab,
                                rng.integers(1, prompt_len + 1)
                                ).astype(np.int32),
            gen_len=int(rng.integers(1, gen + 1)),
            drug_id=int(rng.integers(0, N_DRUGS)),
            cell_id=int(rng.integers(0, N_CELLS))))
    return reqs


def drive(engine: ServingEngine, reqs, slots: int):
    """Submit ``reqs`` with a decode step after every ``max(4 slots, 8)``
    arrivals, then run until drained.  Returns (finished, rejected ids,
    seconds)."""
    t0 = time.perf_counter()
    rejected_ids = []
    for i, req in enumerate(reqs):
        if not engine.submit(req):
            rejected_ids.append(req.req_id)
        if (i + 1) % max(slots * 4, 8) == 0:
            engine.step()                  # interleave arrivals and decode
    done = engine.run_until_drained()
    return done, rejected_ids, time.perf_counter() - t0


def rank_device(rank: int, world: int, device=None) -> torch.device:
    """Rank ``rank``'s device: the CPU under ``device="cpu"``, else
    ``cuda:rank`` when there are ``world`` cards and the cards in turn
    when there are fewer (one card: every rank on ``cuda:0``)."""
    if device is not None and torch.device(device).type == "cpu":
        return torch.device("cpu")
    resolve_device(device)                 # raises without a card
    return torch.device("cuda", rank % torch.cuda.device_count())


def spawn(world: int, target, args=(), timeout_s: float | None = None):
    """Run ``target(rank, world, store_path, *args)`` in ``world`` fresh
    processes (``spawn`` start method) that meet through a ``file://``
    store in a new temporary directory.  Waits for all of them; when one
    fails (or ``timeout_s`` passes) the others are killed and
    ``RuntimeError`` is raised, so no rank is left behind."""
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="repro_torch_mesh_") as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=target,
                             args=(r, world, store, *args), daemon=False)
                 for r in range(world)]
        for pr in procs:
            pr.start()
        t0 = time.monotonic()
        failed = None
        try:
            while any(pr.is_alive() for pr in procs):
                bad = [i for i, pr in enumerate(procs)
                       if pr.exitcode not in (None, 0)]
                if bad:
                    failed = f"rank {bad[0]} exited with " \
                        f"{procs[bad[0]].exitcode}"
                    break
                if timeout_s is not None \
                        and time.monotonic() - t0 > timeout_s:
                    failed = f"ranks still running after {timeout_s} s"
                    break
                procs[0].join(0.2)
        finally:
            for pr in procs:
                if pr.is_alive():
                    pr.kill()
                pr.join()
        bad = [i for i, pr in enumerate(procs) if pr.exitcode != 0]
        if failed or bad:
            raise RuntimeError(failed or f"ranks {bad} failed (exit codes "
                               f"{[procs[i].exitcode for i in bad]})")


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="lm100m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32,
                    help="max prompt length (requests vary below it)")
    ap.add_argument("--gen", type=int, default=16,
                    help="max tokens generated (requests vary below it)")
    ap.add_argument("--queue-capacity", type=int, default=64)
    ap.add_argument("--no-features", action="store_true",
                    help="skip the feature-store stage")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--mesh", default=None,
                    help="e.g. data=1,model=2: rank processes over a mesh")
    return ap.parse_args(argv)


def sharded_params(cfg, device, seed: int, policy):
    """The weights of ``torch.Generator(device).manual_seed(seed)``, as
    world 1 draws them, then this rank's slice of each leaf (the whole
    tree is freed)."""
    params = M.init_params(
        torch.Generator(device=device).manual_seed(seed), cfg)
    if policy is None or policy.mesh.size == 1:
        return params
    return Sh.shard_params(params, policy, cfg=cfg)


def serve(args, device, policy=None, rank: int = 0) -> None:
    """Build the engine (and its stores) on ``device`` under ``policy``,
    drive the requests and check them; rank 0 prints the snapshot."""
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    params = sharded_params(cfg, device, args.seed, policy)
    stores = {}
    if not args.no_features:
        stores, _ = feature_stores(make_context(device), args.seed,
                                   max(args.slots, 8))
    engine = ServingEngine(cfg, params, policy=policy, slots=args.slots,
                           prompt_capacity=args.prompt_len,
                           gen_capacity=args.gen,
                           queue_capacity=args.queue_capacity,
                           feature_stores=stores, device=device)
    reqs = make_requests(cfg, args.requests, args.prompt_len, args.gen,
                         args.seed)
    done, rejected_ids, dt = drive(engine, reqs, args.slots)

    m = engine.metrics
    snap = m.snapshot()
    if rank == 0:
        world = "" if policy is None else \
            f" x {policy.mesh.size} ranks {dict(policy.mesh.shape)}"
        print(f"[serve] {len(done)} completed / {len(rejected_ids)} "
              f"rejected of {args.requests} in {dt:.2f}s on {device}"
              f"{world} ({m.count('tokens_generated') / dt:.0f} tok/s)")
        for k in sorted(snap["counters"]):
            print(f"  counter {k:>18} = {snap['counters'][k]}")
        for k, g in snap["gauges"].items():
            print(f"  gauge   {k:>18} = last {g['last']:.0f} "
                  f"max {g['max']:.0f}")
        for k, s in snap["latency"].items():
            if s["count"]:
                print(f"  series  {k:>18} = p50 {s['p50'] * 1e3:.1f}ms "
                      f"p99 {s['p99'] * 1e3:.1f}ms n={s['count']}")
    if m.count("submitted") != m.count("completed") + \
            m.count("rejected") + m.count("feature_misses"):
        raise SystemExit("accounting identity violated")
    for r in done:
        if r.status == "done" and len(r.out_tokens) != r.gen_len:
            raise SystemExit(f"request {r.req_id}: {len(r.out_tokens)} "
                             f"tokens, wanted {r.gen_len}")
        if stores and r.status == "done" and not r.features:
            raise SystemExit(f"request {r.req_id} served without features")
    if rank == 0:
        print("serve OK", flush=True)


def _serve_rank(rank: int, world: int, store: str, args) -> None:
    """One rank of ``--mesh``: join the group, build the mesh and the
    reference's serving policy, serve."""
    device = rank_device(rank, world, args.device)
    if device.type == "cpu":           # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    Me.init_rank(rank, world, store, device)
    try:
        policy = Sh.make_policy(Me.make_mesh(Me.parse_mesh(args.mesh)),
                                "fsdp_tp")
        serve(args, device, policy, rank)
    finally:
        torch.distributed.destroy_process_group()


def main(argv=None):
    args = parse_args(argv)
    world = math.prod(Me.parse_mesh(args.mesh).values()) if args.mesh else 1
    if world == 1:
        serve(args, resolve_device(args.device))
        return
    rank_device(0, world, args.device)     # raises before any rank starts
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    Tf.check_supported(cfg, Sh.make_policy(
        Me.abstract_mesh(Me.parse_mesh(args.mesh)), "fsdp_tp"))
    spawn(world, _serve_rank, (args,))


if __name__ == "__main__":
    main()
