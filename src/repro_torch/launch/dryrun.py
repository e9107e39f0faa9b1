"""Dry-run of every (architecture × input shape × production mesh) cell
on the ``meta`` device (PyTorch port of ``repro/launch/dryrun.py``).

For each cell it builds the step function the reference builds in
``build_lowered`` (train: ``make_train_step`` under the config's flavor;
prefill: ``make_prefill`` under ``fsdp_tp`` on the kernels' path;
decode: ``make_serve_step`` under ``fsdp_tp``), runs it once as rank 0 of
the 256- or 512-rank mesh on the stand-ins of ``launch/specs.py``, and
records the roofline of what ran (``roofline/``: FLOPs, bytes and
collectives counted op by op, each hand-written kernel at its bound's
work) and the rank's resident bytes.  Nothing is allocated on any
device: the tensors are ``meta`` tensors, the collectives go to
``torch.distributed``'s ``fake`` backend (every rank's groups are made by
``launch/mesh.make_mesh``; a collective returns at once) and the process
group lives only inside :func:`fake_world`.  It is the one entry point
that does not take the card, as the reference's runs on a CPU
placeholder mesh.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun \
        [--arch granite-3-2b] [--cell train_4k] [--mesh both]
        [--out results/dryrun_torch.json] [--force] [--tag baseline]
        [--overrides k=v,...]

Results accumulate incrementally under ``{tag}/{arch}/{cell}/{16x16 |
2x16x16}``; cells already present and ok are skipped unless ``--force``.
A cell the port refuses is recorded as ``{"ok": false, "error": ...}``
with the refusal's words.  (``results/dryrun.json`` is the reference's
file, which its tests read.)
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time
import traceback

import torch.distributed as dist

from ..configs import ARCH_IDS, cells_for, get_config
from ..models import model as M
from ..models import transformer as Tf
from ..models.sharding import make_policy
from ..roofline.analysis import Roofline, model_flops_for
from ..roofline.cost import CostCounter
from . import mesh as Me
from . import specs as SP

MESHES = {False: {"data": 16, "model": 16},
          True: {"pod": 2, "data": 16, "model": 16}}


def mesh_desc(shape: dict) -> str:
    return "x".join(str(n) for n in shape.values())


@contextlib.contextmanager
def fake_world(world: int):
    """This process as rank 0 of a process group of ``world`` ranks
    on the ``fake`` backend (collectives return at once, their outputs
    unwritten); the group is always destroyed on the way out.  Nothing to
    do at world 1."""
    if world == 1:
        yield
        return
    # importing it registers the "fake" backend
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is initialised already; the "
                           "dry-run runs in a process of its own")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def cell_policy(cfg, cell, mesh):
    """The reference's policy of a cell: the config's flavor in training,
    ``fsdp_tp`` (2D weights) in serving."""
    kind = SP.shape_cell(cell).kind
    return make_policy(mesh, cfg.train.sharding if kind == "train"
                       else "fsdp_tp")


def build_step(cfg, cell, policy, sp: dict, decode_len: int | None = None):
    """The cell's step function bound to its stand-ins ``sp``
    (:func:`specs.input_specs`): a callable of no arguments.  A prefill's
    caches are padded to ``decode_len`` (default: the cell's length)."""
    sh = SP.shape_cell(cell)
    if sh.kind == "train":
        step = M.make_train_step(cfg, policy, SP.opt_config(cfg),
                                 donate=True)
        return lambda: step(sp["params"], sp["opt_state"], sp["batch"])
    if sh.kind == "prefill":
        prefill = M.make_prefill(cfg, policy,
                                 decode_len=decode_len or sh.seq_len,
                                 attn_impl="cuda", mamba_impl="cuda")
        return lambda: prefill(sp["params"], sp["batch"])
    serve = M.make_serve_step(cfg, policy)
    return lambda: serve(sp["params"], sp["caches"], sp["tokens"],
                         sp["cache_len"])


def measure(cfg, cell, shape: dict | None, *, arch: str | None = None,
            desc: str | None = None, decode_len: int | None = None) -> dict:
    """One cell's record: the step of ``cfg`` at ``cell`` (a name of
    ``SHAPES`` or a ``ShapeCell``) run once as rank 0 of a mesh of
    ``shape`` (None: world 1) under :func:`fake_world`, counted."""
    sh = SP.shape_cell(cell)
    world = math.prod(shape.values()) if shape else 1
    t0 = time.perf_counter()
    with fake_world(world):
        mesh = Me.make_mesh(shape) if shape else None
        policy = cell_policy(cfg, sh, mesh)
        Tf.check_supported(cfg, policy, train=sh.kind == "train")
        sp = SP.input_specs(cfg, sh, policy)
        step = build_step(cfg, sh, policy, sp, decode_len)
        t1 = time.perf_counter()
        with CostCounter() as cc:
            step()
        t2 = time.perf_counter()
    roof = Roofline(arch=arch or cfg.name, cell=sh.name,
                    mesh=desc or (mesh_desc(shape) if shape else "1"),
                    flops_per_dev=float(cc.flops),
                    bytes_per_dev=float(cc.bytes),
                    collective=cc.collective_stats(),
                    model_flops=model_flops_for(cfg, sh), n_chips=world,
                    memory_per_dev=SP.resident(sp),
                    ndr_link_bytes=cc.ndr_link_bytes,
                    flops_f32_per_dev=float(cc.flops_f32),
                    kernel_op_s=cc.kernel_op_s)
    rec = roof.to_dict()
    rec.update(ok=True, ops=cc.ops, kernels=cc.kernels,
               build_s=t1 - t0, run_s=t2 - t1)
    return rec


def run_cell(arch: str, cell: str, multi_pod: bool, overrides=None) -> dict:
    cfg = get_config(arch)
    if overrides:
        cfg = dataclasses.replace(
            cfg, train=dataclasses.replace(cfg.train, **overrides))
    shape = MESHES[multi_pod]
    return measure(cfg, cell, shape, arch=arch, desc=mesh_desc(shape))


def parse_overrides(spec: str | None) -> dict | None:
    """``k=v[,k=v...]`` -> TrainSettings overrides (bools, ints, floats,
    else strings)."""
    if not spec:
        return None
    overrides = {}
    for kv in spec.split(","):
        k, v = kv.split("=")
        if v in ("True", "true"):
            v = True
        elif v in ("False", "false"):
            v = False
        else:
            try:
                v = int(v)
            except ValueError:
                try:
                    v = float(v)
                except ValueError:
                    pass
        overrides[k] = v
    return overrides


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None,
                    help="architecture id (default: all)")
    ap.add_argument("--cell", default=None,
                    help="shape cell (default: all for the arch)")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="results/dryrun_torch.json")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--tag", default="baseline")
    ap.add_argument("--overrides", default=None,
                    help="TrainSettings overrides k=v[,k=v...] "
                         "(ints/floats/strs)")
    args = ap.parse_args(argv)
    overrides = parse_overrides(args.overrides)

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    results = {}
    if os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)

    archs = [args.arch] if args.arch else list(ARCH_IDS)
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    t_all = time.perf_counter()
    for arch in archs:
        cells = [args.cell] if args.cell else list(cells_for(arch))
        for cell in cells:
            for mp in meshes:
                key = f"{args.tag}/{arch}/{cell}/{mesh_desc(MESHES[mp])}"
                if key in results and results[key].get("ok") \
                        and not args.force:
                    print(f"[skip] {key}")
                    continue
                print(f"[run ] {key}", flush=True)
                try:
                    rec = run_cell(arch, cell, mp, overrides)
                except Exception as e:
                    rec = {"ok": False, "error": f"{type(e).__name__}: {e}",
                           "traceback": traceback.format_exc()[-4000:]}
                    print(f"[FAIL] {key}: {rec['error']}", flush=True)
                results[key] = rec
                with open(args.out, "w") as f:
                    json.dump(results, f, indent=1)
                if rec.get("ok"):
                    print(f"[ok  ] {key} compute={rec['compute_s']:.4f}s "
                          f"memory={rec['memory_s']:.4f}s "
                          f"collective={rec['collective_s']:.4f}s "
                          f"bound={rec['bound']} resident="
                          f"{rec['memory_per_dev']['total_bytes'] / 1e9:.2f}"
                          f" GB (run {rec['run_s']:.1f}s)", flush=True)

    n_ok = sum(1 for r in results.values() if r.get("ok"))
    print(f"done: {n_ok}/{len(results)} cells ok -> {args.out} "
          f"({time.perf_counter() - t_all:.1f} s)")
    return results


if __name__ == "__main__":
    main()
