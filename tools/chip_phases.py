"""Run some of ``chip_smoke.py``'s mesh and MoE phases alone on one CUDA
card, at depths other than the script's.

    python3 tools/chip_phases.py serving_moe_dp2 moe_train \\
        [--dp-layers 8] [--tp-layers 4] [--moe-train-layers 12]
    python3 tools/chip_phases.py serving_mamba_tp2 [--mamba-tp-layers 8]
    python3 tools/chip_phases.py serving_encdec_tp2
    python3 tools/chip_phases.py pod2
    python3 tools/chip_phases.py serving_jamba
    python3 tools/chip_phases.py dryrun

Each phase is ``chip_smoke.py``'s own function with every check of it:
``serving_moe_dp2`` and ``serving_moe_tp2`` (``run_serving_mesh``: the
rank processes on the card, then their dispatch plans and first flash
inputs held to the plain versions), ``moe_train`` (``run_moe_train``:
the step that writes AdamW's state in place, and one that keeps the old
state, with their peaks) and ``serving_mamba_tp2`` (``mamba_train`` and
``serving_mamba`` at world 1, whose records the world-2 legs are held
to, then ``run_mamba_tp2``: ``serving_mamba_tp2`` and
``mamba_train_tp2`` in two rank processes, and case (j) of
``mamba_scan`` held to the plain scan and timed; ``--mamba-tp-layers``
sets the depth of both serving legs) and ``serving_encdec_tp2``
(``serving_seamless``, ``serving_internvl`` and ``seamless_train`` at
world 1 for their records, with flash cases (i)-(k), then
``run_encdec_tp2``: ``serving_seamless_tp2``, ``serving_internvl_tp2``
and ``seamless_train_tp2`` in two rank processes, then flash cases (n)
and (o) held to ``attention_ref``; cases (i)-(k), (n) and (o) timed
beside SDPA) and ``pod2`` (``run_pod2``: ``serving_moe_dp2``'s world-1
record, then ``serving_moe_pod2`` and ``moe_train_pod2`` in four rank
processes at pod=2 x data=2 x model=1, which the whole script runs in
``serving_moe_dp2``'s and ``moe_train_mesh``'s; flash case (p) and the
stores' shuffle held to the plain versions and timed; ``--dp-layers``
sets the serving leg's depth) and ``serving_jamba``
(``run_serving_jamba``: one period of Jamba-1.5-Large at its published
widths and 8 of its 16 experts served with its twin, then its flash
case (q) and scan case (k) held to the plain versions and timed, the
flash case beside SDPA) and ``dryrun`` (``run_serving`` on
Granite-3.0-2B and ``run_serving_jamba``, whose resident bytes and
prefill time it needs, then ``run_dryrun``: Granite-3.0-2B's dry-run
cells on the 16 x 16 mesh, the predicted resident bytes against both
legs' and the prefill priced with the roofline).  The kernels are built
from this
checkout's sources first.  Prints the card's name and power limit, then
the phases' records as ``chip_smoke.py`` prints them, and the seconds
each phase took.  Exits non-zero without a CUDA device or when a phase fails.

The depths are set when this module is imported: a mesh phase's rank
processes import it again (the ``spawn`` start method) with the same
arguments.
"""
import argparse
import sys
import tempfile
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke as C  # noqa: E402

PHASES = ("serving_moe_dp2", "serving_moe_tp2", "moe_train",
          "serving_mamba_tp2", "serving_encdec_tp2", "pod2",
          "serving_jamba", "dryrun")


def parse_args(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("phases", nargs="+", choices=PHASES)
    ap.add_argument("--dp-layers", type=int, default=C.DP_LAYERS)
    ap.add_argument("--tp-layers", type=int, default=C.TP_LAYERS)
    ap.add_argument("--moe-train-layers", type=int,
                    default=C.MOE_TRAIN_LAYERS)
    ap.add_argument("--mamba-tp-layers", type=int,
                    default=C.SERVE_LAYERS[C.MAMBA_ARCH])
    return ap.parse_args(argv)


ARGS = parse_args(sys.argv[1:])
C.MESH_SERVE = {
    "serving_moe_tp2": (C.MESH_SERVE["serving_moe_tp2"][0], ARGS.tp_layers),
    "serving_moe_dp2": (C.MESH_SERVE["serving_moe_dp2"][0], ARGS.dp_layers)}
C.MOE_TRAIN_LAYERS = ARGS.moe_train_layers
C.SERVE_LAYERS = dict(C.SERVE_LAYERS, **{C.MAMBA_ARCH: ARGS.mamba_tp_layers})


def mamba_tp2(m, device, name, tmp: Path) -> None:
    """The world-1 Mamba legs that record what the world-2 ones are held
    to, the world-2 legs, then case (j) held to the plain scan and
    timed, as ``chip_smoke.py``'s timing phase times it."""
    C.run_mamba_train(m, device, name, tmp)
    C.run_serving_mamba(m, device, C.serve_config(m, C.MAMBA_ARCH),
                        record=tmp / C.MAMBA_WORLD1)
    _, cases = C.run_mamba_tp2(m, device, tmp)
    C.compare_kernels(m, cases, device)
    time_cases(m, name, "mamba_scan", cases["mamba_scan"])


def encdec_tp2(m, device, name, tmp: Path) -> None:
    """The world-1 enc-dec and vision legs that record what the world-2
    ones are held to (with flash cases (i)-(k)), the world-2 legs, then
    cases (n) and (o) held to the plain version; all five timed."""
    cases, errs = {"flash_attention": []}, {"flash_attention": 0.0}
    C.run_encdec_world1(m, device, name, tmp, cases, errs)
    _, tp_cases = C.run_encdec_tp2(m, device, tmp)
    C.compare_kernels(m, tp_cases, device)
    time_cases(m, name, "flash_attention",
               cases["flash_attention"] + tp_cases["flash_attention"])


def time_cases(m, name, kname, cases) -> None:
    """A ``kernel_timing`` record of each case, as ``chip_smoke.py``'s
    timing phase writes one: ms, kernel ms, plain ms, bound and the
    library call's ms."""
    for case in cases:
        args, lib = case["args"], case.get("library")
        C.emit({"phase": "kernel_timing", "name": kname,
                "shape": case["shape"], "card": name,
                "ms": C.event_ms(lambda: C._kernel(m, kname, args)),
                "kernel_ms": C.port_kernel_ms(
                    lambda: C._kernel(m, kname, args))[0],
                "plain_ms": C.event_ms(
                    lambda: C._plain(m, kname, args), reps=3),
                "bound_ms": C.bound(kname, args)[0],
                "library_ms": C.event_ms(lib) if lib else None})


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_phases: no CUDA device; nothing run", file=sys.stderr)
        return 2
    m = C._modules()
    device = torch.device("cuda")
    name = C.card()
    print(name, flush=True)
    m["build"].build()
    with tempfile.TemporaryDirectory(prefix="chip_phases_") as tmp:
        for phase in ARGS.phases:
            t0 = time.perf_counter()
            if phase == "moe_train":
                C.run_moe_train(m, device, name)
            elif phase == "serving_mamba_tp2":
                mamba_tp2(m, device, name, Path(tmp))
            elif phase == "serving_encdec_tp2":
                encdec_tp2(m, device, name, Path(tmp))
            elif phase == "serving_jamba":
                _, cases = C.run_serving_jamba(m, device)
                C.compare_kernels(m, cases, device)
                for kname, more in cases.items():
                    time_cases(m, name, kname, more)
            elif phase == "dryrun":
                legs, _ = C.run_serving(m, device,
                                        C.serve_config(m, C.SERVE_ARCH))
                legs.update(C.run_serving_jamba(m, device)[0])
                C.run_dryrun(m, name, legs)
            elif phase == "pod2":
                _, cases = C.run_pod2(m, device, Path(tmp))
                C.compare_kernels(m, cases, device)
                for kname, more in cases.items():
                    time_cases(m, name, kname, more)
            else:
                _, cases = C.run_serving_mesh(m, device, Path(tmp), phase)
                C.compare_kernels(m, cases, device)
            C.emit({"phase": "chip_phases", "of": phase, "card": name,
                    "seconds": time.perf_counter() - t0})
    return 0


if __name__ == "__main__":
    sys.exit(main())
