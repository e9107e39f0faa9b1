"""Time ``chip_smoke.py``'s Granite serving leg of several checkouts of
this repo on one CUDA card, interleaved, in one call.

    python3 tools/serving_ab.py --tree new=. --tree old=build/parent \\
        [--rounds 1]

Each ``--tree LABEL=DIR`` is the root of a checkout (its own
``chip_smoke.py`` and ``src/``).  Per round the trees run in the order
A B ... B A, each in a process of its own that builds the leg's kernels
(``flash_attention``, ``hash_partition``) from that checkout's sources
into its ``build/`` and runs its ``chip_smoke.run_serving`` once, with
every check of the leg.  Each run's summary line (tokens/s, TTFT, prefill
and decode-step ms by CUDA events, the profile) is printed as one JSON
line with its label and the card's name and power limit, beside a probe
of the process's host speed taken before the leg and after it (a
pure-Python loop, and the time of one small eager CUDA op), then one
line with each tree's median prefill and decode-step ms.  Exits non-zero
without a CUDA device or when a run fails.
"""
import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

CHILD = """
import json, sys, time, torch
sys.path.insert(0, ".")


def host_probe():
    # the process's own host speed: a pure-Python loop, and the time of
    # one small eager CUDA op (launch-bound)
    t = time.perf_counter()
    sum(i * i for i in range(1_000_000))
    py_ms = (time.perf_counter() - t) * 1e3
    x = torch.ones(64, device="cuda")
    for _ in range(100):
        x = x + 1
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(2000):
        x = x + 1
    torch.cuda.synchronize()
    return {"python_ms": py_ms,
            "op_us": (time.perf_counter() - t) / 2000 * 1e6}


before = host_probe()
import chip_smoke as c
m = c._modules()
m["build"].build(("flash_attention", "hash_partition"))
c.run_serving(m, torch.device("cuda"), m["get_config"](c.SERVE_ARCH))
print(json.dumps({"host_before": before, "host_after": host_probe()}))
"""


def run_leg(root: Path, timeout: int) -> dict:
    """The serving summary of one run of the checkout at ``root``."""
    proc = subprocess.run([sys.executable, "-c", CHILD], cwd=root,
                          capture_output=True, text=True, timeout=timeout)
    if proc.returncode:
        raise SystemExit(f"{root}: serving leg failed "
                         f"({proc.returncode}):\n{proc.stderr[-4000:]}")
    out = {}
    for line in proc.stdout.splitlines():
        if line.startswith("{") and ('"phase": "serving"' in line
                                     or '"host_before"' in line):
            out.update(json.loads(line))
    if "phase" not in out:
        raise SystemExit(f"{root}: no serving summary in its output")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", required=True)
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--timeout", type=int, default=600,
                    help="seconds one run may take")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("serving_ab: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    trees = [(label, Path(d).resolve())
             for label, d in (t.split("=", 1) for t in a.tree)]
    runs = {label: [] for label, _ in trees}
    for _ in range(a.rounds):
        for label, root in trees + trees[::-1]:
            s = run_leg(root, a.timeout)
            runs[label].append(s)
            print(json.dumps({"tree": label, "card": card, **s}), flush=True)
    print(json.dumps({"card": card, "median": {
        label: {k: float(np.median([s[k] for s in rs]))
                for k in ("prefill_ms", "decode_step_ms", "tokens_per_s")}
        for label, rs in runs.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
