"""Hold the Mamba serving path's scan kernel against the plain scan over
several weight seeds and prompt lengths, for several checkouts of this
repo, on one CUDA card.

    python3 tools/mamba_state_error.py --tree new=. --tree old=build/parent \\
        [--seeds 0,1,2] [--prompts 64,471,872,1024]

Each ``--tree LABEL=DIR`` is the root of a checkout (its own
``chip_smoke.py`` and ``src/``).  Each tree runs in a process of its own,
which builds ``mamba_scan`` from that checkout's sources and, per seed,
makes Falcon-Mamba-7B's random weights at full width and depth (as
``chip_smoke.py``'s Mamba leg does, with that seed), then per prompt
length calls that checkout's ``chip_smoke.against_plain_scan`` on a
request of that many random tokens (from the same seed): one slot
prefill with the kernel and one with the plain scan, then 8 decode steps
from each.  Its tolerances are lifted in that process so that every
reading is printed, whatever it is.  One JSON line per reading, with the
tree's label, the seed, the card's name and power limit, the logits'
largest difference and each state's (conv and ssm, after the prefill
and after the steps) largest difference over its largest magnitude; then
one line with each tree's worst state reading beside
``MAMBA_STATE_TOL``.  Exits non-zero without a CUDA device or when a run
fails.
"""
import argparse
import json
import subprocess
import sys

import torch

CHILD = """
import gc, json, sys, types
import numpy as np, torch
sys.path.insert(0, ".")
import chip_smoke as c
seeds, prompts = json.loads(sys.argv[1]), json.loads(sys.argv[2])
m = c._modules()
m["build"].build(("mamba_scan",))
dev = torch.device("cuda")
cfg = m["get_config"](c.MAMBA_ARCH)
tol = c.MAMBA_STATE_TOL
c.SERVE_LOGIT_TOL = c.MAMBA_STATE_TOL = float("inf")
for seed in seeds:
    params = m["M"].init_params(
        torch.Generator(device=dev).manual_seed(seed), cfg)
    rng = np.random.default_rng(seed)
    for n in prompts:
        req = types.SimpleNamespace(
            req_id=1000 * seed + n, out_tokens=[],
            prompt=rng.integers(0, cfg.vocab, n).astype(np.int32))
        out = c.against_plain_scan(m, cfg, params, req, c.SERVE_PROMPT,
                                   c.SERVE_GEN, dev)
        print(json.dumps({"seed": seed, "state_tol": tol, **out}),
              flush=True)
    del params
    gc.collect()
    torch.cuda.empty_cache()
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", required=True)
    ap.add_argument("--seeds", default="0,1,2")
    ap.add_argument("--prompts", default="64,471,872,1024")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("mamba_state_error: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    seeds = [int(s) for s in a.seeds.split(",")]
    prompts = [int(p) for p in a.prompts.split(",")]
    worst = {}
    for label, root in (t.split("=", 1) for t in a.tree):
        proc = subprocess.run(
            [sys.executable, "-c", CHILD, json.dumps(seeds),
             json.dumps(prompts)], cwd=root, capture_output=True, text=True,
            timeout=1800)
        if proc.returncode:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return 1
        for line in proc.stdout.splitlines():
            if not line.startswith("{"):
                continue
            r = json.loads(line)
            state = max(v for k, v in r.items() if k.endswith("_over_max"))
            prev = worst.get(label)
            if prev is None or state > prev["state"]:
                worst[label] = {"state": state, "seed": r["seed"],
                                "prompt": r["prompt"]}
            print(json.dumps({"tree": label, "card": card, **r}),
                  flush=True)
    print(json.dumps({"worst": worst, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
