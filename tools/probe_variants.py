"""Time the bucketed probe kernels of several kernel-source trees on the
same inputs on one CUDA card.

    python3 tools/probe_variants.py --tree new=src/repro_torch/kernels/csrc \\
        --tree old=build/old_csrc [--edit 'label:OLD=>NEW'] [--rounds 3]

Each ``--tree LABEL=DIR`` is a copy of ``kernels/csrc``; ``--edit
'LABEL:OLD=>NEW'`` makes a variant LABEL of the first tree with the text
OLD replaced by NEW in its sources (it must occur).  Every tree's
``hash_join.cu`` and ``hash_semi.cu`` (where it has one) is compiled with
the port's ``nvcc`` flags and called through its C interface on the
cases below; every variant must give the first one's outputs (a tree
that refuses a case, as an older one with caps may, is reported and left
out of it).  The variants run interleaved (A B ... B A per round), each
call timed with CUDA events over 10 warmed calls; the median over rounds
is printed per case and variant, one JSON line each, beside the card's
name and power limit and the registers ``ptxas`` reports.  Exits
non-zero without a CUDA device.
"""
import argparse
import ctypes
import json
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
KERNELS = {"hash_join": "hash_join_probe", "hash_semi": "hash_semi_member"}


def compile_tree(label, src, edits, out_dir, flags, nvcc):
    """Copy ``src`` (applying ``edits``), build its probe kernels; returns
    {kernel: (CDLL, registers)}."""
    tree = out_dir / label
    shutil.copytree(src, tree)
    for old, new in edits:
        hit = False
        for p in list(tree.glob("*.cu")) + list(tree.glob("*.cuh")):
            text = p.read_text()
            if old in text:
                p.write_text(text.replace(old, new))
                hit = True
        if not hit:
            raise SystemExit(f"{label}: {old!r} not found")
    libs, procs = {}, {}
    for name in KERNELS:
        if (tree / f"{name}.cu").exists():
            so = tree / f"{name}.so"
            procs[name] = (so, subprocess.Popen(
                [nvcc, *flags, "-o", str(so), str(tree / f"{name}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"{label}/{name}.cu failed:\n{log}")
        regs = re.findall(r"Used (\d+) registers", log)
        libs[name] = (ctypes.CDLL(str(so)), [int(r) for r in regs])
    return libs


def join_case(rng, B, Lc, C, fill_lo, fill_hi, per_key=10):
    """Join slabs as the Fig. 4 hash leg fills them: each bucket's probe
    and build slots a prefix of between fill_lo and fill_hi of the slab,
    keys drawn so each occurs about ``per_key`` times in the build."""
    nkeys = max(C // per_key, 1)
    fp = rng.integers(int(fill_lo * Lc), int(fill_hi * Lc) + 1, B)
    fb = rng.integers(int(fill_lo * C), int(fill_hi * C) + 1, B)
    return (rng.integers(0, nkeys, (B, 1, Lc)).astype(np.int32),
            (np.arange(Lc)[None] < fp[:, None]).astype(np.int32),
            rng.integers(0, nkeys, (B, 1, C)).astype(np.int32),
            (np.arange(C)[None] < fb[:, None]).astype(np.int32))


def pooled(rng, B, K, Lc, C):
    """Every slot occupied; keys from 8 K-plane vectors per bucket, the
    build side using 6 of them."""
    pool = rng.integers(-4, 4, (B, K, 8)).astype(np.int32)
    pp = np.repeat(rng.integers(0, 8, (B, 1, Lc)), K, 1)
    bp = np.repeat(rng.integers(0, 6, (B, 1, C)), K, 1)
    return (np.take_along_axis(pool, pp, 2), np.ones((B, Lc), np.int32),
            np.take_along_axis(pool, bp, 2), np.ones((B, C), np.int32))


def semi_case(rng, B, Lc, C, probe_fill, build_fill, hit, K=1):
    """Membership slabs: prefixes of ``probe_fill`` and ``build_fill``
    occupied slots per bucket (Poisson), build keys distinct, a share
    ``hit`` of the probe keys among them; planes past the first are
    functions of the first."""
    fp = np.minimum(rng.poisson(probe_fill, B), Lc)
    fb = np.minimum(rng.poisson(build_fill, B), C)
    bb = (np.arange(C)[None] * 7919 + rng.integers(0, 1 << 20, (B, 1)))
    pick = rng.integers(0, np.maximum(fb, 1)[:, None], (B, Lc))
    pb = np.where(rng.random((B, Lc)) < hit,
                  np.take_along_axis(bb, pick, 1), -1 - pick)
    def planes(x):
        return np.stack([x * (2 * k + 1) + k for k in range(K)], 1)

    return (planes(pb).astype(np.int32),
            (np.arange(Lc)[None] < fp[:, None]).astype(np.int32),
            planes(bb).astype(np.int32),
            (np.arange(C)[None] < fb[:, None]).astype(np.int32))


CASES = {
    # the Fig. 4 hash leg's slab shape (500 k rows a side), filled as the
    # leg (about 60 %) and as chip_smoke.py's case (85-100 %)
    "join B=512 Lc=1632 C=1608 fill 0.55-0.65": (
        "hash_join", lambda r: join_case(r, 512, 1632, 1608, 0.55, 0.65)),
    "join B=512 Lc=1632 C=1608 fill 0.85-1": (
        "hash_join", lambda r: join_case(r, 512, 1632, 1608, 0.85, 1.0)),
    "join B=64 K=33 Lc=64 C=200": (
        "hash_join", lambda r: pooled(r, 64, 33, 64, 200)),
    "join B=4 Lc=64 C=32768": (
        "hash_join", lambda r: pooled(r, 4, 1, 64, 32768)),
    # the UNOMT drug filter's and the set-ops leg's slab shapes and fills
    "semi B=4096 Lc=9768 C=64 (UNOMT drugs)": (
        "hash_semi", lambda r: semi_case(r, 4096, 9768, 64, 2392, 16, 1.0)),
    "semi B=4096 K=2 Lc=9768 C=64": (
        "hash_semi", lambda r: semi_case(r, 4096, 9768, 64, 2392, 16, 1.0,
                                         K=2)),
    "semi B=65536 Lc=612 C=308 (set ops)": (
        "hash_semi", lambda r: semi_case(r, 65536, 612, 308, 153, 76, 0.5)),
    "semi B=16 Lc=256 C=32768": (
        "hash_semi", lambda r: pooled(r, 16, 1, 256, 32768)),
}


def call(lib, kernel, args, device):
    pb, po, bb, bo = args
    B, K, Lc = pb.shape
    C = bb.shape[2]
    stream = torch.cuda.current_stream(device).cuda_stream
    ptrs = [t.data_ptr() for t in args]
    if kernel == "hash_join":
        counts = torch.zeros((B, Lc), dtype=torch.int32, device=device)
        rank = torch.empty((B, Lc, C), dtype=torch.int32, device=device)
        fn = lib.hash_join_probe
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 \
            + [ctypes.c_void_p] * 3
        st = fn(*ptrs, B, K, Lc, C, counts.data_ptr(), rank.data_ptr(),
                stream)
        out = (counts, rank)
    else:
        member = torch.zeros((B, Lc), dtype=torch.int32, device=device)
        fn = lib.hash_semi_member
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 \
            + [ctypes.c_void_p] * 2
        st = fn(*ptrs, B, K, Lc, C, member.data_ptr(), stream)
        out = (member,)
    if st:
        raise RuntimeError(f"{kernel} launch failed: CUDA error {st}")
    return out


def event_ms(fn, reps=10):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", required=True)
    ap.add_argument("--edit", action="append", default=[])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--cases", default="", help="substring of case names")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    flags = list(build.NVCC_FLAGS)
    trees = [t.split("=", 1) for t in a.tree]
    edits = {}
    for e in a.edit:
        label, rest = e.split(":", 1)
        old, new = rest.split("=>", 1)
        edits.setdefault(label, []).append((old, new))
    device = torch.device("cuda")
    work = Path(tempfile.mkdtemp(prefix="probe_variants_"))
    try:
        variants = {}
        for label, src in trees:
            variants[label] = compile_tree(label, Path(src), [], work, flags,
                                           build._nvcc())
        for label, es in edits.items():
            variants[label] = compile_tree(label, Path(trees[0][1]), es,
                                           work, flags, build._nvcc())
        for label, libs in variants.items():
            print(json.dumps({"variant": label, "registers": {
                k: v[1] for k, v in libs.items()}}), flush=True)
        rng = np.random.default_rng(0)
        for case, (kernel, make) in CASES.items():
            if a.cases not in case:
                continue
            args = tuple(torch.from_numpy(np.ascontiguousarray(x))
                         .to(device) for x in make(rng))
            have, first, got = [], None, None
            for v in (v for v in variants if kernel in variants[v]):
                try:
                    got = call(variants[v][kernel][0], kernel, args, device)
                except RuntimeError as e:       # an older tree's caps
                    print(json.dumps({"case": case, "variant": v,
                                      "refused": str(e)}), flush=True)
                    continue
                if first is None:
                    first = got
                elif not all(torch.equal(g, w) for g, w in zip(got, first)):
                    raise SystemExit(f"{case}: {v} differs from {have[0]}")
                have.append(v)
            first = got = None
            times = {v: [] for v in have}
            for _ in range(a.rounds):
                for v in have + have[::-1]:
                    lib = variants[v][kernel][0]
                    times[v].append(event_ms(
                        lambda: call(lib, kernel, args, device)))
            for v in have:
                print(json.dumps({"case": case, "variant": v,
                                  "ms": float(np.median(times[v])),
                                  "ms_all": times[v], "card": card}),
                      flush=True)
            del args
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
