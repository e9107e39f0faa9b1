"""Time kernels of several kernel-source trees on the same inputs on one
CUDA card: the bucketed probes (``hash_join``, ``hash_semi``), the
counting passes (``hash_partition``, ``fused_bucketing``; for a tree
older than their ``*_ranks`` entry points, the per-tile kernel followed by
the cross-tile stage its wrapper composed), the radix digit pass, flash
attention, the selective scan (``mamba_scan``) and the groupby accumulate
(``hash_groupby``).

    python3 tools/probe_variants.py --tree new=src/repro_torch/kernels/csrc \\
        --tree old=build/old_csrc [--edit 'label:OLD=>NEW'] [--rounds 3] \\
        [--cases SUBSTRING,...] [--profile]

Each ``--tree LABEL=DIR`` is a copy of ``kernels/csrc``; ``--edit
'LABEL:OLD=>NEW'`` makes a variant LABEL of the first tree with the text
OLD replaced by NEW in its sources (it must occur).  Every tree's sources
of the kernels the chosen cases need are compiled with the port's
``nvcc`` flags and called through their C interface on the cases below;
every variant must give the first one's outputs (flash attention within
2e-2, the scan within 2e-4, or 2e-2 on bf16 y, the rest exactly; a tree
that refuses a case, as an older one with caps may, is reported and left
out of it).  The variants run interleaved
(A B ... B A per round), each call timed with CUDA events over 10 warmed
calls (``--unchecked LABEL`` times a variant without the comparison: one
that leaves work out on purpose, to see what that work costs); the
median over rounds is printed per case and variant, one JSON line each,
beside the card's name and power limit and the registers ``ptxas``
reports.  ``--profile`` adds each variant's device time per
call by kernel name, from ``torch.profiler`` over 5 calls.  Exits
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


def compile_tree(label, src, edits, out_dir, flags, nvcc, kernels):
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
    for name in kernels:
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


def semi_case(rng, B, Lc, C, probe_fill, build_fill, hit, K=1, per_key=1):
    """Membership slabs: prefixes of ``probe_fill`` and ``build_fill``
    occupied slots per bucket (Poisson), each build key on about
    ``per_key`` of the build slots, a share ``hit`` of the probe keys
    among them; planes past the first are functions of the first."""
    fp = np.minimum(rng.poisson(probe_fill, B), Lc)
    fb = np.minimum(rng.poisson(build_fill, B), C)
    nkeys = np.maximum(fb // per_key, 1)[:, None]
    bb = (rng.integers(0, nkeys, (B, C)) * 7919
          + rng.integers(0, 1 << 20, (B, 1)))
    pick = rng.integers(0, np.maximum(fb, 1)[:, None], (B, Lc))
    pb = np.where(rng.random((B, Lc)) < hit,
                  np.take_along_axis(bb, pick, 1), -1 - pick)
    def planes(x):
        return np.stack([x * (2 * k + 1) + k for k in range(K)], 1)

    return (planes(pb).astype(np.int32),
            (np.arange(Lc)[None] < fp[:, None]).astype(np.int32),
            planes(bb).astype(np.int32),
            (np.arange(C)[None] < fb[:, None]).astype(np.int32))


def float_semi_case(rng, B, Lc, C):
    """chip_smoke.py's float membership slabs: two float key planes (bits)
    with -0.0, NaN, infinities and subnormals, about 80 % occupied."""
    vals = np.float32([0.0, -0.0, np.nan, np.inf, -np.inf, 1e-40, 1.5,
                       -2.25, 3.0e38])
    return (rng.choice(vals, (B, 2, Lc)).view(np.int32),
            (rng.random((B, Lc)) < 0.8).astype(np.int32),
            rng.choice(vals, (B, 2, C)).view(np.int32),
            (rng.random((B, C)) < 0.8).astype(np.int32))


def flash_case(rng, B, Hq, Hkv, Sq, Skv, D, causal):
    """bf16 q, k, v from a normal distribution, and the causal flag."""
    return tuple(rng.normal(size=s).astype(np.float32)
                 for s in ((B, Hq, Sq, D), (B, Hkv, Skv, D),
                           (B, Hkv, Skv, D))) + (causal,)


def radix_case(rng, n, shift, bits, scatter=True, tile=1024):
    """Random sort words, with a random perm for a scatter pass."""
    words = rng.integers(-2**31, 2**31, n, dtype=np.int64).astype(np.int32)
    if bits == 1:
        words &= 1
    head = (rng.permutation(n).astype(np.int32), words) if scatter \
        else (words,)
    return head + (shift, bits, tile)


def partition_case(rng, n, P):
    """Partition ids uniform over [0, P)."""
    return (rng.integers(0, P, n).astype(np.int32), P)


def bucketing_case(rng, n, P, K=1):
    """K int32 key planes with ~10 rows a key, 80 % of the rows valid."""
    return (rng.integers(0, max(n // 10, 1), (K, n)).astype(np.int32),
            (np.arange(n) < int(n * 0.8)).astype(np.uint8), P)


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
    # the UNOMT drug and cell filters' and the set-ops leg's slab shapes
    # and fills, and chip_smoke.py's slab past shared memory
    "semi B=4096 Lc=9768 C=64 (UNOMT drugs)": (
        "hash_semi", lambda r: semi_case(r, 4096, 9768, 64, 2392, 16, 1.0)),
    "semi B=128 Lc=312500 C=40 (UNOMT cells)": (
        "hash_semi", lambda r: semi_case(r, 128, 312500, 40, 78125, 8, 1.0)),
    "semi B=4096 K=2 Lc=9768 C=64": (
        "hash_semi", lambda r: semi_case(r, 4096, 9768, 64, 2392, 16, 1.0,
                                         K=2)),
    "semi B=65536 Lc=612 C=308 (set ops)": (
        "hash_semi", lambda r: semi_case(r, 65536, 612, 308, 153, 76, 0.5,
                                         per_key=5)),
    "semi B=16 Lc=256 C=32768": (
        "hash_semi", lambda r: pooled(r, 16, 1, 256, 32768)),
    "semi B=512 K=2 Lc=256 C=64 float": (
        "hash_semi", lambda r: float_semi_case(r, 512, 256, 64)),
    # chip_smoke.py's hash_partition (the world-1 shuffle, a 512-bucket
    # ranking) and fused_bucketing (the hash join's 512 buckets) cases
    "partition n=10M P=2": (
        "hash_partition", lambda r: partition_case(r, 10_000_000, 2)),
    "partition n=625k P=513": (
        "hash_partition", lambda r: partition_case(r, 625_000, 513)),
    "bucketing n=625k K=1 P=512": (
        "fused_bucketing", lambda r: bucketing_case(r, 625_000, 512)),
    # chip_smoke.py's cases past those: several tiles a block, P = 9
    "partition n=3M P=9": (
        "hash_partition", lambda r: partition_case(r, 3_000_005, 9)),
    "bucketing n=3M K=3 P=9": (
        "fused_bucketing", lambda r: bucketing_case(r, 3_000_005, 9, K=3)),
    # the shapes of chip_smoke.py's flash and radix cases
    "flash (a) B=1 Hq=32 Hkv=8 S=1024 D=64 causal": (
        "flash_attention", lambda r: flash_case(r, 1, 32, 8, 1024, 1024, 64,
                                                True)),
    "flash (g) B=4 Hq=32 Hkv=8 S=1024 D=64 causal": (
        "flash_attention", lambda r: flash_case(r, 4, 32, 8, 1024, 1024, 64,
                                                True)),
    "flash (f) B=1 Hq=16 Hkv=16 S=1024 D=128 causal": (
        "flash_attention", lambda r: flash_case(r, 1, 16, 16, 1024, 1024,
                                                128, True)),
    "flash (d) B=1 Hq=32 Hkv=8 S=1024 D=64 full": (
        "flash_attention", lambda r: flash_case(r, 1, 32, 8, 1024, 1024, 64,
                                                False)),
    "radix scatter n=20M bits=8": (
        "radix_sort", lambda r: radix_case(r, 20_000_000, 0, 8)),
    "radix scatter n=20M bits=8 tile=2048": (
        "radix_sort", lambda r: radix_case(r, 20_000_000, 0, 8, tile=2048)),
    "radix ranks n=20M bits=8": (
        "radix_sort", lambda r: radix_case(r, 20_000_000, 0, 8, False)),
    "radix scatter n=20M bits=1": (
        "radix_sort", lambda r: radix_case(r, 20_000_000, 0, 1)),
    "radix scatter n=625k bits=11": (
        "radix_sort", lambda r: radix_case(r, 625_000, 11, 11)),
    # chip_smoke.py's scan case (a) (the Falcon-Mamba-7B prefill's first
    # layer at 952 tokens) and (e) (batch 4)
    "scan (a) B=1 S=952 E=8192 N=16 bf16 hT": (
        "mamba_scan", lambda r: scan_case(r, 1, 952, 8192, 16, True, True)),
    "scan (e) B=4 S=1024 E=8192 N=16 hT": (
        "mamba_scan", lambda r: scan_case(r, 4, 1024, 8192, 16, False,
                                          True)),
    # the groupby leg's slabs (10 M rows over 65536 buckets of 440 slots)
    "groupby B=65536 C=440 K=1 V=1 (leg slabs)": (
        "hash_groupby", lambda r: groupby_case(r, 65536, 440, 153)),
    "groupby B=65536 C=440 K=1 V=1 holes": (
        "hash_groupby", lambda r: groupby_case(r, 65536, 440, 153, True)),
    # slabs whose workspace is past a block's shared memory, a third full
    "groupby B=512 C=7000 K=2 V=5 (past shared memory)": (
        "hash_groupby", lambda r: groupby_case(r, 512, 7000, 2333, K=2,
                                               V=5)),
}


def scan_case(rng, B, S, E, N, bf16, state):
    """Selective-scan inputs as chip_smoke.py's random cases draw them,
    x bf16 or float32, and whether the final state is asked for."""
    x = rng.normal(size=(B, S, E)).astype(np.float32)
    delta = np.log1p(np.exp(rng.normal(size=(B, S, E)))).astype(np.float32)
    A = -np.exp(rng.normal(size=(E, N)) * 0.5).astype(np.float32)
    Bm, Cm = (rng.normal(size=(B, S, N)).astype(np.float32)
              for _ in range(2))
    D = rng.normal(size=E).astype(np.float32)
    xt = torch.from_numpy(x)
    return (xt.to(torch.bfloat16) if bf16 else xt, delta, A, Bm, Cm, D,
            state)


def groupby_case(rng, B, C, fill, holes=False, K=1, V=1):
    """Groupby slabs filled as the groupby leg's: about ``fill`` occupied
    slots a bucket (Poisson) with about 10 rows a key (K key planes, those
    past the first functions of it), V integer-valued value columns; the
    occupied slots a prefix, or (``holes``) scattered over the slab."""
    n = np.minimum(rng.poisson(fill, B), C)
    keys = rng.integers(0, np.maximum(n // 10, 1)[:, None, None], (B, 1, C))
    keys = np.concatenate([keys * (2 * k + 1) + k for k in range(K)], 1)
    if holes:
        occ = rng.random((B, C)) < (n / C)[:, None]
    else:
        occ = np.arange(C)[None] < n[:, None]
    return (keys.astype(np.int32), occ.astype(np.int32),
            rng.integers(-100, 100, (B, V, C)).astype(np.float32))


def to_device(case, device, kernel):
    """Arrays to the card (flash inputs as bf16), the rest as is."""
    out = []
    for x in case:
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(np.ascontiguousarray(x))
            if kernel == "flash_attention":
                x = x.to(torch.bfloat16)
        out.append(x.to(device) if isinstance(x, torch.Tensor) else x)
    return tuple(out)


def same(kernel, got, want):
    if kernel in ("flash_attention", "mamba_scan"):
        def tol(g):
            return 2e-2 if kernel == "flash_attention" \
                or g.dtype == torch.bfloat16 else 2e-4
        return all(torch.allclose(g.float(), w.float(), atol=tol(g),
                                  rtol=tol(g)) for g, w in zip(got, want))
    if kernel == "hash_groupby":
        return all(torch.equal(g.nan_to_num(), w.nan_to_num())
                   for g, w in zip(got, want))
    return all(torch.equal(g, w) for g, w in zip(got, want))


def call(lib, kernel, args, device):
    stream = torch.cuda.current_stream(device).cuda_stream
    if kernel == "flash_attention":
        q, k, v, causal = args
        B, Hq, Sq, D = q.shape
        o = torch.empty_like(q)
        fn = lib.flash_attention_fwd
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 \
            + [ctypes.c_float, ctypes.c_void_p]
        st = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B,
                Hq, k.shape[1], Sq, k.shape[2], D, int(causal), D ** -0.5,
                stream)
        if st:
            raise RuntimeError(f"{kernel} launch failed: CUDA error {st}")
        return (o,)
    if kernel == "mamba_scan":
        x, delta, A, Bm, Cm, D, state = args
        Bsz, S, E = x.shape
        N = A.shape[1]
        y = torch.empty_like(x)
        hT = torch.empty((Bsz, E, N), device=device) if state else None
        fn = lib.mamba_scan_fwd
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 \
            + [ctypes.c_void_p]
        st = fn(*(t.data_ptr() for t in args[:6]), y.data_ptr(),
                hT.data_ptr() if state else None, Bsz, S, E, N,
                int(x.dtype == torch.bfloat16), stream)
        if st:
            raise RuntimeError(f"{kernel} launch failed: CUDA error {st}")
        return (y, hT) if state else (y,)
    if kernel == "hash_groupby":
        kb, occ, vals = args
        B, K, C = kb.shape
        V = vals.shape[1]
        rep, counts = (torch.empty((B, C), dtype=torch.int32, device=device)
                       for _ in range(2))
        sums, mins, maxs = torch.empty((3, B, V, C), device=device)
        fn = lib.hash_groupby_accumulate
        # a tree with hash_groupby_workspace_bytes takes the workspace of a
        # slab past shared memory from its caller; an older one allocates it
        ws = ()
        if hasattr(lib, "hash_groupby_workspace_bytes"):
            size = lib.hash_groupby_workspace_bytes
            size.argtypes = [ctypes.c_int] * 4
            size.restype = ctypes.c_longlong
            nbytes = size(B, K, V, C)
            buf = torch.empty(nbytes // 4, dtype=torch.int32,
                              device=device) if nbytes else None
            ws = (buf.data_ptr() if nbytes else None,)
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 \
            + [ctypes.c_void_p] * (6 + len(ws))
        st = fn(kb.data_ptr(), occ.data_ptr(), vals.data_ptr(), B, K, V, C,
                *ws, rep.data_ptr(), counts.data_ptr(), sums.data_ptr(),
                mins.data_ptr(), maxs.data_ptr(), stream)
        if st:
            raise RuntimeError(f"{kernel} launch failed: CUDA error {st}")
        return rep, counts, sums, mins, maxs
    if kernel == "radix_sort":
        perm, words = args[:2] if len(args) == 5 else (None, args[0])
        shift, bits, tile = args[-3:]
        n = words.shape[0]
        # (an older tree's radix_sort_blocks(n, tile) ignores the rest)
        lib.radix_sort_blocks.argtypes = [ctypes.c_longlong] \
            + [ctypes.c_int] * 3
        lib.radix_sort_blocks.restype = ctypes.c_longlong
        hist = torch.empty((lib.radix_sort_blocks(
            n, tile, bits, int(perm is not None)), 1 << bits),
            dtype=torch.int32, device=device)
        total = torch.empty(1 << bits, dtype=torch.int32, device=device)
        outs = [torch.empty_like(words) for _ in range(2 if perm is not None
                                                       else 1)]
        fn = lib.radix_sort_pass
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong] \
            + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 6
        ptr = [t.data_ptr() for t in outs]
        st = fn(words.data_ptr(), perm.data_ptr() if perm is not None
                else None, n, shift, bits, tile, hist.data_ptr(),
                total.data_ptr(), *((ptr[1], ptr[0], None) if perm is not None
                                    else (None, None, ptr[0])), stream)
        if st:
            raise RuntimeError(f"{kernel} launch failed: CUDA error {st}")
        return (total, *outs)
    if kernel in ("hash_partition", "fused_bucketing"):
        ids, P = args[0], args[-1]
        n = ids.shape[-1]
        tile = getattr(lib, f"{kernel}_tile_rows")()
        tiles = -(-n // tile)
        rank = torch.empty(n, dtype=torch.int32, device=device)
        whole = hasattr(lib, f"{kernel}_ranks")
        if not whole:
            # an older tree: per-tile outputs, the cross-tile stage composed
            # here as its wrapper did
            from repro_torch.kernels.hash_partition.ref import \
                add_tile_offsets
        if kernel == "hash_partition" and whole:
            scratch = torch.empty(tiles * P, dtype=torch.int32, device=device)
            hist = torch.empty(P, dtype=torch.int32, device=device)
            fn = lib.hash_partition_ranks
            fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int] \
                + [ctypes.c_void_p] * 4
            st = fn(ids.data_ptr(), n, P, scratch.data_ptr(), hist.data_ptr(),
                    rank.data_ptr(), stream)
            out = (hist, rank)
        elif kernel == "hash_partition":
            hist = torch.empty((tiles, P), dtype=torch.int32, device=device)
            fn = lib.hash_partition_tiles
            fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int] \
                + [ctypes.c_void_p] * 3
            st = fn(ids.data_ptr(), n, P, hist.data_ptr(), rank.data_ptr(),
                    stream)
            out = add_tile_offsets(hist, rank, ids, P, tile)
        elif whole:
            K = ids.shape[0]
            bid = torch.empty(n, dtype=torch.int32, device=device)
            scratch = torch.empty(tiles * (P + 1), dtype=torch.int32,
                                  device=device)
            hist = torch.empty(P + 1, dtype=torch.int32, device=device)
            fn = lib.fused_bucketing_ranks
            fn.argtypes = [ctypes.c_void_p] * 3 + [
                ctypes.c_longlong, ctypes.c_int, ctypes.c_int] \
                + [ctypes.c_void_p] * 5
            planes = (ctypes.c_void_p * K)(*(ids[k].data_ptr()
                                             for k in range(K)))
            st = fn(planes, None, args[1].data_ptr(), n, K, P,
                    scratch.data_ptr(), bid.data_ptr(), hist.data_ptr(),
                    rank.data_ptr(), stream)
            out = (bid, hist, rank)
        else:
            bid = torch.empty(n, dtype=torch.int32, device=device)
            hist = torch.empty((tiles, P + 1), dtype=torch.int32,
                               device=device)
            fn = lib.fused_bucketing_tiles
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_longlong, ctypes.c_int, ctypes.c_int] \
                + [ctypes.c_void_p] * 4
            st = fn(ids.data_ptr(), args[1].data_ptr(), n, ids.shape[0], P,
                    bid.data_ptr(), hist.data_ptr(), rank.data_ptr(), stream)
            out = (bid, *add_tile_offsets(hist, rank, bid, P + 1, tile))
        if st:
            raise RuntimeError(f"{kernel} launch failed: CUDA error {st}")
        return out
    pb, po, bb, bo = args
    B, K, Lc = pb.shape
    C = bb.shape[2]
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
    elif hasattr(lib, "hash_semi_workspace_bytes"):
        # the hash-table kernel: every slot written, a workspace for tables
        # past shared memory
        member = torch.empty((B, Lc), dtype=torch.int32, device=device)
        size = lib.hash_semi_workspace_bytes
        size.argtypes = [ctypes.c_int] * 2
        size.restype = ctypes.c_longlong
        nbytes = size(B, C)
        ws = torch.empty(nbytes // 8, dtype=torch.int64, device=device) \
            if nbytes else None
        fn = lib.hash_semi_member
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 \
            + [ctypes.c_void_p] * 3
        st = fn(*ptrs, B, K, Lc, C, ws.data_ptr() if nbytes else None,
                member.data_ptr(), stream)
        out = (member,)
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


def device_ms(fn, reps=5):
    """Device milliseconds per call of each kernel ``fn`` launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key[:60]: e.self_device_time_total / 1e3 / reps
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", required=True)
    ap.add_argument("--edit", action="append", default=[])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--cases", default="",
                    help="comma-separated substrings of case names")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--unchecked", action="append", default=[],
                    help="a variant that is timed but not held to the "
                         "first one's outputs (a deliberately partial one)")
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
    chosen = {c: v for c, v in CASES.items()
              if any(part in c for part in a.cases.split(","))}
    kernels = sorted({kernel for kernel, _ in chosen.values()})
    work = Path(tempfile.mkdtemp(prefix="probe_variants_"))
    try:
        variants = {}
        for label, src in trees:
            variants[label] = compile_tree(label, Path(src), [], work, flags,
                                           build._nvcc(), kernels)
        for label, es in edits.items():
            variants[label] = compile_tree(label, Path(trees[0][1]), es,
                                           work, flags, build._nvcc(),
                                           kernels)
        for label, libs in variants.items():
            print(json.dumps({"variant": label, "registers": {
                k: v[1] for k, v in libs.items()}}), flush=True)
        rng = np.random.default_rng(0)
        for case, (kernel, make) in chosen.items():
            args = to_device(make(rng), device, kernel)
            have, first, got = [], None, None
            for v in (v for v in variants if kernel in variants[v]):
                try:
                    got = call(variants[v][kernel][0], kernel, args, device)
                except RuntimeError as e:       # an older tree's caps
                    print(json.dumps({"case": case, "variant": v,
                                      "refused": str(e)}), flush=True)
                    continue
                if v in a.unchecked:
                    pass
                elif first is None:
                    first = got
                elif not same(kernel, got, first):
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
                lib = variants[v][kernel][0]
                prof = device_ms(lambda: call(lib, kernel, args, device)) \
                    if a.profile else None
                print(json.dumps({"case": case, "variant": v,
                                  "ms": float(np.median(times[v])),
                                  "ms_all": times[v], "card": card,
                                  "device_ms": prof}), flush=True)
            del args
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
