"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. build the eight CUDA kernels from ``src/repro_torch/kernels/csrc``;
2. hold each kernel against its plain PyTorch version at the main path's
   shapes: the integer outputs exactly (the radix pass as the scatter of
   perm and words, three CUDA launches, and as ranks); the groupby
   accumulate's sums within 1e-6 of the group's sum of magnitudes and its
   mins and maxs as values (NaN == NaN, -0.0 == +0.0); the join probe past
   32 key planes and past a block's shared memory;
3. the paper's Fig. 4 join with the sortmerge backend, 10 M rows per
   side at world 1, checked against the keys and a float64 sum;
4. the same join with the hash backend at 500 k rows per side, which
   must be bit-identical to a sortmerge run on the same data;
5. Table 5 GroupBy + Aggregate, 10 M rows over 1 M keys: ``dist_groupby``
   with the hash backend (65536 buckets) equal to numpy and bit-identical
   to the sort backend;
6. Unique: ``dist_unique`` hash == sort on the same table;
7. OrderBy: ``dist_sort`` over (k, v), 10 M rows, radix == xla == a
   numpy stable sort;
8. the broadcast join, 1 M x 100 k rows, bit-identical to the shuffle
   join;
9. the UNOMT data-engineering pipeline (paper Figs. 8-11), 10 M response
   rows, 65536 drugs, 1024 cells: ``unomt_dist_pipeline`` with the
   sortmerge and the hash membership backends, bit-identical to each
   other, equal to an independent numpy pipeline and dropping nothing;
   the hash run launches ``hash_semi`` twice (the drug and cell filters);
   then ``feature_label_arrays``;
10. the set operators, 10 M x 5 M rows: ``dist_isin``,
   ``dist_intersect`` and ``dist_difference`` under both membership
   backends, equal to each other and to numpy; then the slabs the
   UNOMT and set-op hash runs gave ``hash_semi`` (all five of its
   launches) are held against the plain version, with float planes and
   a slab past a block's shared memory;
11. the LM serving path: Granite-3.0-2B at its published widths and
   depth, random weights from ``torch.Generator`` seed 0, served by
   ``ServingEngine`` (8 slots, prompts up to 1024 tokens, up to 64
   generated) with both UNOMT feature stores; 32 requests; the flash
   kernel runs in every layer of every prefill.  Checked: the accounting
   identity, tokens and features of every request, nothing dropped, exact
   launch counts, two requests against the one-shot prefill/decode loop
   (fed the engine's tokens) and every request against the same engine
   on the plain ``xla`` attention path, within ``SERVE_LOGIT_TOL``; then
   ``flash_attention`` against ``attention_ref`` on the q, k, v one
   prefill gave it and on six more shapes; tokens/s, TTFT, prefill and
   decode-step times and a profile of one prefill and 8 decode steps;
11b. the Mamba serving path: Falcon-Mamba-7B at its published widths and
   depth (64 layers), random weights from ``torch.Generator`` seed 0,
   the same engine settings and request stream as phase 11 (the Granite
   weights freed first); every prefill runs at the prompt's true length
   and the selective-scan kernel in every layer.  Checked: the
   accounting identity, tokens and features of every request, nothing
   dropped, exact launch counts (``mamba_scan`` 64 per prefill, no
   ``flash_attention``), two requests against the one-shot loop (fed the
   engine's tokens) within ``SERVE_LOGIT_TOL``, and the same two
   requests on the plain scan: prefill logits, conv and ssm states and 8
   decode steps from each state; then ``mamba_scan`` against
   ``selective_scan_ref`` within ``SCAN_TOL`` on the inputs of the
   longest prefill's first layer and on six more shapes; tokens/s, TTFT,
   prefill and decode-step times and a profile;
12. timings: each leg's median of 3 warmed runs and peak memory, a
   profile, and each kernel's CUDA-event time per call and the summed
   profiler device time of the port's kernels that call launches (two or
   three for ``hash_partition``, ``fused_bucketing`` and the radix pass),
   beside its plain version, its bound and, where there is one, a
   library call (a stable
   ``argsort`` of the ids beside ``hash_partition``, ``fused_bucketing``
   and the radix scatter pass; ``torch.isin`` of the occupied keys beside
   each ``hash_semi`` slab of a leg; SDPA beside ``flash_attention``).

The launch counters are set to 0 just before each leg's first run and
read just after it; the Table 5, UNOMT and set-ops legs must launch
exactly the kernels their path runs, as often as it runs them.  The line before the last is the kernel table; the last line
is ``{"ok": true, "device": {...}}``.  Exits non-zero without a result
when there is no CUDA device.
"""
import collections
import contextlib
import gc
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SORTMERGE_ROWS = 10_000_000
HASH_ROWS = 500_000
GROUPBY_ROWS = 10_000_000      # Table 5 groupby/unique leg
GROUPBY_KEYS = 1_000_000       # 10 % key uniqueness, as Fig. 4
GROUPBY_BUCKETS = 65536
SORT_ROWS = 10_000_000         # Table 5 OrderBy leg
BCAST_ROWS = (1_000_000, 100_000)
UNOMT_ROWS = 10_000_000        # response rows of the UNOMT leg
UNOMT_DRUGS = 65_536
UNOMT_CELLS = 1_024
SETOP_ROWS = (10_000_000, 5_000_000)   # set-ops leg: a and b
SETOP_KEYS = 1_000_000         # a.k over [0, 1 M), b.k over [500 k, 1.5 M)
SERVE_ARCH = "granite-3-2b"    # the serving leg's model, full width and depth
MAMBA_ARCH = "falcon-mamba-7b"  # the Mamba serving leg's, full width and depth
SERVE_SLOTS, SERVE_PROMPT, SERVE_GEN = 8, 1024, 64
SERVE_QUEUE, SERVE_REQUESTS = 64, 32
AGGS = {"v": ["sum", "count", "mean", "min", "max"]}
BYTES_PER_S = 3.35e12          # H100 SXM device memory rate
OPS_PER_S = 67e12              # H100 SXM float32 rate outside tensor cores
BF16_OPS_PER_S = 989e12        # H100 SXM dense bf16 tensor-core rate
# special-function (exp2) results: 16 per SM per clock, 132 SMs, 1.98 GHz
EXP_PER_S = 16 * 132 * 1.98e9
KERNELS = ("hash_partition", "fused_bucketing", "hash_join", "radix_sort",
           "hash_groupby", "hash_semi", "flash_attention", "mamba_scan")
JOIN_KERNELS = KERNELS[:3]
# the __global__ functions of csrc/*.cu, as the profiler names them
# (the counting pass of tile_scan.cuh: count_upsweep, count_scan and
# rank_downsweep, under hash_partition, fused_bucketing and radix_sort;
# hash_semi_table builds hash_semi's tables past shared memory)
PORT_KERNEL_FNS = ("count_upsweep", "count_scan", "rank_downsweep",
                   "radix_downsweep", "hash_join", "hash_groupby",
                   "hash_semi", "hash_semi_table",
                   "flash_attention", "mamba_scan")


def _modules():
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.core import dist_ops
    from repro_torch.core import local_ops
    from repro_torch.core.context import make_context
    from repro_torch.data import unomt
    from repro_torch.kernels import bucketing, build
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.launch import serve
    from repro_torch.models import attention as attn
    from repro_torch.models import layers
    from repro_torch.models import model
    from repro_torch.serving import ServingEngine
    from repro_torch.kernels.fused_bucketing import ops as fb_ops
    from repro_torch.kernels.fused_bucketing import ref as fb_ref
    from repro_torch.kernels.hash_groupby import ops as hg_ops
    from repro_torch.kernels.hash_groupby import ref as hg_ref
    from repro_torch.kernels.hash_join import ops as hj_ops
    from repro_torch.kernels.hash_join import ref as hj_ref
    from repro_torch.kernels.hash_partition import ops as hp_ops
    from repro_torch.kernels.hash_partition import ref as hp_ref
    from repro_torch.kernels.hash_semi import ops as hs_ops
    from repro_torch.kernels.hash_semi import ref as hs_ref
    from repro_torch.kernels.mamba_scan import ops as ms_ops
    from repro_torch.kernels.mamba_scan import ref as ms_ref
    from repro_torch.models import mamba
    from repro_torch.kernels.radix_sort import ops as rs_ops
    from repro_torch.kernels.radix_sort import ref as rs_ref
    return dict(D=dist_ops, L=local_ops, U=unomt, make_context=make_context,
                build=build, bucketing=bucketing,
                ops={"hash_partition": hp_ops, "fused_bucketing": fb_ops,
                     "hash_join": hj_ops, "radix_sort": rs_ops,
                     "hash_groupby": hg_ops, "hash_semi": hs_ops,
                     "flash_attention": fa_ops, "mamba_scan": ms_ops},
                hp_ref=hp_ref, fb_ref=fb_ref, hj_ref=hj_ref, rs_ref=rs_ref,
                hg_ref=hg_ref, hs_ref=hs_ref, fa_ref=fa_ref, ms_ref=ms_ref,
                get_config=get_config, M=model, A=attn, Ly=layers, Mb=mamba,
                serve=serve, ServingEngine=ServingEngine)


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _allocated(device) -> int:
    return torch.cuda.memory_allocated(device) \
        if torch.device(device).type == "cuda" else 0


# --------------------------------------------------------------------------
# kernel inputs at the main path's shapes
# --------------------------------------------------------------------------


def kernel_cases(m, device, hash_plan, groupby_sizes, groupby_loads,
                 scale=1.0, seed=1):
    """The inputs each kernel gets on the legs: hash_partition at P = 2
    (the world-1 shuffle's live + trash partitions) on 10 M rows, at
    P = 513 (a 512-bucket ranking) on 625 k rows, and past those: 10 M
    rows at P = 2 with every 7th id -1 (blocks of 4 tiles, the last
    ragged), and P = 9 on 3 M + 5 rows (a ragged tile); fused_bucketing
    at 512 buckets on 625 k rows with one int plane and with two float
    planes (-0.0 and NaN included), and with three int planes at P = 9 on
    3 M + 5 rows (the plain versions' (P, n) one-hots stay under 1 GB);
    hash_join on the 500 k leg's slab shapes;
    radix_sort's digit pass on 20 M rows (the groupby and sort legs'
    shuffled capacity), as the scatter of a random perm with the words and
    as within-digit ranks, at 8 bits, shifts 0 and 24, and its 1-bit
    pass, at 11 bits on 625 k rows, and the scatter on one ragged 64-row
    tile; hash_groupby on slabs shaped and filled as the groupby leg's
    (``groupby_loads`` rows in each bucket), with NaN and -0.0 among the
    values: once integer-valued, as the leg's, once normal-distributed,
    where the sums may round, and once with the occupied slots scattered
    over each slab, one bucket all one key and one bucket empty;
    hash_join also at K = 33 key planes and at a slab wider than a
    block's shared memory.
    hash_semi's cases come from the UNOMT leg (:func:`semi_cases`)."""
    rng = np.random.default_rng(seed)
    n_big = max(int(SORTMERGE_ROWS * scale), 1)
    n_slab = hash_plan["shuffle_sizes"]["left"][1]
    sizes = hash_plan["local_join_sizes"]
    B, C, Lc = (sizes["num_buckets"], sizes["bucket_capacity"],
                sizes["probe_capacity"])

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    cases = {}
    cases["hash_partition"] = [
        dict(shape=f"n={n_big} P=2", args=(
            dev(rng.integers(0, 2, n_big).astype(np.int32)), 2)),
        dict(shape=f"n={n_slab} P=513", args=(
            dev(rng.integers(0, 513, n_slab).astype(np.int32)), 513))]
    valid = dev(np.arange(n_slab) < int(n_slab * 0.8))
    floats = rng.normal(size=(2, n_slab)).astype(np.float32)
    floats[:, ::7] = -0.0
    floats[:, ::11] = np.nan
    cases["fused_bucketing"] = [
        dict(shape=f"n={n_slab} K=1 P={B} int", args=(
            (dev(rng.integers(0, n_slab // 10, n_slab).astype(np.int32)),),
            valid, B)),
        dict(shape=f"n={n_slab} K=2 P={B} float", args=(
            tuple(dev(f.view(np.int32)) for f in floats), valid, B))]
    # several tiles a block, ragged ends, uncounted ids, three planes: from
    # their own generator so the later cases draw what they drew before
    xrng = np.random.default_rng(seed + 200)
    n_mid = max(int(3_000_005 * scale), 1)
    skipped = xrng.integers(0, 2, n_big).astype(np.int32)
    skipped[::7] = -1
    cases["hash_partition"] += [
        dict(shape=f"n={n_big} P=2 every 7th id -1", args=(dev(skipped), 2)),
        dict(shape=f"n={n_mid} P=9", args=(
            dev(xrng.integers(0, 9, n_mid).astype(np.int32)), 9))]
    cases["fused_bucketing"].append(dict(
        shape=f"n={n_mid} K=3 P=9 int", args=(
            tuple(dev(xrng.integers(-2**31, 2**31, n_mid, dtype=np.int64)
                      .astype(np.int32)) for _ in range(3)),
            dev(xrng.random(n_mid) < 0.8), 9)))
    # each bucket holds ~1/B of the rows with ~10 rows per key, as on the
    # 500 k-row leg; the rest of each slab is empty
    fill_p = rng.integers(int(0.85 * Lc), Lc + 1, B)
    fill_b = rng.integers(int(0.85 * C), C + 1, B)
    nkeys = max(C // 10, 1)
    cases["hash_join"] = [dict(shape=f"B={B} K=1 Lc={Lc} C={C}", args=(
        dev(rng.integers(0, nkeys, (B, 1, Lc)).astype(np.int32)),
        dev((np.arange(Lc)[None, :] < fill_p[:, None]).astype(np.int32)),
        dev(rng.integers(0, nkeys, (B, 1, C)).astype(np.int32)),
        dev((np.arange(C)[None, :] < fill_b[:, None]).astype(np.int32))))]
    # past 32 key planes, and a build slab of (1 + 1) * 32768 * 4 B, more
    # than the 227 KB a block may hold
    wide = dict(K33=(64, 33, 64, 200), C32768=(4, 1, 64, 32768))
    for name, shape in wide.items():
        cases["hash_join"].append(dict(
            shape=f"B={shape[0]} K={shape[1]} Lc={shape[2]} C={shape[3]}",
            args=tuple(dev(a) for a in pooled_slabs(rng, *shape))))

    n_sort = max(int(2 * GROUPBY_ROWS * scale), 1)
    words = dev(rng.integers(-2**31, 2**31, n_sort, dtype=np.int64)
                .astype(np.int32))
    flags = dev(rng.integers(0, 2, n_sort).astype(np.int32))
    words11 = dev(rng.integers(-2**31, 2**31, n_slab, dtype=np.int64)
                  .astype(np.int32))
    # the permutations a pass carries, from their own generator so the
    # later cases draw what they drew before
    prng = np.random.default_rng(seed + 100)
    n64 = min(64, n_sort)
    perm, perm11, perm64 = (dev(prng.permutation(n).astype(np.int32))
                            for n in (n_sort, n_slab, n64))
    # a scatter pass takes (perm, words, shift, bits, tile), the ranking
    # (words, shift, bits, tile)
    cases["radix_sort"] = [
        dict(shape=f"scatter n={n_sort} bits=8 shift=0",
             args=(perm, words, 0, 8, 1024)),
        dict(shape=f"ranks n={n_sort} bits=8 shift=0",
             args=(words, 0, 8, 1024)),
        dict(shape=f"scatter n={n_sort} bits=8 shift=24",
             args=(perm, words, 24, 8, 1024)),
        dict(shape=f"scatter n={n_sort} bits=1", args=(perm, flags, 0, 1,
                                                       1024)),
        dict(shape=f"scatter n={n_slab} bits=11 shift=11",
             args=(perm11, words11, 11, 11, 1024)),
        dict(shape=f"ranks n={n_sort} bits=8 shift=24",
             args=(words, 24, 8, 1024)),
        dict(shape=f"ranks n={n_sort} bits=1", args=(flags, 0, 1, 1024)),
        dict(shape=f"ranks n={n_slab} bits=11 shift=11",
             args=(words11, 11, 11, 1024)),
        dict(shape=f"scatter n={n64} bits=8 shift=8", args=(
            perm64, words[:n64].clone(), 8, 8, 1024))]

    # each bucket holds as many rows as the leg's keys put in it, ~10 rows
    # per key
    B, C = groupby_sizes["num_buckets"], groupby_sizes["bucket_capacity"]
    B = max(int(B * scale), 1)
    fill = groupby_loads[:B]
    vals = rng.integers(-100, 100, (B, 1, C)).astype(np.float32)
    vals[rng.random(vals.shape) < 0.01] = -0.0
    vals[rng.random(vals.shape) < 0.001] = np.nan
    keys = rng.integers(0, np.maximum(fill // 10, 1)[:, None, None],
                        (B, 1, C))
    normal = rng.normal(size=(B, 1, C)).astype(np.float32)
    normal[vals == 0] = -0.0
    normal[np.isnan(vals)] = np.nan
    kb = dev(keys.astype(np.int32))
    occ = dev((np.arange(C)[None, :] < fill[:, None]).astype(np.int32))
    # the leg's fills with holes in the occupancy (not a prefix), one
    # bucket whose every slot holds one key and one empty bucket, from
    # their own generator so the cases above draw what they drew before
    hrng = np.random.default_rng(seed + 300)
    hocc = (hrng.random((B, C)) < (fill / C)[:, None]).astype(np.int32)
    hkeys = keys.astype(np.int32)
    hocc[0], hkeys[0] = 1, 7
    if B > 1:
        hocc[1] = 0
    cases["hash_groupby"] = [
        dict(shape=f"B={B} K=1 V=1 C={C} integer", args=(kb, occ, dev(vals))),
        dict(shape=f"B={B} K=1 V=1 C={C} normal", args=(kb, occ,
                                                        dev(normal))),
        dict(shape=f"B={B} K=1 V=1 C={C} integer, holes, a one-key and an "
                   "empty bucket", args=(dev(hkeys), dev(hocc), dev(vals)))]
    return cases


def pooled_slabs(rng, B, K, Lc, C):
    """Probe and build slabs, every slot occupied, whose keys come from a
    pool of 8 K-plane vectors per bucket (the build side uses the first
    6, so some probes miss)."""
    pool = rng.integers(-4, 4, (B, K, 8)).astype(np.int32)
    pp = np.repeat(rng.integers(0, 8, (B, 1, Lc)), K, 1)
    bp = np.repeat(rng.integers(0, 6, (B, 1, C)), K, 1)
    return (np.take_along_axis(pool, pp, 2), np.ones((B, Lc), np.int32),
            np.take_along_axis(pool, bp, 2), np.ones((B, C), np.int32))


def float_semi_slabs(rng, dev, B=512, Lc=256, C=64):
    """Two float key planes (bits) with -0.0, NaN, infinities and
    subnormals among them, about 80 % of the slots occupied."""
    vals = np.float32([0.0, -0.0, np.nan, np.inf, -np.inf, 1e-40, 1.5,
                       -2.25, 3.0e38])
    pb = rng.choice(vals, (B, 2, Lc)).view(np.int32)
    bb = rng.choice(vals, (B, 2, C)).view(np.int32)
    return (dev(pb), dev((rng.random((B, Lc)) < 0.8).astype(np.int32)),
            dev(bb), dev((rng.random((B, C)) < 0.8).astype(np.int32)))


def semi_cases(recorded, device, seed=2):
    """hash_semi's cases: the slabs its wrapper received on the counted
    hash runs of the UNOMT leg (the drug and the cell filter) and of the
    set-op legs (isin, intersect, difference), with the probe and build
    keys of their occupied slots for ``torch.isin``, then two float
    planes and a slab wider than a block's shared memory."""
    rng = np.random.default_rng(seed)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    cases = []
    for col, (pb, po, bb, bo) in zip(
            ("drug_id", "cell_id", "isin", "intersect", "difference"),
            recorded, strict=True):
        B, K, Lc = pb.shape
        cases.append(dict(
            shape=f"{col} B={B} K={K} Lc={Lc} C={bb.shape[2]}",
            args=(pb, po, bb, bo),
            library=(pb[:, 0][po > 0], bb[:, 0][bo > 0])))
    cases.append(dict(shape="B=512 K=2 Lc=256 C=64 float",
                      args=float_semi_slabs(rng, dev)))
    cases.append(dict(
        shape="B=16 K=1 Lc=256 C=32768",
        args=tuple(dev(a) for a in pooled_slabs(rng, 16, 1, 256, 32768))))
    return cases


def _plain(m, name, args):
    """The plain version on the same inputs; the probes in chunks of
    buckets to bound their memory (the radix and groupby plain versions
    chunk themselves)."""
    if name == "hash_partition":
        return m["hp_ref"].radix_histogram_ranks_ref(*args)
    if name == "fused_bucketing":
        return m["fb_ref"].fused_bucket_ranks_ref(*args)
    if name == "radix_sort" and len(args) == 5:
        return m["rs_ref"].scatter_pass_ref(*args[:4])
    if name == "radix_sort":
        return m["rs_ref"].digit_histogram_ranks_ref(*args[:3])
    if name == "hash_groupby":
        return m["hg_ref"].bucket_accumulate_ref(*args)
    if name == "flash_attention":
        q, k, v, causal = args
        return (m["fa_ref"].attention_ref(q, k, v, causal=causal),)
    if name == "mamba_scan":
        y, hT = m["ms_ref"].selective_scan_ref(*args[:6])
        return (y, hT) if args[6] else (y,)
    pb, po, bb, bo = args
    if name == "hash_semi":
        # about 2**28 pairs per chunk of buckets
        chunk = max(1, (1 << 28) // max(pb.shape[2] * bb.shape[2], 1))
        return (torch.cat([m["hs_ref"].bucket_member_ref(
            pb[i:i + chunk], po[i:i + chunk], bb[i:i + chunk],
            bo[i:i + chunk]) for i in range(0, pb.shape[0], chunk)]),)
    chunk = 32
    parts = [m["hj_ref"].bucket_probe_ref(pb[i:i + chunk], po[i:i + chunk],
                                          bb[i:i + chunk], bo[i:i + chunk])
             for i in range(0, pb.shape[0], chunk)]
    return tuple(torch.cat(p) for p in zip(*parts))


def _kernel(m, name, args):
    op = m["ops"][name]
    if name == "hash_partition":
        return op.radix_histogram_ranks(*args)
    if name == "fused_bucketing":
        return op.fused_bucket_ranks(*args)
    if name == "radix_sort" and len(args) == 5:
        return op.scatter_pass(*args)
    if name == "radix_sort":
        return op.digit_histogram_ranks(*args)
    if name == "hash_groupby":
        return op.bucket_accumulate(*args)
    if name == "hash_semi":
        return (op.bucket_member(*args),)
    if name == "flash_attention":
        q, k, v, causal = args
        return (op.flash_attention(q, k, v, causal=causal),)
    if name == "mamba_scan":
        out = op.selective_scan(*args[:6], return_state=args[6])
        return out if args[6] else (out,)
    return op.bucket_probe(*args)


def _groupby_close(m, args, got, want):
    """rep and counts exact; mins and maxs equal as values (NaN == NaN,
    -0.0 == +0.0); sums within 1e-6 of the group's sum of magnitudes.
    Returns the largest absolute sum difference and the largest ratio of
    a difference to its group's sum of magnitudes (NaN pairs excluded)."""
    for g, w in zip(got[:2], want[:2]):
        if not torch.equal(g, w):
            raise AssertionError("hash_groupby: rep/counts differ")
    for g, w in zip(got[3:], want[3:]):
        if not bool(((g == w) | (torch.isnan(g) & torch.isnan(w))).all()):
            raise AssertionError("hash_groupby: mins/maxs differ")
    kb, occ, vals = args
    scale = m["hg_ref"].bucket_accumulate_ref(kb, occ, vals.abs())[2]
    both_nan = torch.isnan(got[2]) & torch.isnan(want[2])
    diff = torch.where(both_nan, 0.0, (got[2] - want[2]).abs())
    ratio = torch.where(diff > 0, diff / scale, 0.0)
    worst = float(ratio.max()) if ratio.numel() else 0.0
    if not bool(((diff <= 1e-6 * scale) | both_nan).all()):
        raise AssertionError("hash_groupby: sums differ beyond 1e-6 of "
                             f"the group's sum of magnitudes (worst {worst})")
    return (float(diff.max()) if diff.numel() else 0.0), worst


def compare_kernels(m, cases, device) -> dict:
    """Kernel == plain version on every case (exactly, but for the
    groupby sums, see :func:`_groupby_close`); returns the largest
    absolute difference per kernel."""
    errs = {}
    for name, runs in cases.items():
        errs[name] = 0
        for case in runs:
            got = _kernel(m, name, case["args"])
            want = _plain(m, name, case["args"])
            _sync(device)
            if name in ("flash_attention", "mamba_scan"):
                close, tol = (_flash_close, FLASH_TOL) \
                    if name == "flash_attention" else (_scan_close, SCAN_TOL)
                err = close(case, got, want)
                errs[name] = max(errs[name], err)
                emit({"phase": "kernel_close", "kernel": name,
                      "shape": case["shape"], "max_abs_err": err,
                      "tolerance": tol})
                continue
            if name == "hash_groupby":
                err, worst = _groupby_close(m, case["args"], got, want)
                errs[name] = max(errs[name], err)
                emit({"phase": "kernel_equal", "kernel": name,
                      "shape": case["shape"], "equal": True,
                      "max_abs_err": err, "worst_err_over_abs_sum": worst})
                continue
            for g, w in zip(got, want):
                if g.shape != w.shape or g.dtype != w.dtype \
                        or not torch.equal(g, w):
                    raise AssertionError(f"{name} {case['shape']}: kernel "
                                         "differs from its plain version")
                if g.numel():
                    errs[name] = max(errs[name], int(
                        (g.to(torch.int64) - w.to(torch.int64)).abs().max()))
            emit({"phase": "kernel_equal", "kernel": name,
                  "shape": case["shape"], "equal": True})
    return errs


# --------------------------------------------------------------------------
# the Fig. 4 join legs
# --------------------------------------------------------------------------


def fig4_data(rows: int, seed: int = 0):
    """Two relations with ~10% key uniqueness (paper Fig. 4)."""
    rng = np.random.default_rng(seed)
    nkeys = max(rows // 10, 1)
    left = {"k": rng.integers(0, nkeys, rows).astype(np.int32),
            "lv": rng.normal(size=rows).astype(np.float32)}
    right = {"k": rng.integers(0, nkeys, rows).astype(np.int32),
             "rv": rng.normal(size=rows).astype(np.float32)}
    return left, right


def pipeline(m, ctx, fn, *datas):
    """``run()`` drives ``fn`` once through the pipeline on the
    distributed tables of ``datas``."""
    D = m["D"]
    pipe = D.DistributedPipeline(ctx, fn)
    tables = [D.distribute_table(ctx, d) for d in datas]
    return lambda: pipe(*tables)


def fig4_leg(m, ctx, left, right, impl, plan):
    """``run()`` drives ``dist_join`` once with the plan's sizes."""
    return pipeline(m, ctx, lambda c, a, b: m["D"].dist_join(
        c, a, b, left_on=["k"], out_capacity=plan["out_capacity"],
        shuffle_sizes=plan["shuffle_sizes"], local_impl=impl,
        local_join_sizes=plan["local_join_sizes"]), left, right)


def counted_run(m, run, device):
    """One run with every launch counter set to 0 just before it; returns
    (result, launches per kernel)."""
    for op in m["ops"].values():
        op.launches = 0
    out = run()
    _sync(device)
    return out, {k: op.launches for k, op in m["ops"].items()}


def check_sortmerge(m, ctx, out, dropped, left, right):
    """Exact checks of the world-1 sortmerge output: no drops, the keys
    are left-row-major with each left key repeated by its right count,
    and sum(lv*rv) equals sum over keys of sum(lv)*sum(rv)."""
    if int(dropped) != 0:
        raise AssertionError(f"sortmerge leg dropped {int(dropped)} rows")
    got = m["D"].collect_table(ctx, out)
    nkeys = int(max(left["k"].max(), right["k"].max())) + 1
    rcount = np.bincount(right["k"], minlength=nkeys)
    want_k = np.repeat(left["k"], rcount[left["k"]])
    if not np.array_equal(got["k"], want_k):
        raise AssertionError("sortmerge leg: output keys differ from "
                             "repeat(left_k, right_count[left_k])")
    prod = got["lv"].astype(np.float64) * got["rv"].astype(np.float64)
    want = np.dot(
        np.bincount(left["k"], weights=left["lv"].astype(np.float64),
                    minlength=nkeys),
        np.bincount(right["k"], weights=right["rv"].astype(np.float64),
                    minlength=nkeys))
    tol = 1e-6 * np.abs(prod).sum()
    if abs(prod.sum() - want) > tol:
        raise AssertionError(f"sortmerge leg: sum(lv*rv) {prod.sum()} != "
                             f"{want} within {tol}")
    return len(want_k)


def bit_identical(a, b) -> bool:
    """Two tables with the same rows, bit for bit (floats by their bits)."""
    if a.names != b.names or int(a.nvalid) != int(b.nvalid):
        return False
    n = int(a.nvalid)
    for k in a.names:
        x, y = a.columns[k][:n], b.columns[k][:n]
        if x.dtype != y.dtype:
            return False
        if x.dtype == torch.float32:
            x, y = x.view(torch.int32), y.view(torch.int32)
        if not torch.equal(x, y):
            return False
    return True


def run_legs(m, ctx, sortmerge_rows, hash_rows, device):
    """Drive both legs once each, counted and checked; returns what the
    timing phase needs."""
    D = m["D"]
    legs = {}
    left, right = fig4_data(sortmerge_rows)
    plan = D.plan_dist_join_sizes([left["k"]], [right["k"]], world=1,
                                  local_impl="sortmerge")
    run = fig4_leg(m, ctx, left, right, "sortmerge", plan)
    (out, dropped), launches = counted_run(m, run, device)
    if launches["hash_partition"] < 1:
        raise AssertionError("sortmerge leg launched no hash_partition")
    rows_out = check_sortmerge(m, ctx, out, dropped, left, right)
    del out
    emit({"phase": "fig4_sortmerge", "rows_per_side": sortmerge_rows,
          "out_rows": rows_out, "dropped": int(dropped),
          "launches": launches, "plan": plan})
    legs["sortmerge"] = dict(run=run, launches=launches,
                             rows=sortmerge_rows)

    left, right = fig4_data(hash_rows)
    plan = D.plan_dist_join_sizes([left["k"]], [right["k"]], world=1,
                                  local_impl="hash")
    run = fig4_leg(m, ctx, left, right, "hash", plan)
    (out, dropped), launches = counted_run(m, run, device)
    if min(launches[k] for k in JOIN_KERNELS) < 1:
        raise AssertionError(f"hash leg missed a kernel: {launches}")
    ref_run = fig4_leg(m, ctx, left, right, "sortmerge",
                       dict(plan, local_join_sizes=None))
    ref_out, ref_dropped = ref_run()
    if int(dropped) != 0 or int(ref_dropped) != 0:
        raise AssertionError(f"hash leg dropped {int(dropped)} rows "
                             f"(sortmerge on its data {int(ref_dropped)})")
    if not bit_identical(out, ref_out):
        raise AssertionError("hash leg differs from sortmerge on its data")
    emit({"phase": "fig4_hash", "rows_per_side": hash_rows,
          "out_rows": int(out.nvalid), "dropped": int(dropped),
          "bit_identical_to_sortmerge": True, "launches": launches,
          "plan": plan})
    legs["hash"] = dict(run=run, launches=launches, rows=hash_rows,
                        plan=plan)
    return legs


# --------------------------------------------------------------------------
# the Table 5 legs: GroupBy, Unique, OrderBy, broadcast join
# --------------------------------------------------------------------------


def groupby_data(rows: int, nkeys: int, seed: int = 0):
    """k uniform over ``nkeys`` keys, v integer-valued float32 in
    [-100, 100) (as ``benchmarks/bench_groupby.py``)."""
    rng = np.random.default_rng(seed)
    return {"k": rng.integers(0, nkeys, rows).astype(np.int32),
            "v": rng.integers(-100, 100, rows).astype(np.float32)}


def plan_groupby_sizes(m, data) -> dict:
    """Host-side slab sizes for the hash groupby, as users size a traced
    hash groupby (``benchmarks/bench_groupby.hash_sizes``)."""
    B, C = m["bucketing"].plan_bucket_sizes([data["k"]],
                                            num_buckets=GROUPBY_BUCKETS)
    return {"num_buckets": B, "bucket_capacity": C}


def sort_data(rows: int, seed: int = 0):
    """k int32 in [-500 000, 500 000), v normal float32 with -0.0 and NaN
    sprinkled in."""
    rng = np.random.default_rng(seed)
    v = rng.normal(size=rows).astype(np.float32)
    v[rng.random(rows) < 0.01] = -0.0
    v[rng.random(rows) < 0.001] = np.nan
    return {"k": rng.integers(-500_000, 500_000, rows).astype(np.int32),
            "v": v}


def expect_launches(leg: str, launches: dict, want: dict) -> None:
    """Exactly ``want`` launches (0 for a kernel not named)."""
    full = {k: want.get(k, 0) for k in KERNELS}
    if any(launches[k] != full[k] for k in KERNELS):
        raise AssertionError(f"{leg}: launches {launches}, expected {full}")


def counted_leg(m, leg, run, device, want, legs):
    """One counted run that must launch exactly ``want`` and drop nothing;
    the leg is kept for the timing phase."""
    (out, dropped), launches = counted_run(m, run, device)
    expect_launches(leg, launches, want)
    if int(dropped) != 0:
        raise AssertionError(f"{leg} dropped {int(dropped)} rows")
    legs[leg] = dict(run=run, launches=launches)
    return out


def check_groupby(got: dict, data: dict) -> None:
    """Keys, counts, sums, mins and maxs equal numpy's (exact on this
    integer-valued data), and mean == float32(sum) / float32(count)."""
    k, v = data["k"], data["v"]
    uniq = np.unique(k)
    nk = int(k.max()) + 1
    counts = np.bincount(k, minlength=nk)[uniq]
    sums = np.bincount(k, weights=v.astype(np.float64),
                       minlength=nk)[uniq].astype(np.float32)
    mins = np.full(nk, np.inf, np.float32)
    maxs = np.full(nk, -np.inf, np.float32)
    np.minimum.at(mins, k, v)
    np.maximum.at(maxs, k, v)
    want = {"k": uniq.astype(np.int32), "v_sum": sums,
            "v_count": counts.astype(np.int32),
            "v_mean": sums / counts.astype(np.float32),
            "v_min": mins[uniq], "v_max": maxs[uniq]}
    if list(got) != list(want):
        raise AssertionError(f"groupby leg: columns {list(got)}")
    for name, w in want.items():
        g = got[name]
        if g.dtype != w.dtype or not np.array_equal(g.view(np.int32),
                                                    w.view(np.int32)):
            raise AssertionError(f"groupby leg: {name} differs from numpy")


def check_sorted(got: dict, data: dict) -> None:
    """The rows are a numpy stable sort by (k, v), NaN last and -0.0 equal
    to +0.0, bit for bit."""
    k, v = data["k"], data["v"]
    order = np.lexsort((np.where(np.isnan(v), np.inf, v), k))
    if not (np.array_equal(got["k"], k[order])
            and np.array_equal(got["v"].view(np.int32),
                               v[order].view(np.int32))):
        raise AssertionError("sort leg: rows are not in (k, v) order")


def run_table5(m, ctx, device, data, sizes):
    """Drive the GroupBy, Unique, OrderBy and broadcast-join phases once
    each, counted and checked; returns the legs the timing phase runs
    again."""
    D = m["D"]
    legs = {}
    uniq, first = np.unique(data["k"], return_index=True)

    hashed = {"hash_partition": 1, "radix_sort": 8, "hash_groupby": 1}
    sorted_ = {"hash_partition": 1, "radix_sort": 1}
    out = {}
    for impl, want in (("hash", hashed), ("sort", sorted_)):
        kw = dict(local_impl=impl,
                  groupby_sizes=sizes if impl == "hash" else None)
        run = pipeline(m, ctx, lambda c, a, kw=kw: D.dist_groupby(
            c, a, ["k"], AGGS, **kw), data)
        out[impl] = counted_leg(m, f"groupby_{impl}", run, device, want,
                                legs)
        legs[f"groupby_{impl}"]["rows"] = GROUPBY_ROWS
    check_groupby(D.collect_table(ctx, out["hash"]), data)
    if not bit_identical(out["hash"], out["sort"]):
        raise AssertionError("groupby leg: hash differs from sort")
    emit({"phase": "groupby", "rows": GROUPBY_ROWS, "keys": GROUPBY_KEYS,
          "groups": int(out["hash"].nvalid), "sizes": sizes,
          "equal_to_numpy": True, "bit_identical_to_sort": True,
          "launches": {i: legs[f"groupby_{i}"]["launches"] for i in out}})

    for impl, want in (("hash", hashed), ("sort", sorted_)):
        kw = dict(local_impl=impl,
                  groupby_sizes=sizes if impl == "hash" else None)
        run = pipeline(m, ctx, lambda c, a, kw=kw: D.dist_unique(
            c, a, ["k"], **kw), data)
        out[impl] = counted_leg(m, f"unique_{impl}", run, device, want, {})
    got = D.collect_table(ctx, out["hash"])
    if not (bit_identical(out["hash"], out["sort"])
            and np.array_equal(got["k"], uniq)
            and np.array_equal(got["v"], data["v"][first])):
        raise AssertionError("unique leg: hash, sort and numpy differ")
    emit({"phase": "unique", "rows": GROUPBY_ROWS, "nvalid": len(uniq),
          "bit_identical_hash_sort": True})
    del out

    sdata = sort_data(SORT_ROWS)
    out = {}
    for impl, want in (("radix", {"hash_partition": 1, "radix_sort": 27}),
                       ("xla", {"hash_partition": 1})):
        run = pipeline(m, ctx, lambda c, a, impl=impl: D.dist_sort(
            c, a, ["k", "v"], local_impl=impl), sdata)
        out[impl] = counted_leg(m, f"sort_{impl}", run, device, want, legs)
        legs[f"sort_{impl}"]["rows"] = SORT_ROWS
    if not bit_identical(out["radix"], out["xla"]):
        raise AssertionError("sort leg: radix differs from xla")
    check_sorted(D.collect_table(ctx, out["radix"]), sdata)
    emit({"phase": "orderby", "rows": SORT_ROWS,
          "bit_identical_radix_xla": True, "numpy_order": True,
          "launches": {i: legs[f"sort_{i}"]["launches"] for i in out}})
    del out

    rng = np.random.default_rng(0)
    nl, nr = BCAST_ROWS
    left = {"k": rng.integers(0, nr, nl).astype(np.int32),
            "lv": rng.normal(size=nl).astype(np.float32)}
    right = {"k": np.arange(nr, dtype=np.int32),
             "rv": rng.normal(size=nr).astype(np.float32)}
    out = {}
    for strategy, want in (("broadcast", {"radix_sort": 1}),
                           ("shuffle", {"hash_partition": 2})):
        run = pipeline(m, ctx, lambda c, a, b, s=strategy: D.dist_join(
            c, a, b, left_on=["k"], strategy=s), left, right)
        out[strategy] = counted_leg(m, f"join_{strategy}", run, device,
                                    want, {})
    if int(out["broadcast"].nvalid) != nl \
            or not bit_identical(out["broadcast"], out["shuffle"]):
        raise AssertionError("broadcast join differs from the shuffle join")
    emit({"phase": "broadcast_join", "left_rows": nl, "right_rows": nr,
          "out_rows": nl, "bit_identical_to_shuffle": True})
    return legs


# --------------------------------------------------------------------------
# the UNOMT data-engineering pipeline and the set operators
# --------------------------------------------------------------------------

UNOMT_TABLES = ("response", "descriptors", "fingerprints", "rna")


def unomt_data(m, rows, drugs, cells):
    """The leg's raw tables, at the generator's own widths (8 drug and 8
    RNA features)."""
    return m["U"].gen_unomt_tables(n_response=rows, n_drugs=drugs,
                                   n_cells=cells, seed=0)


def _scaled(x):
    x = x.astype(np.float64)
    return (x - x.mean()) / np.sqrt(x.var() + 1e-12)


def unomt_numpy(m, raw) -> dict:
    """An independent pipeline: ``np.isnan`` for the nulls, index lookups
    for the joins (drug and cell ids are unique after Fig. 9 and 10),
    ``np.isin`` for the Fig. 11 filters, float64 scaling."""
    U = m["U"]
    r, desc, fp, rna = (raw[k] for k in UNOMT_TABLES)
    ok = ~np.isnan(r["response"])
    out = {"drug_id": (r["drug_id_raw"][ok] - 1_000_000).astype(np.int32),
           "cell_id": r["cell_id"][ok],
           "concentration": _scaled(r["concentration"][ok]),
           "response": r["response"][ok]}
    if len(np.unique(desc["drug_id"])) != len(desc["drug_id"]) or \
            len(np.unique(fp["drug_id"])) != len(fp["drug_id"]):
        raise AssertionError("unomt: duplicate drug ids in a sub-table")
    drugs = np.intersect1d(desc["drug_id"], fp["drug_id"])
    cells, first = np.unique(rna["cell_id"], return_index=True)
    keep = np.isin(out["drug_id"], drugs) & np.isin(out["cell_id"], cells)
    out = {k: v[keep] for k, v in out.items()}
    for sub in (desc, fp):
        row = np.full(int(sub["drug_id"].max()) + 1, -1, np.int64)
        row[sub["drug_id"]] = np.arange(len(sub["drug_id"]))
        for c in sub:
            if c != "drug_id":
                out[c] = sub[c][row[out["drug_id"]]]
    row = np.full(int(cells.max()) + 1, -1, np.int64)
    row[cells] = np.arange(len(cells))
    for c in U.rna_cols():
        out[c] = _scaled(rna[c][first])[row[out["cell_id"]]]
    return out


def check_unomt(got: dict, want: dict) -> None:
    """The same multiset of rows, compared after a lexsort on (drug_id,
    cell_id, response): ids and unscaled floats exactly, the scaled
    columns within 1e-4."""
    if list(got) != list(want):
        raise AssertionError(f"unomt: columns {list(got)} != {list(want)}")
    if len(got["drug_id"]) != len(want["drug_id"]):
        raise AssertionError(f"unomt: {len(got['drug_id'])} rows, numpy "
                             f"{len(want['drug_id'])}")
    og = np.lexsort((got["response"], got["cell_id"], got["drug_id"]))
    ow = np.lexsort((want["response"], want["cell_id"], want["drug_id"]))
    scaled = ["concentration"] + [c for c in got if c.startswith("rna")]
    for c in got:
        g, w = got[c][og], want[c][ow]
        if c in scaled:
            err = float(np.abs(g.astype(np.float64) - w).max()) \
                if len(g) else 0.0
            if not err <= 1e-4:
                raise AssertionError(f"unomt: {c} off by {err}")
        elif not np.array_equal(g, w):
            raise AssertionError(f"unomt: {c} differs from numpy")


@contextlib.contextmanager
def recording(op, fn_name, calls, limit=None):
    """Context in which ``op.fn_name`` also appends a copy of the
    arguments of each call (of the first ``limit`` calls), positional then
    keyword, to ``calls``; launches are counted as without it."""
    plain = getattr(op, fn_name)

    def keep(*args, **kwargs):
        if limit is None or len(calls) < limit:
            calls.append(tuple(a.clone() for a in args)
                         + tuple(kwargs.values()))
        return plain(*args, **kwargs)

    setattr(op, fn_name, keep)
    try:
        yield
    finally:
        setattr(op, fn_name, plain)


# exact launches of the UNOMT leg at its size and seed (the same in every
# run): 8 shuffles, the radix passes of compactions and rankings, and
# for the hash filters drug ids in 4096 buckets (hashed in torch, ranked
# by radix passes) and cell ids in 128 (fused_bucketing)
UNOMT_LAUNCHES = {
    "sortmerge": {"hash_partition": 8, "radix_sort": 5},
    "hash": {"hash_partition": 8, "radix_sort": 9, "fused_bucketing": 2,
             "hash_semi": 2}}


def run_unomt(m, ctx, device, raw):
    """Drive ``unomt_dist_pipeline`` once per membership backend, counted
    and checked; then the Table -> tensor hand-off.  Returns the legs and
    the slabs the hash run gave ``bucket_member`` (drug, then cell
    filter)."""
    D, U = m["D"], m["U"]
    legs, out, slabs = {}, {}, []
    rows = len(raw["response"]["cell_id"])
    for impl in ("sortmerge", "hash"):
        run = pipeline(m, ctx, lambda c, *ts, impl=impl: U.unomt_dist_pipeline(
            c, *ts, overcommit=1.0, semi_impl=impl),
            *[raw[k] for k in UNOMT_TABLES])
        with recording(m["ops"]["hash_semi"], "bucket_member",
                       slabs if impl == "hash" else []):
            (res, dropped), launches = counted_run(m, run, device)
        if int(dropped) != 0:
            raise AssertionError(f"unomt {impl} dropped {int(dropped)} rows")
        expect_launches(f"unomt_{impl}", launches, UNOMT_LAUNCHES[impl])
        out[impl] = res
        legs[f"unomt_{impl}"] = dict(run=run, launches=launches, rows=rows)
    if not bit_identical(out["sortmerge"], out["hash"]):
        raise AssertionError("unomt: hash membership differs from sortmerge")
    got = D.collect_table(ctx, out["hash"])
    check_unomt(got, unomt_numpy(m, raw))
    X, y, mask = U.feature_label_arrays(out["hash"])
    cap, n = out["hash"].capacity, int(out["hash"].nvalid)
    if X.shape != (cap, 17) or X.dtype != torch.float32 \
            or X.device.type != device.type or y.shape != (cap,) \
            or int(mask.sum()) != n or not bool(torch.isfinite(X[:n]).all()):
        raise AssertionError(f"unomt: features {tuple(X.shape)} {X.dtype} "
                             f"on {X.device}, {int(mask.sum())} valid")
    emit({"phase": "unomt", "response_rows": rows,
          "drugs": len(raw["descriptors"]["drug_id"]),
          "cells": len(np.unique(raw["rna"]["cell_id"])),
          "out_rows": n, "capacity": cap, "features": X.shape[1],
          "dropped": 0, "bit_identical_sortmerge_hash": True,
          "equal_to_numpy": True,
          "launches": {i: legs[f"unomt_{i}"]["launches"] for i in out}})
    return legs, slabs


def setop_data(rows_a, rows_b, nkeys, seed=0):
    """a.k uniform over [0, nkeys), b.k uniform over [nkeys / 2,
    3 nkeys / 2): half of a's keys can be in b."""
    rng = np.random.default_rng(seed)
    a = {"k": rng.integers(0, nkeys, rows_a).astype(np.int32),
         "v": rng.normal(size=rows_a).astype(np.float32)}
    b = {"k": rng.integers(nkeys // 2, nkeys + nkeys // 2, rows_b)
         .astype(np.int32),
         "v": rng.normal(size=rows_b).astype(np.float32)}
    return a, b


# radix passes of each set op at the leg's size and seed (the same in
# every run); each op also shuffles both sides (2 hash_partition)
SETOP_RADIX = {"isin": {"sortmerge": 1, "hash": 7},
               "intersect": {"sortmerge": 2, "hash": 8},
               "difference": {"sortmerge": 1, "hash": 7}}


def run_setops(m, ctx, device, a, b):
    """``dist_isin``, ``dist_intersect`` and ``dist_difference`` once per
    membership backend (dedup by sort either way), counted and checked
    against numpy; the membership kernel must run exactly once per hash
    call.  Returns the legs and the slabs the hash runs gave
    ``bucket_member`` (isin, intersect, difference)."""
    D = m["D"]
    mask = np.isin(a["k"], b["k"])
    uk, first = np.unique(a["k"][mask], return_index=True)
    if not np.array_equal(uk, np.intersect1d(a["k"], b["k"])):
        raise AssertionError("set ops: numpy intersect disagrees")
    want = {"isin": {"k": a["k"][mask], "v": a["v"][mask]},
            "intersect": {"k": uk, "v": a["v"][mask][first]},
            "difference": {"k": a["k"][~mask], "v": a["v"][~mask]}}
    if not np.array_equal(np.unique(want["difference"]["k"]),
                          np.setdiff1d(a["k"], b["k"])):
        raise AssertionError("set ops: numpy difference disagrees")
    ops = {
        "isin": lambda c, x, y, impl: D.dist_isin(
            c, x, "k", y, "k", overcommit=1.0, local_impl=impl),
        "intersect": lambda c, x, y, impl: D.dist_intersect(
            c, x, y, ["k"], overcommit=1.0, local_impl=impl,
            dedup_impl="sort"),
        "difference": lambda c, x, y, impl: D.dist_difference(
            c, x, y, ["k"], overcommit=1.0, local_impl=impl)}
    legs, summary, slabs = {}, {}, []
    for op, fn in ops.items():
        out = {}
        for impl in ("sortmerge", "hash"):
            run = pipeline(m, ctx, lambda c, x, y, fn=fn, impl=impl: fn(
                c, x, y, impl), a, b)
            with recording(m["ops"]["hash_semi"], "bucket_member",
                           slabs if impl == "hash" else []):
                (res, dropped), launches = counted_run(m, run, device)
            if int(dropped) != 0:
                raise AssertionError(f"{op} {impl} dropped {int(dropped)}")
            expect_launches(f"{op}_{impl}", launches,
                            {"hash_partition": 2,
                             "radix_sort": SETOP_RADIX[op][impl],
                             "hash_semi": int(impl == "hash")})
            out[impl] = res
            legs[f"{op}_{impl}"] = dict(run=run, launches=launches,
                                        rows=len(a["k"]))
        if not bit_identical(out["sortmerge"], out["hash"]):
            raise AssertionError(f"{op}: hash differs from sortmerge")
        got = D.collect_table(ctx, out["hash"])
        for c, w in want[op].items():
            if not np.array_equal(got[c].view(np.int32), w.view(np.int32)):
                raise AssertionError(f"{op}: column {c} differs from numpy")
        summary[op] = len(got["k"])
    emit({"phase": "set_ops", "rows": [len(a["k"]), len(b["k"])],
          "keys": SETOP_KEYS, "out_rows": summary, "dropped": 0,
          "bit_identical_sortmerge_hash": True, "equal_to_numpy": True,
          "launches": {k: v["launches"] for k, v in legs.items()}})
    return legs, slabs


# --------------------------------------------------------------------------
# the LM serving path: ServingEngine with feature fetch, flash attention
# --------------------------------------------------------------------------

# bf16 outputs compared in float32: the reference's own bf16 tolerance for
# its kernel (tests/test_kernels.py::test_flash_attention_dtypes)
FLASH_TOL = 2e-2
# Prefill logits of the flash path against the plain ``xla`` path, and the
# engine's logits against the one-shot loop's at every position, agree
# within SERVE_LOGIT_TOL absolute (logits of magnitude about 4).  Each attention output of the
# kernel is within one bf16 ulp of plain attention's (it rounds P to bf16
# for the tensor cores and sums in another order), and forty layers of
# random weights amplify such differences: the first runs on the card
# measured 0.215 at most and 0.178 at the median over the leg's 32
# prompts, and plain attention_ref against xla (float32 both, other sums)
# 0.149 on one; the engine against the one-shot loop 0.165 (the same
# kernels at other batch shapes).  Greedy tokens are compared where the
# reference's top-2 logit margin is at least SERVE_LOGIT_TOL: below it a
# difference within the tolerance may pick the other token.  Against the
# ``xla`` run, which decodes freely, up to the first such position (the
# sequences may go apart there); against the one-shot loop, fed the
# engine's tokens, at every position.
SERVE_LOGIT_TOL = 0.3


def _margin(logits) -> np.ndarray:
    top = torch.topk(logits.float(), 2, dim=-1).values
    return (top[..., 0] - top[..., 1]).cpu().numpy()


class Recorder:
    """Hooks on an engine: each request's prefill logits (float32, on the
    host) and its top-2 logit margin at every token it emits, in the order
    of its ``out_tokens``; for the requests of ``keep`` also the logits of
    every token (``steps``)."""

    def __init__(self, engine, keep=()):
        self.logits = {}
        self.margins = collections.defaultdict(list)
        self.steps = collections.defaultdict(list)
        upcoming = collections.deque()
        fetch, prefill, step = (engine._fetch_features,
                                engine._slot_prefill, engine._serve_step)

        def fetch_hook(reqs):
            good = fetch(reqs)
            upcoming.extend(good)
            return good

        def prefill_hook(params, batch, length):
            logits, caches = prefill(params, batch, length)
            rid = upcoming.popleft().req_id
            self.logits[rid] = logits[0].float().cpu()
            self.margins[rid].append(float(_margin(logits)[0]))
            if rid in keep:
                self.steps[rid].append(self.logits[rid])
            return logits, caches

        def step_hook(params, caches, tokens, cache_lens):
            logits, caches = step(params, caches, tokens, cache_lens)
            mg = _margin(logits)
            for slot in engine.batch.active():
                rid = engine.batch.request_at(slot).req_id
                self.margins[rid].append(float(mg[slot]))
                if rid in keep:
                    self.steps[rid].append(logits[slot].float().cpu())
            return logits, caches

        engine._fetch_features = fetch_hook
        engine._slot_prefill = prefill_hook
        engine._serve_step = step_hook


def greedy_agree(got, want, margins, tol) -> int:
    """Tokens compared before the first position whose margin is below
    ``tol``; raises on a difference before it."""
    n = 0
    for g, w, mg in zip(got, want, margins):
        if mg < tol:
            break
        if g != w:
            raise AssertionError(f"token {n}: {g} != {w} at margin {mg}")
        n += 1
    return n


def _leaves(tree):
    for v in tree.values():
        yield from _leaves(v) if isinstance(v, dict) else (v,)


def count_lookups(stores) -> list:
    """Wrap each store's ``lookup``; the returned one-element list counts
    the calls."""
    n = [0]
    for store in stores.values():
        plain = store.lookup

        def lookup(keys, plain=plain):
            n[0] += 1
            return plain(keys)

        store.lookup = lookup
    return n


def check_served(done, reqs, tables, n_req):
    """Every request done with ``gen_len`` tokens and the features of its
    numpy rows."""
    if sorted(r.req_id for r in done) != list(range(n_req)):
        raise AssertionError("serving: requests lost")
    for r in done:
        if r.status != "done" or len(r.out_tokens) != r.gen_len:
            raise AssertionError(f"serving: request {r.req_id} {r.status} "
                                 f"with {len(r.out_tokens)} tokens")
        want = {}
        for attr, tbl in tables.items():
            row = int(np.flatnonzero(tbl[attr] == getattr(r, attr))[0])
            want.update({c: float(v[row]) for c, v in tbl.items()
                         if c != attr})
        if r.features != want:
            raise AssertionError(f"serving: request {r.req_id} features "
                                 "differ from its numpy rows")


def oneshot_tokens(m, cfg, params, req, device):
    """The one-shot loop (exact-length prefill, then batch-1 decode at a
    scalar cache length) fed the engine's tokens, so both see the same
    context at every position: its greedy choice, top-2 margin and logits
    (float32, host) at each of the request's positions."""
    M = m["M"]
    n = len(req.prompt)
    prefill = M.make_prefill(cfg, decode_len=n + req.gen_len)
    step = M.make_serve_step(cfg)
    logits, caches = prefill(params, {"tokens": torch.from_numpy(
        req.prompt[None]).to(device)})
    toks, margins, steps = [], [], []
    for i in range(req.gen_len):
        toks.append(int(torch.argmax(logits[0])))
        margins.append(float(_margin(logits)[0]))
        steps.append(logits[0].float().cpu())
        if i < req.gen_len - 1:
            logits, caches = step(params, caches, torch.tensor(
                [[req.out_tokens[i]]], dtype=torch.int32, device=device),
                n + i)
    return toks, margins, steps


def profile_serving(m, fns, device, labelled, kernel):
    """Each of ``fns`` (name -> callable) once warmed, then once under
    torch.profiler with the functions of ``labelled`` ((module, name)
    pairs, none calling another) in labelled ranges: wall ms, device busy
    ms and share, and device ms under each label.  ``kernel`` is (label,
    the port kernel's name): that kernel is launched through ctypes, not
    by an operator of its wrapper's range, so its label's time is read
    from the kernel itself."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    plain = {name: getattr(mod, name) for mod, name in labelled}

    def label(name):
        def fn(*args, **kwargs):
            with record_function(f"serve::{name}"):
                return plain[name](*args, **kwargs)
        return fn

    out = {}
    for key, fn in fns.items():
        fn()
        torch.cuda.synchronize(device)
        for mod, name in labelled:
            setattr(mod, name, label(name))
        try:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize(device)
                wall_ms = (time.perf_counter() - t0) * 1e3
        finally:
            for mod, name in labelled:
                setattr(mod, name, plain[name])
        # kernels only: the labels also appear on the device's timeline as
        # annotation spans (first to last kernel of the range, gaps
        # included), kept apart here
        kernels = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and not e.key.startswith("serve::")]
        busy = sum(e.self_device_time_total for e in kernels) / 1e3
        by_label, spans = collections.Counter(), collections.Counter()
        for e in prof.events():
            if e.name.startswith("serve::"):
                part = e.name.split("::")[1]
                if e.device_type == DeviceType.CUDA:
                    spans[part] += e.device_time_total / 1e3
                else:       # the kernels of the range's operators
                    by_label[part] += e.device_time_total / 1e3
        by_label[kernel[0]] = sum(e.self_device_time_total for e in kernels
                                  if kernel[1] in e.key) / 1e3
        kernels.sort(key=lambda e: -e.self_device_time_total)
        out[key] = {"wall_ms": wall_ms, "device_busy_ms": busy,
                    "device_busy_share": busy / wall_ms,
                    "device_ms_by_label": dict(by_label),
                    "device_span_ms_by_label": dict(spans),
                    "device_ms_other": busy - sum(by_label.values()),
                    "top_kernels": [{"name": e.key[:80], "count": e.count,
                                     "device_ms":
                                         e.self_device_time_total / 1e3}
                                    for e in kernels[:6]]}
    return out


def check_engine_run(leg, engine, done, rejected, reqs, tables, stores):
    """The accounting identity, no rejection or feature miss, every
    request served with its tokens and features, no feature row
    dropped."""
    mt = engine.metrics
    if mt.count("submitted") != mt.count("completed") + \
            mt.count("rejected") + mt.count("feature_misses"):
        raise AssertionError(f"{leg}: accounting identity violated")
    if rejected or mt.count("feature_misses"):
        raise AssertionError(f"{leg}: {len(rejected)} rejected, "
                             f"{mt.count('feature_misses')} feature misses")
    check_served(done, reqs, tables, len(reqs))
    dropped = {k: s.dropped for k, s in stores.items()}
    if any(dropped.values()):
        raise AssertionError(f"{leg}: feature stores dropped {dropped}")


def store_chunks(serve, stores) -> int:
    """The feature stores' ingest morsels: one shuffle each."""
    return sum(math.ceil(s.n_rows / serve.CHUNK_ROWS)
               for s in stores.values())


def against_oneshot(m, cfg, params, rec, by_id, pick, device) -> dict:
    """The requests of ``pick`` against the one-shot loop, fed the
    engine's tokens: the logits at every position within
    SERVE_LOGIT_TOL, and the same greedy token wherever the one-shot
    margin is at least that."""
    oneshot = {"requests": pick, "positions": 0, "compared": 0,
               "equal": 0, "logit_diff": 0.0}
    for rid in pick:
        r = by_id[rid]
        toks, margins, steps = oneshot_tokens(m, cfg, params, r, device)
        for i, (a, b) in enumerate(zip(rec.steps[rid], steps, strict=True)):
            oneshot["logit_diff"] = max(oneshot["logit_diff"],
                                        float((a - b).abs().max()))
            oneshot["positions"] += 1
            oneshot["equal"] += toks[i] == r.out_tokens[i]
            if margins[i] >= SERVE_LOGIT_TOL:
                oneshot["compared"] += 1
                if toks[i] != r.out_tokens[i]:
                    raise AssertionError(
                        f"serving: request {rid} token {i}: engine "
                        f"{r.out_tokens[i]}, one-shot {toks[i]} at margin "
                        f"{margins[i]}")
    if oneshot["logit_diff"] > SERVE_LOGIT_TOL or not oneshot["compared"]:
        raise AssertionError(f"serving: engine against one-shot {oneshot}")
    return oneshot


def run_serving(m, device, cfg, *, prompt_cap=SERVE_PROMPT,
                gen_cap=SERVE_GEN, n_req=SERVE_REQUESTS, slots=SERVE_SLOTS,
                queue=SERVE_QUEUE, attn_impl=None):
    """Drive the serving path once with the flash kernel, counted and
    checked, then against the one-shot loop and the ``xla`` attention
    path; time and profile it.  ``attn_impl`` is the first engine's
    attention path (``None``: what the device implies; a rehearsal on the
    CPU passes ``"cuda"`` to reach the flash wrapper's plain version).
    Returns (legs, the q, k, v and causal flag of the first flash
    call)."""
    M, serve = m["M"], m["serve"]
    ops = m["ops"]
    params = M.init_params(torch.Generator(device=device).manual_seed(0),
                           cfg)
    _sync(device)
    resident = _allocated(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    recorded = []

    for op in ops.values():
        op.launches = 0
    stores, tables = serve.feature_stores(m["make_context"](device), 0,
                                          max(slots, 8))
    lookups = count_lookups(stores)
    engine = m["ServingEngine"](
        cfg, params, slots=slots, prompt_capacity=prompt_cap,
        gen_capacity=gen_cap, queue_capacity=queue, feature_stores=stores,
        attn_impl=attn_impl, device=device)
    reqs = serve.make_requests(cfg, n_req, prompt_cap, gen_cap, seed=0)
    pick = [r.req_id for r in reqs if r.gen_len > 1][:2]
    rec = Recorder(engine, keep=set(pick))
    with recording(ops["flash_attention"], "flash_attention", recorded,
                   limit=1):
        done, rejected, seconds = serve.drive(engine, reqs, slots)
    _sync(device)
    launches = {k: op.launches for k, op in ops.items()}
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0) - resident

    mt = engine.metrics
    check_engine_run("serving", engine, done, rejected, reqs, tables, stores)
    # one shuffle per ingest chunk and per lookup; the lookups' sortmerge
    # join and the ingest append run no radix pass
    expect_launches("serving", launches, {
        "flash_attention": cfg.n_layers * mt.count("prefills"),
        "hash_partition": store_chunks(serve, stores) + lookups[0],
        "radix_sort": 0})
    by_id = {r.req_id: r for r in done}
    oneshot = against_oneshot(m, cfg, params, rec, by_id, pick, device)

    # the same requests on the plain attention path
    for op in ops.values():
        op.launches = 0
    n_lookups = lookups[0]
    xla = m["ServingEngine"](
        cfg, params, slots=slots, prompt_capacity=prompt_cap,
        gen_capacity=gen_cap, queue_capacity=queue, feature_stores=stores,
        attn_impl="xla", device=device)
    xrec = Recorder(xla)
    xreqs = serve.make_requests(cfg, n_req, prompt_cap, gen_cap, seed=0)
    xdone, _, xseconds = serve.drive(xla, xreqs, slots)
    _sync(device)
    xlaunches = {k: op.launches for k, op in ops.items()}
    expect_launches("serving_xla", xlaunches, {
        "hash_partition": lookups[0] - n_lookups, "radix_sort": 0})
    check_served(xdone, xreqs, tables, n_req)
    want = {r.req_id: r for r in xdone}
    diffs = {rid: float((lg - xrec.logits[rid]).abs().max())
             for rid, lg in rec.logits.items()}
    worst = max(diffs.values())
    if worst > SERVE_LOGIT_TOL:
        raise AssertionError(f"serving: flash and xla prefill logits differ "
                             f"by {worst} > {SERVE_LOGIT_TOL}")
    compared = sum(greedy_agree(r.out_tokens, want[r.req_id].out_tokens,
                                xrec.margins[r.req_id], SERVE_LOGIT_TOL)
                   for r in done)
    if compared == 0:
        raise AssertionError("serving: no token compared with the xla run")
    # the noise of plain attention alone: attention_ref (float32, -inf
    # masks, other sums) against xla on the first request's prompt
    r0 = reqs[0]
    padded = np.zeros((1, prompt_cap), np.int32)
    padded[0, :len(r0.prompt)] = r0.prompt
    batch = {"tokens": torch.from_numpy(padded).to(device)}
    ref_logits, _ = M.make_slot_prefill(
        cfg, decode_len=prompt_cap + gen_cap, attn_impl="ref")(
        params, batch, len(r0.prompt))
    ref_vs_xla = float((ref_logits[0].float().cpu()
                        - xrec.logits[r0.req_id]).abs().max())

    # time one full-length prefill and one decode step of all slots
    prefill = M.make_slot_prefill(cfg, decode_len=prompt_cap + gen_cap)
    full = {"tokens": torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (1, prompt_cap)).astype(np.int32)).to(device)}
    step = M.make_serve_step(cfg)
    toks = torch.zeros((slots, 1), dtype=torch.int32, device=device)
    lens = np.full(slots, prompt_cap - 1, np.int32)
    prefill_ms = event_ms(lambda: prefill(params, full, prompt_cap), reps=5)
    step_ms = event_ms(lambda: step(params, engine.caches, toks, lens),
                       reps=10)
    # one layer's decode attention alone, at the step's shapes
    q1 = torch.randn((slots, cfg.n_heads, 1, cfg.d_head), device=device) \
        .to(torch.bfloat16)
    lens_dev = torch.as_tensor(lens, device=device)
    decode_attention_ms = event_ms(lambda: m["A"].decode_attention(
        q1, engine.caches["k"][0], engine.caches["v"][0], lens_dev))

    def decode8():
        for _ in range(8):
            step(params, engine.caches, toks, lens)

    prof = profile_serving(m, {
        "prefill": lambda: prefill(params, full, prompt_cap),
        "decode_8_steps": decode8}, device,
        [(m["Ly"], "dense"), (m["A"], "decode_attention"),
         (m["Ly"], "logits_out"), (ops["flash_attention"],
                                   "flash_attention")],
        ("flash_attention", "flash_attention_kernel"))
    busy = sum(p["device_busy_ms"] for p in prof.values()) \
        / sum(p["wall_ms"] for p in prof.values())
    tokens = mt.count("tokens_generated")
    summary = {
        "phase": "serving", "arch": cfg.name, "layers": cfg.n_layers,
        "d_model": cfg.d_model, "slots": slots, "prompt_capacity":
        prompt_cap, "gen_capacity": gen_cap, "requests": n_req,
        "completed": mt.count("completed"), "prefills": mt.count("prefills"),
        "decode_steps": mt.count("decode_steps"), "tokens": tokens,
        "prompt_tokens": int(sum(len(r.prompt) for r in reqs)),
        "seconds": seconds, "tokens_per_s": tokens / seconds,
        "ttft_p50_ms": mt.percentile("ttft", 50) * 1e3,
        "ttft_p99_ms": mt.percentile("ttft", 99) * 1e3,
        "latency_p50_ms": mt.percentile("latency", 50) * 1e3,
        "latency_p99_ms": mt.percentile("latency", 99) * 1e3,
        "prefill_ms": prefill_ms, "decode_step_ms": step_ms,
        "decode_attention_ms_per_layer": decode_attention_ms,
        "peak_bytes_above_resident": peak, "resident_bytes": resident,
        "weight_bytes": sum(t.numel() * t.element_size()
                            for t in _leaves(params)),
        "feature_lookups": n_lookups, "dropped": 0, "launches": launches,
        "oneshot": oneshot, "xla_seconds": xseconds,
        "xla_tokens_per_s": xla.metrics.count("tokens_generated")
        / xseconds,
        "xla_launches": xlaunches, "logit_tol": SERVE_LOGIT_TOL,
        "prefill_logit_diff_max": worst,
        "prefill_logit_diff_median": float(np.median(list(diffs.values()))),
        "logit_diff_ref_vs_xla": ref_vs_xla,
        "tokens_compared_with_xla": compared,
        "tokens_equal_xla": sum(r.out_tokens == want[r.req_id].out_tokens
                                for r in done),
        "busy_share_prefill_plus_8_decode": busy, "profile": prof}
    emit(summary)
    legs = {"serving": dict(launches=launches, rows=n_req),
            "serving_xla": dict(launches=xlaunches, rows=n_req)}
    del params, engine, xla, stores, prefill, step, full
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return legs, recorded[0]


def flash_cases(recorded, device, seed=3):
    """flash_attention's cases: (a) the q, k, v one layer of the serving
    leg's first prefill gave it; (b) (1, 32, 1024, 1024, 64) causal; (c)
    right-aligned Sq 256 < Skv 1024; (d) not causal; (e) ragged Sq = Skv
    = 1000; (f) D = 128 with Hq = Hkv; (g) B = 4.  Where Sq == Skv the
    library call is ``scaled_dot_product_attention`` (top-left causal, so
    only there), with ``enable_gqa``."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def qkv(B, Hq, Hkv, Sq, Skv, D):
        return tuple(torch.randn(s, generator=gen, device=device)
                     .to(torch.bfloat16)
                     for s in ((B, Hq, Sq, D), (B, Hkv, Skv, D),
                               (B, Hkv, Skv, D)))

    q, k, v, causal = recorded
    cases = [dict(shape=f"(a) serving prefill q {tuple(q.shape)} kv "
                        f"{tuple(k.shape)} causal", args=(q, k, v, causal))]
    for label, shape, causal in (
            ("(b)", (1, 32, 8, 1024, 1024, 64), True),
            ("(c)", (1, 32, 8, 256, 1024, 64), True),
            ("(d)", (1, 32, 8, 1024, 1024, 64), False),
            ("(e)", (1, 32, 8, 1000, 1000, 64), True),
            ("(f)", (1, 16, 16, 1024, 1024, 128), True),
            ("(g)", (4, 32, 8, 1024, 1024, 64), True)):
        B, Hq, Hkv, Sq, Skv, D = shape
        cases.append(dict(
            shape=f"{label} B {B} Hq {Hq} Hkv {Hkv} Sq {Sq} Skv {Skv} "
                  f"D {D} {'causal' if causal else 'full'}",
            args=(*qkv(*shape), causal)))
    for case in cases:
        q, k, v, causal = case["args"]
        if q.shape[2] == k.shape[2]:
            case["library"] = lambda q=q, k=k, v=v, c=causal: \
                torch.nn.functional.scaled_dot_product_attention(
                    q, k, v, is_causal=c, enable_gqa=True)
    return cases


def _flash_close(case, got, want) -> float:
    """Finite, and within FLASH_TOL (absolute and relative) of the plain
    version in float32; returns the largest absolute difference."""
    got, want = got[0], want[0]
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"flash_attention {case['shape']}: "
                             f"{got.dtype} {tuple(got.shape)}")
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    if not bool(torch.isfinite(g).all()) \
            or bool((diff > FLASH_TOL * (1 + w.abs())).any()):
        raise AssertionError(f"flash_attention {case['shape']}: differs "
                             f"from attention_ref by {float(diff.max())}")
    return float(diff.max())


# --------------------------------------------------------------------------
# the Mamba serving path: Falcon-Mamba-7B with the selective-scan kernel
# --------------------------------------------------------------------------

# the reference's own tolerance for its scan kernel against its ref
# (tests/test_kernels.py::test_selective_scan_interpret_matches_ref),
# absolute and relative; the two sum over N in other orders
SCAN_TOL = 2e-4
# the kernel path's conv and ssm states against the plain scan's, within
# MAMBA_STATE_TOL of each state's largest magnitude (the CPU tests' rule
# against the reference): the two scans differ by float32 rounding, which
# a bf16 rounding of the next layer's input may turn into one bf16 ulp
# (2^-8) and 64 random-weight layers carry on.  The first run on the card
# measured 0.0137 at most (the ssm state after an 872-token prompt and 8
# decode steps) and logits within 0.073 of each other.
MAMBA_STATE_TOL = 2e-2


@contextlib.contextmanager
def recording_longest(op, fn_name, calls):
    """Context in which ``op.fn_name`` keeps in ``calls`` a copy of the
    arguments (positional then keyword) of the first call with the
    longest sequence (``args[0].shape[1]``) seen so far."""
    plain = getattr(op, fn_name)

    def keep(*args, **kwargs):
        if not calls or args[0].shape[1] > calls[0][0].shape[1]:
            calls[:] = [tuple(a.clone() for a in args)
                        + tuple(kwargs.values())]
        return plain(*args, **kwargs)

    setattr(op, fn_name, keep)
    try:
        yield
    finally:
        setattr(op, fn_name, plain)


def against_plain_scan(m, cfg, params, req, prompt_cap, gen_cap, device,
                       steps=8) -> dict:
    """One request's slot prefill with the scan kernel and with the plain
    scan (``mamba_impl="xla"``), then ``steps`` decode steps from each
    state fed the same tokens (the engine's, then seeded random ones):
    the kernel runs in every layer of the first prefill and in none of
    the second; logits within SERVE_LOGIT_TOL at every position; the
    conv and ssm states after the prefill and after the steps within
    MAMBA_STATE_TOL of their largest magnitude."""
    M, scan = m["M"], m["ops"]["mamba_scan"]
    n = len(req.prompt)
    padded = np.zeros((1, prompt_cap), np.int32)
    padded[0, :n] = req.prompt
    batch = {"tokens": torch.from_numpy(padded).to(device)}
    rng = np.random.default_rng(req.req_id)
    feed = (list(req.out_tokens)
            + rng.integers(0, cfg.vocab, steps).tolist())[:steps]
    step = M.make_serve_step(cfg)
    runs = {}
    for impl in ("cuda", "xla"):
        scan.launches = 0
        logits, caches = M.make_slot_prefill(
            cfg, decode_len=prompt_cap + gen_cap, mamba_impl=impl)(
            params, batch, n)
        launched = scan.launches
        states = [{k: v.clone() for k, v in caches.items()}]
        seq = [logits[0].float().cpu()]
        for i, tok in enumerate(feed):
            logits, caches = step(params, caches, torch.tensor(
                [[tok]], dtype=torch.int32, device=device), n + i)
            seq.append(logits[0].float().cpu())
        states.append(caches)
        runs[impl] = (seq, states, launched)
    _sync(device)
    if (runs["cuda"][2], runs["xla"][2]) != (cfg.n_layers, 0):
        raise AssertionError(f"serving_mamba: scan launches "
                             f"{runs['cuda'][2]} / {runs['xla'][2]}, "
                             f"expected {cfg.n_layers} / 0")
    out = {"request": req.req_id, "prompt": n, "steps": steps,
           "logit_diff": max(float((a - b).abs().max()) for a, b in zip(
               runs["cuda"][0], runs["xla"][0], strict=True))}
    for when, (a, b) in zip(("prefill", "decoded"),
                            zip(runs["cuda"][1], runs["xla"][1])):
        for k in ("conv", "ssm"):
            scale = float(b[k].abs().max())
            out[f"{k}_{when}_diff_over_max"] = \
                float((a[k] - b[k]).abs().max()) / scale
    worst = max(v for k, v in out.items() if k.endswith("_over_max"))
    if out["logit_diff"] > SERVE_LOGIT_TOL or worst > MAMBA_STATE_TOL:
        raise AssertionError(f"serving_mamba: kernel against plain scan "
                             f"{out}")
    return out


def run_serving_mamba(m, device, cfg, *, prompt_cap=SERVE_PROMPT,
                      gen_cap=SERVE_GEN, n_req=SERVE_REQUESTS,
                      slots=SERVE_SLOTS, queue=SERVE_QUEUE, mamba_impl=None):
    """Drive the serving path once with a Mamba stack and the scan kernel,
    counted and checked, then against the one-shot loop and, for two
    requests, the plain scan; time and profile it.  ``mamba_impl`` is the
    engine's scan path (``None``: what the device implies; a rehearsal on
    the CPU passes ``"cuda"`` to reach the scan wrapper's plain version).
    Returns (legs, the arguments of the longest prefill's first scan)."""
    M, serve, ops = m["M"], m["serve"], m["ops"]
    params = M.init_params(torch.Generator(device=device).manual_seed(0),
                           cfg)
    _sync(device)
    resident = _allocated(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    recorded = []

    for op in ops.values():
        op.launches = 0
    stores, tables = serve.feature_stores(m["make_context"](device), 0,
                                          max(slots, 8))
    lookups = count_lookups(stores)
    engine = m["ServingEngine"](
        cfg, params, slots=slots, prompt_capacity=prompt_cap,
        gen_capacity=gen_cap, queue_capacity=queue, feature_stores=stores,
        mamba_impl=mamba_impl, device=device)
    reqs = serve.make_requests(cfg, n_req, prompt_cap, gen_cap, seed=0)
    pick = [r.req_id for r in reqs if r.gen_len > 1][:2]
    rec = Recorder(engine, keep=set(pick))
    with recording_longest(ops["mamba_scan"], "selective_scan", recorded):
        done, rejected, seconds = serve.drive(engine, reqs, slots)
    _sync(device)
    launches = {k: op.launches for k, op in ops.items()}
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0) - resident

    mt = engine.metrics
    check_engine_run("serving_mamba", engine, done, rejected, reqs, tables,
                     stores)
    expect_launches("serving_mamba", launches, {
        "mamba_scan": cfg.n_layers * mt.count("prefills"),
        "hash_partition": store_chunks(serve, stores) + lookups[0],
        "radix_sort": 0})
    by_id = {r.req_id: r for r in done}
    oneshot = against_oneshot(m, cfg, params, rec, by_id, pick, device)
    plain_scan = [against_plain_scan(m, cfg, params, by_id[rid], prompt_cap,
                                     gen_cap, device) for rid in pick]

    # time one full-length prefill and one decode step of all slots
    prefill = M.make_slot_prefill(cfg, decode_len=prompt_cap + gen_cap)
    full = {"tokens": torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (1, prompt_cap)).astype(np.int32)).to(device)}
    step = M.make_serve_step(cfg)
    toks = torch.zeros((slots, 1), dtype=torch.int32, device=device)
    lens = np.full(slots, prompt_cap - 1, np.int32)
    prefill_ms = event_ms(lambda: prefill(params, full, prompt_cap), reps=5)
    step_ms = event_ms(lambda: step(params, engine.caches, toks, lens),
                       reps=10)

    def decode8():
        for _ in range(8):
            step(params, engine.caches, toks, lens)

    prof = profile_serving(m, {
        "prefill": lambda: prefill(params, full, prompt_cap),
        "decode_8_steps": decode8}, device,
        [(m["Ly"], "dense"), (m["Mb"], "_ssm_inputs"),
         (m["Ly"], "logits_out"), (ops["mamba_scan"], "selective_scan")],
        ("selective_scan", "mamba_scan_kernel"))
    busy = sum(p["device_busy_ms"] for p in prof.values()) \
        / sum(p["wall_ms"] for p in prof.values())
    tokens = mt.count("tokens_generated")
    emit({
        "phase": "serving_mamba", "arch": cfg.name, "layers": cfg.n_layers,
        "d_model": cfg.d_model, "d_inner": cfg.d_inner,
        "ssm_state": cfg.ssm_state, "slots": slots,
        "prompt_capacity": prompt_cap, "gen_capacity": gen_cap,
        "requests": n_req, "completed": mt.count("completed"),
        "prefills": mt.count("prefills"),
        "decode_steps": mt.count("decode_steps"), "tokens": tokens,
        "prompt_tokens": int(sum(len(r.prompt) for r in reqs)),
        "seconds": seconds, "tokens_per_s": tokens / seconds,
        "ttft_p50_ms": mt.percentile("ttft", 50) * 1e3,
        "ttft_p99_ms": mt.percentile("ttft", 99) * 1e3,
        "latency_p50_ms": mt.percentile("latency", 50) * 1e3,
        "latency_p99_ms": mt.percentile("latency", 99) * 1e3,
        "prefill_ms": prefill_ms, "decode_step_ms": step_ms,
        "peak_bytes_above_resident": peak, "resident_bytes": resident,
        "weight_bytes": sum(t.numel() * t.element_size()
                            for t in _leaves(params)),
        "cache_bytes": {k: v.numel() * v.element_size()
                        for k, v in engine.caches.items()},
        "feature_lookups": lookups[0], "dropped": 0, "launches": launches,
        "oneshot": oneshot, "plain_scan": plain_scan,
        "logit_tol": SERVE_LOGIT_TOL, "state_tol": MAMBA_STATE_TOL,
        "busy_share_prefill_plus_8_decode": busy, "profile": prof})
    legs = {"serving_mamba": dict(launches=launches, rows=n_req)}
    del params, engine, stores, prefill, step, full
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return legs, recorded[0]


def scan_cases(recorded, device, seed=4):
    """mamba_scan's cases: (a) the x, delta, A, B, C and D the longest
    prefill of the Mamba leg gave its first layer, with the final state;
    (b) that shape with random inputs; (c) ragged S = 1000; (d) S = 1;
    (e) B = 4; (f) N = 8; (g) y alone (no final state); (h) E = 8200, not
    a multiple of the kernel's 32-channel tile; (i) S = 961, one past a
    multiple of its 64-step time chunk.  No PyTorch call computes the
    selective scan, so there is no library time."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def rand(B, S, E, N):
        def r(*shape):
            return torch.randn(shape, generator=gen, device=device)
        return (r(B, S, E), torch.nn.functional.softplus(r(B, S, E)),
                -torch.exp(r(E, N) * 0.5), r(B, S, N), r(B, S, N), r(E))

    x = recorded[0]
    B, S, E = x.shape
    N = recorded[2].shape[1]
    cases = [dict(shape=f"(a) serving prefill x {tuple(x.shape)} N {N} "
                        "with hT", args=tuple(recorded))]
    for label, shape, state in (("(b)", (B, S, E, N), True),
                                ("(c)", (1, 1000, E, N), True),
                                ("(d)", (1, 1, E, N), True),
                                ("(e)", (4, 1024, E, N), True),
                                ("(f)", (1, 1024, E, 8), True),
                                ("(g)", (1, 1024, E, N), False),
                                ("(h)", (1, 1024, 8200, N), True),
                                ("(i)", (1, 961, E, N), True)):
        cases.append(dict(
            shape=f"{label} B {shape[0]} S {shape[1]} E {shape[2]} "
                  f"N {shape[3]} {'with hT' if state else 'y alone'}",
            args=(*rand(*shape), state)))
    return cases


def _scan_close(case, got, want) -> float:
    """Each output finite and within SCAN_TOL (absolute and relative) of
    the plain version; returns the largest absolute difference."""
    err = 0.0
    for g, w in zip(got, want, strict=True):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"mamba_scan {case['shape']}: {g.dtype} "
                                 f"{tuple(g.shape)}")
        diff = (g - w).abs()
        if not bool(torch.isfinite(g).all()) \
                or bool((diff > SCAN_TOL * (1 + w.abs())).any()):
            raise AssertionError(f"mamba_scan {case['shape']}: differs from "
                                 f"selective_scan_ref by {float(diff.max())}")
        err = max(err, float(diff.max()) if diff.numel() else 0.0)
    return err


# --------------------------------------------------------------------------
# timings
# --------------------------------------------------------------------------


def time_leg(run, device, reps=3):
    """Median host seconds of ``reps`` warmed runs, each ended by a
    synchronize, and the peak device memory the runs add to what is
    resident before them (the leg's input tables, the other legs' and the
    kernel cases): (seconds, peak bytes above resident, resident bytes)."""
    run()
    _sync(device)
    torch.cuda.reset_peak_memory_stats(device)
    resident = torch.cuda.memory_allocated(device)
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        run()
        _sync(device)
        ts.append(time.perf_counter() - t0)
    return (float(np.median(ts)),
            torch.cuda.max_memory_allocated(device) - resident, resident)


def profile_leg(run, top=8):
    """One warmed run under torch.profiler: the device's busy share of the
    run's wall time and the device kernels that took most of it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    kernels.sort(key=lambda e: -e.self_device_time_total)

    def row(e):
        return {"name": e.key[:80], "count": e.count,
                "device_ms": e.self_device_time_total / 1e3}

    return {"wall_ms": wall_us / 1e3, "device_busy_ms": busy_us / 1e3,
            "device_busy_share": busy_us / wall_us,
            "top_kernels": [row(e) for e in kernels[:top]],
            "port_kernels": [row(e) for e in kernels
                             if any(f"{k}_kernel" in e.key
                                    for k in PORT_KERNEL_FNS)]}


def event_ms(fn, reps=10):
    """CUDA-event milliseconds per call over ``reps`` warmed calls."""
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


def port_kernel_ms(fn, reps=5, tries=3):
    """Device milliseconds of the port's kernels that one call of ``fn``
    launches, each once: their sum and each by name, from
    ``torch.profiler`` over ``reps`` warmed calls, as each kernel's mean
    over the launches the profile recorded (it may drop some, or all: a
    profile that recorded none is taken again, up to ``tries`` times).
    (None, {}) when none recorded any."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    mine = {}
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        mine = {e.key[:100]: e.self_device_time_total / 1e3 / e.count
                for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and e.count
                and any(f"{k}_kernel" in e.key for k in PORT_KERNEL_FNS)}
        if mine:
            break
    return (sum(mine.values()) if mine else None), mine


def bound(name, args):
    """(least milliseconds, what bounds it): each input read once, each
    output written once, at the device memory rate; the key compares and
    value updates at the float32 rate, counted for this run's data."""
    if name == "radix_sort" and len(args) == 5:
        _, words, _, bits, _ = args
        n = words.numel()
        # words and perm in, both out in the new order (the cases keep the
        # words), and the pass's (2^bits,) histogram out; the per-block
        # histograms are the kernels' scratch, not the function's
        nbytes = 16 * n + 4 * (1 << bits)
        ops = n
    elif name == "radix_sort":
        words, _, bits, _ = args
        n = words.numel()
        # words in; ranks and the pass's (2^bits,) histogram out
        nbytes = 4 * n + 4 * n + 4 * (1 << bits)
        ops = n
    elif name == "hash_groupby":
        kb, occ, vals = args
        B, K, C = kb.shape
        V = vals.shape[1]
        # the occupancy and the keys and values of the occupied slots in
        # (an empty slot's results do not depend on its keys or values),
        # every slot's results out; each occupied slot is compared with
        # the occupied slots of its bucket
        filled = (occ > 0).sum(1).double()
        nbytes = 4 * (B * C + int(filled.sum()) * (K + V)) \
            + 4 * B * C * (2 + 3 * V)
        pairs = int((filled ** 2).sum())
        ops = pairs * (K + 2 + 3 * V)
    elif name == "flash_attention":
        # q, k, v in and the output out, once each (bf16); 4 D operations
        # (the two products) for each live (query, key) pair
        q, k, v, causal = args
        B, Hq, Sq, D = q.shape
        Skv = k.shape[2]
        nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())
        live = sum(min(Skv, i + Skv - Sq + 1) for i in range(Sq)) \
            if causal else Sq * Skv
        t_bytes = nbytes / BYTES_PER_S * 1e3
        t_ops = 4 * D * B * Hq * live / BF16_OPS_PER_S * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops \
            else (t_ops, "operations")
    elif name == "mamba_scan":
        # x and y once each, delta, A, B, C and D read once, hT written
        # once when asked; B S E N exponentials at the special-function
        # rate and 5 float32 operations each (the decay, the two products
        # of the update, the product with C and its sum)
        x, delta, A, Bm, Cm, D, with_state = args
        Bsz, S, E = x.shape
        N = A.shape[1]
        nbytes = 2 * x.numel() * x.element_size() + 4 * (
            delta.numel() + A.numel() + Bm.numel() + Cm.numel() + D.numel()
            + (Bsz * E * N if with_state else 0))
        cells = Bsz * S * E * N
        t_bytes = nbytes / BYTES_PER_S * 1e3
        t_ops = max(cells / EXP_PER_S, 5 * cells / OPS_PER_S) * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops \
            else (t_ops, "operations")
    elif name == "hash_partition":
        pid, P = args
        n = pid.numel()
        nbytes, ops = 4 * n + 4 * P + 4 * n, n
    elif name == "fused_bucketing":
        bits, valid, P = args
        n, K = valid.numel(), len(bits)
        nbytes = 4 * K * n + n + 4 * n + 4 * (P + 1) + 4 * n
        ops = 12 * K * n
    elif name == "hash_semi":
        pb, po, bb, bo = args
        B, K, Lc = pb.shape
        # both occupancy slabs and the key planes of the occupied slots in,
        # one member flag per probe slot out; each occupied slot's key
        # compared once (a hash table meets about one key a probe)
        occupied = int((po > 0).sum()) + int((bo > 0).sum())
        nbytes = 4 * (po.numel() + bo.numel() + B * Lc + K * occupied)
        ops = K * occupied
    else:
        pb, po, bb, bo = args
        B, K, Lc = pb.shape
        C = bb.shape[2]
        nbytes = 4 * (pb.numel() + po.numel() + bb.numel() + bo.numel()
                      + B * Lc + B * Lc * C)
        ops = B * Lc * C * K
    t_bytes, t_ops = nbytes / BYTES_PER_S * 1e3, ops / OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def library_times(m, cases, gdata, sizes, device) -> dict:
    """One PyTorch call beside a kernel: a stable ``argsort`` of the ids,
    which gives their stable within-partition order, beside
    ``hash_partition`` (10 M pids, P = 2) and ``fused_bucketing`` (the
    bucket ids of its first case); a stable ``argsort`` of the 20 M-row
    words beside the radix pass and the port's ``radix_permutation`` of
    the same key (5 passes); the sort-backend local groupby beside the
    hash-backend one on the groupby leg's rows; ``torch.isin`` of the drug
    filter's probe keys against its build keys;
    ``scaled_dot_product_attention`` on the q, k, v of the serving leg's
    prefill."""
    L, rs = m["L"], m["ops"]["radix_sort"]
    pid = cases["hash_partition"][0]["args"][0]
    bid = m["fb_ref"].fused_bucket_ranks_ref(
        *cases["fused_bucketing"][0]["args"])[0]
    words = cases["radix_sort"][0]["args"][1]
    none = torch.zeros(words.shape[0], dtype=torch.bool, device=device)
    out = {"hash_partition": {"library_ms": event_ms(
               lambda: torch.argsort(pid, stable=True), reps=5)},
           "fused_bucketing": {"library_ms": event_ms(
               lambda: torch.argsort(bid, stable=True), reps=10)},
           "radix_sort": {
        "library_ms": event_ms(lambda: torch.argsort(words, stable=True),
                               reps=5),
        "radix_permutation_ms": event_ms(
            lambda: rs.radix_permutation((words,), none), reps=5)}}
    t = m["D"].distribute_table(m["make_context"](), gdata)
    out["hash_groupby"] = {
        "library_ms": event_ms(lambda: L.groupby_aggregate(
            t, ["k"], AGGS, impl="sort"), reps=3),
        "hash_groupby_local_ms": event_ms(lambda: L.groupby_aggregate(
            t, ["k"], AGGS, impl="hash", may_plan=False, **sizes), reps=3)}
    probe, build = cases["hash_semi"][0]["library"]
    out["hash_semi"] = {"library_ms": event_ms(
        lambda: torch.isin(probe, build), reps=5)}
    out["flash_attention"] = {"library_ms": event_ms(
        cases["flash_attention"][0]["library"], reps=20)}
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 2
    m = _modules()
    device = torch.device("cuda")
    name = card()
    print(name, flush=True)

    t0 = time.perf_counter()
    libs = m["build"].build()
    build_s = time.perf_counter() - t0
    emit({"phase": "build", "seconds": build_s, "card": name,
          "libraries": [p.name for p in libs.values()]})
    for lib in libs.values():
        for line in lib.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "smem" in line or "spill" in line:
                print("ptxas:", lib.stem, line.strip(), flush=True)

    ctx = m["make_context"]()
    hash_plan = m["D"].plan_dist_join_sizes(
        *[[side["k"]] for side in fig4_data(HASH_ROWS)], world=1,
        local_impl="hash")
    gdata = groupby_data(GROUPBY_ROWS, GROUPBY_KEYS)
    sizes = plan_groupby_sizes(m, gdata)
    loads = np.bincount(m["bucketing"].bucket_ids_np(
        [gdata["k"]], sizes["num_buckets"]), minlength=sizes["num_buckets"])
    cases = kernel_cases(m, device, hash_plan, sizes, loads)
    errs = compare_kernels(m, cases, device)
    emit({"kernels": list(KERNELS)})

    legs = run_legs(m, ctx, SORTMERGE_ROWS, HASH_ROWS, device)
    legs.update(run_table5(m, ctx, device, gdata, sizes))
    raw = unomt_data(m, UNOMT_ROWS, UNOMT_DRUGS, UNOMT_CELLS)
    unomt_legs, slabs = run_unomt(m, ctx, device, raw)
    legs.update(unomt_legs)
    setop_legs, setop_slabs = run_setops(
        m, ctx, device, *setop_data(*SETOP_ROWS, SETOP_KEYS))
    legs.update(setop_legs)
    cases["hash_semi"] = semi_cases(slabs + setop_slabs, device)
    errs.update(compare_kernels(m, {"hash_semi": cases["hash_semi"]},
                                device))
    serving_legs, qkv = run_serving(m, device, m["get_config"](SERVE_ARCH))
    legs.update(serving_legs)
    cases["flash_attention"] = flash_cases(qkv, device)
    errs.update(compare_kernels(
        m, {"flash_attention": cases["flash_attention"]}, device))
    mamba_legs, scan_args = run_serving_mamba(
        m, device, m["get_config"](MAMBA_ARCH))
    legs.update(mamba_legs)
    cases["mamba_scan"] = scan_cases(scan_args, device)
    errs.update(compare_kernels(
        m, {"mamba_scan": cases["mamba_scan"]}, device))

    for leg, info in legs.items():
        if "run" not in info:          # the serving legs time themselves
            continue
        seconds, peak, resident = time_leg(info["run"], device)
        emit({"phase": "timing", "leg": leg, "rows": info["rows"],
              "median_s": seconds, "peak_bytes_above_resident": peak,
              "resident_bytes": resident, "card": name})
        emit({"phase": "profile", "leg": leg, "card": name,
              **profile_leg(info["run"])})

    library = library_times(m, cases, gdata, sizes, device)
    table = []
    for kname in KERNELS:
        case = cases[kname][0]
        args = case["args"]
        ms = event_ms(lambda: _kernel(m, kname, args))
        plain_ms = event_ms(lambda: _plain(m, kname, args), reps=3)
        bound_ms, bound_by = bound(kname, args)
        op = m["ops"][kname]
        extra = library.get(kname, {"library_ms": None})
        row = {"name": kname, "route": "cuda", "source": op.SOURCE,
               "replaces": op.REPLACES,
               "launches": sum(leg["launches"][kname]
                               for leg in legs.values()),
               "max_abs_err": errs[kname], "ms": ms, "plain_ms": plain_ms,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "library_ms": extra["library_ms"]}
        kernel_ms, by_name = port_kernel_ms(lambda: _kernel(m, kname, args))
        emit(dict(row, phase="kernel_timing", shape=case["shape"],
                  card=name, per_leg={leg: info["launches"][kname]
                                      for leg, info in legs.items()},
                  kernel_ms=kernel_ms, kernel_ms_by_name=by_name,
                  **{k: v for k, v in extra.items() if k != "library_ms"}))
        table.append(row)
    for kname in KERNELS:
        for extra in cases[kname][1:]:
            lib = extra.get("library")
            if kname == "hash_semi" and lib is not None:
                lib = (lambda p=lib[0], b=lib[1]: torch.isin(p, b))
            emit({"phase": "kernel_timing", "name": kname,
                  "shape": extra["shape"], "card": name,
                  "ms": event_ms(lambda: _kernel(m, kname, extra["args"])),
                  "kernel_ms": port_kernel_ms(
                      lambda: _kernel(m, kname, extra["args"]))[0],
                  "plain_ms": event_ms(
                      lambda: _plain(m, kname, extra["args"]), reps=3),
                  "bound_ms": bound(kname, extra["args"])[0],
                  "library_ms": event_ms(lib) if lib else None})

    emit({"kernels": table})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
