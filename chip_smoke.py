"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. build the three CUDA kernels from ``src/repro_torch/kernels/csrc``;
2. hold each kernel against its plain PyTorch version at the main path's
   shapes, exactly (they are integer kernels);
3. the paper's Fig. 4 join with the sortmerge backend, 10 M rows per
   side at world 1, checked against the keys and a float64 sum;
4. the same join with the hash backend at 500 k rows per side, which
   must be bit-identical to a sortmerge run on the same data;
5. timings: each leg's median of 3 warmed runs and peak memory, and each
   kernel's CUDA-event time beside its plain version and its bound.

The launch counters are set to 0 just before each leg's first run and
read just after it.  The line before the last is the kernel table; the
last line is ``{"ok": true, "device": {...}}``.  Exits non-zero without a
result when there is no CUDA device.
"""
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SORTMERGE_ROWS = 10_000_000
HASH_ROWS = 500_000
BYTES_PER_S = 3.35e12          # H100 SXM device memory rate
OPS_PER_S = 67e12              # H100 SXM float32 rate outside tensor cores
KERNELS = ("hash_partition", "fused_bucketing", "hash_join")


def _modules():
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import dist_ops
    from repro_torch.core.context import make_context
    from repro_torch.kernels import build
    from repro_torch.kernels.fused_bucketing import ops as fb_ops
    from repro_torch.kernels.fused_bucketing import ref as fb_ref
    from repro_torch.kernels.hash_join import ops as hj_ops
    from repro_torch.kernels.hash_join import ref as hj_ref
    from repro_torch.kernels.hash_partition import ops as hp_ops
    from repro_torch.kernels.hash_partition import ref as hp_ref
    return dict(D=dist_ops, make_context=make_context, build=build,
                ops={"hash_partition": hp_ops, "fused_bucketing": fb_ops,
                     "hash_join": hj_ops},
                hp_ref=hp_ref, fb_ref=fb_ref, hj_ref=hj_ref)


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


# --------------------------------------------------------------------------
# kernel inputs at the main path's shapes
# --------------------------------------------------------------------------


def kernel_cases(device, hash_plan, scale=1.0, seed=1):
    """The inputs each kernel gets on the legs: hash_partition at P = 2
    (the world-1 shuffle's live + trash partitions) on 10 M rows and at
    P = 513 (a 512-bucket ranking) on 625 k rows; fused_bucketing at 512
    buckets on 625 k rows with one int plane and with two float planes
    (-0.0 and NaN included); hash_join on the 500 k leg's slab shapes."""
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
    return cases


def _plain(m, name, args, chunk=32):
    """The plain version on the same inputs; hash_join in chunks of
    buckets to bound its memory."""
    if name == "hash_partition":
        return m["hp_ref"].radix_histogram_ranks_ref(*args)
    if name == "fused_bucketing":
        return m["fb_ref"].fused_bucket_ranks_ref(*args)
    pb, po, bb, bo = args
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
    return op.bucket_probe(*args)


def compare_kernels(m, cases, device) -> dict:
    """Kernel == plain version, exactly, on every case; returns the
    largest absolute difference per kernel (0)."""
    errs = {}
    for name, runs in cases.items():
        errs[name] = 0
        for case in runs:
            got = _kernel(m, name, case["args"])
            want = _plain(m, name, case["args"])
            _sync(device)
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


def fig4_leg(m, ctx, left, right, impl, plan):
    """(run, tables): ``run()`` drives ``dist_join`` once through the
    pipeline on the distributed tables."""
    D = m["D"]
    pipe = D.DistributedPipeline(ctx, lambda c, a, b: D.dist_join(
        c, a, b, left_on=["k"], out_capacity=plan["out_capacity"],
        shuffle_sizes=plan["shuffle_sizes"], local_impl=impl,
        local_join_sizes=plan["local_join_sizes"]))
    gl = m["D"].distribute_table(ctx, left)
    gr = m["D"].distribute_table(ctx, right)
    return lambda: pipe(gl, gr)


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
    if min(launches.values()) < 1:
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
# timings
# --------------------------------------------------------------------------


def time_leg(run, device, reps=3):
    """Median host seconds of ``reps`` warmed runs, each ended by a
    synchronize, and the peak device memory over them."""
    run()
    _sync(device)
    torch.cuda.reset_peak_memory_stats(device)
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        run()
        _sync(device)
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)), torch.cuda.max_memory_allocated(device)


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
    return {"wall_ms": wall_us / 1e3, "device_busy_ms": busy_us / 1e3,
            "device_busy_share": busy_us / wall_us,
            "top_kernels": [{"name": e.key[:80], "count": e.count,
                             "device_ms": e.self_device_time_total / 1e3}
                            for e in kernels[:top]]}


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


def bound(name, args):
    """(least milliseconds, what bounds it): each input read once, each
    output written once, at the device memory rate; the key compares at
    the float32 rate."""
    if name == "hash_partition":
        pid, P = args
        n = pid.numel()
        nbytes, ops = 4 * n + 4 * P + 4 * n, n
    elif name == "fused_bucketing":
        bits, valid, P = args
        n, K = valid.numel(), len(bits)
        nbytes = 4 * K * n + n + 4 * n + 4 * (P + 1) + 4 * n
        ops = 12 * K * n
    else:
        pb, po, bb, bo = args
        B, K, Lc = pb.shape
        C = bb.shape[2]
        nbytes = 4 * (pb.numel() + po.numel() + bb.numel() + bo.numel()
                      + B * Lc + B * Lc * C)
        ops = B * Lc * C * K
    t_bytes, t_ops = nbytes / BYTES_PER_S * 1e3, ops / OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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
            if "registers" in line or "smem" in line:
                print("ptxas:", lib.stem, line.strip(), flush=True)

    ctx = m["make_context"]()
    hash_plan = m["D"].plan_dist_join_sizes(
        *[[side["k"]] for side in fig4_data(HASH_ROWS)], world=1,
        local_impl="hash")
    cases = kernel_cases(device, hash_plan)
    errs = compare_kernels(m, cases, device)
    emit({"kernels": list(KERNELS)})

    legs = run_legs(m, ctx, SORTMERGE_ROWS, HASH_ROWS, device)

    for leg, info in legs.items():
        seconds, peak = time_leg(info["run"], device)
        emit({"phase": "timing", "leg": leg, "rows_per_side": info["rows"],
              "median_s": seconds, "max_memory_allocated": peak,
              "card": name})
        emit({"phase": "profile", "leg": leg, "card": name,
              **profile_leg(info["run"])})

    table = []
    for kname in KERNELS:
        case = cases[kname][0]
        args = case["args"]
        ms = event_ms(lambda: _kernel(m, kname, args))
        plain_ms = event_ms(lambda: _plain(m, kname, args), reps=3)
        bound_ms, bound_by = bound(kname, args)
        op = m["ops"][kname]
        row = {"name": kname, "route": "cuda", "source": op.SOURCE,
               "replaces": op.REPLACES,
               "launches": sum(leg["launches"][kname]
                               for leg in legs.values()),
               "max_abs_err": errs[kname], "ms": ms, "plain_ms": plain_ms,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "library_ms": None, "shape": case["shape"], "card": name}
        emit(dict(row, phase="kernel_timing"))
        table.append(row)
    for kname in ("hash_partition", "fused_bucketing"):
        extra = cases[kname][1]
        emit({"phase": "kernel_timing", "name": kname,
              "shape": extra["shape"], "card": name,
              "ms": event_ms(lambda: _kernel(m, kname, extra["args"])),
              "plain_ms": event_ms(lambda: _plain(m, kname, extra["args"]),
                                   reps=3),
              "bound_ms": bound(kname, extra["args"])[0]})

    emit({"kernels": table})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
