"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test is marked ``gpu`` and skips without a CUDA device; the
file imports neither JAX nor the JAX package, so it runs on a machine
that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import local_ops as L
from repro_torch.core.table import Table
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.fused_bucketing import fused_bucket_ranks
from repro_torch.kernels.fused_bucketing import ops as fb_ops
from repro_torch.kernels.fused_bucketing.ref import (bucket_ids,
                                                     fused_bucket_ranks_ref)
from repro_torch.kernels.hash_groupby.ops import bucket_accumulate
from repro_torch.kernels.hash_groupby.ref import bucket_accumulate_ref
from repro_torch.kernels.hash_join.ops import bucket_probe
from repro_torch.kernels.hash_join.ref import bucket_probe_ref
from repro_torch.kernels.hash_semi import ops as hs_ops
from repro_torch.kernels.hash_semi.ref import bucket_member_ref
from repro_torch.kernels.hash_partition import ops as hp_ops
from repro_torch.kernels.hash_partition import radix_histogram_ranks
from repro_torch.kernels.hash_partition.ref import radix_histogram_ranks_ref
from repro_torch.kernels.mamba_scan import ops as scan_ops
from repro_torch.kernels.mamba_scan.ref import selective_scan_ref
from repro_torch.kernels.radix_sort import ops as rs_ops
from repro_torch.kernels.radix_sort.ref import (digit_histogram_ranks_ref,
                                                scatter_pass_ref)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are built with nvcc for "
                    "sm_90a and have no CPU mode")
    return torch.device("cuda")


def on(device, a):
    return torch.from_numpy(np.array(a)).to(device)


def key_planes(rng, n, k, kind):
    """K int32 bit-planes: negative ints, or float bits with -0.0/NaN."""
    if kind == "int":
        return [rng.integers(-40, 40, n).astype(np.int32) for _ in range(k)]
    vals = np.array([0.0, -0.0, np.nan, 1.5, -2.25, np.inf], np.float32)
    return [rng.choice(vals, n).view(np.int32) for _ in range(k)]


def equal(got, want):
    return all(g.dtype == w.dtype and torch.equal(g, w)
               for g, w in zip(got, want))


@pytest.mark.parametrize("P", [2, 9, 513])
@pytest.mark.parametrize("n", [1, 1023, 1024, 5000])
def test_hash_partition_equals_plain(cuda, P, n, rng):
    pid = on(cuda, rng.integers(0, P, n).astype(np.int32))
    pid[::7] = -1                     # outside [0, P): uncounted, rank 0
    assert equal(radix_histogram_ranks(pid, P),
                 radix_histogram_ranks_ref(pid, P))


@pytest.mark.parametrize("P", [1, 3, 16])
def test_plan_partitions_launches_the_kernel(cuda, P, rng):
    """``core.partition.plan_partitions`` on a CUDA table: one launch of
    the kernel, (hist, dest, pid) equal to the same table's on the CPU."""
    from repro_torch.core.partition import plan_partitions
    cols = {"k": rng.integers(-50, 50, 5000).astype(np.int32),
            "f": rng.choice(np.array([0.0, -0.0, 1e-40, 2.5], np.float32),
                            5000)}
    before = hp_ops.launches
    got = plan_partitions(Table.from_dict(cols, 6000, device=cuda),
                          ["k", "f"], P, impl="cuda")
    assert hp_ops.launches == before + 1
    want = plan_partitions(Table.from_dict(cols, 6000, device="cpu"),
                           ["k", "f"], P)
    assert equal([g.cpu() for g in got], want)


@pytest.mark.parametrize("P", [2, 9, 512])
@pytest.mark.parametrize("K,kind", [(1, "int"), (2, "float")])
def test_fused_bucketing_equals_plain(cuda, P, K, kind, rng):
    planes = tuple(on(cuda, p) for p in key_planes(rng, 3000, K, kind))
    valid = on(cuda, rng.random(3000) < 0.8)
    assert equal(fused_bucket_ranks(planes, valid, P),
                 fused_bucket_ranks_ref(planes, valid, P))


def plain_ranks_by_chunks(pid, P, chunk=16):
    """radix_histogram_ranks_ref over ``chunk`` partitions at a time, so
    its (P, n) one-hot stays small at millions of rows: ids of other
    chunks become -1, which the plain version neither counts nor ranks."""
    hists, ranks = [], torch.zeros_like(pid)
    for p0 in range(0, P, chunk):
        width = min(chunk, P - p0)
        local = torch.where((pid >= p0) & (pid < p0 + width), pid - p0, -1)
        h, r = radix_histogram_ranks_ref(local, width)
        hists.append(h)
        ranks += r
    return torch.cat(hists), ranks


# blocks of the counting pass walk 2 tiles of 2048 rows from 2048 tiles
# on and 4 from 4096; the last block and its last tile are ragged; every
# 7th id is -1 and every 11th P, neither counted nor ranked
@pytest.mark.parametrize("P", [2, 9, 513])
@pytest.mark.parametrize("n", [4_200_001, 8_400_003])
def test_hash_partition_many_tiles_per_block(cuda, P, n, rng):
    pid = on(cuda, rng.integers(0, P, n).astype(np.int32))
    pid[::7] = -1
    pid[3::11] = P
    before = hp_ops.launches
    got = radix_histogram_ranks(pid, P)
    assert hp_ops.launches == before + 1
    assert equal(got, plain_ranks_by_chunks(pid, P))


@pytest.mark.parametrize("P", [2, 5])
def test_hash_partition_past_the_folded_offsets(cuda, P, rng):
    """Past 2896 blocks of 8192 rows at P = 2 the few-id downsweep reads
    offsets from the scan kernel instead of summing the blocks before
    it."""
    n = 24_000_003
    pid = on(cuda, rng.integers(0, P, n).astype(np.int32))
    pid[::7] = -1
    assert equal(radix_histogram_ranks(pid, P),
                 radix_histogram_ranks_ref(pid, P))


@pytest.mark.parametrize("P", [2, 9, 512])
def test_fused_bucketing_many_tiles_per_block(cuda, P, rng):
    """K 3 key planes (passed by address), 4.2 M rows (blocks of 2
    tiles), 20 % invalid."""
    n = 4_200_001
    planes = tuple(on(cuda, p) for p in key_planes(rng, n, 3, "int"))
    valid = on(cuda, rng.random(n) < 0.8)
    before = fb_ops.launches
    got = fused_bucket_ranks(planes, valid, P)
    assert fb_ops.launches == before + 1
    bid = torch.where(valid, bucket_ids(planes, P), P)
    assert equal(got, (bid, *plain_ranks_by_chunks(bid, P + 1)))


def test_fused_bucketing_past_the_planes_passed_by_address(cuda, rng):
    """More key planes than the kernel's parameters hold: one stacked
    copy."""
    K = fb_ops._entry()[1] + 3
    planes = tuple(on(cuda, p) for p in key_planes(rng, 5000, K, "int"))
    valid = on(cuda, rng.random(5000) < 0.8)
    assert equal(fused_bucket_ranks(planes, valid, 9),
                 fused_bucket_ranks_ref(planes, valid, 9))


# (600, 2600, 8): 32 probe slots per warp and blocks that walk more than
# one group of 256 slots
@pytest.mark.parametrize("K", [1, 2])
@pytest.mark.parametrize("B,Lc,C", [(3, 70, 33), (64, 16, 200),
                                    (600, 2600, 8)])
def test_hash_join_equals_plain(cuda, B, K, Lc, C, rng):
    args = (on(cuda, rng.integers(-3, 3, (B, K, Lc)).astype(np.int32)),
            on(cuda, (rng.random((B, Lc)) < 0.8).astype(np.int32)),
            on(cuda, rng.integers(-3, 3, (B, K, C)).astype(np.int32)),
            on(cuda, (rng.random((B, C)) < 0.8).astype(np.int32)))
    assert equal(bucket_probe(*args), bucket_probe_ref(*args))


def pooled_slabs(rng, B, K, Lc, C):
    """Probe and build slabs whose keys come from a pool of 8 K-plane
    vectors per bucket (the build side uses the first 6, so some probes
    miss); bucket 0 has no occupied slot, bucket 1 every slot occupied."""
    pool = rng.integers(-4, 4, (B, K, 8)).astype(np.int32)
    pp = rng.integers(0, 8, (B, 1, Lc))
    bp = rng.integers(0, 6, (B, 1, C))
    pbits = np.take_along_axis(pool, np.repeat(pp, K, 1), 2)
    bbits = np.take_along_axis(pool, np.repeat(bp, K, 1), 2)
    pocc = (rng.random((B, Lc)) < 0.8).astype(np.int32)
    bocc = (rng.random((B, C)) < 0.8).astype(np.int32)
    pocc[0], bocc[0] = 0, 0
    if B > 1:
        pocc[1], bocc[1] = 1, 1
    return pbits, pocc, bbits, bocc


# C = 30000 at K = 1 and 2500 at K = 2: tables past shared memory, in
# the workspace; K = 33 and 40: planes past the hashed ones; B = 600,
# Lc = 2600: blocks that take more than one round of probe slots
@pytest.mark.parametrize("K,B,Lc,C", [(1, 4, 100, 33), (2, 64, 16, 200),
                                      (33, 6, 70, 150), (40, 3, 130, 300),
                                      (1, 3, 90, 30000), (2, 3, 40, 2500),
                                      (1, 600, 2600, 40), (2, 600, 2600, 40)])
def test_hash_semi_equals_plain(cuda, K, B, Lc, C, rng):
    args = tuple(on(cuda, a) for a in pooled_slabs(rng, B, K, Lc, C))
    before = hs_ops.launches
    got = hs_ops.bucket_member(*args)
    assert hs_ops.launches == before + 1
    want = bucket_member_ref(*args)
    assert got.dtype == torch.int32 and torch.equal(got, want)
    assert 0 < int(want.sum()) < want.numel()
    assert not got[0].any()


def test_hash_semi_without_build_slots_launches_nothing(cuda):
    before = hs_ops.launches
    got = hs_ops.bucket_member(
        torch.ones((2, 1, 8), dtype=torch.int32, device=cuda),
        torch.ones((2, 8), dtype=torch.int32, device=cuda),
        torch.ones((2, 1, 0), dtype=torch.int32, device=cuda),
        torch.ones((2, 0), dtype=torch.int32, device=cuda))
    assert hs_ops.launches == before and not got.any()


def member_slabs(rng, B, K, Lc, C, build_keys=6, probe_keys=12, fill=0.8,
                 prefix=False, shared_planes=0, values=None):
    """Membership slabs: each bucket's build keys are drawn from the first
    ``build_keys`` of a pool of ``probe_keys`` K-plane vectors, its probe
    keys from the whole pool, so some probes miss.  The pool's planes are
    int32 over their whole range, or drawn from ``values`` (an array, or
    "multiples" of B), and its first ``shared_planes`` planes are one
    value for every key.  Slots are occupied with probability ``fill``,
    scattered or (``prefix``) as a prefix; bucket 0 has no occupied slot
    and, where B > 1, bucket 1 has every slot occupied."""
    shape = (B, K, probe_keys)
    if values is None:
        pool = rng.integers(-2**31, 2**31, shape, dtype=np.int64)
    elif isinstance(values, str):          # every key a multiple of B
        pool = B * rng.integers(-2**31 // B, 2**31 // B, shape)
    else:
        pool = rng.choice(np.asarray(values, np.int64), shape)
    pool[:, :shared_planes] = 7
    pool = pool.astype(np.int32)

    def side(L, keys):
        pick = np.repeat(rng.integers(0, keys, (B, 1, L)), K, 1)
        if prefix:
            occ = np.arange(L)[None] < rng.binomial(L, fill, B)[:, None]
        else:
            occ = rng.random((B, L)) < fill
        occ[0] = False
        if B > 1:
            occ[1] = True
        return np.take_along_axis(pool, pick, 2), occ.astype(np.int32)

    pbits, pocc = side(Lc, probe_keys)
    bbits, bocc = side(C, build_keys)
    return pbits, pocc, bbits, bocc


def member_equals_plain(args, nontrivial=True):
    """One launch, bit for bit the plain version, bucket 0 all zero; with
    ``nontrivial``, some occupied probe slots hit and some miss."""
    before = hs_ops.launches
    got = hs_ops.bucket_member(*args)
    assert hs_ops.launches == before + 1
    want = bucket_member_ref(*args)
    assert got.dtype == torch.int32 and torch.equal(got, want)
    assert not got[0].any()
    if nontrivial:
        assert 0 < int(want.sum()) < int((args[1] > 0).sum())


INT32_EXTREMES = [-2**31, -2**31 + 1, -1, 0, 1, 2**31 - 2, 2**31 - 1]


# the edges of the hash-table kernel: keys repeated in the build side,
# keys equal on their first planes (past the 4 hashed ones at K = 5),
# keys sharing their bucket's hash bits, holes and prefixes, Lc not a
# multiple of 4 (scalar path) and past one block's round, int32 extremes
@pytest.mark.parametrize("case", [
    dict(B=64, K=1, Lc=300, C=200, build_keys=40, probe_keys=80),
    dict(B=32, K=2, Lc=200, C=100, build_keys=20, probe_keys=40,
         shared_planes=1),
    dict(B=32, K=3, Lc=200, C=100, build_keys=20, probe_keys=40,
         shared_planes=2),
    dict(B=32, K=5, Lc=200, C=100, build_keys=20, probe_keys=40,
         shared_planes=4),
    dict(B=512, K=1, Lc=64, C=300, build_keys=120, probe_keys=240,
         values="multiples"),
    dict(B=64, K=1, Lc=256, C=100, fill=0.5),
    dict(B=64, K=2, Lc=256, C=100, fill=0.3, prefix=True),
    dict(B=8, K=1, Lc=1, C=50),
    dict(B=8, K=1, Lc=3, C=50),
    dict(B=8, K=2, Lc=5, C=50),
    dict(B=8, K=1, Lc=4097, C=50, prefix=True),
    dict(B=16, K=1, Lc=64, C=32, build_keys=3, probe_keys=7,
         values=INT32_EXTREMES),
    dict(B=16, K=2, Lc=64, C=32, build_keys=20, probe_keys=40,
         values=INT32_EXTREMES),
], ids=["repeated-build-keys", "K2-same-plane0", "K3-same-planes01",
        "K5-same-planes0123", "multiples-of-B", "holes", "prefix-K2",
        "Lc1", "Lc3", "Lc5-K2", "Lc4097", "int32-extremes",
        "int32-extremes-K2"])
def test_hash_semi_edge_slabs(cuda, case, rng):
    args = tuple(on(cuda, a) for a in member_slabs(rng, **case))
    member_equals_plain(args, nontrivial=case["B"] * case["Lc"] >= 64)


# tables past shared memory go to the workspace, built once per bucket in
# device memory; C // 5 distinct build keys fill at most a tenth of each
# table
@pytest.mark.parametrize("B", [3, 600])
@pytest.mark.parametrize("K,C", [(1, 30000), (1, 70000), (2, 2500)])
def test_hash_semi_tables_in_the_workspace(cuda, B, K, C, rng):
    args = tuple(on(cuda, a) for a in member_slabs(
        rng, B, K, 90 if B == 3 else 20, C, build_keys=C // 5,
        probe_keys=2 * C // 5))
    assert hs_ops._entry()[1](B, C) > 0
    member_equals_plain(args)


def test_hash_semi_unaligned_rows(cuda, rng):
    """Probe slabs whose base is 4 bytes past a 16-byte boundary (Lc a
    multiple of 4): the scalar path."""
    pbits, pocc, bbits, bocc = member_slabs(rng, 40, 2, 256, 64)

    def offset(a):
        flat = torch.empty(a.size + 1, dtype=torch.int32, device=cuda)
        view = flat[1:].view(a.shape)
        view.copy_(torch.from_numpy(a))
        assert view.is_contiguous() and view.data_ptr() % 16 == 4
        return view

    member_equals_plain((offset(pbits), offset(pocc), on(cuda, bbits),
                         on(cuda, bocc)))


@pytest.mark.parametrize("K,B,Lc,C", [(33, 4, 70, 120), (40, 3, 64, 300),
                                      (300, 2, 70, 500), (1, 2, 64, 30000)])
def test_hash_join_any_planes_and_width(cuda, K, B, Lc, C, rng):
    """No cap on key planes or slab width: the build slab streams through
    shared memory and the running rank carries across chunks."""
    args = tuple(on(cuda, a) for a in pooled_slabs(rng, B, K, Lc, C))
    assert equal(bucket_probe(*args), bucket_probe_ref(*args))


@pytest.mark.parametrize("impl", ["sortmerge", "hash"])
def test_set_ops_on_the_card_equal_cpu(cuda, impl, rng):
    n = 5000
    a = {"k": rng.integers(0, 900, n).astype(np.int32),
         "f": rng.choice(np.float32([0.0, -0.0, 1e-40, 2.5, np.nan]), n),
         "v": rng.normal(size=n).astype(np.float32)}
    b = {"k": rng.integers(450, 1350, n // 2).astype(np.int32),
         "f": rng.choice(np.float32([0.0, 2.5, -1.0]), n // 2),
         "v": rng.normal(size=n // 2).astype(np.float32)}
    ta, tb = (Table.from_dict(x, capacity=n + 7, device=cuda) for x in (a, b))
    ca, cb = (Table.from_dict(x, capacity=n + 7, device="cpu")
              for x in (a, b))
    assert torch.equal(L.isin(ta, "k", tb, "k", impl=impl).cpu(),
                       L.isin(ca, "k", cb, "k", impl=impl))
    for op in ("intersect", "difference"):
        got = getattr(L, op)(ta, tb, on=["k", "f"], impl=impl).to_numpy()
        want = getattr(L, op)(ca, cb, on=["k", "f"], impl=impl).to_numpy()
        for c in want:
            np.testing.assert_array_equal(got[c].view(np.int32),
                                          want[c].view(np.int32))


@pytest.mark.parametrize("tile", [512, 1024, 2048])
@pytest.mark.parametrize("n", [1, 64, 1023, 5000])
@pytest.mark.parametrize("bits,shift", [(1, 0), (4, 28), (8, 0), (8, 24),
                                        (11, 21)])
def test_radix_digit_pass_equals_plain(cuda, bits, shift, n, tile, rng):
    words = on(cuda, rng.integers(-2**31, 2**31, n, dtype=np.int64)
               .astype(np.int32))
    before = rs_ops.launches
    got = rs_ops.digit_histogram_ranks(words, shift, bits, tile)
    assert rs_ops.launches == before + 1        # even a ragged single tile
    assert equal(got, digit_histogram_ranks_ref(words, shift, bits))


@pytest.mark.parametrize("tile", [512, 1024, 2048])
@pytest.mark.parametrize("n", [1, 64, 1023, 5000])
@pytest.mark.parametrize("bits", [1, 4, 8, 11])
def test_radix_scatter_pass_equals_plain(cuda, bits, n, tile, rng):
    """The CUDA pass (upsweep, scan, downsweep: one counted launch) ==
    the plain composition: perm and words, and perm from the identity."""
    shift = (5 * bits) % (33 - bits)
    words = on(cuda, rng.integers(-2**31, 2**31, n, dtype=np.int64)
               .astype(np.int32))
    perm = on(cuda, rng.permutation(n).astype(np.int32))
    before = rs_ops.launches
    got = rs_ops.scatter_pass(perm, words, shift, bits, tile)
    assert rs_ops.launches == before + 1
    assert equal(got, scatter_pass_ref(perm, words, shift, bits))
    ident, none = rs_ops.scatter_pass(None, words, shift, bits, tile,
                                      keep_words=False)
    assert none is None
    assert torch.equal(ident, scatter_pass_ref(None, words, shift, bits)[0])


@pytest.mark.parametrize("tile", [512, 1024, 2048])
@pytest.mark.parametrize("kind", ["equal", "descending"])
def test_radix_pass_skewed_words(cuda, kind, tile, rng):
    """Every row on one digit, and words in descending order."""
    n = 5000
    w = np.full(n, 0x5A5A5A5A, np.int32) if kind == "equal" else \
        ((n - np.arange(n)) * 400_000 - 2**30).astype(np.int32)
    words = on(cuda, w)
    perm = on(cuda, rng.permutation(n).astype(np.int32))
    for bits, shift in ((1, 31), (4, 4), (8, 0), (8, 24), (11, 21)):
        assert equal(rs_ops.scatter_pass(perm, words, shift, bits, tile),
                     scatter_pass_ref(perm, words, shift, bits))
        assert equal(rs_ops.digit_histogram_ranks(words, shift, bits, tile),
                     digit_histogram_ranks_ref(words, shift, bits))


@pytest.mark.parametrize("tile", [512, 1024])
@pytest.mark.parametrize("bits", [8, 11])
def test_radix_pass_many_tiles_per_block(cuda, bits, tile, rng):
    """Past 2048 tiles a block walks several of them in turn."""
    n = 3_000_007
    words = on(cuda, rng.integers(-2**31, 2**31, n, dtype=np.int64)
               .astype(np.int32))
    perm = on(cuda, rng.permutation(n).astype(np.int32))
    assert equal(rs_ops.scatter_pass(perm, words, 8, bits, tile),
                 scatter_pass_ref(perm, words, 8, bits))
    assert equal(rs_ops.digit_histogram_ranks(words, 8, bits, tile),
                 digit_histogram_ranks_ref(words, 8, bits))


def test_radix_pass_on_zero_rows_launches_nothing(cuda):
    empty = torch.zeros(0, dtype=torch.int32, device=cuda)
    before = rs_ops.launches
    perm, words = rs_ops.scatter_pass(empty, empty, 0, 8, 1024)
    hist, ranks = rs_ops.digit_histogram_ranks(empty, 0, 8, 1024)
    assert rs_ops.launches == before
    assert perm.numel() == words.numel() == ranks.numel() == 0
    assert hist.shape == (256,) and not hist.any()


def test_radix_pass_wrong_input_raises(cuda):
    words = torch.zeros(8, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="int32 CUDA tensor"):
        rs_ops.scatter_pass(None, words.long(), 0, 8, 1024)
    with pytest.raises(ValueError, match="does not match"):
        rs_ops.scatter_pass(words[:4].clone(), words, 0, 8, 1024)
    with pytest.raises(ValueError, match="1-D"):
        rs_ops.digit_histogram_ranks(words.view(2, 4), 0, 8, 1024)


def test_radix_engine_equals_cpu(cuda, rng):
    """Sort, rank, partition and grouped ranks on the card == the same
    calls on CPU tensors (the plain digit pass)."""
    n = 7000
    f = rng.choice(np.array([np.nan, -0.0, 0.0, np.inf, -np.inf, 1.5, -2.0,
                             3.0e38], np.float32), n)
    i = rng.integers(-2**31, 2**31, n, dtype=np.int64).astype(np.int32)
    i[:2] = [-2**31, 2**31 - 1]
    data = {"f": f, "i": i, "row": np.arange(n, dtype=np.int32)}
    for by in (["f"], ["i", "f"]):
        for asc in (True, False):
            t = Table.from_dict(data, capacity=n + 100, device=cuda)
            c = Table.from_dict(data, capacity=n + 100, device="cpu")
            got = L.sort_values(t, by, asc, impl="radix").columns["row"]
            want = L.sort_values(c, by, asc, impl="xla").columns["row"]
            assert torch.equal(got[:n].cpu(), want[:n])
    keep = rng.random(n) < 0.3
    assert torch.equal(rs_ops.stable_partition_perm(on(cuda, keep)).cpu(),
                       rs_ops.stable_partition_perm(torch.from_numpy(keep)))
    for P in (513, 70000):
        pid = rng.integers(0, P, n).astype(np.int32)
        got = rs_ops.grouped_ranks(on(cuda, pid), P)
        want = rs_ops.grouped_ranks(torch.from_numpy(pid), P)
        assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want))


def same_value(a, b):
    """Equal values, NaN == NaN and -0.0 == +0.0."""
    return bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())


@pytest.mark.parametrize("B,K,V,C", [(3, 1, 1, 40), (64, 2, 5, 300),
                                     (5, 1, 2, 1500)])
def test_hash_groupby_equals_plain(cuda, B, K, V, C, rng):
    kb = on(cuda, rng.integers(-4, 4, (B, K, C)).astype(np.int32))
    occ = on(cuda, (rng.random((B, C)) < 0.8).astype(np.int32))
    vals = rng.normal(size=(B, V, C)).astype(np.float32)
    vals[rng.random(vals.shape) < 0.05] = -0.0
    vals[rng.random(vals.shape) < 0.01] = np.nan
    vals = on(cuda, vals)
    rep, counts, sums, mins, maxs = bucket_accumulate(kb, occ, vals)
    w = bucket_accumulate_ref(kb, occ, vals)
    assert equal((rep, counts), w[:2])
    assert same_value(mins, w[3]) and same_value(maxs, w[4])
    scale = bucket_accumulate_ref(kb, occ, vals.abs())[2]
    close = (sums - w[2]).abs() <= 1e-6 * scale
    assert bool((close | (torch.isnan(sums) & torch.isnan(w[2]))).all())


@pytest.mark.parametrize("B,K,C", [(4, 9, 300), (3, 40, 1500),
                                   (2, 300, 500)])
def test_hash_groupby_many_key_planes(cuda, B, K, C, rng):
    """Past the planes held in registers, and (K = 300) past what fits in
    a full 1024-slot shared-memory chunk."""
    pool = rng.integers(-4, 4, (B, K, 6)).astype(np.int32)
    pick = rng.integers(0, 6, (B, 1, C))
    kb = on(cuda, np.take_along_axis(pool, np.repeat(pick, K, 1), 2))
    occ = on(cuda, (rng.random((B, C)) < 0.8).astype(np.int32))
    vals = on(cuda, rng.integers(-100, 100, (B, 2, C)).astype(np.float32))
    assert equal(bucket_accumulate(kb, occ, vals),
                 bucket_accumulate_ref(kb, occ, vals))


def test_hash_groupby_integer_sums_exact(cuda, rng):
    kb = on(cuda, rng.integers(0, 9, (16, 1, 440)).astype(np.int32))
    occ = on(cuda, np.ones((16, 440), np.int32))
    vals = on(cuda, rng.integers(-100, 100, (16, 1, 440)).astype(np.float32))
    assert torch.equal(bucket_accumulate(kb, occ, vals)[2],
                       bucket_accumulate_ref(kb, occ, vals)[2])


def edge_slabs(rng, C, K=1, V=1):
    """Five buckets: holes in the occupancy (not a prefix), every slot
    one key, no slot occupied, every key distinct, and a prefix."""
    kb = rng.integers(-3, 3, (5, K, C)).astype(np.int32)
    kb[1] = 7
    kb[3] = np.arange(C)[None, :] * (np.arange(K)[:, None] + 1)
    occ = (rng.random((5, C)) < 0.35).astype(np.int32)
    occ[1], occ[2] = 1, 0
    occ[3] = 1
    occ[4] = np.arange(C) < C // 3
    vals = rng.integers(-100, 100, (5, V, C)).astype(np.float32)
    vals[rng.random(vals.shape) < 0.05] = -0.0
    vals[rng.random(vals.shape) < 0.01] = np.nan
    return kb, occ, vals


@pytest.mark.parametrize("C,K,V", [(440, 1, 1), (1500, 2, 5), (12000, 1, 1),
                                   (7000, 2, 5)])
def test_hash_groupby_edge_buckets(cuda, C, K, V, rng):
    """Holey occupancy, a bucket of one key, an empty bucket, all keys
    distinct and a prefix; C 12000 and 7000 are past the shared-memory
    workspace (it is then in device memory), 7000 with two key planes
    and five value columns.  Integer-valued, so the sums are exact."""
    kb, occ, vals = (on(cuda, a) for a in edge_slabs(rng, C, K, V))
    got = bucket_accumulate(kb, occ, vals)
    want = bucket_accumulate_ref(kb, occ, vals)
    assert equal(got[:2], want[:2])
    assert bool((got[1][2] == 0).all()) and int(got[1][1, 0]) == C
    assert torch.equal(torch.nan_to_num(got[2]), torch.nan_to_num(want[2]))
    assert same_value(got[3], want[3]) and same_value(got[4], want[4])


def test_zero_rows_launch_nothing(cuda):
    before = hp_ops.launches
    hist, ranks = radix_histogram_ranks(
        torch.zeros(0, dtype=torch.int32, device=cuda), 3)
    assert hp_ops.launches == before
    assert hist.tolist() == [0, 0, 0] and ranks.numel() == 0


def test_fused_bucketing_on_zero_rows_launches_nothing(cuda):
    before = fb_ops.launches
    empty = torch.zeros(0, dtype=torch.int32, device=cuda)
    bid, hist, ranks = fused_bucket_ranks(
        (empty, empty), torch.zeros(0, dtype=torch.bool, device=cuda), 4)
    assert fb_ops.launches == before
    assert bid.numel() == ranks.numel() == 0
    assert hist.tolist() == [0] * 5


def test_wrong_input_raises(cuda):
    with pytest.raises(ValueError, match="int32 CUDA tensor"):
        radix_histogram_ranks(torch.zeros(4, dtype=torch.int64,
                                          device=cuda), 3)


# --------------------------------------------------------------------------
# flash attention and the serving path
# --------------------------------------------------------------------------

# bf16 in and out, compared in float32: the reference's own bf16 tolerance
# for its kernel (tests/test_kernels.py::test_flash_attention_dtypes)
FLASH_TOL = 2e-2


def bf16_qkv(cuda, rng, B, Hq, Hkv, Sq, Skv, D):
    return tuple(on(cuda, rng.normal(size=s).astype(np.float32))
                 .to(torch.bfloat16)
                 for s in ((B, Hq, Sq, D), (B, Hkv, Skv, D),
                           (B, Hkv, Skv, D)))


# (B, Hq, Hkv, Sq, Skv): square, ragged, right-aligned (Sq < Skv), one row;
# and past 4 rounds of the K/V ring (3 stages of 64 keys at D <= 64, 2 at
# D = 128), one query row among them
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", [16, 32, 64, 128])
@pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv", [
    (1, 4, 2, 128, 128), (2, 4, 1, 100, 100), (1, 2, 2, 37, 203),
    (1, 8, 2, 1, 70), (3, 2, 1, 64, 1000), (2, 4, 2, 1, 1100),
    (1, 4, 1, 300, 2000)])
def test_flash_attention_equals_plain(cuda, B, Hq, Hkv, Sq, Skv, D, causal,
                                      rng):
    q, k, v = bf16_qkv(cuda, rng, B, Hq, Hkv, Sq, Skv, D)
    got = flash_ops.flash_attention(q, k, v, causal=causal)
    want = attention_ref(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    torch.testing.assert_close(got.float(), want.float(), atol=FLASH_TOL,
                               rtol=FLASH_TOL)


# the enc-dec and vision shapes: cross-attention, not causal, with Sq > Skv
# (the test file's small one, a ragged one and SeamlessM4T's 1024 decoder
# positions against 256 frames), and causal GQA at D 128 (InternVL2's
# 16 q / 8 KV heads over 1280 positions, and the small one)
@pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv,D,causal", [
    (2, 4, 4, 128, 64, 64, False), (1, 4, 2, 300, 70, 64, False),
    (2, 16, 16, 1024, 256, 64, False), (1, 4, 2, 128, 128, 128, True),
    (2, 16, 8, 1280, 1280, 128, True)])
def test_flash_attention_encdec_and_vision_shapes(cuda, B, Hq, Hkv, Sq, Skv,
                                                  D, causal, rng):
    q, k, v = bf16_qkv(cuda, rng, B, Hq, Hkv, Sq, Skv, D)
    got = flash_ops.flash_attention(q, k, v, causal=causal)
    want = attention_ref(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    torch.testing.assert_close(got.float(), want.float(), atol=FLASH_TOL,
                               rtol=FLASH_TOL)


def test_flash_attention_counts_launches(cuda, rng):
    q, k, v = bf16_qkv(cuda, rng, 1, 2, 2, 64, 64, 64)
    before = flash_ops.launches
    flash_ops.flash_attention(q, k, v)
    flash_ops.flash_attention(q.cpu(), k.cpu(), v.cpu())   # plain version
    assert flash_ops.launches == before + 1


def test_flash_attention_wrong_input_raises(cuda, rng):
    q, k, v = bf16_qkv(cuda, rng, 1, 2, 2, 64, 64, 64)
    with pytest.raises(ValueError, match="bfloat16 CUDA tensor"):
        flash_ops.flash_attention(q.float(), k.float(), v.float())
    with pytest.raises(ValueError, match="contiguous"):
        flash_ops.flash_attention(q.transpose(2, 3), k, v)
    with pytest.raises(ValueError, match="head dim"):
        flash_ops.flash_attention(q[..., :48].contiguous(),
                                  k[..., :48].contiguous(),
                                  v[..., :48].contiguous())
    with pytest.raises(ValueError, match="Sq 64 > Skv 32"):
        flash_ops.flash_attention(q, k[:, :, :32].contiguous(),
                                  v[:, :, :32].contiguous())


def test_reduced_engine_on_the_card(cuda):
    """Reduced granite-3-2b served on the card with feature stores: the
    accounting identity holds, every request is served with its features,
    the flash kernel runs once per layer of every prefill, and a slot
    prefill's logits on the card are within 2e-2 of the CPU's (the model
    tests' bf16 tolerance)."""
    from repro_torch.configs import get_reduced
    from repro_torch.core.context import make_context
    from repro_torch.launch.serve import feature_stores, make_requests
    from repro_torch.models import model as M
    from repro_torch.serving import ServingEngine

    cfg = get_reduced("granite-3-2b")
    cpu_params = M.init_params(torch.Generator().manual_seed(0), cfg)
    params = _to(cpu_params, cuda)
    stores, _ = feature_stores(make_context(cuda), 0, 8)
    eng = ServingEngine(cfg, params, slots=4, prompt_capacity=40,
                        gen_capacity=8, queue_capacity=16,
                        feature_stores=stores, device=cuda)
    assert eng.attn_impl == "cuda"
    reqs = make_requests(cfg, 12, 40, 8, seed=0)
    before = flash_ops.launches
    for r in reqs:
        assert eng.submit(r)
    done = eng.run_until_drained()
    m = eng.metrics
    assert m.count("submitted") == m.count("completed") + \
        m.count("rejected") + m.count("feature_misses") == 12
    assert all(len(r.out_tokens) == r.gen_len and r.features for r in done)
    assert flash_ops.launches - before == cfg.n_layers * m.count("prefills")
    assert all(s.dropped == 0 for s in stores.values())

    for r in reqs[:3]:
        padded = np.zeros((1, 40), np.int32)
        padded[0, :len(r.prompt)] = r.prompt
        logits = {}
        for device, p in ((cuda, params), (torch.device("cpu"), cpu_params)):
            prefill = M.make_slot_prefill(cfg, decode_len=48)
            logits[device.type], _ = prefill(
                p, {"tokens": torch.from_numpy(padded).to(device)},
                len(r.prompt))
        torch.testing.assert_close(logits["cuda"].cpu(), logits["cpu"],
                                   atol=2e-2, rtol=2e-2)


def _to(tree, device):
    return {k: _to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


# --------------------------------------------------------------------------
# the Mamba selective scan and a Mamba stack served on the card
# --------------------------------------------------------------------------

# the reference's own tolerance for its scan kernel
# (tests/test_kernels.py::test_selective_scan_interpret_matches_ref)
SCAN_TOL = 2e-4


def scan_inputs(cuda, rng, B, S, E, N):
    x = rng.normal(size=(B, S, E))
    delta = np.log1p(np.exp(rng.normal(size=(B, S, E))))
    A = -np.exp(rng.normal(size=(E, N)) * 0.5)
    Bm, Cm = rng.normal(size=(B, S, N)), rng.normal(size=(B, S, N))
    D = rng.normal(size=(E,))
    return tuple(on(cuda, a.astype(np.float32))
                 for a in (x, delta, A, Bm, Cm, D))


@pytest.mark.parametrize("return_state", [True, False])
@pytest.mark.parametrize("N", [8, 16])
@pytest.mark.parametrize("S", [1, 100, 1024])
@pytest.mark.parametrize("B", [1, 4])
def test_mamba_scan_equals_plain(cuda, B, S, N, return_state, rng):
    args = scan_inputs(cuda, rng, B, S, 200, N)     # E = 200: ragged blocks
    got = scan_ops.selective_scan(*args, return_state=return_state)
    want = selective_scan_ref(*args)
    torch.cuda.synchronize()
    if not return_state:
        got, want = (got,), want[:1]
    for g, w in zip(got, want, strict=True):
        assert g.dtype == torch.float32 and g.shape == w.shape
        torch.testing.assert_close(g, w, atol=SCAN_TOL, rtol=SCAN_TOL)


@pytest.mark.parametrize("N", [1, 2, 4, 32])
def test_mamba_scan_other_state_sizes_and_bf16_x(cuda, N, rng):
    args = scan_inputs(cuda, rng, 2, 70, 96, N)
    y, h = scan_ops.selective_scan(*args, return_state=True)
    wy, wh = selective_scan_ref(*args)
    torch.testing.assert_close(y, wy, atol=SCAN_TOL, rtol=SCAN_TOL)
    torch.testing.assert_close(h, wh, atol=SCAN_TOL, rtol=SCAN_TOL)
    xb = args[0].bfloat16()
    yb = scan_ops.selective_scan(xb, *args[1:])
    wb = selective_scan_ref(xb, *args[1:])[0]
    torch.cuda.synchronize()
    assert yb.dtype == torch.bfloat16
    # bf16 outputs: one rounding of the same float32 value, or of two
    # values within SCAN_TOL of each other
    torch.testing.assert_close(yb.float(), wb.float(), atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("E,S,N,bf16", [
    (8200, 65, 16, False),            # E past a multiple of the tile
    (200, 63, 16, False), (200, 64, 16, False), (200, 65, 16, False),
    (200, 127, 16, True), (200, 128, 16, True), (200, 129, 16, True),
    (200, 129, 32, True), (200, 65, 32, False),     # N 32, bf16 x
    (200, 31, 4, True), (200, 33, 4, False),        # 32-step chunks
    (200, 65, 8, True),
    (77, 45, 16, True), (77, 45, 2, False), (77, 45, 1, True),  # E odd
])
def test_mamba_scan_ring_edges(cuda, E, S, N, bf16, rng):
    """S at the time ring's chunk boundaries (64 steps, 32 at N 4 and
    below) and one either side, E not a multiple of the channel tile (32
    at N 8 to 32) or of a 16-byte row piece, and N 32 with bf16 x."""
    args = scan_inputs(cuda, rng, 2, S, E, N)
    if bf16:
        args = (args[0].bfloat16(),) + args[1:]
    y, h = scan_ops.selective_scan(*args, return_state=True)
    wy, wh = selective_scan_ref(*args)
    torch.cuda.synchronize()
    assert y.dtype == args[0].dtype
    tol = 2e-2 if bf16 else SCAN_TOL
    torch.testing.assert_close(y.float(), wy.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(h, wh, atol=SCAN_TOL, rtol=SCAN_TOL)


@pytest.mark.parametrize("E,N", [(4096, 16), (64, 8), (32, 8)])
def test_mamba_scan_model_rank_channels(cuda, E, N, rng):
    """The channels one model rank holds, as a prefill at world > 1
    scans them: Falcon-Mamba-7B's 8192 over two ranks, reduced
    falcon-mamba-7b's 128 over two and four."""
    args = scan_inputs(cuda, rng, 1, 300, E, N)
    y, h = scan_ops.selective_scan(*args, return_state=True)
    wy, wh = selective_scan_ref(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(y, wy, atol=SCAN_TOL, rtol=SCAN_TOL)
    torch.testing.assert_close(h, wh, atol=SCAN_TOL, rtol=SCAN_TOL)


def test_mamba_scan_unaligned_inputs(cuda, rng):
    """Inputs that start 4 bytes past a 16-byte boundary take the
    element-wise and 4-byte staging."""
    args = scan_inputs(cuda, rng, 1, 70, 96, 16)

    def shifted(t):
        flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        out = flat[1:].view(t.shape)
        out.copy_(t)
        return out

    moved = tuple(shifted(a) for a in args)
    assert moved[0].data_ptr() % 16 and moved[3].data_ptr() % 16
    y, h = scan_ops.selective_scan(*moved, return_state=True)
    wy, wh = selective_scan_ref(*args)
    torch.testing.assert_close(y, wy, atol=SCAN_TOL, rtol=SCAN_TOL)
    torch.testing.assert_close(h, wh, atol=SCAN_TOL, rtol=SCAN_TOL)


def test_mamba_scan_counts_launches(cuda, rng):
    args = scan_inputs(cuda, rng, 1, 16, 32, 16)
    before = scan_ops.launches
    scan_ops.selective_scan(*args)
    scan_ops.selective_scan(*(a.cpu() for a in args))   # plain version
    empty = scan_inputs(cuda, rng, 1, 0, 32, 16)         # S = 0
    y, h = scan_ops.selective_scan(*empty, return_state=True)
    assert scan_ops.launches == before + 1
    assert y.shape == (1, 0, 32) and not bool(h.any())


def test_mamba_scan_wrong_input_raises(cuda, rng):
    x, d, A, Bm, Cm, D = scan_inputs(cuda, rng, 1, 16, 32, 16)
    with pytest.raises(ValueError, match="float32 CUDA tensor"):
        scan_ops.selective_scan(x, d.double(), A, Bm, Cm, D)
    with pytest.raises(ValueError, match="float32 CUDA tensor"):
        scan_ops.selective_scan(x.half(), d, A, Bm, Cm, D)
    with pytest.raises(ValueError, match="contiguous"):
        scan_ops.selective_scan(x, d, A, Bm.transpose(1, 2).contiguous()
                                .transpose(1, 2), Cm, D)
    with pytest.raises(ValueError, match="CUDA tensor"):
        scan_ops.selective_scan(x, d, A.cpu(), Bm, Cm, D)
    with pytest.raises(ValueError, match="state size"):
        scan_ops.selective_scan(x, d, A[:, :12].contiguous(),
                                Bm[..., :12].contiguous(),
                                Cm[..., :12].contiguous(), D)
    with pytest.raises(ValueError, match="Cm is"):
        scan_ops.selective_scan(x, d, A, Bm, Cm[:, :8], D)


def test_reduced_mamba_engine_on_the_card(cuda):
    """Reduced falcon-mamba-7b served on the card: every request served,
    the scan kernel once per layer of every prefill and no flash launch,
    and the same tokens as the same engine on the CPU (the plain scan)
    up to the first position whose CPU top-2 margin is at most twice the
    two devices' logit difference there (within 2e-2)."""
    from repro_torch.configs import get_reduced
    from repro_torch.launch.serve import make_requests
    from repro_torch.models import model as M
    from repro_torch.serving import ServingEngine

    cfg = get_reduced("falcon-mamba-7b")
    cpu_params = M.init_params(torch.Generator().manual_seed(0), cfg)
    runs = {}
    for device, params in ((cuda, _to(cpu_params, cuda)),
                           (torch.device("cpu"), cpu_params)):
        eng = ServingEngine(cfg, params, slots=4, prompt_capacity=40,
                            gen_capacity=8, queue_capacity=16,
                            device=device)
        logits = {}
        plain = eng._slot_prefill

        def prefill(p, batch, length, plain=plain, logits=logits):
            lg, caches = plain(p, batch, length)
            logits[len(logits)] = lg[0].float().cpu()
            return lg, caches

        eng._slot_prefill = prefill
        reqs = make_requests(cfg, 12, 40, 8, seed=0)
        before = (scan_ops.launches, flash_ops.launches)
        for r in reqs:
            assert eng.submit(r)
        done = eng.run_until_drained()
        m = eng.metrics
        assert m.count("completed") == m.count("submitted") == 12
        assert all(len(r.out_tokens) == r.gen_len for r in done)
        want = (cfg.n_layers * m.count("prefills"), 0) \
            if device.type == "cuda" else (0, 0)
        assert (scan_ops.launches - before[0],
                flash_ops.launches - before[1]) == want
        runs[device.type] = ({r.req_id: r.out_tokens for r in done}, logits)
    (gpu_toks, gpu_lg), (cpu_toks, cpu_lg) = runs["cuda"], runs["cpu"]
    compared = 0
    for i in cpu_lg:                 # prefills in the same order
        diff = float((gpu_lg[i] - cpu_lg[i]).abs().max())
        assert diff <= 2e-2
        top = torch.topk(cpu_lg[i], 2).values
        if float(top[0] - top[1]) > 2 * diff:
            assert int(gpu_lg[i].argmax()) == int(cpu_lg[i].argmax())
            compared += 1
    assert compared >= 1
    assert sum(gpu_toks[k] == cpu_toks[k] for k in cpu_toks) >= 1


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(3, 1024), (2, 8, 64), (4, 17), (2, 5)])
def test_layer_init_draws_as_randn_times_std(cuda, dtype, shape):
    """``layers.normal`` on a CUDA generator (each slice drawn in place)
    gives the bits that ``randn`` of the slice times ``std``, rounded to
    the leaf's dtype, gives from the same generator state."""
    from repro_torch.models import layers as Ly
    got = Ly.normal(torch.Generator(device=cuda).manual_seed(7), shape,
                    0.02, dtype)
    gen = torch.Generator(device=cuda).manual_seed(7)
    want = torch.stack([(torch.randn(shape[1:], generator=gen,
                                     device=cuda) * 0.02).to(dtype)
                        for _ in range(shape[0])])
    assert got.dtype == want.dtype and torch.equal(got, want)
