"""The port's roofline (``repro_torch/roofline``) against the JAX
package's, and its cost counter on hand-countable programs:

* ``collectives._ring_factor`` equals the reference's for every op at
  groups of 1, 2, 4 and 16; ``analysis.model_flops_for`` equals the
  reference's for every arch x cell;
* ``Roofline``'s terms, ``bound``, ``step_s`` and ``mfu`` on hand
  numbers at the H100 SXM constants, nodes of 8 priced at NVLink and
  groups across nodes at the NDR rate, the kernels' operations other
  than flash attention's in ``compute_s`` as seconds, not FLOPs;
* ``cost.CostCounter``: a matmul counts exactly 2 M N K FLOPs and its
  operands' and result's bytes; an L-layer loop counts L times; a view
  is billed 0 bytes and ``index_select`` at its output window; a kernel
  on ``meta`` tensors at its bound's work, not its plain version's (only
  flash attention's products as FLOPs); the training scan's chunks on
  ``meta``, its middle chunks run once and counted for all
  (``CostCounter.repeated``), count exactly what every chunk run on CPU
  tensors counts, forward and backward; one
  ``all_reduce`` over a group of 4 under the ``fake`` backend counted
  once at 2·3/4 of its bytes, and no process group left afterwards;
* ``cost.bound``: ``chip_smoke.py``'s kernel bound, moved here, gives
  the numbers it gave (row 7's 0.00435 ms; the flash count in closed
  form equals the sum it replaced).
"""
import math

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro import configs as JC
from repro.roofline import analysis as JA
from repro.roofline import hlo as JH
from repro_torch import configs as TC
from repro_torch.core import context
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.hash_partition import ops as hp_ops
from repro_torch.kernels.mamba_scan import ops as ms_ops
from repro_torch.launch import dryrun as Dr
from repro_torch.launch import mesh as Me
from repro_torch.models import mamba as Mb
from repro_torch.roofline import analysis as TA
from repro_torch.roofline import collectives as TCo
from repro_torch.roofline import cost as Cost

OPS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
       "collective-permute", "broadcast")
META = torch.device("meta")


@pytest.mark.parametrize("group", [1, 2, 4, 16])
def test_ring_factor_matches_reference(group):
    for op in OPS:
        assert TCo._ring_factor(op, group) == JH._ring_factor(op, group)


def test_model_flops_match_reference():
    for arch in JC.ARCH_IDS:
        for cell in JC.cells_for(arch):
            assert TA.model_flops_for(TC.get_config(arch), cell) \
                == JA.model_flops_for(JC.get_config(arch), cell), \
                (arch, cell)


def test_roofline_terms_and_bound():
    stats = TCo.CollectiveStats(counts={"all-reduce": 1},
                                result_bytes={"all-reduce": 1e9},
                                link_bytes={"all-reduce": 2e9})
    r = TA.Roofline(arch="x", cell="train_4k", mesh="16x16",
                    flops_per_dev=1e12, bytes_per_dev=1e11,
                    collective=stats, model_flops=6e15, n_chips=256)
    assert (TA.PEAK_FLOPS, TA.HBM_BW, TA.NVLINK_BW, TA.NDR_BW) \
        == (989e12, 3.35e12, 450e9, 50e9)
    np.testing.assert_allclose(r.compute_s, 1e12 / 989e12)
    np.testing.assert_allclose(r.memory_s, 1e11 / 3.35e12)
    np.testing.assert_allclose(r.collective_s, 2e9 / 450e9)
    assert r.bound == "memory"
    assert r.step_s == max(r.compute_s, r.memory_s, r.collective_s)
    np.testing.assert_allclose(r.mfu, 6e15 / (r.step_s * 989e12 * 256))
    assert 0 < r.mfu < 1.0
    np.testing.assert_allclose(r.useful_flops_fraction, 6e15 / 256e12)
    scan = TA.Roofline(**{**r.__dict__, "kernel_op_s": 0.25})
    np.testing.assert_allclose(scan.compute_s, 1e12 / 989e12 + 0.25)
    assert scan.bound == "compute" and scan.flops_per_dev == 1e12
    assert scan.to_dict()["kernel_op_s"] == 0.25
    across = TA.Roofline(**{**r.__dict__, "ndr_link_bytes": 1.5e9})
    np.testing.assert_allclose(across.collective_s,
                               0.5e9 / 450e9 + 1.5e9 / 50e9)
    assert across.bound == "collective"
    d = across.to_dict()
    for k in ("compute_s", "memory_s", "collective_s", "bound", "step_s",
              "model_flops", "useful_flops_fraction", "mfu",
              "flops_per_dev", "bytes_per_dev", "memory_per_dev"):
        assert k in d and k in r.to_dict()
    assert d["bound"] == "collective"


def test_matmul_loop_view_and_gather_counts():
    M, K, N, L = 48, 32, 16, 5
    x = torch.empty(M, K, dtype=torch.bfloat16, device=META)
    w = torch.empty(L, K, K, dtype=torch.bfloat16, device=META)
    with Cost.CostCounter() as one:
        y = x @ w[0, :, :N]
    assert one.flops == 2 * M * N * K
    assert one.bytes == 2 * (M * K + K * N + M * N)
    with Cost.CostCounter() as loop:
        h = x
        for i in range(L):
            h = h @ w[i]
    assert loop.flops == L * 2 * M * K * K
    assert loop.bytes == L * 2 * (2 * M * K + K * K)
    with Cost.CostCounter() as views:
        x.view(K, M).transpose(0, 1).reshape(M, K)[:, :8].unsqueeze(0)
    assert views.bytes == 0 and views.flops == 0
    idx = torch.empty(7, dtype=torch.int64, device=META)
    with Cost.CostCounter() as sel:
        torch.index_select(w, 0, idx[:3])
    assert sel.bytes == 2 * 3 * K * K * 2 and sel.flops == 0
    assert y.shape == (M, N) and h.shape == (M, K)


def test_kernels_on_meta_bill_their_bound():
    q = torch.empty(2, 8, 64, 16, dtype=torch.bfloat16, device=META)
    kv = torch.empty(2, 2, 64, 16, dtype=torch.bfloat16, device=META)
    x = torch.empty(1, 32, 24, dtype=torch.bfloat16, device=META)
    d = torch.empty(1, 32, 24, device=META)
    A = torch.empty(24, 4, device=META)
    Bm = torch.empty(1, 32, 4, device=META)
    D = torch.empty(24, device=META)
    pid = torch.empty(100, dtype=torch.int32, device=META)
    with Cost.CostCounter() as c:
        o = fa_ops.flash_attention(q, kv, kv, causal=True)
        y, hT = ms_ops.selective_scan(x, d, A, Bm, Bm, D, return_state=True)
        hist, ranks = hp_ops.radix_histogram_ranks(pid, 5)
    assert o.shape == q.shape and o.dtype == q.dtype
    assert y.shape == x.shape and hT.shape == (1, 24, 4)
    assert hist.shape == (5,) and ranks.shape == (100,)
    work = [Cost.kernel_work("flash_attention", (q, kv, kv, True)),
            Cost.kernel_work("mamba_scan", (x, d, A, Bm, Bm, D, True)),
            Cost.kernel_work("hash_partition", (pid, 5))]
    assert c.flops == work[0][1]        # flash attention's products
    assert c.bytes == sum(w[0] for w in work)
    # the scan's and the partition's operations, at their own rates
    assert c.kernel_op_s == pytest.approx(
        max(24 * 4 * 32 / TA.EXP_PER_S, 5 * 24 * 4 * 32 / TA.F32_FLOPS)
        + 100 / TA.F32_FLOPS, rel=1e-12)
    assert {k: v["calls"] for k, v in c.kernels.items()} == {
        "flash_attention": 1, "mamba_scan": 1, "hash_partition": 1}
    assert c.ops == 0                   # nothing of the plain versions


def test_all_reduce_counted_once_and_group_destroyed():
    x = torch.empty(1000, dtype=torch.float32, device=META)
    with Dr.fake_world(4):
        mesh = Me.make_mesh({"data": 2, "model": 2})
        group = mesh.groups["model"]
        with Cost.CostCounter() as c:
            context.all_reduce(x, group)
        assert dist.get_world_size(group) == 2
        whole = dist.new_group([0, 1, 2, 3])
        with Cost.CostCounter() as c4:
            context.all_reduce(x, whole)
    assert not dist.is_initialized()
    assert c.counts == {"all-reduce": 1}
    assert c.result_bytes["all-reduce"] == 4000
    assert c.link_bytes["all-reduce"] == 4000 * 2 * 1 / 2
    assert c4.counts == {"all-reduce": 1}
    assert c4.link_bytes["all-reduce"] == 4000 * 2 * 3 / 4
    assert c4.ndr_link_bytes == 0       # four ranks: one node
    assert context.observers == []


def test_groups_across_nodes_are_priced_at_ndr():
    x = torch.empty(256, dtype=torch.bfloat16, device=META)
    with Dr.fake_world(32):
        mesh = Me.make_mesh({"data": 2, "model": 16})
        with Cost.CostCounter() as c:
            context.all_gather(x, mesh.groups["model"])   # ranks 0-15
            context.all_to_all(x, mesh.groups["data"])    # ranks 0, 16
    assert not dist.is_initialized()
    gather = 16 * 512 * 15 / 16
    assert c.link_bytes == {"all-gather": gather,
                            "all-to-all": 512 * 1 / 2}
    assert c.ndr_link_bytes == gather + 256


def test_bound_gives_the_numbers_it_gave():
    q = torch.empty(1, 32, 1024, 64, dtype=torch.bfloat16, device=META)
    kv = torch.empty(1, 8, 1024, 64, dtype=torch.bfloat16, device=META)
    ms, by = Cost.bound("flash_attention", (q, kv, kv, True))
    assert by == "operations" and round(ms, 5) == 0.00435
    for Sq, Skv in ((1024, 1024), (1024, 256), (7, 300), (300, 7)):
        live = sum(min(Skv, i + Skv - Sq + 1) for i in range(Sq))
        qs = torch.empty(1, 2, Sq, 8, device=META)
        ks = torch.empty(1, 2, Skv, 8, device=META)
        assert Cost.kernel_work("flash_attention", (qs, ks, ks, True))[1] \
            == 4 * 8 * 2 * live
    pid = torch.empty(10_000_000, dtype=torch.int32, device=META)
    ms, by = Cost.bound("hash_partition", (pid, 2))
    assert by == "bytes" and math.isclose(
        ms, (4 * 10_000_000 * 2 + 8) / 3.35e12 * 1e3)


@pytest.mark.parametrize("S,with_state", [(20, False), (20, True),
                                          (22, False), (22, True)])
def test_repeated_scan_chunks_count_as_every_chunk(S, with_state,
                                                   monkeypatch):
    """5 chunks of 4 steps (and a tail of 2 at S 22), the final state in
    the loss or not: on ``meta`` the first and last chunks run and the
    3 between them run once, counted 3 times (the sums of the gradients
    of the inputs every chunk reads billed as the real loop adds them);
    on CPU tensors every chunk runs.  Tolerance: exact."""
    rng = np.random.default_rng(S)
    B, E, N = 2, 6, 3
    arrays = [rng.standard_normal((B, S, E)), rng.random((B, S, E)) * 0.1,
              -rng.random((E, N)), rng.standard_normal((B, S, N)),
              rng.standard_normal((B, S, N)), rng.standard_normal(E)]
    loops = []
    repeated = Cost.CostCounter.repeated

    def counted(self, n, *args, **kw):
        loops.append(n)
        return repeated(self, n, *args, **kw)

    monkeypatch.setattr(Cost.CostCounter, "repeated", counted)

    def count(device):
        ts = [torch.tensor(a, dtype=torch.float32, device=device)
              if device != META else torch.empty(a.shape, device=META)
              for a in arrays]
        for t in ts:
            t.requires_grad_()
        with Cost.CostCounter() as c:
            y, h = Mb.scan_chunked(*ts, chunk=4)
            (y.sum() + (h.sum() if with_state else 0)).backward()
        assert y.shape == (B, S, E) and h.shape == (B, E, N)
        return c

    full = count("cpu")
    assert loops == []
    meta = count(META)
    assert loops == [3]
    assert (meta.flops, meta.bytes, meta.ops, meta.flops_f32) \
        == (full.flops, full.bytes, full.ops, full.flops_f32)
    assert full.flops > 0
