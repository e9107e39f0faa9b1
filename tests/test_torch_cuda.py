"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test is marked ``gpu`` and skips without a CUDA device; the
file imports neither JAX nor the JAX package, so it runs on a machine
that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.fused_bucketing import fused_bucket_ranks
from repro_torch.kernels.fused_bucketing.ref import fused_bucket_ranks_ref
from repro_torch.kernels.hash_join.ops import bucket_probe
from repro_torch.kernels.hash_join.ref import bucket_probe_ref
from repro_torch.kernels.hash_partition import ops as hp_ops
from repro_torch.kernels.hash_partition import radix_histogram_ranks
from repro_torch.kernels.hash_partition.ref import radix_histogram_ranks_ref

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


@pytest.mark.parametrize("P", [2, 9, 512])
@pytest.mark.parametrize("K,kind", [(1, "int"), (2, "float")])
def test_fused_bucketing_equals_plain(cuda, P, K, kind, rng):
    planes = tuple(on(cuda, p) for p in key_planes(rng, 3000, K, kind))
    valid = on(cuda, rng.random(3000) < 0.8)
    assert equal(fused_bucket_ranks(planes, valid, P),
                 fused_bucket_ranks_ref(planes, valid, P))


@pytest.mark.parametrize("K", [1, 2])
@pytest.mark.parametrize("B,Lc,C", [(3, 70, 33), (64, 16, 200)])
def test_hash_join_equals_plain(cuda, B, K, Lc, C, rng):
    args = (on(cuda, rng.integers(-3, 3, (B, K, Lc)).astype(np.int32)),
            on(cuda, (rng.random((B, Lc)) < 0.8).astype(np.int32)),
            on(cuda, rng.integers(-3, 3, (B, K, C)).astype(np.int32)),
            on(cuda, (rng.random((B, C)) < 0.8).astype(np.int32)))
    assert equal(bucket_probe(*args), bucket_probe_ref(*args))


def test_zero_rows_launch_nothing(cuda):
    before = hp_ops.launches
    hist, ranks = radix_histogram_ranks(
        torch.zeros(0, dtype=torch.int32, device=cuda), 3)
    assert hp_ops.launches == before
    assert hist.tolist() == [0, 0, 0] and ranks.numel() == 0


def test_wrong_input_raises(cuda):
    with pytest.raises(ValueError, match="int32 CUDA tensor"):
        radix_histogram_ranks(torch.zeros(4, dtype=torch.int64,
                                          device=cuda), 3)
