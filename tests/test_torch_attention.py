"""The port's attention paths against the JAX package on the same numpy
inputs: ``full_attention``, ``chunked_attention`` and ``decode_attention``
against ``repro.models.attention``; the flash-attention wrapper's plain
version (what it runs for CPU tensors) against the reference's Pallas
kernel in interpret mode (``bq = bk = 64``) and its ``attention_ref``.

Tolerances: 2e-5 in float32 (both sides compute in float32; only the
order of the sums differs, as in ``tests/test_attention.py``) and 2e-2
for bf16 inputs and outputs (the reference's own bf16 tolerance for its
kernel, ``tests/test_kernels.py::test_flash_attention_dtypes``: the two
round the float32 result to bf16 after different sums).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.kernels.flash_attention.ref import attention_ref as jax_ref
from repro.models import attention as JA
from repro_torch.core.kernel_backend import attention_impl
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention import attention_ref
from repro_torch.models import attention as TA

F32_TOL = 2e-5
BF16_TOL = 2e-2


def qkv(B, Hq, Hkv, Sq, Skv, D, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, Hq, Sq, D)).astype(np.float32),
            rng.normal(size=(B, Hkv, Skv, D)).astype(np.float32),
            rng.normal(size=(B, Hkv, Skv, D)).astype(np.float32))


def both(*arrays, dtype="float32"):
    """The same arrays for JAX and for the port, in ``dtype``."""
    j = [jnp.asarray(a).astype(dtype) for a in arrays]
    t = [torch.from_numpy(np.array(a.astype(jnp.float32))).to(
        getattr(torch, dtype)) for a in j]
    return j, t


def close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("B,Hq,Hkv,S,D", [
    (1, 2, 2, 64, 32), (2, 4, 2, 96, 64), (1, 8, 1, 128, 32)])
def test_full_attention_matches_jax(B, Hq, Hkv, S, D):
    (jq, jk, jv), (tq, tk, tv) = both(*qkv(B, Hq, Hkv, S, S, D))
    close(TA.full_attention(tq, tk, tv, causal=True),
          JA.full_attention(jq, jk, jv, causal=True), F32_TOL)


@pytest.mark.parametrize("qc,kc", [(16, 16), (16, 64), (40, 24)])
def test_chunked_attention_chunk_invariance(qc, kc):
    (jq, jk, jv), (tq, tk, tv) = both(*qkv(1, 4, 2, 128, 128, 32,
                                          seed=qc * 100 + kc))
    got = TA.chunked_attention(tq, tk, tv, causal=True, q_chunk=qc,
                               k_chunk=kc)
    close(got, JA.chunked_attention(jq, jk, jv, causal=True, q_chunk=qc,
                                    k_chunk=kc), F32_TOL)
    close(got, jax_ref(jq, jk, jv, causal=True), F32_TOL)


def test_chunked_attention_cross_no_causal():
    (jq, jk, jv), (tq, tk, tv) = both(*qkv(2, 4, 4, 64, 96, 32, seed=9))
    close(TA.chunked_attention(tq, tk, tv, causal=False, q_chunk=32,
                               k_chunk=32),
          JA.chunked_attention(jq, jk, jv, causal=False, q_chunk=32,
                               k_chunk=32), F32_TOL)


def test_chunked_right_aligned_causal():
    """Sq < Skv: query i attends to kv[:i + (Skv - Sq) + 1]."""
    (jq, jk, jv), (tq, tk, tv) = both(*qkv(1, 2, 2, 32, 128, 32, seed=17))
    close(TA.chunked_attention(tq, tk, tv, causal=True, q_chunk=16,
                               k_chunk=32),
          JA.chunked_attention(jq, jk, jv, causal=True, q_chunk=16,
                               k_chunk=32), F32_TOL)


def test_attention_dispatcher_paths_agree():
    (jq, jk, jv), (tq, tk, tv) = both(*qkv(1, 4, 2, 64, 64, 32))
    want = JA.attention(jq, jk, jv, impl="xla", q_chunk=16, k_chunk=16)
    for impl, kw in (("xla", dict(q_chunk=128, k_chunk=128)),
                     ("xla", dict(q_chunk=16, k_chunk=16)),
                     ("ref", {}), ("cuda", {})):
        close(TA.attention(tq, tk, tv, impl=impl, **kw), want, F32_TOL)
    with pytest.raises(ValueError, match="unknown attention impl"):
        TA.attention(tq, tk, tv, impl="pallas")


@pytest.mark.parametrize("per_slot", [False, True])
def test_decode_attention_matches_jax(per_slot):
    B, Hq, Hkv, S, D = 3, 4, 2, 40, 32
    q, k, v = qkv(B, Hq, Hkv, 1, S, D, seed=3)
    cache_len = np.array([5, 17, 39], np.int32) if per_slot else 21
    (jq, jk, jv), (tq, tk, tv) = both(q, k, v)
    want = JA.decode_attention(jq, jk, jv, jnp.asarray(cache_len))
    got = TA.decode_attention(tq, tk, tv, torch.as_tensor(cache_len))
    close(got, want, F32_TOL)


# (B, Hq, Hkv, Sq, Skv, D): GQA groups 1, 2 and 4, Sq < Skv, D 16 and 64
FLASH_SHAPES = [(1, 2, 2, 128, 128, 64), (2, 4, 2, 64, 128, 16),
                (1, 4, 1, 128, 128, 16), (1, 8, 2, 64, 192, 64)]
# an enc-dec decoder's cross-attention (not causal, Sq > Skv) and a vision
# backbone's GQA at D 128 (causal)
CROSS_SHAPE, GQA128_SHAPE = (2, 4, 4, 128, 64, 64), (1, 4, 2, 128, 128, 128)
BOTH_DTYPES = (("float32", F32_TOL), ("bfloat16", BF16_TOL))


@pytest.mark.parametrize("shape,causal,dtype,tol", [
    (shape, True, dtype, tol) for shape in FLASH_SHAPES
    for dtype, tol in BOTH_DTYPES]
    + [(FLASH_SHAPES[3], False, "float32", F32_TOL)]
    + [(shape, causal, dtype, tol)
       for shape, causal in ((CROSS_SHAPE, False), (GQA128_SHAPE, True))
       for dtype, tol in BOTH_DTYPES])
def test_flash_plain_matches_pallas_interpret(shape, causal, dtype, tol):
    (jq, jk, jv), (tq, tk, tv) = both(*qkv(*shape, seed=sum(shape)),
                                      dtype=dtype)
    got = flash_ops.flash_attention(tq, tk, tv, causal=causal)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    want = jax_flash(jq, jk, jv, causal=causal, impl="pallas_interpret",
                     bq=64, bk=64)
    close(got, want.astype(jnp.float32), tol)
    close(got, jax_ref(jq, jk, jv, causal=causal).astype(jnp.float32), tol)
    close(attention_ref(tq, tk, tv, causal=causal), want.astype(jnp.float32),
          tol)


def test_flash_plain_launches_nothing():
    _, (tq, tk, tv) = both(*qkv(1, 2, 2, 8, 8, 16))
    before = flash_ops.launches
    flash_ops.flash_attention(tq, tk, tv)
    assert flash_ops.launches == before


def test_flash_raises_on_causal_sq_above_skv():
    _, (tq, tk, tv) = both(*qkv(1, 2, 2, 16, 8, 16))
    with pytest.raises(ValueError, match="Sq 16 > Skv 8"):
        flash_ops.flash_attention(tq, tk, tv, causal=True)
    # without the mask every row sees every key: allowed
    assert flash_ops.flash_attention(tq, tk, tv, causal=False).shape == \
        tq.shape


def test_flash_raises_on_bad_shapes():
    _, (tq, tk, tv) = both(*qkv(1, 3, 2, 8, 8, 16))
    with pytest.raises(ValueError, match="not a multiple"):
        flash_ops.flash_attention(tq, tk, tv)
    with pytest.raises(ValueError, match="4-D"):
        flash_ops.flash_attention(tq[0], tk[0], tv[0])
    with pytest.raises(ValueError, match="inconsistent"):
        flash_ops.flash_attention(tq[:, :2], tk, tv[..., :8])


def test_attention_impl_follows_the_device(monkeypatch):
    monkeypatch.delenv("REPRO_ATTN_IMPL", raising=False)
    assert attention_impl("cpu") == "xla"
    assert attention_impl("cuda") == "cuda"
    monkeypatch.setenv("REPRO_ATTN_IMPL", "xla")
    assert attention_impl("cpu") == "xla"
    with pytest.raises(ValueError, match="cannot run on a cuda"):
        attention_impl("cuda")
    monkeypatch.setenv("REPRO_ATTN_IMPL", "cuda")
    with pytest.raises(ValueError, match="cannot run on a cpu"):
        attention_impl("cpu")
    monkeypatch.setenv("REPRO_ATTN_IMPL", "pallas")
    with pytest.raises(ValueError, match="unknown"):
        attention_impl("cpu")
