"""Fused attention forward: the CUDA kernel for CUDA tensors, the plain
version (``ref.attention_ref``) for CPU tensors.

The kernel (``csrc/flash_attention.cu``) replaces the TPU kernel
``flash_attention_fwd`` of ``src/repro/kernels/flash_attention/kernel.py``:
online softmax over key tiles with the running max, normalizer and
accumulator in float32, grouped-query heads read from their KV head, the
causal mask right-aligned and masked scores at ``-1e30``.  It runs both
products on Hopper's warpgroup tensor cores (``wgmma``) with the K and V
tiles brought in by TMA, which is why the tensors must start on a 16-byte
boundary.

Shapes it takes: q ``(B, Hq, Sq, D)`` and k, v ``(B, Hkv, Skv, D)``, all
contiguous bf16 (what the model path gives it), ``Hq % Hkv == 0`` and
``D`` in {16, 32, 64, 128}; ragged ``Sq`` and ``Skv`` are masked in the
kernel.  Causal ``Sq > Skv`` raises on either device: there a query row
may see no key at all, and the TPU kernel (a ``-1e30`` mask, so a uniform
average of the values) and ``attention_ref`` (``-inf``, so NaN) disagree;
no caller in either package passes that shape.
"""
import ctypes
import functools

import torch

from .. import build
from .ref import attention_ref

REPLACES = "src/repro/kernels/flash_attention/kernel.py:77"
SOURCE = "src/repro_torch/kernels/csrc/flash_attention.cu"
HEAD_DIMS = (16, 32, 64, 128)

# kernel launches in this process; chip_smoke.py resets and reads it
launches = 0


def _check_shapes(q, k, v, causal):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k and v must be 4-D (B, H, S, D)")
    B, Hq, Sq, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"inconsistent shapes: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    Hkv, Skv = k.shape[1], k.shape[2]
    if Hkv == 0 or Hq % Hkv != 0:
        raise ValueError(f"{Hq} query heads are not a multiple of "
                         f"{Hkv} KV heads")
    if causal and Sq > Skv:
        raise ValueError(f"causal attention with Sq {Sq} > Skv {Skv}: a "
                         "query row would see no key (the TPU kernel and "
                         "attention_ref disagree there)")


@functools.cache
def _entry():
    """(library, its ``flash_attention_fwd`` with argument types set)."""
    lib = build.library("flash_attention")
    fn = lib.flash_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 \
        + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def _flash_cuda(q, k, v, causal):
    global launches
    for name, t in (("q", q), ("k", k), ("v", v)):
        build.check_input(name, t, torch.bfloat16)
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not in {HEAD_DIMS}")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("q, k and v must start on a 16-byte boundary "
                         "(the kernel loads them with TMA)")
    out = torch.empty_like(q)
    if B == 0 or Hq == 0 or Sq == 0:
        return out
    if Skv == 0:
        raise ValueError("attention over zero keys")
    lib, fn = _entry()
    status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                B, Hq, Hkv, Sq, Skv, D, int(causal), D ** -0.5,
                torch.cuda.current_stream(q.device).cuda_stream)
    build.check(lib, status, "flash_attention")
    launches += 1
    return out


def flash_attention(q, k, v, *, causal: bool = True):
    """softmax(q kᵀ / sqrt(D)) v per head, query head ``h`` on KV head
    ``h // (Hq / Hkv)`` -> ``(B, Hq, Sq, D)`` in ``q.dtype``.  The kernel
    runs for a CUDA tensor, the plain version for a CPU tensor; a meta
    tensor gets the output's shape (``build.on_meta``)."""
    _check_shapes(q, k, v, causal)
    if q.device.type == "cuda":
        return _flash_cuda(q, k, v, causal)
    if q.is_meta:
        return build.on_meta("flash_attention", (q, k, v, causal),
                             torch.empty(q.shape, dtype=q.dtype,
                                         device=q.device))
    return attention_ref(q, k, v, causal=causal)
