"""Mamba-1 selective scan: the CUDA kernel for CUDA tensors, the plain
version (``ref.selective_scan_ref``) for CPU tensors.

The kernel (``csrc/mamba_scan.cu``) replaces the TPU kernel
``selective_scan_pallas`` of ``src/repro/kernels/mamba_scan/kernel.py``:
a block owns a tile of channels of one sequence and walks all of its
time steps, each thread keeping several states of one channel in
registers; time chunks stream through a shared-memory ring filled by
``cp.async`` while earlier chunks run, the lanes of a channel reduce
``h * C_t`` for several steps in one reduce-scatter, and the final state
is written when it is asked for (prefill needs it; the TPU kernel wrote
none, so the reference's serving path never reached it).

Shapes it takes: x, delta ``(Bsz, S, E)``; A ``(E, N)``; Bm, Cm
``(Bsz, S, N)``; D ``(E,)``.  All float32 and contiguous, but x may be
bf16 (y is then bf16 too); N a power of two up to 32; any S (S = 0
launches nothing).
"""
import ctypes

import torch

from .. import build
from .ref import selective_scan_ref

REPLACES = "src/repro/kernels/mamba_scan/kernel.py:50"
SOURCE = "src/repro_torch/kernels/csrc/mamba_scan.cu"
STATE_SIZES = (1, 2, 4, 8, 16, 32)

# kernel launches in this process; chip_smoke.py resets and reads it
launches = 0


def _check_shapes(x, delta, A, Bm, Cm, D):
    if x.dim() != 3 or A.dim() != 2:
        raise ValueError("x must be (Bsz, S, E) and A (E, N)")
    Bsz, S, E = x.shape
    N = A.shape[1]
    want = {"delta": (delta, (Bsz, S, E)), "A": (A, (E, N)),
            "Bm": (Bm, (Bsz, S, N)), "Cm": (Cm, (Bsz, S, N)),
            "D": (D, (E,))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} is {tuple(t.shape)}, expected {shape} "
                             f"for x {tuple(x.shape)} and N {N}")


def _scan_cuda(x, delta, A, Bm, Cm, D, return_state):
    global launches
    build.check_input("x", x, torch.bfloat16 if x.dtype == torch.bfloat16
                      else torch.float32)
    for name, t in (("delta", delta), ("A", A), ("Bm", Bm), ("Cm", Cm),
                    ("D", D)):
        build.check_input(name, t, torch.float32)
    Bsz, S, E = x.shape
    N = A.shape[1]
    if N not in STATE_SIZES:
        raise ValueError(f"state size {N} not in {STATE_SIZES}")
    if Bsz > 65535:
        raise ValueError(f"batch {Bsz} > 65535")
    y = torch.empty_like(x)
    hT = torch.zeros((Bsz, E, N), dtype=torch.float32, device=x.device) \
        if return_state else None
    if Bsz and S and E:
        lib = build.library("mamba_scan")
        fn = lib.mamba_scan_fwd
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        status = fn(x.data_ptr(), delta.data_ptr(), A.data_ptr(),
                    Bm.data_ptr(), Cm.data_ptr(), D.data_ptr(), y.data_ptr(),
                    hT.data_ptr() if return_state else None, Bsz, S, E, N,
                    int(x.dtype == torch.bfloat16),
                    torch.cuda.current_stream(x.device).cuda_stream)
        build.check(lib, status, "mamba_scan")
        launches += 1
    return (y, hT) if return_state else y


def selective_scan(x, delta, A, Bm, Cm, D, *, return_state: bool = False):
    """y (Bsz, S, E) in ``x.dtype``, and with ``return_state`` also the
    final state hT (Bsz, E, N) float32; the state starts at 0.  The
    kernel runs for a CUDA tensor, the plain scan for a CPU tensor; a meta
    tensor gets the outputs' shapes (``build.on_meta``)."""
    _check_shapes(x, delta, A, Bm, Cm, D)
    if x.device.type == "cuda":
        return _scan_cuda(x, delta, A, Bm, Cm, D, return_state)
    if x.is_meta:
        y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
        hT = torch.empty((x.shape[0], x.shape[2], A.shape[1]),
                         dtype=torch.float32, device=x.device)
        return build.on_meta("mamba_scan",
                             (x, delta, A, Bm, Cm, D, return_state),
                             (y, hT) if return_state else y)
    y, hT = selective_scan_ref(x, delta, A, Bm, Cm, D)
    return (y, hT) if return_state else y
