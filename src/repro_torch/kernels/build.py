"""Build and load the hand-written CUDA kernels.

Every ``csrc/<name>.cu`` has a plain C interface and compiles on its own
with ``nvcc`` for Hopper (``sm_90a``) into a shared library under
``build/repro_torch/`` at the root of the checkout, named by a hash of the
source, the shared headers and the flags; ``ctypes`` loads it.  Nothing
is built when a module is imported: :func:`library` builds on first use,
and :func:`build` compiles several sources at once, one ``nvcc`` process
each, all started together.  The compiler's register and shared-memory
report (``-Xptxas -v``) is kept beside each library as ``<name>.log``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
KERNELS = ("hash_partition", "fused_bucketing", "hash_join",
           "radix_sort", "hash_groupby", "hash_semi", "flash_attention",
           "mamba_scan")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()

# observers of the kernels' calls on the ``meta`` device (the dry-run's
# cost counter, ``roofline/cost.py``): each is called with the kernel's
# name and the arguments its bound counts
meta_observers: list = []


def on_meta(name: str, args: tuple, out):
    """A kernel's call on ``meta`` tensors: nothing runs, every observer
    is told of the call, and ``out`` (empty tensors of the outputs'
    shapes) is returned, as a meta kernel gives shapes only.  A dry-run
    bills the kernel's own work, not its plain version's op trace."""
    for observe in meta_observers:
        observe(name, args)
    return out


# how a loop of identical iterations runs on ``meta`` tensors while a
# dry-run's cost counter (``roofline/cost.py``) counts: it puts here a
# ``repeat(n, fn, *args, carry=())`` that runs ``fn(*args)``, the first
# iteration, once and counts its ops, forward and backward, ``n`` times
meta_loops: list = []


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME")
    for cand in ((Path(home) / "bin" / "nvcc") if home else None,
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).is_file():
            return str(cand)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels are built from csrc/ at first use")


def target(name: str) -> Path:
    """The shared library that ``csrc/<name>.cu`` builds into."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in (CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names=KERNELS) -> dict[str, Path]:
    """Compile every kernel of ``names`` that is not built yet, one
    ``nvcc`` per source, all running at once.  Raises on a failed build."""
    jobs = {}
    for name in names:
        out = target(name)
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        jobs[name] = (out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (out, tmp, proc) in jobs.items():
        log, _ = proc.communicate()
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name}.cu:\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return {name: target(name) for name in names}


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        if name not in _loaded:
            lib = ctypes.CDLL(str(build((name,))[name]))
            lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
            lib.repro_cuda_error_string.restype = ctypes.c_char_p
            _loaded[name] = lib
        return _loaded[name]


def check_input(name: str, t: torch.Tensor, dtype=torch.int32) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype``."""
    if t.device.type != "cuda" or t.dtype != dtype \
            or not t.is_contiguous():
        kind = str(dtype).removeprefix("torch.")
        raise ValueError(f"{name} must be a contiguous {kind} CUDA tensor, "
                         f"got {t.dtype} on {t.device}")


def check(lib: ctypes.CDLL, status: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if status != 0:
        msg = lib.repro_cuda_error_string(status).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {status} "
                           f"({msg})")
