"""Select kernel implementations per device.

The table kernels run as hand-written CUDA kernels on CUDA tensors and as
their plain PyTorch versions on CPU tensors: the tensor's device decides,
never a fallback.  Environment overrides mirror the JAX package's:

* ``REPRO_KERNEL_IMPL`` — table kernels: ``ref | cuda``.  It may only
  confirm what the device implies; asking for ``cuda`` on a CPU tensor or
  ``ref`` on a CUDA tensor raises;
* ``REPRO_JOIN_IMPL``    — local join algorithm: ``sortmerge | hash``;
* ``REPRO_GROUPBY_IMPL`` — local groupby/dedup algorithm: ``sort | hash``;
* ``REPRO_SEMI_IMPL``    — local membership algorithm (``isin``,
  ``semi_mask``, ``intersect``, ``difference``): ``sortmerge | hash``;
* ``REPRO_SORT_IMPL``    — local sort algorithm: ``xla`` (a chain of
  stable ``torch.sort`` calls; the name is kept for parity with the JAX
  package) or ``radix`` (the multi-pass LSD engine on the
  ``radix_sort`` kernel);
* ``REPRO_ATTN_IMPL`` — model attention: ``cuda`` (the flash kernel) on
  CUDA tensors, ``xla`` (the plain full or chunked attention; the name is
  kept for parity with the JAX package) on CPU tensors.  Like
  ``REPRO_KERNEL_IMPL`` it may only confirm what the device implies;
* ``REPRO_MAMBA_IMPL`` — the Mamba selective scan: ``cuda`` (the scan
  kernel) on CUDA tensors, ``xla`` (the plain scan in chunks,
  ``models.mamba.scan_chunked``) on CPU tensors; it too may only confirm
  what the device implies.
"""
import os

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA card; raises when there is none (the port
    never moves to the CPU silently — pass ``device="cpu"`` for that)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def table_kernel_impl(device) -> str:
    """'cuda' for CUDA tensors, 'ref' for CPU tensors."""
    device = torch.device(device)
    impl = "cuda" if device.type == "cuda" else "ref"
    env = os.environ.get("REPRO_KERNEL_IMPL")
    if env and env != impl:
        if env not in ("ref", "cuda"):
            raise ValueError(f"unknown REPRO_KERNEL_IMPL {env!r} "
                             "(expected 'ref' or 'cuda')")
        raise ValueError(f"REPRO_KERNEL_IMPL={env} cannot run on a "
                         f"{device.type} tensor: the kernels run on CUDA "
                         "tensors and their plain versions on CPU tensors")
    return impl


def join_impl() -> str:
    """Local join algorithm: 'sortmerge' (default) or 'hash'."""
    return os.environ.get("REPRO_JOIN_IMPL") or "sortmerge"


def groupby_impl() -> str:
    """Local groupby/aggregate/dedup algorithm: 'sort' (default) or
    'hash'."""
    return os.environ.get("REPRO_GROUPBY_IMPL") or "sort"


def semi_impl() -> str:
    """Local semi-join/membership algorithm: 'sortmerge' (binary search
    over the sorted key set, default) or 'hash' (bucketed build + probe on
    ``kernels/hash_semi``)."""
    return os.environ.get("REPRO_SEMI_IMPL") or "sortmerge"


def sort_impl() -> str:
    """Local sort algorithm: 'xla' (stable sort chain, default) or 'radix'
    (multi-pass LSD radix rank on ``kernels/radix_sort``)."""
    return os.environ.get("REPRO_SORT_IMPL") or "xla"


def _model_impl(device, env_var: str, which: str) -> str:
    """'cuda' for CUDA tensors, 'xla' for CPU tensors; ``env_var`` may
    only confirm that choice."""
    device = torch.device(device)
    impl = "cuda" if device.type == "cuda" else "xla"
    env = os.environ.get(env_var)
    if env and env != impl:
        if env not in ("xla", "cuda"):
            raise ValueError(f"unknown {env_var} {env!r} "
                             "(expected 'xla' or 'cuda')")
        raise ValueError(f"{env_var}={env} cannot run on a {device.type} "
                         f"tensor: {which}")
    return impl


def attention_impl(device) -> str:
    """'cuda' (the flash-attention kernel) for CUDA tensors, 'xla' (plain
    PyTorch attention) for CPU tensors.  A caller may still pass
    ``attn_impl="xla"`` explicitly on the card: that is the reference's
    XLA path, chosen, not a fallback."""
    return _model_impl(device, "REPRO_ATTN_IMPL",
                       "the flash kernel runs on CUDA tensors and plain "
                       "attention on CPU tensors")


def mamba_impl(device) -> str:
    """'cuda' (the selective-scan kernel) for CUDA tensors, 'xla' (the
    plain scan) for CPU tensors.  A caller may still pass
    ``mamba_impl="xla"`` explicitly on the card: that is the plain scan,
    chosen, not a fallback."""
    return _model_impl(device, "REPRO_MAMBA_IMPL",
                       "the scan kernel runs on CUDA tensors and the plain "
                       "scan on CPU tensors")
