"""Mamba-1 block (PyTorch port of ``repro/models/mamba.py``): Falcon-Mamba
layers.

Two scan paths for the full sequence, both returning the final state:

* ``cuda`` — the ``kernels/mamba_scan`` kernel (CUDA tensors only;
  forward only, so a call that wants gradients raises);
* ``xla``  — :func:`scan_chunked`, the reference's chunked
  ``_scan_chunked_xla`` (the name is kept for parity with the JAX
  package): one ``torch.utils.checkpoint`` per chunk of steps, so a
  backward holds one chunk's per-step decays, inputs and states at a
  time.  ``mamba_scan/ref.py``, which forms them for the whole sequence
  and writes its states with ``out=`` (autograd refuses that), is only
  the kernel's plain version.

and ``mamba_step``, the O(1) single-token decode on the (conv, ssm)
state.  Parameters are stacked over layers as the rest of the model's
are; the in, x and out projections are bf16 and everything else float32,
``dt_proj.w`` included (the reference never casts it, and
``dt_low @ dt_proj.w`` runs in float32 — with TF32 off, PyTorch's
default for matrix products).

Under a ``policy`` whose model axis spans several ranks (the
reference's channel dim E sharded over the model axis) a rank holds the
parameters of its block of E/M channels (``sharding.shard_params``:
``in_proj``'s x and z columns of those channels, ``x_proj`` and
``out_proj``'s rows, ``dt_proj``'s columns, the conv, ``A_log`` and
``D`` of each channel) and its block of the states: the conv, the scan
and the gate run on its channels alone.  Two products cross the
channels: ``x_proj``, whose partial products are summed over the model
group in float32 and rounded to bf16 once, as the whole product is, so
that every rank holds the whole ``dt_low``, B and C (:func:`_ssm_inputs`),
and ``out_proj``, whose partial products are summed as the other
row-parallel products are (``layers.dense_rows``).  The block's input
passes through ``layers.model_copy``, so that its gradient sums the
ranks' channels.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..kernels import build
from ..kernels.mamba_scan import ops as scan_ops
from . import layers as Ly

F32 = torch.float32


def dt_rank(cfg) -> int:
    return cfg.dt_rank or max(1, math.ceil(cfg.d_model / 16))


def mamba_init(gen: torch.Generator, cfg, n: int, dtype=Ly.BF16) -> dict:
    """``n`` stacked Mamba blocks with the reference's initialisers; the
    in, x and out projections in ``dtype``."""
    d, E, N, K = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_conv
    R = dt_rank(cfg)
    dev = gen.device
    A = torch.arange(1, N + 1, dtype=F32, device=dev).expand(n, E, N)
    return {
        "in_proj": Ly.dense_init(gen, n, d, 2 * E, dtype=dtype),
        "conv_w": Ly.normal(gen, (n, K, E), Ly.INIT_STD, F32),
        "conv_b": torch.zeros((n, E), device=dev),
        "x_proj": Ly.dense_init(gen, n, E, R + 2 * N, dtype=dtype),
        "dt_proj": {
            "w": Ly.normal(gen, (n, R, E), R ** -0.5, F32),
            "b": torch.full((n, E), math.log(math.expm1(0.01)),
                            device=dev),
        },
        "A_log": torch.log(A).contiguous(),
        "D": torch.ones((n, E), device=dev),
        "out_proj": Ly.dense_init(
            gen, n, E, d, std=Ly.INIT_STD / math.sqrt(2 * cfg.n_layers),
            dtype=dtype),
    }


def _causal_conv(x, w, b):
    """Depthwise causal conv via K shifted adds.  x (B,S,E), w (K,E) ->
    float32 (B,S,E)."""
    K = w.shape[0]
    S = x.shape[1]
    xp = F.pad(x.float(), (0, 0, K - 1, 0))
    y = torch.zeros(x.shape, dtype=F32, device=x.device)
    for k in range(K):
        y = y + xp[:, k:k + S] * w[k].float()
    return y + b.float()


def _channels(p) -> int:
    """The channels of the block's parameters as held here: E at world
    1, this rank's E/M under a sharded model axis."""
    return p["in_proj"]["w"].shape[-1] // 2


def _ssm_inputs(p, cfg, xc, policy=None):
    """xc (B,S,E) float32 -> (delta (B,S,E), A (E,N), Bm, Cm (B,S,N)),
    all float32; E is the channels held here.  Under a sharded model
    axis ``x_proj``'s partial products (bf16 operands, float32 products
    and sums) are summed over the model group in float32 and rounded to
    bf16 once; its gradient, which each rank's channels give in part, is
    summed over the group in float32 and then rounded to bf16 once, as
    world 1's backward rounds its one product."""
    N = cfg.ssm_state
    R = dt_rank(cfg)
    w = p["x_proj"]["w"].to(Ly.BF16)
    if policy is None or not policy.sharded:
        proj = (xc.to(Ly.BF16) @ w).float()
    else:
        part = xc.to(Ly.BF16).float() @ w.float()
        proj = Ly.model_copy(Ly.model_sum(part, policy).to(Ly.BF16).float(),
                             policy)
    dt_low, Bm, Cm = proj[..., :R], proj[..., R:R + N], proj[..., R + N:]
    delta = F.softplus(dt_low @ p["dt_proj"]["w"].float()
                       + p["dt_proj"]["b"].float())
    A = -torch.exp(p["A_log"].float())
    return delta, A, Bm.contiguous(), Cm.contiguous()


def _conv_state(x_in, K: int):
    """The last K - 1 inputs of the conv, left-padded with zeros."""
    S = x_in.shape[1]
    xf = x_in.float()
    if S >= K - 1:
        return xf[:, S - (K - 1):].contiguous()
    return F.pad(xf, (0, 0, K - 1 - S, 0))


def _scan_steps(x, delta, A, Bm, Cm, h):
    """One chunk, out of place: x, delta (B,c,E); Bm, Cm (B,c,N); h
    (B,E,N) -> (y (B,c,E) without the D term, h after the chunk).  The
    chunk's decays and inputs are formed at once, (B,c,E,N) each; a step
    is then one multiply-add, and y one contraction over N."""
    dA = torch.exp(delta[..., None] * A)
    dBx = (delta * x)[..., None] * Bm[:, :, None, :]
    hs = []
    for t in range(x.shape[1]):
        h = torch.addcmul(dBx[:, t], dA[:, t], h)
        hs.append(h)
    y = torch.einsum("bcen,bcn->bce", torch.stack(hs, dim=1), Cm)
    return y, h


def scan_chunked(x, delta, A, Bm, Cm, D, h0=None, chunk: int = 128):
    """The selective scan for training (the reference's
    ``_scan_chunked_xla``), float32: one ``torch.utils.checkpoint`` per
    chunk of ``min(chunk, S)`` steps; the last chunk may be shorter, so
    any S.  x, delta (B,S,E); A (E,N); Bm, Cm (B,S,N); D (E,); optional
    h0 (B,E,N) -> (y (B,S,E), hT (B,E,N))."""
    Bsz, S, E = x.shape
    h = x.new_zeros((Bsz, E, A.shape[1])) if h0 is None else h0
    c = max(1, min(chunk, S))
    ys, start = [], 0

    def one(s0, x, delta, A, Bm, Cm, h):
        t = slice(s0, s0 + c)
        return checkpoint(_scan_steps, x[:, t], delta[:, t], A, Bm[:, t],
                          Cm[:, t], h, use_reentrant=False)

    n = S // c - 2           # the whole chunks between the first and last
    if x.is_meta and n > 1 and build.meta_loops:
        # a dry-run's count (``kernels/build.meta_loops``): the whole
        # chunks between the first (whose h takes no gradient) and the
        # last (whose h may give none) run the same ops, so the second
        # runs and counts for all of them
        y, h = one(0, x, delta, A, Bm, Cm, h)
        ys.append(y)
        y, h = build.meta_loops[-1](n, one, c, x, delta, A, Bm, Cm, h,
                                    carry=(6,))
        ys += [y] + [y.detach()] * (n - 1)
        start = (n + 1) * c
    for s0 in range(start, S, c):
        y, h = one(s0, x, delta, A, Bm, Cm, h)
        ys.append(y)
    y = torch.cat(ys, dim=1) if ys else x.new_zeros(x.shape)
    return y + x * D, h


def mamba_apply(p, cfg, x, *, impl: str = "xla", scan_chunk: int = 128,
                return_state: bool = False, policy=None):
    """Full-sequence Mamba block.  x (B,S,d) -> (y (B,S,d), state | None)
    with state ``{"conv" (B,K-1,E), "ssm" (B,E,N)}`` float32 (E: the
    channels held here).  ``impl``: ``cuda`` (the scan kernel; on CPU
    tensors its wrapper's plain version) or ``xla`` (:func:`scan_chunked`
    in chunks of ``scan_chunk`` steps)."""
    E, K = _channels(p), cfg.ssm_conv
    xz = Ly.dense(p["in_proj"], Ly.model_copy(x, policy))     # (B,S,2E)
    x_in, z = xz[..., :E], xz[..., E:]
    xc = F.silu(_causal_conv(x_in, p["conv_w"], p["conv_b"]))
    delta, A, Bm, Cm = _ssm_inputs(p, cfg, xc, policy)
    D = p["D"].float()
    grads = torch.is_grad_enabled() and (xc.requires_grad
                                         or delta.requires_grad)
    if impl == "cuda" and grads:
        raise ValueError("the mamba_scan kernel has no backward; train "
                         "with mamba_impl='xla'")
    if impl == "cuda":
        y = scan_ops.selective_scan(xc, delta, A, Bm, Cm, D,
                                    return_state=return_state)
        y, hT = y if return_state else (y, None)
    elif impl == "xla":
        y, hT = scan_chunked(xc, delta, A, Bm, Cm, D, chunk=scan_chunk)
    else:
        raise ValueError(f"unknown mamba impl {impl!r} (expected 'cuda' or "
                         "'xla')")
    y = y * F.silu(z.float())
    out = Ly.dense_rows(p["out_proj"], y.to(x.dtype), policy)
    if return_state:
        return out, {"conv": _conv_state(x_in, K), "ssm": hT}
    return out, None


def mamba_step(p, cfg, x, state, policy=None):
    """Single-token decode.  x (B,1,d); ``state = {"conv" (B,K-1,E),
    "ssm" (B,E,N)}`` float32 (this rank's channels under a sharded model
    axis), updated IN PLACE (the reference returns a new state and
    donates the old buffers).  Returns (y (B,1,d), state)."""
    E = _channels(p)
    xz = Ly.dense(p["in_proj"], Ly.model_copy(x, policy))     # (B,1,2E)
    x_in, z = xz[..., :E], xz[..., E:]
    window = torch.cat([state["conv"], x_in.float()], dim=1)   # (B,K,E)
    xc = torch.einsum("bke,ke->be", window, p["conv_w"].float()) \
        + p["conv_b"].float()
    xc = F.silu(xc)[:, None, :]                           # (B,1,E)
    delta, A, Bm, Cm = _ssm_inputs(p, cfg, xc, policy)
    dA = torch.exp(delta[:, 0, :, None] * A[None])        # (B,E,N)
    h = dA * state["ssm"] + (delta[:, 0] * xc[:, 0])[..., None] \
        * Bm[:, 0][:, None, :]
    y = torch.einsum("ben,bn->be", h, Cm[:, 0]) \
        + xc[:, 0] * p["D"].float()[None]
    y = (y * F.silu(z[:, 0].float()))[:, None, :]
    out = Ly.dense_rows(p["out_proj"], y.to(x.dtype), policy)
    state["conv"].copy_(window[:, 1:])
    state["ssm"].copy_(h)
    return out, state
