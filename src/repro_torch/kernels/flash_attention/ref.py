"""Plain PyTorch version of the fused attention kernel (GQA + causal).

The tolerance anchor for the CUDA kernel, as ``attention_ref`` is for the
TPU kernel in the JAX package: float32 math throughout, masked scores set
to ``-inf``, the causal mask right-aligned (query row ``i`` sees key
columns ``<= i + Skv - Sq``).
"""
import torch


def attention_ref(q, k, v, *, causal: bool = True,
                  scale: float | None = None):
    """q: (B, Hq, Sq, D); k, v: (B, Hkv, Skv, D); Hq % Hkv == 0 ->
    (B, Hq, Sq, D) in ``q.dtype``."""
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    group = Hq // Hkv
    scale = scale if scale is not None else D ** -0.5
    qf = q.float() * scale
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf)
    if causal:
        qi = torch.arange(Sq, device=q.device)[:, None] + (Skv - Sq)
        kj = torch.arange(Skv, device=q.device)[None, :]
        s = s.masked_fill(kj > qi, float("-inf"))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    return torch.einsum("bhqk,bhkd->bhqd", p, vf).to(q.dtype)
