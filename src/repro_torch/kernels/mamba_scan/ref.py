"""Plain PyTorch version of the Mamba-1 selective scan.

The tolerance anchor for the CUDA kernel, as ``selective_scan_ref`` is
for the TPU kernel in the JAX package (Mamba paper: ZOH for A, Euler for
B; ``delta`` already softplus-ed):

    h_t = exp(delta_t * A) * h_{t-1} + (delta_t * x_t) B_t
    y_t = <h_t, C_t> + D * x_t

all in float32.  A loop over t, one fused multiply-add of the state per
step: the decay ``exp(delta A)`` and the input ``(delta x) B`` of every
step are formed first, the states of all steps are kept and ``y`` is one
contraction over N at the end.
"""
import torch


def selective_scan_ref(x, delta, A, Bm, Cm, D, h0=None):
    """x, delta (Bsz, S, E); A (E, N); Bm, Cm (Bsz, S, N); D (E,);
    optional h0 (Bsz, E, N) -> (y (Bsz, S, E) in ``x.dtype``,
    hT (Bsz, E, N) float32).  Any S >= 0."""
    Bsz, S, E = x.shape
    N = A.shape[1]
    xf, df = x.float(), delta.float()
    Bf, Cf = Bm.float(), Cm.float()
    dA = torch.exp(df[..., None] * A.float())              # (Bsz,S,E,N)
    dBx = (df * xf)[..., None] * Bf[:, :, None, :]
    h = torch.zeros((Bsz, E, N), dtype=torch.float32, device=x.device) \
        if h0 is None else h0.float()
    hs = torch.empty((S, Bsz, E, N), dtype=torch.float32, device=x.device)
    for t in range(S):
        h = torch.addcmul(dBx[:, t], dA[:, t], h, out=hs[t])
    y = torch.einsum("sben,bsn->bse", hs, Cf) + xf * D.float()
    return y.to(x.dtype), h.clone()
