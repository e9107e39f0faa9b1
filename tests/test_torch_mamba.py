"""The port's Mamba-1 pieces against the JAX package, on the CPU.

* The selective scan: the port's ``selective_scan`` (on CPU tensors, the
  plain version) against the reference's Pallas kernel in interpret mode
  on two of ``tests/test_kernels.py``'s ``SCAN_SWEEP`` shapes, and its
  final state, a ragged S, an initial state and bf16 x against the
  reference's ``selective_scan_ref``.  Tolerance 2e-4 (rtol and atol),
  the reference's own for its kernel (bf16 x: 3e-2, as the reference's
  bf16 test); the two sum over N in other orders.
* The Mamba block on reduced ``falcon-mamba-7b``, weights from the
  reference's ``mamba_init`` carried across by ``params_from_jax``:
  ``mamba_apply`` with its state and ``mamba_step``.  Outputs are bf16
  (the out projection) and within ``LOGIT_TOL = 2e-2`` as in
  ``tests/test_torch_model.py``; states within 2e-2 of the state's
  largest magnitude (the ssm state of these random weights is of order
  1e-7, so an absolute tolerance would test nothing).
* The port's own full-sequence block against its step-by-step decode,
  as ``tests/test_mamba.py`` holds the reference.
* ``kernel_backend.mamba_impl`` and the wrapper's shape checks.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_reduced as jax_reduced
from repro.kernels.mamba_scan import selective_scan as jax_scan
from repro.kernels.mamba_scan.ref import selective_scan_ref as jax_scan_ref
from repro.models import mamba as JMb
from repro_torch.configs import get_reduced
from repro_torch.core.kernel_backend import mamba_impl
from repro_torch.kernels.mamba_scan import ops as scan_ops
from repro_torch.kernels.mamba_scan import selective_scan, selective_scan_ref
from repro_torch.models import mamba as Mb
from repro_torch.models import model as M

SCAN_TOL = 2e-4
LOGIT_TOL = 2e-2
ARCH = "falcon-mamba-7b"


def scan_inputs(B, S, E, N, seed=0):
    """x, delta, A, B, C, D as numpy: delta softplus-ed, A negative."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, S, E)).astype(np.float32)
    delta = np.log1p(np.exp(rng.normal(size=(B, S, E)))).astype(np.float32)
    A = -np.exp(rng.normal(size=(E, N)) * 0.5).astype(np.float32)
    Bm = rng.normal(size=(B, S, N)).astype(np.float32)
    Cm = rng.normal(size=(B, S, N)).astype(np.float32)
    D = rng.normal(size=(E,)).astype(np.float32)
    return x, delta, A, Bm, Cm, D


def torch_args(args):
    return tuple(torch.from_numpy(a) for a in args)


def jax_args(args):
    return tuple(jnp.asarray(a) for a in args)


def close(got, want, tol=SCAN_TOL):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(jnp.asarray(want, jnp.float32)),
                               rtol=tol, atol=tol)


def state_close(got, want, tol=LOGIT_TOL):
    """Within ``tol`` of the state's largest magnitude."""
    want = np.asarray(want, np.float32)
    scale = float(np.abs(want).max())
    assert scale > 0
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=tol * scale)


# (B, S, E, N, be, chunk) of the reference's SCAN_SWEEP
@pytest.mark.parametrize("B,S,E,N,be,chunk", [(1, 64, 32, 8, 32, 32),
                                              (2, 128, 64, 16, 32, 64)])
def test_scan_matches_the_pallas_kernel(B, S, E, N, be, chunk):
    args = scan_inputs(B, S, E, N, seed=S + E)
    want = jax_scan(*jax_args(args), impl="pallas_interpret", be=be,
                    chunk=chunk)
    close(selective_scan(*torch_args(args)), want)


@pytest.mark.parametrize("B,S,E,N", [(2, 48, 32, 16), (1, 37, 24, 8),
                                     (3, 1, 16, 4), (1, 5, 8, 32)])
def test_scan_and_final_state_match_the_reference(B, S, E, N):
    """y and hT against ``selective_scan_ref``; S = 37 and 1 are ragged
    for any block of time steps."""
    args = scan_inputs(B, S, E, N, seed=B * S + N)
    jy, jh = jax_scan_ref(*jax_args(args))
    ty, th = selective_scan(*torch_args(args), return_state=True)
    assert ty.dtype == torch.float32 and th.shape == (B, E, N)
    close(ty, jy)
    close(th, jh)


def test_scan_from_an_initial_state():
    args = scan_inputs(2, 9, 16, 8, seed=3)
    h0 = np.random.default_rng(4).normal(size=(2, 16, 8)).astype(np.float32)
    jy, jh = jax_scan_ref(*jax_args(args), h0=jnp.asarray(h0))
    ty, th = selective_scan_ref(*torch_args(args), h0=torch.from_numpy(h0))
    close(ty, jy)
    close(th, jh)
    # two halves chained through the state give the whole sequence
    x, d, A, Bm, Cm, D = torch_args(args)
    y1, h1 = selective_scan_ref(x[:, :4], d[:, :4], A, Bm[:, :4], Cm[:, :4],
                                D, h0=torch.from_numpy(h0))
    y2, h2 = selective_scan_ref(x[:, 4:], d[:, 4:], A, Bm[:, 4:], Cm[:, 4:],
                                D, h0=h1)
    torch.testing.assert_close(torch.cat([y1, y2], 1), ty, rtol=1e-6,
                               atol=1e-6)
    torch.testing.assert_close(h2, th, rtol=1e-6, atol=1e-6)


def test_scan_bf16_x():
    """bf16 x gives bf16 y, within the reference's bf16 tolerance of its
    float32 ref."""
    args = scan_inputs(1, 32, 16, 8, seed=5)
    jy, _ = jax_scan_ref(*jax_args(args))
    x = torch.from_numpy(args[0]).bfloat16()
    ty = selective_scan(x, *torch_args(args[1:]))
    assert ty.dtype == torch.bfloat16
    close(ty, jy, 3e-2)


def test_scan_empty_sequence():
    x, d, A, Bm, Cm, D = torch_args(scan_inputs(2, 0, 8, 4))
    y, h = selective_scan(x, d, A, Bm, Cm, D, return_state=True)
    assert y.shape == (2, 0, 8) and h.shape == (2, 8, 4)
    assert not bool(h.any())


def test_scan_wrapper_checks_shapes_and_counts_no_cpu_launch():
    x, d, A, Bm, Cm, D = torch_args(scan_inputs(1, 6, 8, 4))
    before = scan_ops.launches
    selective_scan(x, d, A, Bm, Cm, D)
    assert scan_ops.launches == before
    with pytest.raises(ValueError, match="delta"):
        selective_scan(x, d[:, :5], A, Bm, Cm, D)
    with pytest.raises(ValueError, match="Bm"):
        selective_scan(x, d, A, Bm[..., :3], Cm, D)
    with pytest.raises(ValueError, match="D is"):
        selective_scan(x, d, A, Bm, Cm, D[:4])
    with pytest.raises(ValueError, match="x must be"):
        selective_scan(x[0], d, A, Bm, Cm, D)


def test_mamba_impl_follows_the_device(monkeypatch):
    monkeypatch.delenv("REPRO_MAMBA_IMPL", raising=False)
    assert mamba_impl("cpu") == "xla"
    assert mamba_impl("cuda") == "cuda"
    monkeypatch.setenv("REPRO_MAMBA_IMPL", "xla")
    assert mamba_impl("cpu") == "xla"
    with pytest.raises(ValueError, match="cannot run on a cuda"):
        mamba_impl("cuda")
    monkeypatch.setenv("REPRO_MAMBA_IMPL", "cuda")
    with pytest.raises(ValueError, match="cannot run on a cpu"):
        mamba_impl("cpu")
    monkeypatch.setenv("REPRO_MAMBA_IMPL", "pallas")
    with pytest.raises(ValueError, match="unknown"):
        mamba_impl("cpu")


# --------------------------------------------------------------------------
# the Mamba block on reduced falcon-mamba-7b
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def block():
    """(reference cfg, reference params, port cfg, port params) of one
    Mamba block; ``dt_proj.b`` and ``D`` drawn away from their constant
    init so that they matter."""
    cfg, tcfg = jax_reduced(ARCH), get_reduced(ARCH)
    tree = jax.tree_util.tree_map(
        np.asarray, JMb.mamba_init(jax.random.PRNGKey(7), cfg))
    rng = np.random.default_rng(7)
    tree["dt_proj"]["b"] = tree["dt_proj"]["b"] + rng.normal(
        scale=0.5, size=tree["dt_proj"]["b"].shape).astype(np.float32)
    tree["D"] = tree["D"] + rng.normal(
        scale=0.1, size=tree["D"].shape).astype(np.float32)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    return cfg, jp, tcfg, M.params_from_jax(tree, tcfg, "cpu")


def block_input(cfg, B, S, seed):
    x = np.random.default_rng(seed).normal(size=(B, S, cfg.d_model))
    return x.astype(np.float32) * 0.5


def test_params_keep_dt_proj_float32(block):
    _, _, _, tp = block
    assert tp["dt_proj"]["w"].dtype == torch.float32
    for name in ("in_proj", "x_proj", "out_proj"):
        assert tp[name]["w"].dtype == torch.bfloat16


@pytest.mark.parametrize("impl", ["xla", "cuda"])
@pytest.mark.parametrize("S", [16, 2])
def test_mamba_apply_with_state_matches_jax(block, impl, S):
    """``cuda`` on CPU tensors is the scan wrapper's plain version; S = 2
    is shorter than the conv window (K - 1 = 3), so its conv state is
    left-padded."""
    cfg, jp, tcfg, tp = block
    x = block_input(cfg, 2, S, seed=S)
    jy, js = jax.jit(lambda p, v: JMb.mamba_apply(
        p, cfg, v, return_state=True))(jp, jnp.asarray(x, jnp.bfloat16))
    ty, ts = Mb.mamba_apply(tp, tcfg, torch.from_numpy(x).bfloat16(),
                            impl=impl, return_state=True)
    assert ty.dtype == torch.bfloat16
    close(ty, jy, LOGIT_TOL)
    for k in ("conv", "ssm"):
        assert ts[k].dtype == torch.float32 and ts[k].shape == js[k].shape
        state_close(ts[k], js[k])
    ty2, none = Mb.mamba_apply(tp, tcfg, torch.from_numpy(x).bfloat16(),
                               impl=impl)
    assert none is None and torch.equal(ty2, ty)


def test_mamba_step_matches_jax(block):
    cfg, jp, tcfg, tp = block
    B, S = 2, 8
    x = block_input(cfg, B, S, seed=11)
    _, js = JMb.mamba_apply(jp, cfg, jnp.asarray(x, jnp.bfloat16),
                            return_state=True)
    _, ts = Mb.mamba_apply(tp, tcfg, torch.from_numpy(x).bfloat16(),
                           return_state=True)
    x1 = block_input(cfg, B, 1, seed=12)
    jy, js = jax.jit(lambda p, v, s: JMb.mamba_step(p, cfg, v, s))(
        jp, jnp.asarray(x1, jnp.bfloat16), js)
    ids = {k: id(v) for k, v in ts.items()}
    ty, ts2 = Mb.mamba_step(tp, tcfg, torch.from_numpy(x1).bfloat16(), ts)
    assert {k: id(v) for k, v in ts2.items()} == ids      # in place
    close(ty, jy, LOGIT_TOL)
    for k in ("conv", "ssm"):
        state_close(ts2[k], js[k])


def test_full_sequence_equals_stepwise_decode(block):
    """The port's block over 12 tokens at once equals 12 ``mamba_step``
    calls from a zero state (the reference's own SSM decode test), and so
    does the final state."""
    _, _, tcfg, tp = block
    B, S = 2, 12
    x = torch.from_numpy(block_input(tcfg, B, S, seed=13)).bfloat16()
    y_full, s_full = Mb.mamba_apply(tp, tcfg, x, return_state=True)
    state = {"conv": torch.zeros((B, tcfg.ssm_conv - 1, tcfg.d_inner)),
             "ssm": torch.zeros((B, tcfg.d_inner, tcfg.ssm_state))}
    ys = [Mb.mamba_step(tp, tcfg, x[:, t:t + 1], state)[0] for t in range(S)]
    torch.testing.assert_close(torch.cat(ys, 1).float(), y_full.float(),
                               rtol=2e-3, atol=2e-3)
    for k in ("conv", "ssm"):
        torch.testing.assert_close(state[k], s_full[k], rtol=1e-4,
                                   atol=1e-4 * float(s_full[k].abs().max()))


def test_unknown_scan_impl_raises(block):
    _, _, tcfg, tp = block
    with pytest.raises(ValueError, match="unknown mamba impl"):
        Mb.mamba_apply(tp, tcfg, torch.zeros((1, 2, tcfg.d_model)),
                       impl="pallas")


def test_init_params_shapes_match_the_reference():
    """``init_params`` from a torch.Generator has the reference's tree,
    shapes and constant leaves (A_log, D, conv_b, dt_proj.b)."""
    from repro.models import model as JM
    cfg, tcfg = jax_reduced(ARCH), get_reduced(ARCH)
    jp = jax.eval_shape(lambda: JM.init_params(jax.random.PRNGKey(0), cfg))
    tp = M.init_params(torch.Generator().manual_seed(0), tcfg)
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert len(flat) == sum(1 for _ in _leaves(tp))
    for path, leaf in flat:
        node = tp
        for k in path:
            node = node[k.key]
        assert tuple(node.shape) == leaf.shape, path
    real = JM.init_params(jax.random.PRNGKey(0), cfg)["layers"]["mamba"]
    for name in ("A_log", "D", "conv_b"):
        np.testing.assert_allclose(tp["layers"]["mamba"][name].numpy(),
                                   np.asarray(real[name]), rtol=1e-6)
    np.testing.assert_allclose(tp["layers"]["mamba"]["dt_proj"]["b"].numpy(),
                               np.asarray(real["dt_proj"]["b"]), rtol=1e-5)


def _leaves(tree):
    for v in tree.values():
        yield from _leaves(v) if isinstance(v, dict) else (v,)
