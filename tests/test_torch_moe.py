"""The port's MoE layers against the JAX package, on the CPU.

The reference's five cases (``tests/test_moe.py``) on the port, each also
held to the reference on the same numpy inputs (weights from the
reference's ``moe_init`` carried across by ``params_from_jax``, so the
experts are bf16 and the router float32 in both):

* ``_route``: weights normalised, ids in range, aux near 1; against the
  reference, ids equal and weights within ``ROUTE_TOL`` on every token
  whose routing is clear; aux within ``ROUTE_TOL`` relative of the
  float64 aux of each package's own first choices, and of the other's
  where their first choices agree.  A token
  is clear when each gap between consecutive router probabilities from
  the first to the (k+1)-th, taken as the gap of their logarithms (the
  probabilities' relative gap, which is what float32 rounding moves), is
  above ``TIE_GAP``: the two packages' float32 router products on inputs
  of identical bits differ by about 1e-6 of the logits, so below the gap
  either order is right.
* ``_expert_ffn``: within ``BF16_TOL`` of the reference (rtol, and atol
  of ``BF16_TOL`` times the largest magnitude): both run bf16 products
  with float32 sums, in other orders, so an output may differ by a bf16
  ulp or two.
* ``moe_dense`` on reduced ``granite-moe-3b-a800m``, reduced
  ``qwen3-moe-235b-a22b`` and a 20-expert variant padded to 32: shapes,
  finiteness, ids as above, and the outputs of the clear tokens within
  ``BF16_TOL``; at least ``CLEAR_SHARE`` of the tokens must be clear.
* ``moe_apply`` without a mesh is ``moe_dense``, bit for bit.
* Expert padding: 40 experts pad to 48 and 20 to 32, the router keeps the
  routing width, ids stay below it, and the padded rows are never
  computed (NaN there leaves the output finite); ``params_from_jax``
  carries the padded rows across.
* The gradient reaches the router, finite everywhere, and the router's
  gradient is within ``GRAD_TOL`` of the reference's, relative to its
  largest element.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as jax_config
from repro.configs import get_reduced as jax_reduced
from repro.models import moe as JMoe
from repro_torch.configs import get_config, get_reduced
from repro_torch.models import model as M
from repro_torch.models import moe as Moe

TIE_GAP = 1e-4
ROUTE_TOL = 1e-5
BF16_TOL = 2e-2
GRAD_TOL = 2e-2
CLEAR_SHARE = 0.9
PADDED = "granite-moe-3b-a800m/20"      # 20 experts, padded to 32
CASES = ("granite-moe-3b-a800m", "qwen3-moe-235b-a22b", PADDED)


def configs(case):
    """(reference cfg, port cfg) of a case: a reduced config, or with a
    ``/n`` suffix the same with ``n`` experts."""
    arch, _, n = case.partition("/")
    jcfg, cfg = jax_reduced(arch), get_reduced(arch)
    if n:
        jcfg = dataclasses.replace(jcfg, n_experts=int(n))
        cfg = dataclasses.replace(cfg, n_experts=int(n))
    return jcfg, cfg


def weights(jcfg, cfg, seed):
    """The reference's ``moe_init`` tree and the port's copy of it."""
    jp = JMoe.moe_init(jax.random.PRNGKey(seed), jcfg)
    tp = M.params_from_jax(jax.tree_util.tree_map(np.asarray, jp), cfg,
                           "cpu")
    return jp, tp


def bf16_input(shape, seed):
    """numpy float32 values that bf16 holds exactly, and both packages'
    bf16 arrays of them."""
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    x = np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    return x, jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).bfloat16()


def routing_gaps(router, x2, k):
    """(T, k): the gaps between each token's consecutive router
    log-probabilities (the logits less one constant a token), first to
    (k+1)-th, in float64 on the host."""
    logits = x2.astype(np.float64) @ np.asarray(router, np.float64)
    return -np.diff(-np.sort(-logits, axis=-1)[:, :k + 1], axis=-1)


def clear_tokens(router, x2, k):
    """Tokens whose top-k ids and their order are clear of ties."""
    return routing_gaps(router, x2, k).min(-1) > TIE_GAP


def aux_of(first, router, x2):
    """The auxiliary loss of the first choices ``first`` (T,) on the
    float64 router probabilities: ``E * sum(frac * pmean)``."""
    logits = x2.astype(np.float64) @ np.asarray(router, np.float64)
    p = np.exp(logits - logits.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    E = p.shape[1]
    frac = np.bincount(np.asarray(first), minlength=E) / len(first)
    return E * float(np.sum(frac * p.mean(0)))


def check_aux(aux, ids, jaux, jids, router, x2):
    """Each package's aux within ROUTE_TOL of the float64 aux of its own
    first choices (which differ only at a tie), and the two equal where
    their first choices are."""
    for a, i in ((aux, ids), (jaux, jids)):
        want = aux_of(np.asarray(i)[:, 0], router, x2)
        assert abs(float(a) - want) <= ROUTE_TOL * want, (float(a), want)
    if np.array_equal(np.asarray(ids)[:, 0], np.asarray(jids)[:, 0]):
        assert abs(float(aux) - float(jaux)) <= ROUTE_TOL * float(jaux)


def close(got, want, tol=BF16_TOL):
    want = np.asarray(jnp.asarray(want, jnp.float32))
    got = got.float().detach().numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * float(np.abs(want).max()))


def test_router_weights_normalized():
    jcfg, cfg = configs("qwen3-moe-235b-a22b")
    rng = np.random.default_rng(0)
    router = rng.normal(size=(cfg.d_model, cfg.n_experts)).astype(np.float32)
    x, jx, tx = bf16_input((16, cfg.d_model), 1)
    w, ids, aux = Moe._route(torch.from_numpy(router), tx, cfg.top_k)
    assert w.shape == ids.shape == (16, cfg.top_k)
    assert w.dtype == torch.float32 and ids.dtype == torch.int32
    np.testing.assert_allclose(w.sum(-1).numpy(), 1.0, rtol=1e-5)
    assert bool(((ids >= 0) & (ids < cfg.n_experts)).all())
    assert 0.5 < float(aux) < 4.0
    jw, jids, jaux = JMoe._route(jnp.asarray(router), jx, cfg.top_k)
    ok = clear_tokens(router, x, cfg.top_k)
    assert ok.mean() >= CLEAR_SHARE
    np.testing.assert_array_equal(ids.numpy()[ok], np.asarray(jids)[ok])
    np.testing.assert_allclose(w.numpy()[ok], np.asarray(jw)[ok],
                               rtol=ROUTE_TOL, atol=ROUTE_TOL)
    check_aux(aux, ids, jaux, jids, router, x)


def test_expert_ffn_matches_reference():
    jcfg, cfg = configs("granite-moe-3b-a800m")
    jp, tp = weights(jcfg, cfg, 10)
    _, jxb, txb = bf16_input((cfg.n_experts, 6, cfg.d_model), 11)
    got = Moe._expert_ffn(tp["e_gate"], tp["e_up"], tp["e_down"], txb)
    assert got.dtype == torch.bfloat16
    close(got, jax.jit(JMoe._expert_ffn)(jp["e_gate"], jp["e_up"],
                                         jp["e_down"], jxb))


@pytest.mark.parametrize("case", CASES)
def test_moe_dense_shapes_finite_and_matches_reference(case):
    jcfg, cfg = configs(case)
    jp, tp = weights(jcfg, cfg, 2)
    B, S = 2, 24
    x, jx, tx = bf16_input((B, S, cfg.d_model), 3)
    y, aux = Moe.moe_dense(tp, cfg, tx)
    assert y.shape == tx.shape and y.dtype == torch.bfloat16
    assert bool(torch.isfinite(y.float()).all()) and np.isfinite(float(aux))
    jy, jaux = jax.jit(JMoe.moe_dense, static_argnums=1)(jp, jcfg, jx)
    x2 = x.reshape(B * S, -1)
    ok = clear_tokens(np.asarray(jp["router"]), x2, cfg.top_k)
    assert ok.mean() >= CLEAR_SHARE
    _, ids, _ = Moe._route(tp["router"], tx.reshape(B * S, -1), cfg.top_k)
    _, jids, _ = JMoe._route(jp["router"], jx.reshape(B * S, -1), cfg.top_k)
    np.testing.assert_array_equal(ids.numpy()[ok], np.asarray(jids)[ok])
    close(y.reshape(B * S, -1)[torch.from_numpy(ok)],
          np.asarray(jy.astype(jnp.float32)).reshape(B * S, -1)[ok])
    check_aux(aux, ids, jaux, jids, np.asarray(jp["router"]), x2)


def test_moe_apply_without_mesh_is_dense():
    _, cfg = configs("qwen3-moe-235b-a22b")
    p = Moe.moe_init(torch.Generator().manual_seed(4), cfg, 1)
    p = {k: v[0] for k, v in p.items()}
    x = torch.randn((1, 8, cfg.d_model),
                    generator=torch.Generator().manual_seed(5)).bfloat16()
    y1, a1 = Moe.moe_apply(p, cfg, x)
    y2, a2 = Moe.moe_dense(p, cfg, x)
    assert torch.equal(y1, y2) and torch.equal(a1, a2)


def test_expert_padding():
    """granite has 40 experts, padded to 48; pads take no tokens and are
    never computed."""
    full = get_config("granite-moe-3b-a800m")
    assert full.n_experts == 40 and Moe.n_experts_padded(full) == 48
    assert Moe.n_experts_padded(jax_config("granite-moe-3b-a800m")) == 48
    jcfg, cfg = configs(PADDED)
    assert Moe.n_experts_padded(cfg) == JMoe.n_experts_padded(jcfg) == 32
    assert Moe.n_experts_padded(get_reduced("granite-moe-3b-a800m")) == 8
    p = Moe.moe_init(torch.Generator().manual_seed(6), cfg, 3)
    d, f = cfg.d_model, cfg.d_expert_ff
    assert tuple(p["router"].shape) == (3, d, 20)
    assert p["router"].dtype == torch.float32
    assert tuple(p["e_gate"].shape) == tuple(p["e_up"].shape) == (3, 32, d, f)
    assert tuple(p["e_down"].shape) == (3, 32, f, d)
    assert p["e_gate"].dtype == torch.bfloat16
    layer = {k: v[0].clone() for k, v in p.items()}
    x = torch.randn((64, d), generator=torch.Generator().manual_seed(7))
    _, ids, _ = Moe._route(layer["router"], x, cfg.top_k)
    assert bool((ids < cfg.n_experts).all())
    y, _ = Moe.moe_dense(layer, cfg, x[None].bfloat16())
    for k in ("e_gate", "e_up", "e_down"):
        layer[k][cfg.n_experts:] = float("nan")
    y_nan, _ = Moe.moe_dense(layer, cfg, x[None].bfloat16())
    assert torch.equal(y, y_nan)
    # the reference's padded rows carried across, bf16 as it casts them
    jp, tp = weights(jcfg, cfg, 8)
    for k in ("e_gate", "e_up", "e_down"):
        assert tp[k].shape[0] == 32 and tp[k].dtype == torch.bfloat16
        np.testing.assert_array_equal(
            tp[k].float().numpy(),
            np.asarray(jp[k].astype(jnp.bfloat16).astype(jnp.float32)))
    np.testing.assert_array_equal(tp["router"].numpy(),
                                  np.asarray(jp["router"]))


def test_moe_grad_flows_to_router():
    jcfg, cfg = configs("qwen3-moe-235b-a22b")
    jp = JMoe.moe_init(jax.random.PRNGKey(8), jcfg)
    x, jx, _ = bf16_input((1, 8, cfg.d_model), 9)
    # float32 masters in both, cast to bf16 at use
    tp = {k: torch.from_numpy(np.array(v)).requires_grad_(True)
          for k, v in jp.items()}
    tx = torch.from_numpy(x)

    def loss(p, x, moe, c, to_f32):
        y, aux = moe(p, c, x)
        return (to_f32(y) ** 2).sum() + 0.01 * aux

    total = loss(tp, tx, Moe.moe_dense, cfg, lambda y: y.float())
    grads = dict(zip(tp, torch.autograd.grad(total, list(tp.values()))))
    assert float(grads["router"].abs().sum()) > 0
    for g in grads.values():
        assert bool(torch.isfinite(g).all())
    jg = jax.jit(jax.grad(lambda p: loss(
        p, jnp.asarray(x), JMoe.moe_dense, jcfg,
        lambda y: y.astype(jnp.float32))))(jp)
    ok = clear_tokens(np.asarray(jp["router"]), x.reshape(8, -1), cfg.top_k)
    assert ok.all()
    want = np.asarray(jg["router"])
    np.testing.assert_allclose(grads["router"].numpy(), want, rtol=0,
                               atol=GRAD_TOL * float(np.abs(want).max()))
